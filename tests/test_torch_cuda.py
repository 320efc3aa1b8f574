"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips without CUDA (decided inside the test,
never at import). This file imports neither JAX nor the reference
package, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality — every output is a boolean verdict, an
integer choice, or (the claim kernels' NIC headroom) a float32 value the
kernel must round as the plain version does.
"""

import random

import numpy as np
import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import reference, sweep

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _case(rng, T, N, U, K, C, A):
    """The attic parity case generator (attic/test_nic_pallas.py)."""
    UK, CA = U * K, C * A
    free_rx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    free_tx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    dem_rx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    dem_tx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    unchosen = rng.random((CA, UK)) < 0.5
    dem_rx[np.broadcast_to(unchosen, (T, CA, UK))] = 0.0
    dem_tx[np.broadcast_to(unchosen, (T, CA, UK))] = 0.0
    valid = rng.random((N, CA)) < 0.8
    pci_ok = rng.random((N, CA)) < 0.7
    map_pci = rng.random(T) < 0.5
    return (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci)


@pytest.mark.parametrize(
    "shape", [(2, 128, 2, 2, 4, 4), (3, 256, 2, 4, 4, 16), (4, 1000, 2, 7, 4, 49)]
)
def test_nic_any_first_kernel_matches_plain(shape):
    _need_cuda()
    T, N, U, K, C, A = shape
    args = [torch.from_numpy(a).cuda() for a in _case(np.random.default_rng(7), *shape)]
    dims = dict(U=U, K=K, C=C, A=A)
    before = kernels.LAUNCHES["nic_any_first"]
    got = kernels.nic_any_first(*args, **dims)
    want = reference.nic_any_first(*args, **dims)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nic_any_first"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cuda(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.parametrize("shape", sweep.NIC_SWEEP, ids=str)
def test_nic_any_first_sweep_matches_plain(shape):
    """The edge shapes of the kernel: picks per combo across 32-lane
    chunks, straddling combos, none/all fitting, T=1, ragged node tiles,
    U*K past 32, a warp with a second chunk, U*K=1000 and picks that
    choose every slot."""
    _need_cuda()
    args, kw = sweep.nic_case(sweep.NIC_SWEEP.index(shape), *shape)
    args = _cuda(args)
    got = kernels.nic_any_first(*args, **kw)
    want = reference.nic_any_first(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", sweep.PLANE_SWEEP, ids=str)
def test_solve_planes_sweep_matches_plain(shape):
    _need_cuda()
    args = _cuda(sweep.plane_case(sweep.PLANE_SWEEP.index(shape), *shape))
    before = kernels.LAUNCHES["solve_planes"]
    got = kernels.solve_planes(*args)
    want = reference.solve_planes(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["solve_planes"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fill", ["tie", "none"])
def test_solve_planes_first_maximum_and_no_feasible_combo(fill):
    """Tied skew: the combo value still orders by c, and the first maximum
    wins; no feasible combo: cand 0, best_c 0, and best_m, best_a and
    n_picks read at combo 0 — all as the plain version has them."""
    _need_cuda()
    T, N, U, G, C, NCLS = 3, 301, 2, 2, 4, 4
    args = sweep.plane_case(11, T, N, U, G, C, NCLS, fill)
    got = kernels.solve_planes(*_cuda(args))
    want = reference.solve_planes(*[torch.from_numpy(np.ascontiguousarray(a))
                                    for a in args])
    assert torch.equal(got.cpu(), want)
    P = {name: i for i, name in enumerate(kernels.PLANES)}
    cand = want[P["cand"]] != 0
    assert torch.equal(want[P["best_c"]][~cand], torch.zeros_like(want[0][~cand]))
    if fill == "none":
        assert not cand.any()
        first_a = torch.from_numpy(args[22])
        assert torch.equal(want[P["best_a"]], first_a[..., 0])
    else:
        assert cand.any()


def _solve_instance(seed, n_nodes=40):
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    rng = random.Random(seed)
    nodes = {}
    for i in range(n_nodes):
        spec = SynthNodeSpec(
            name=f"node{i:03d}", phys_cores=rng.choice([8, 16, 24]),
            nics_per_numa=rng.choice([1, 2, 4]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            groups=rng.choice(["default", "edge", "default.edge"]),
        )
        node = make_node(spec)
        for core in node.cores:
            if rng.random() < 0.3:
                core.used = True
        nodes[node.name] = node
    cluster = encode_cluster(nodes, now=0.0)
    return cluster, encode_pods(workload_mix(60, ["default", "edge"]), cluster.interner)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_kernels_match_plain(seed):
    """All three kernels through the solve, CUDA against CPU plain."""
    _need_cuda()
    from nhd_tpu_torch.solver.kernel import solve_bucket, solve_bucket_ranked

    cluster, buckets = _solve_instance(seed)
    for G, pods in buckets.items():
        got = solve_bucket(cluster, pods, device="cuda")
        want = solve_bucket(cluster, pods, device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        gr = solve_bucket_ranked(cluster, pods, 16, device="cuda").cpu()
        wr = solve_bucket_ranked(cluster, pods, 16, device="cpu")
        live = wr[0] > 0
        assert torch.equal(gr[0] > 0, live)
        for row in range(9):
            assert torch.equal(gr[row][live], wr[row][live])


@pytest.mark.parametrize("speculate", ["0", "1"])
def test_schedule_cuda_equals_cpu(speculate, monkeypatch):
    """One pipelined CUDA schedule places like the CPU plain path, with
    classic rounds and with the speculative round 0 (set on both sides:
    the default differs between the card and the CPU)."""
    _need_cuda()
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    monkeypatch.setenv("NHD_TPU_SPECULATE", speculate)

    reqs = workload_mix(300, ["default", "edge"])
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    out = []
    for dev in ("cuda", "cpu"):
        res, stats = BatchScheduler(
            device=dev, respect_busy=False, register_pods=False
        ).schedule(cap_cluster(30, ["default", "edge"]), items, now=0.0)
        out.append([(r.node, None if r.mapping is None else dict(r.mapping))
                    for r in res])
    assert out[0] == out[1]
    assert sum(1 for n, _ in out[0] if n) > 0


@pytest.mark.parametrize("shape", sweep.NODE_SWEEP, ids=str)
def test_nic_node_masks_sweep_matches_plain(shape):
    """G from 1 to 6, C*A from 1 to 4096, U past the registers, U*K past
    32 and past shared memory, ragged strips, switch ids -1 and out of
    range, every NIC on one switch, negative switch entries."""
    _need_cuda()
    args = _cuda(sweep.node_case(sweep.NODE_SWEEP.index(shape), *shape))
    before = kernels.LAUNCHES["nic_node_masks"]
    got = kernels.nic_node_masks(*args)
    want = reference.nic_node_masks(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nic_node_masks"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _spec_pair(shape):
    """The sweep case twice on the card: one set for the kernels, one for
    the plain versions (the kernels write some inputs in place)."""
    case = sweep.spec_case(sweep.SPEC_SWEEP.index(shape), *shape)
    mk = lambda: {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()  # noqa: E731
                  if isinstance(v, np.ndarray) else v for k, v in case.items()}
    return mk(), mk()


def _assert_same(a, b, names):
    for k in names:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("shape", sweep.SPEC_SWEEP, ids=str)
def test_claim_kernels_sweep_match_plain(shape):
    """spec_elect, spec_fill and spec_apply each against its plain version
    on the same inputs (the later two fed the plain plan), every in-place
    tensor compared after the call."""
    _need_cuda()
    k, p = _spec_pair(shape)
    kw = dict(sharing=k["sharing"], respect_busy=k["respect_busy"])
    launches = {n: kernels.LAUNCHES[n] for n in ("spec_elect", "spec_fill", "spec_apply")}
    plan_k = kernels.spec_elect(*(k[n] for n in sweep.SPEC_ELECT_ARGS), **kw)
    plan_p = reference.spec_elect(*(p[n] for n in sweep.SPEC_ELECT_ARGS), **kw)
    torch.cuda.synchronize()
    assert torch.equal(plan_k, plan_p)
    _assert_same(k, p, ["status"])
    plan_k = plan_p.clone()
    kernels.spec_fill(plan_k, k["status"])
    reference.spec_fill(plan_p, p["status"])
    torch.cuda.synchronize()
    assert torch.equal(plan_k, plan_p)
    _assert_same(k, p, ["status"])
    assert (plan_p[6] > 0).any()
    kernels.spec_apply(plan_p, *(k[n] for n in sweep.SPEC_APPLY_ARGS), **kw)
    reference.spec_apply(plan_p, *(p[n] for n in sweep.SPEC_APPLY_ARGS), **kw)
    torch.cuda.synchronize()
    _assert_same(k, p, sweep.SPEC_APPLY_ARGS)
    for n, v in launches.items():
        assert kernels.LAUNCHES[n] == v + 1


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", sweep.FILL_SWEEP, ids=str)
def test_spec_fill_sweep_matches_plain(shape, offset):
    """spec_fill against its plain version on a plan and need drawn
    directly; with *offset* 1 the plan starts one word past a 16-byte
    boundary, so no row takes the int4 loads."""
    _need_cuda()
    plan, status = sweep.fill_case(sweep.FILL_SWEEP.index(shape), *shape)
    buf = torch.zeros(plan.size + offset, dtype=torch.int32, device="cuda")
    plan_k = buf[offset:].view(plan.shape)
    plan_k.copy_(torch.from_numpy(plan))
    status_k = torch.from_numpy(status).cuda()
    plan_p, status_p = plan_k.clone(), status_k.clone()
    before = kernels.LAUNCHES["spec_fill"]
    kernels.spec_fill(plan_k, status_k)
    reference.spec_fill(plan_p, status_p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spec_fill"] == before + 1
    assert torch.equal(plan_k, plan_p)
    assert torch.equal(status_k, status_p)


@pytest.mark.parametrize("cap", sweep.GATE_CAPS)
@pytest.mark.parametrize("shape", sweep.GATE_SWEEP, ids=str)
def test_spec_gate_sweep_matches_plain(shape, cap):
    """spec_gate against its plain version on every gate sweep case at
    each cap: the control tensor equal after the call, the inputs
    untouched."""
    _need_cuda()
    case = sweep.gate_case(sweep.GATE_SWEEP.index(shape), *shape)
    status, offsets, ctl = (torch.from_numpy(a).cuda() for a in case)
    iters = sweep.gate_iters(case[2], cap)
    want = ctl.clone()
    before = kernels.LAUNCHES["spec_gate"]
    kernels.spec_gate(status, offsets, ctl, iters=iters)
    reference.spec_gate(status, offsets, want, iters=iters)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spec_gate"] == before + 1
    assert torch.equal(ctl, want)


def _megaround_case(iters, zero_need=False):
    """A cap_cluster(40) megaround instance: (cluster, buckets, needs)."""
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _pad_pow2

    groups = ["default", "edge", "batch"]
    cluster = encode_cluster(cap_cluster(40, groups), now=0.0)
    buckets = list(encode_pods(workload_mix(400, groups), cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             * (0 if zero_need else 1) for p in buckets]
    return cluster, buckets, needs


@pytest.mark.parametrize("graph", ["1", "0"])
@pytest.mark.parametrize("sharing", [False, True])
def test_megaround_graph_equals_host_loop(sharing, graph, monkeypatch):
    """The megaround as the graph replays it (its WHILE node) and, with
    the replay off, as its fixed trip launches one by one, against the
    host loop, all on the card, from the same encoded state: claims,
    counts, need left, iterations and node state. A replay counts one
    megaround_graph launch and one spec_gate, and its body once per
    iteration when the iteration word is read (``count_passes``): 1 +
    iterations of spec_gate; the fixed trip 1 + NHD_TPU_SPEC_ITERS."""
    _need_cuda()
    import nhd_tpu_torch.core.node as node_mod
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.speculate import run_megaround

    monkeypatch.setattr(node_mod, "ENABLE_NIC_SHARING", sharing)
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "8")
    monkeypatch.setattr(speculate, "REPLAY", graph == "1")
    groups = ["default", "edge", "batch"]
    cluster = encode_cluster(cap_cluster(40, groups), now=0.0)
    buckets = list(encode_pods(workload_mix(400, groups), cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in buckets]
    state = DeviceClusterState(cluster, "cuda")
    loop_state = DeviceClusterState(cluster, "cuda")
    loop = run_megaround(loop_state._dev, buckets,
                         [loop_state.pod_tensors(p) for p in buckets], needs,
                         cluster.U, cluster.K, 8, False)
    state.megaround(buckets, needs, False)   # the key's capture, warm-up included
    state.rebuild_resident()                  # back to the host mirror
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    got = state.megaround(buckets, needs, False)
    torch.cuda.synchronize()
    its = int(got[3])
    kernels.count_passes(got.body, its)
    moved = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.COUNTED}
    for g, w in zip([*got, *(state._dev[n] for n in _MUTABLE)],
                    [*loop, *(loop_state._dev[n] for n in _MUTABLE)]):
        assert torch.equal(g.cpu(), w.cpu())
    assert its >= 1
    assert moved["spec_gate"] == (1 + its if graph == "1" else 9)
    assert moved["spec_apply"] == (its if graph == "1" else 8)
    assert moved[kernels.GRAPH] == (1 if graph == "1" else 0)
    assert (got.body.get("spec_gate") == 1) == (graph == "1")


@pytest.mark.parametrize("case", ["cap", "no_need"])
def test_while_graph_passes_equal_the_iterations(case, monkeypatch):
    """The WHILE graph runs its body exactly as many times as the
    iteration word says: a body with one more op (a pass counter) is
    captured, and after a replay the counter equals ctl[1] and the
    results equal the fixed trip's and the host loop's, where the cap
    binds (NHD_TPU_SPEC_ITERS=2 with need left: 2) and where the need
    is 0 at the start (no pass: 0)."""
    _need_cuda()
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.kernel import _MUTABLE
    from nhd_tpu_torch.solver.speculate import run_megaround

    iters = 2 if case == "cap" else 8
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", str(iters))
    cluster, buckets, needs = _megaround_case(iters, zero_need=case == "no_need")
    passes = torch.zeros(1, dtype=torch.int32, device="cuda")
    iteration = speculate.megaround_iteration

    def counted(*a, **kw):
        passes.add_(1)
        return iteration(*a, **kw)

    monkeypatch.setattr(speculate, "megaround_iteration", counted)
    monkeypatch.setattr(speculate, "GRAPHS", speculate.MegaroundCache())
    outs = []
    for form in ("graph", "fixed", "loop"):
        state = DeviceClusterState(cluster, "cuda")
        if form == "loop":
            res = run_megaround(state._dev, buckets,
                                [state.pod_tensors(p) for p in buckets], needs,
                                cluster.U, cluster.K, iters, False)
        else:
            monkeypatch.setattr(speculate, "REPLAY", form == "graph")
            if form == "graph":
                # the capture (its warm-up runs one pass eagerly) first
                DeviceClusterState(cluster, "cuda").megaround(buckets, needs, False)
                (entry,) = speculate.GRAPHS.entries()
                assert entry.graph is not None
                torch.cuda.synchronize()
                passes.zero_()
            res = state.megaround(buckets, needs, False)
        torch.cuda.synchronize()
        outs.append([t.cpu() for t in res] + [state._dev[n].cpu() for n in _MUTABLE])
        if form == "graph":
            assert int(passes) == int(res[3])   # one pass per iteration, no more
    for got in outs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(outs[0], got))
    assert int(outs[0][3]) == (2 if case == "cap" else 0)


def test_while_capture_failure_raises(monkeypatch):
    """A helper call that fails during the capture raises
    KernelLaunchError with its CUDA code; nothing falls back to the
    fixed trip or the host loop, and no graph is kept."""
    _need_cuda()
    from nhd_tpu_torch.kernels import build
    from nhd_tpu_torch.kernels.build import KernelLaunchError
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState

    cluster, buckets, needs = _megaround_case(8)
    monkeypatch.setattr(speculate, "GRAPHS", speculate.MegaroundCache())
    call = build.call_helper

    def refused(source, entry, *args):
        if entry == "nhd_graph_while_open":
            raise KernelLaunchError(source, 801, "refused for the test")
        return call(source, entry, *args)

    monkeypatch.setattr(build, "call_helper", refused)
    before = dict(kernels.LAUNCHES)
    state = DeviceClusterState(cluster, "cuda")
    with pytest.raises(KernelLaunchError) as info:
        state.megaround(buckets, needs, False)
    assert info.value.code == 801
    assert kernels.LAUNCHES[kernels.GRAPH] == before[kernels.GRAPH]
    assert all(e.graph is None for e in speculate.GRAPHS.entries())


@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("respect_busy", [False, True])
def test_megaround_cuda_equals_cpu(sharing, respect_busy, monkeypatch):
    """The whole megaround, kernels on the card against the plain versions
    on the CPU, from the same encoded state: claims, counts, need left,
    iterations and the projected node state."""
    _need_cuda()
    import nhd_tpu_torch.core.node as node_mod
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2

    monkeypatch.setattr(node_mod, "ENABLE_NIC_SHARING", sharing)
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "8")
    groups = ["default", "edge", "batch"]
    cluster = encode_cluster(cap_cluster(40, groups), now=0.0)
    buckets = list(encode_pods(workload_mix(400, groups), cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in buckets]
    out = []
    for dev in ("cuda", "cpu"):
        state = DeviceClusterState(cluster, dev)
        res = state.megaround(buckets, needs, respect_busy)
        out.append(([t.cpu() for t in res],
                    [state._dev[n].cpu() for n in _MUTABLE]))
    (got, got_state), (want, want_state) = out
    for g, w in zip(got + got_state, want + want_state):
        assert torch.equal(g, w)
    assert int(want[3]) > 1 and (want[1] > 0).any()


@pytest.mark.parametrize("placement", ["first-fit", "routed"])
def test_streaming_cuda_equals_cpu(placement, monkeypatch):
    """A cfg5-shaped federation (120 cap_cluster nodes in tiles of 40,
    1,200 workload_mix pods, 5 groups) through the tiler with three
    workers launching on the card, against the CPU run of the same tiling:
    every pod's node, mapping and NICs equal; the launch counts equal the
    sum of what each tile sub-call launched, and every kernel of the path
    launched: the megaround's, and rank_top once a classic rank dispatch
    (none where every pod placed in the megarounds), never rank_merge."""
    _need_cuda()
    from chip_smoke import ranked_uses, spans
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, StreamingScheduler

    groups = ["default", "edge", "batch", "fed1", "fed2"]
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(1200, groups))]
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    out = {}
    for dev, workers in (("cuda", "3"), ("cpu", "1")):
        monkeypatch.setenv("NHD_STREAM_WORKERS", workers)
        sched = StreamingScheduler(device=dev, tile_nodes=40, chunk_pods=500,
                                   placement=placement, respect_busy=False,
                                   register_pods=False)
        kernels.reset_launches()
        ranked0 = ranked_uses()
        with spans(sched) as got:
            res, stats = sched.schedule(cap_cluster(120, groups), items, now=0.0)
        torch.cuda.synchronize()
        ranked = ranked_uses() - ranked0
        out[dev] = [(r.node, r.mapping, r.nic_list) for r in res]
        if dev == "cuda":
            total = dict(kernels.LAUNCHES)
            summed = {n: sum(c[n] for _t, c, _w in got["calls"])
                      for n in kernels.COUNTED}
            assert total == summed
            rank = set(kernels.RANK_KERNELS)
            assert all(v > 0 for n, v in total.items() if n not in rank), total
            assert (total["rank_top"], total["rank_merge"]) == (ranked, 0), total
            assert stats.scheduled == 1200
    assert out["cuda"] == out["cpu"]


def test_cli_fake_demo_on_cuda():
    """``python -m nhd_tpu_torch.cli --fake --device cuda``: the demo
    TriadSet binds 4/6 across the 4 nodes inside 15 s on the card, as the
    JAX CLI binds it with the default 30 s busy back-off, and the clean
    exit prints a launch count for each kernel and the megaround's graph
    replays: above 0 for the solve and claim kernels, spec_gate and the
    replays, 0 for rank_merge (no mesh); rank_top runs only where a batch
    took a classic round."""
    _need_cuda()
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    r = subprocess.run(
        [sys.executable, "-m", "nhd_tpu_torch.cli", "--fake", "--device",
         "cuda", "--rpc-port", "0", "--run-seconds", "15"],
        capture_output=True, text=True, timeout=180, env=env, cwd=root,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "demo summary: 4/6 pods bound across 4 nodes" in r.stdout, r.stdout
    import json

    printed = [line for line in r.stdout.splitlines()
               if line.startswith("kernel launches: ")]
    assert len(printed) == 1, r.stdout
    got = json.loads(printed[0].split(": ", 1)[1])
    assert sorted(got) == sorted(kernels.COUNTED), got
    rank = set(kernels.RANK_KERNELS)
    assert all(n > 0 for k, n in got.items() if k not in rank), got
    assert got["rank_merge"] == 0, got


def test_truncated_library_quarantined_and_rebuilt(tmp_path, monkeypatch):
    """A real kernel library truncated on disk (a torn write) meets a
    fresh library table: the load quarantines it (kept under
    quarantine/), rebuilds it from source with nvcc and launches it,
    exact against the plain version; nothing else is rebuilt."""
    _need_cuda()
    import os

    from nhd_tpu_torch.kernels import build
    from nhd_tpu_torch.solver import aot

    aot.reset()
    aot.configure(directory=str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "COUNTS", dict.fromkeys(build.COUNTS, 0))
    try:
        build.build_all()   # built, not opened: rewriting a mapped file faults
        # every source: the kernels and the WHILE node's helper
        assert build.COUNTS["builds"] == len(build.SOURCES)
        so = build.library_path("nic_any_first")
        with open(so, "r+b") as fh:
            fh.truncate(64)
        shape = (2, 128, 2, 2, 4, 4)
        T, N, U, K, C, A = shape
        args = [torch.from_numpy(a).cuda()
                for a in _case(np.random.default_rng(3), *shape)]
        dims = dict(U=U, K=K, C=C, A=A)
        got = kernels.nic_any_first(*args, **dims)
        want = reference.nic_any_first(*args, **dims)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        assert so.name in os.listdir(tmp_path / "quarantine")
        assert build.COUNTS["quarantined"] == 1
        assert build.COUNTS["builds"] == len(build.SOURCES) + 1
        assert build.stale_reason("nic_any_first") is None
    finally:
        aot.reset()


# ---------------------------------------------------------------------------
# the node mesh on the card: every shard on cuda:0 (one card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("shape", sweep.PLANE_SWEEP[:4], ids=str)
def test_solve_planes_shard_matches_plain_and_columns(shape, shards):
    """solve_planes on each shard's node rows with its node_base (blocks
    of ceil(N / shards) rows, the last one short): equal to the plain
    version and to the unsharded kernel planes' columns."""
    _need_cuda()
    N = shape[1]
    args = _cuda(sweep.plane_case(sweep.PLANE_SWEEP.index(shape), *shape))
    full = kernels.solve_planes(*args)
    Ns = -(-N // shards)
    for lo in range(0, N, Ns):
        hi = min(N, lo + Ns)
        part = list(args)
        for i in range(11):                      # the [N, ...] node rows
            part[i] = args[i][lo:hi].contiguous()
        for i in (21, 22, 23):                   # the [T, N, C] NIC planes
            part[i] = args[i][:, lo:hi].contiguous()
        place = dict(node_base=lo, n_global=N)
        got = kernels.solve_planes(*part, **place)
        want = reference.solve_planes(*part, **place)
        torch.cuda.synchronize()
        assert torch.equal(got, want), lo
        assert torch.equal(got, full[:, :, lo:hi]), lo


@pytest.mark.parametrize("respect_busy", [False, True])
def test_mesh_megaround_and_rank_equal_one_device_on_card(respect_busy, monkeypatch):
    """A 4-shard mesh on cuda:0: the megaround's claims, counts, need left,
    iterations and node state equal one device's, and every bucket's
    sharded rank equals the single-device rank on the val > 0 slots."""
    _need_cuda()
    from nhd_tpu_torch.parallel.sharding import make_mesh, solve_bucket_ranked_sharded
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2, solve_bucket_ranked

    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "8")
    groups = ["default", "edge", "batch"]
    cluster = encode_cluster(cap_cluster(40, groups), now=0.0)
    buckets = list(encode_pods(workload_mix(400, groups), cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in buckets]
    mesh = make_mesh(n_shards=4, device="cuda")
    for pods in buckets:
        one = solve_bucket_ranked(cluster, pods, 64, device="cuda").cpu().numpy()
        got = solve_bucket_ranked_sharded(cluster, pods, 64, mesh)
        live = one[0] > 0
        assert np.array_equal(got[0] > 0, live)
        assert np.array_equal(got[:, live], one[:, live])
    out = []
    for m in (mesh, None):
        state = DeviceClusterState(cluster, "cuda", m)
        res = state.megaround(buckets, needs, respect_busy)
        out.append(([t.cpu() for t in res],
                    [state.resident(n).cpu() for n in _MUTABLE]))
    (got, got_state), (want, want_state) = out
    for g, w in zip(got + got_state, want + want_state):
        assert torch.equal(g, w)
    assert int(want[3]) > 1 and (want[1] > 0).any()


@pytest.mark.parametrize("i", range(len(sweep.RANK_SWEEP)))
def test_rank_kernels_equal_plain_on_the_sweep(i):
    """rank_top and rank_merge on the card against their plain versions,
    bit for bit, on every RANK_SWEEP case, and each launch counted."""
    _need_cuda()
    c = sweep.rank_case(i, *sweep.RANK_SWEEP[i])
    args = [torch.from_numpy(c[k]).cuda()
            for k in ("planes", "gpu_free", "cpu_free", "hp_free")]
    cand = torch.from_numpy(c["cand"]).cuda()
    before = {n: kernels.LAUNCHES[n] for n in kernels.RANK_KERNELS}
    got = kernels.rank_top(*args, R=c["R"], node_base=c["node_base"])
    merged = kernels.rank_merge(cand, R=c["merge_R"])
    torch.cuda.synchronize()
    assert torch.equal(got, reference.rank_top(*args, R=c["R"],
                                               node_base=c["node_base"]))
    assert torch.equal(merged, reference.rank_merge(cand, R=c["merge_R"]))
    assert all(kernels.LAUNCHES[n] == before[n] + 1 for n in kernels.RANK_KERNELS)
