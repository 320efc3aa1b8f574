"""The megaround as one device program: the fixed trip with its exit on the
device (nhd_tpu_torch/solver/speculate.py, kernels/spec_gate.cu) on the CPU.

On the card a single-device megaround is one CUDA graph replay of
``megaround_trip``: ``spec_gate`` opens each of ``spec_iters()``
iterations and every other kernel returns at once where its gate word is
0. On the CPU the same trip runs launch by launch through the plain
versions, so these tests hold the gate's semantics: the trip against the
host loop (``run_megaround``) and the JAX reference's
``lax.while_loop`` at each way the loop can end, no host pull inside the
trip, the table buffer's refill against a fresh ``spec_tables``, the
graph cache across resident states and re-uploads, the launch accounting
of a replay, the prewarm's key, and ``spec_gate``'s plain version
against a numpy statement of its rule. The card's own cases (replay
against the host loop, the kernel against its plain version) are in
tests/test_torch_cuda.py.

Tolerance: exact. Claim words, counts, need, iteration counts and node
state (float32 NIC headroom included) are bit-identical.
"""

import numpy as np
import pytest
import torch

import nhd_tpu.core.node as jx_node
import nhd_tpu.sim.workloads as jx_workloads
import nhd_tpu_torch.core.node as pt_node
from nhd_tpu.solver import speculate as jx_spec
from nhd_tpu.solver.device_state import DeviceClusterState as JxState
from nhd_tpu.solver.encode import encode_cluster, encode_pods
from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import sweep
from nhd_tpu_torch.solver import device_state, speculate
from nhd_tpu_torch.solver.device_state import DeviceClusterState as PtState
from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _MUTABLE, _pad_pow2

G3 = ["default", "edge", "batch"]


@pytest.fixture(autouse=True)
def _spec_env(monkeypatch):
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "8")


def _few_pairs(reqs, keep=2):
    """*reqs* with all but *keep* of the two-group pods dropped: the G=2
    bucket runs out of need while the G=1 bucket still claims."""
    out, pairs = [], 0
    for r in reqs:
        if len(r.groups) == 2:
            pairs += 1
            if pairs > keep:
                continue
        out.append(r)
    return out


#: exit -> (nodes, requests) through the reference's packages
EXITS = {
    "need_exhausted": lambda wl: (wl.cap_cluster(32, G3), wl.workload_mix(300, G3)),
    "no_progress": lambda wl: (wl.bench_cluster(16, G3), wl.workload_mix(300, G3)),
    "iters_cap": lambda wl: (wl.cap_cluster(32, G3), wl.workload_mix(600, G3)),
    "bucket_dead_mid_loop": lambda wl: (
        wl.cap_cluster(32, G3), _few_pairs(wl.workload_mix(600, G3))),
    "nic_sharing": lambda wl: (wl.cap_cluster(32, G3), wl.workload_mix(300, G3)),
}


def _encode(name):
    """One instance encoded once by the reference's encoder: every run
    starts from these arrays."""
    nodes, reqs = EXITS[name](jx_workloads)
    cluster = encode_cluster(nodes, now=0.0)
    cluster.busy[:] = False
    pods = list(encode_pods(reqs, cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in pods]
    return cluster, pods, needs


def _gate_log(monkeypatch):
    """Record the control tensor after every spec_gate call."""
    seen = []
    gate = kernels.spec_gate

    def spy(status, offsets, ctl):
        gate(status, offsets, ctl)
        seen.append(ctl.clone().numpy())

    monkeypatch.setattr(kernels, "spec_gate", spy)
    return seen


@pytest.mark.parametrize("name", sorted(EXITS))
def test_fixed_trip_matches_host_loop_and_reference(name, monkeypatch):
    """The gated fixed trip (``DeviceClusterState.megaround`` on one
    device) against the host loop and the reference, at each exit: need
    spent, no progress (a saturated cluster), the NHD_TPU_SPEC_ITERS cap,
    a bucket whose need runs out while another claims, and NIC sharing
    on. Claims, counts, need left, iterations and node state equal."""
    iters = 2 if name == "iters_cap" else 8
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", str(iters))
    sharing = name == "nic_sharing"
    monkeypatch.setattr(jx_node, "ENABLE_NIC_SHARING", sharing)
    monkeypatch.setattr(pt_node, "ENABLE_NIC_SHARING", sharing)
    cluster, pods, needs = _encode(name)
    jx_spec._get_megaround.cache_clear()
    try:
        ref = JxState(cluster, None)
        want = [np.asarray(x) for x in ref.megaround(pods, needs, False)]
        want += [np.asarray(ref._dev[n]) for n in _MUTABLE]
    finally:
        jx_spec._get_megaround.cache_clear()
    loop_state = PtState(cluster, "cpu")
    loop = speculate.run_megaround(
        loop_state._dev, pods, [loop_state.pod_tensors(p) for p in pods], needs,
        cluster.U, cluster.K, iters, False)
    loop = [t.numpy() for t in loop] + [loop_state._dev[n].numpy() for n in _MUTABLE]
    seen = _gate_log(monkeypatch)
    state = PtState(cluster, "cpu")
    got = [t.numpy() for t in state.megaround(pods, needs, False)]
    got += [state._dev[n].numpy() for n in _MUTABLE]
    for g, lp, w in zip(got, loop, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w) and np.array_equal(lp, w)
    its, need_left = int(want[3]), int(want[2].sum())
    assert len(seen) == iters   # the trip is fixed; the gate counts
    assert [int(c[1]) for c in seen][-1] == its
    if name == "need_exhausted":
        assert need_left == 0 and 1 <= its < iters
    elif name == "no_progress":
        assert need_left > 0 and its < iters
    elif name == "iters_cap":
        assert need_left > 0 and its == iters
    elif name == "bucket_dead_mid_loop":
        first = seen[0]
        mid = [c for c in seen[1:] if c[0] == 1 and (c[2:] < first[2:]).any()]
        assert len(pods) == 2 and first[2:].all() and mid
    else:
        assert (want[1] > 0).any()


def test_no_host_pull_inside_the_trip(monkeypatch):
    """The trip reads nothing of the device from the host: no HostPull
    while it runs, where the host loop makes one an iteration."""
    pulls = []
    init = device_state.HostPull.__init__

    def counted(self, *a, **kw):
        pulls.append(1)
        init(self, *a, **kw)

    monkeypatch.setattr(device_state.HostPull, "__init__", counted)
    cluster, pods, needs = _encode("need_exhausted")
    state = PtState(cluster, "cpu")
    _claims, _counts, _need, it = state.megaround(pods, needs, False)
    assert pulls == []
    loop_state = PtState(cluster, "cpu")
    speculate.run_megaround(loop_state._dev, pods,
                            [loop_state.pod_tensors(p) for p in pods], needs,
                            cluster.U, cluster.K, 8, False)
    assert len(pulls) == int(it)


def test_table_buffer_refill_equals_fresh_spec_tables():
    """The table buffer, built once for a key and refilled for a second
    bucket set of the same shapes, holds what a fresh ``spec_tables``
    uploads for that set (and the pods' padded arrays and NIC demand
    ``upload_pods`` makes)."""
    cluster, pods, needs = _encode("need_exhausted")
    _, pods2, needs2 = _encode("bucket_dead_mid_loop")
    U, K, Np = cluster.U, cluster.K, 64
    shapes = speculate._shapes(pods)
    assert shapes == speculate._shapes(pods2)
    first = speculate.trip_arrays(pods, needs, shapes, U, K, Np)
    second = speculate.trip_arrays(pods2, needs2, shapes, U, K, Np)
    layout = tuple((n, a.dtype.str, a.shape) for n, a in first.items())
    buf = speculate.TableBuffer(layout, torch.device("cpu"))
    buf.fill(first)
    buf.fill(second)
    st = PtState(cluster, "cpu")
    fresh = speculate.spec_tables(pods2, [st.pod_tensors(p) for p in pods2],
                                  U, K, Np, torch.device("cpu"))
    for name in ("trow", "plane_off", "cpu_g", "cpu_m", "gpu_g", "nic_occ",
                 "gpu_uk", "nic_rx", "nic_tx"):
        assert torch.equal(buf.views[name], getattr(fresh, name)), name
    assert not (first["trow"] == second["trow"]).all()
    up = st.pod_tensors(pods2[1])
    for name, t in zip(speculate._POD_ARG_ORDER, up.args):
        assert torch.equal(buf.views[f"1.{name}"], t), name
    assert torch.equal(buf.views["1.dem_rx"], up.dem_rx)
    assert int(buf.views["status"][1:].sum()) == int(sum(n.sum() for n in needs2))


def test_repeated_type_rows_refill_only_the_need(monkeypatch):
    """A dispatch whose buckets have the type rows of the key's last one
    builds no table and copies only the status, offsets and control
    words; a new set of type rows rebuilds them. Each dispatch equals
    the host loop from the same state."""
    speculate.GRAPHS.clear()
    cluster, pods, needs = _encode("need_exhausted")
    _, pods2, needs2 = _encode("bucket_dead_mid_loop")
    built = []
    table_arrays = speculate.table_arrays

    def counted(*a, **kw):
        built.append(1)
        return table_arrays(*a, **kw)

    monkeypatch.setattr(speculate, "table_arrays", counted)
    half = [n // 2 for n in needs]
    for i, (p, n) in enumerate(((pods, needs), (pods, half), (pods2, needs2))):
        state, loop_state = PtState(cluster, "cpu"), PtState(cluster, "cpu")
        before = len(built)
        got = [t.numpy() for t in state.megaround(p, n, False)]
        rebuilt = len(built) - before
        want = speculate.run_megaround(
            loop_state._dev, p, [loop_state.pod_tensors(b) for b in p], n,
            cluster.U, cluster.K, 8, False)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
        for name in _MUTABLE:
            assert torch.equal(state._dev[name], loop_state._dev[name])
        assert rebuilt == (1, 0, 1)[i]
    assert len(speculate.GRAPHS) == 1


def test_one_graph_serves_every_resident_state_of_a_key():
    """States of one key share one cache entry (its own node buffers,
    none of theirs), and a re-upload between dispatches leaves nothing a
    dispatch could read at a freed address: the second dispatch after
    ``rebuild_resident`` equals the host loop from the same state."""
    speculate.GRAPHS.clear()
    cluster, pods, needs = _encode("need_exhausted")
    a, b = PtState(cluster, "cpu"), PtState(cluster, "cpu")
    a.megaround(pods, needs, False)
    b.megaround(pods, needs, False)
    (entry,) = speculate.GRAPHS.entries()
    for name in _ARG_ORDER:
        assert entry.node[name].data_ptr() not in (
            a._dev[name].data_ptr(), b._dev[name].data_ptr())
    old = a._dev["cpu_free"].data_ptr()
    a.rebuild_resident()
    assert a._dev["cpu_free"].data_ptr() != old
    got = [t.numpy() for t in a.megaround(pods, needs, False)]
    loop_state = PtState(cluster, "cpu")
    want = speculate.run_megaround(
        loop_state._dev, pods, [loop_state.pod_tensors(p) for p in pods], needs,
        cluster.U, cluster.K, 8, False)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    for name in _MUTABLE:
        assert torch.equal(a._dev[name], loop_state._dev[name])
    assert speculate.GRAPHS.entries() == [entry]


def test_launch_accounting_of_a_replay():
    """A capture's launches go to its tally, not to the counts; each
    replay adds one megaround_graph launch and the tally, to the counts
    and to the replaying thread's own."""
    saved = dict(kernels.LAUNCHES)
    try:
        kernels.reset_launches()
        before = kernels.thread_launches()
        with kernels.capturing() as tally:
            for name in ("spec_gate", "spec_elect", "spec_gate"):
                kernels._count(name)
        assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTED, 0)
        assert tally["spec_gate"] == 2 and tally["spec_elect"] == 1
        kernels.count_replay(tally)
        kernels.count_replay(tally)
        after = kernels.thread_launches()
        want = dict.fromkeys(kernels.COUNTED, 0)
        want.update({kernels.GRAPH: 2, "spec_gate": 4, "spec_elect": 2})
        assert kernels.LAUNCHES == want
        assert {n: after[n] - before[n] for n in kernels.COUNTED} == want
    finally:
        kernels.LAUNCHES.update(saved)


@pytest.mark.parametrize("code,transient", [(2, True), (None, False)])
def test_graph_fault_is_a_kernel_launch_error(code, transient):
    """A capture or replay that fails surfaces as KernelLaunchError with
    the CUDA code it carries (901, a capture invalidated, where none), so
    the solver guard classifies it as any launch fault: out of memory
    retries on classic rounds, the rest is terminal."""
    from nhd_tpu_torch.kernels.build import KernelLaunchError
    from nhd_tpu_torch.solver.guard import classify_device_fault

    exc = RuntimeError("capture failed")
    if code is not None:
        exc.error_code = code
    err = speculate._graph_error("megaround replay", exc)
    assert isinstance(err, KernelLaunchError)
    assert err.kernel == kernels.GRAPH and err.code == (901 if code is None else code)
    assert classify_device_fault(err) is transient


def test_prewarm_warms_the_key_a_batch_dispatches():
    """The prewarm's megaround (``aot._warm_megaround`` on a recorded
    spec) fills the process's cache with the keys of both busy rules,
    and the batch's first dispatch of the key makes no new entry."""
    from nhd_tpu_torch.solver import aot

    cluster, pods, needs = _encode("need_exhausted")
    state = PtState(cluster, "cpu")
    spec = dict(U=cluster.U, K=cluster.K, mesh="",
                node=aot.arg_spec(state.shard_tensors()[0]),
                buckets=[dict(G=p.G, pod=aot.arg_spec(state.pod_tensors(p).args))
                         for p in pods])
    speculate.GRAPHS.clear()
    aot._warm_megaround(spec, torch.device("cpu"))
    warmed = speculate.GRAPHS.entries()
    assert len(warmed) == 2
    state.megaround(pods, needs, False)
    assert set(map(id, speculate.GRAPHS.entries())) == set(map(id, warmed))


def _gate_rule(status, offsets, ctl):
    """spec_gate's rule, in numpy."""
    need = status[1:].astype(np.int64)
    per = np.array([need[offsets[b]:offsets[b + 1]].sum()
                    for b in range(len(offsets) - 1)])
    alive = int(ctl[0] != 0 and status[0] != 0 and per.sum() > 0)
    return np.concatenate([[alive, ctl[1] + alive], (per > 0) & bool(alive)]).astype(np.int32)


@pytest.mark.parametrize("shape", sweep.GATE_SWEEP, ids=str)
def test_spec_gate_plain_matches_its_rule(shape):
    status, offsets, ctl = sweep.gate_case(sweep.GATE_SWEEP.index(shape), *shape)
    want = _gate_rule(status, offsets, ctl)
    t = [torch.from_numpy(a.copy()) for a in (status, offsets, ctl)]
    kernels.spec_gate(*t)   # CPU tensors: the plain version
    assert np.array_equal(t[2].numpy(), want)
    assert np.array_equal(t[0].numpy(), status) and np.array_equal(t[1].numpy(), offsets)


def test_gate_sweep_reaches_its_edges():
    """The sweep has live and dead outcomes, buckets live and dead beside
    each other, and a bucket whose sum is 0 or below though a row is
    above 0 (the rule reads the sum)."""
    outcomes, mixed, by_sum = set(), False, False
    for i, shape in enumerate(sweep.GATE_SWEEP):
        status, offsets, ctl = sweep.gate_case(i, *shape)
        out = _gate_rule(status, offsets, ctl)
        outcomes.add(int(out[0]))
        mixed |= bool(out[0]) and 0 < out[2:].sum() < len(out) - 2
        for b in range(len(offsets) - 1):
            rows = status[1:][offsets[b]:offsets[b + 1]].astype(np.int64)
            by_sum |= bool((rows > 0).any() and rows.sum() <= 0)
    assert outcomes == {0, 1} and mixed and by_sum


def test_dead_gate_leaves_every_kernel_a_no_op():
    """Each plain version returns at once on a gate of 0: in-place
    tensors unchanged, outputs zeros; the solve keeps *out*'s planes."""
    case = sweep.spec_case(0, *sweep.SPEC_SWEEP[1])
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()
         if isinstance(v, np.ndarray)}
    dead = torch.zeros(1, dtype=torch.int32)
    kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
    before = {k: v.clone() for k, v in t.items()}
    args = [t[k] for k in sweep.SPEC_ELECT_ARGS[:-1]]
    plan = kernels.spec_elect(*args, dead, **kw)
    assert not plan.any()
    kernels.spec_fill(plan, t["status"], dead)
    kernels.spec_apply(plan, *(t[k] for k in sweep.SPEC_APPLY_ARGS[:-1]), dead,
                       it=case["it"], **kw)
    for k, v in before.items():
        assert torch.equal(t[k], v), k
    args = [torch.from_numpy(a) for a in sweep.plane_case(0, *sweep.PLANE_SWEEP[0])]
    out = torch.full((8, *args[21].shape[:2]), 7, dtype=torch.int32)
    assert kernels.solve_planes(*args, dead, out=out) is out
    assert (out == 7).all()
    masks = kernels.nic_node_masks(*(torch.from_numpy(a) for a in sweep.node_case(
        0, *sweep.NODE_SWEEP[0])), dead)
    assert not any(m.any() for m in masks)
