"""The speculative megaround (K2) of the port against the JAX reference.

``nhd_tpu_torch.solver.speculate`` runs the reference's ``lax.while_loop``
(nhd_tpu/solver/speculate.py) as a host loop over the solve kernels and
the three claim kernels; on the CPU every kernel is its plain PyTorch
version. Both packages run with ``NHD_TPU_SPECULATE=1`` and
``NHD_TPU_SPEC_ITERS=8``, JAX on the CPU. The instances are those of
tests/test_speculate.py (capacity-matched, a random cluster, PCI with
NUMA, switch capacity, the busy back-off, both saturation-certificate
cases), ten more random seeds and NIC sharing on.

Tolerance: exact. Claim words, counts, need, iteration counts, node
state (float32 NIC headroom included) and placements are bit-identical.
"""

import random

import numpy as np
import pytest
import torch

import nhd_tpu.core.node as jx_node
import nhd_tpu.sim.workloads as jx_workloads
import nhd_tpu_torch.core.node as pt_node
import nhd_tpu_torch.sim.workloads as pt_workloads
from nhd_tpu.solver import BatchItem as JxItem
from nhd_tpu.solver import BatchScheduler as JxScheduler
from nhd_tpu.solver import speculate as jx_spec
from nhd_tpu.solver.device_state import DeviceClusterState as JxState
from nhd_tpu.solver.encode import encode_cluster, encode_pods
from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.solver import BatchItem as PtItem
from nhd_tpu_torch.solver import BatchScheduler as PtScheduler
from nhd_tpu_torch.solver import speculate as pt_spec
from nhd_tpu_torch.solver.device_state import DeviceClusterState as PtState
from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _MUTABLE, _pad_pow2, solve_planes
from tests.test_torch_kernel import JAX_PKG, PORT_PKG, random_cluster, random_request

G3 = ["default", "edge", "batch"]


@pytest.fixture(autouse=True)
def _spec_env(monkeypatch):
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "8")


def _wl(pkg):
    return pt_workloads if pkg is PORT_PKG else jx_workloads


def _simple(pkg, gpus=0, pci=False):
    """tests/test_batch.py's simple_request, per package."""
    R, T = pkg.request, pkg.topology
    return R.PodRequest(
        groups=(R.GroupRequest(
            proc=R.CpuRequest(4, T.SmtMode.ON), misc=R.CpuRequest(1, T.SmtMode.ON),
            gpus=gpus, nic_rx_gbps=10.0, nic_tx_gbps=5.0,
        ),),
        misc=R.CpuRequest(1, T.SmtMode.ON), hugepages_gb=2,
        map_mode=T.MapMode.PCI if pci else T.MapMode.NUMA,
    )


def _random11(pkg):
    rng = random.Random(11)
    reqs = [random_request(pkg, rng) for _ in range(60)]
    return random_cluster(pkg, rng, 12), reqs, 1010.0, False


def _mixed_caps(pkg):
    nodes = {}
    for i in range(4):
        spec = pkg.sim.SynthNodeSpec(name=f"mix{i}", nics_per_numa=2)
        node = pkg.sim.make_node(spec)
        node.nics[0].speed_gbps = node.nics[0].speed_gbps / 2  # mixed caps
        nodes[spec.name] = node
    return nodes, _wl(pkg).workload_mix(120, ["default"]), 0.0, False


def _wrap_ties(pkg):
    """More than 32 global type rows, every need equal: 20 one-group types
    (bucket rows 0-31) and 3 two-group ones (rows 32-35), 3 pods each, on
    GPU nodes, so every candidate row of a node has the key 2^24 + 3 and
    the lowest eligible row wins, across spec_elect's 32-row lane wrap."""
    R, T = pkg.request, pkg.topology

    def grp(proc):
        return R.GroupRequest(proc=R.CpuRequest(proc, T.SmtMode.ON),
                              misc=R.CpuRequest(0, T.SmtMode.ON), gpus=0,
                              nic_rx_gbps=5.0, nic_tx_gbps=2.0)

    types = [(grp(p),) for p in range(1, 21)] + [(grp(p), grp(2)) for p in (1, 2, 3)]
    reqs = [R.PodRequest(groups=g, misc=R.CpuRequest(1, T.SmtMode.ON),
                         hugepages_gb=1, map_mode=T.MapMode.NUMA)
            for g in types for _ in range(3)]
    return _wl(pkg).cap_cluster(6, G3[:1]), reqs, 0.0, False


def _seeded(seed):
    def make(pkg):
        rq = random.Random(seed + 1000)
        reqs = [random_request(pkg, rq) for _ in range(40)]
        return (random_cluster(pkg, random.Random(seed), 10), reqs, 1010.0,
                seed % 2 == 1)
    return make


#: name -> make(pkg) -> (nodes, requests, now, respect_busy)
INSTANCES = {
    "capacity": lambda pkg: (_wl(pkg).cap_cluster(32, G3),
                             _wl(pkg).workload_mix(300, G3), 0.0, False),
    "random11": _random11,
    "pci_numa": lambda pkg: (pkg.sim.make_cluster(4),
                             [_simple(pkg, 1)] * 3 + [_simple(pkg, 1, pci=True)] * 3,
                             0.0, False),
    "switch_cap": lambda pkg: (pkg.sim.make_cluster(3),
                               [_simple(pkg, 1, pci=True)] * 9, 0.0, False),
    "respect_busy": lambda pkg: (pkg.sim.make_cluster(3), [_simple(pkg, 1)] * 9,
                                 0.0, True),
    "certificate": lambda pkg: (_wl(pkg).bench_cluster(16, G3),
                                _wl(pkg).workload_mix(300, G3), 0.0, False),
    "mixed_caps": _mixed_caps,
    "wrap_ties": _wrap_ties,
    **{f"seed{s}": _seeded(s) for s in range(10)},
}


def _encode(name):
    """One instance encoded once, by the reference's encoder: both
    packages' device states start from these same arrays."""
    nodes, reqs, now, respect_busy = INSTANCES[name](JAX_PKG)
    cluster = encode_cluster(nodes, now=now)
    if not respect_busy:
        cluster.busy[:] = False
    pods = list(encode_pods(reqs, cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in pods]
    return cluster, pods, needs, respect_busy


def _megaround_both(cluster, pods, needs, respect_busy):
    ref = JxState(cluster, None)
    want = [np.asarray(x) for x in ref.megaround(pods, needs, respect_busy)]
    want_state = [np.asarray(ref._dev[n]) for n in _MUTABLE]
    port = PtState(cluster, "cpu")
    got = [t.numpy() for t in port.megaround(pods, needs, respect_busy)]
    got_state = [port._dev[n].numpy() for n in _MUTABLE]
    return (got, got_state), (want, want_state)


def _assert_identical(got, want, what):
    for g, w, label in zip(got, want, what):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert np.array_equal(g, w), label


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_megaround_matches_reference(name):
    """Claims, counts, need left and iterations used bit-identical to the
    reference's megaround on the same encoded instance, and so is the
    projected node state it leaves behind."""
    (got, got_state), (want, want_state) = _megaround_both(*_encode(name))
    _assert_identical(got, want, ("claims", "counts", "need_left", "iterations"))
    _assert_identical(got_state, want_state, _MUTABLE)
    assert int(want[3]) >= 1


@pytest.mark.parametrize("name", ["capacity", "seed3"])
def test_megaround_matches_reference_with_nic_sharing(name, monkeypatch):
    """Sharing on: the bandwidth branch of the capacity and the deltas.
    The reference reads the flag when it traces, under a cache on the
    shapes: the cache is cleared on both sides of the test."""
    monkeypatch.setattr(jx_node, "ENABLE_NIC_SHARING", True)
    monkeypatch.setattr(pt_node, "ENABLE_NIC_SHARING", True)
    jx_spec._get_megaround.cache_clear()
    try:
        (got, got_state), (want, want_state) = _megaround_both(*_encode(name))
    finally:
        jx_spec._get_megaround.cache_clear()
    _assert_identical(got, want, ("claims", "counts", "need_left", "iterations"))
    _assert_identical(got_state, want_state, _MUTABLE)
    assert (want[1] > 0).any()


@pytest.mark.parametrize("name", ["capacity", "pci_numa", "respect_busy", "seed3",
                                  "wrap_ties"])
def test_claim_kernels_match_reference_iteration_by_iteration(name, monkeypatch):
    """Each claim kernel's plain version against the reference's loop
    body, one iteration at a time (the reference run with
    NHD_TPU_SPEC_ITERS=1, call after call on its resident state):
    spec_elect's (type, c, m, a) at every node that took copies is the
    reference's claim word, spec_fill's counts and need are the
    reference's counts and need left, and spec_apply's node state and
    claim row are the reference's — exact integers, float32 exact."""
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "1")
    cluster, pods, needs, respect_busy = _encode(name)
    ref = JxState(cluster, None)
    port = PtState(cluster, "cpu")
    U, K, Np = cluster.U, cluster.K, port.Np
    pts = [port.pod_tensors(p) for p in pods]
    node = port._dev
    node_list = [node[n] for n in _ARG_ORDER]
    tabs = pt_spec.spec_tables(pods, pts, U, K, Np, torch.device("cpu"))
    off = tabs.offsets
    status = torch.from_numpy(np.concatenate([[1], *needs]).astype(np.int32))
    kw = dict(sharing=False, respect_busy=respect_busy)
    iterations = 0
    while True:
        w_claims, w_counts, w_need, w_it = (
            np.asarray(x) for x in ref.megaround(pods, needs, respect_busy))
        if int(w_it) == 0:
            break
        iterations += 1
        for b, (p, pt) in enumerate(zip(pods, pts)):
            if int(status[1 + off[b]: 1 + off[b + 1]].sum()) > 0:
                solve_planes(p.G, U, K, node_list, pt, out=tabs.views[b])
        plan = reference.spec_elect(
            tabs.planes, tabs.plane_off, tabs.trow, node["smt"], node["cpu_free"],
            node["gpu_free"], node["hp_free"], node["nic_free"], tabs.cpu_g,
            tabs.cpu_m, tabs.gpu_g, tabs.nic_occ, status, **kw)
        took = w_counts[0] > 0
        e = plan[0].clamp(min=0).long()
        word = (e * (1 << pt_spec._T_SHIFT) + (plan[3] * U + plan[4]) * tabs.trow[e, 0]
                + plan[5]).numpy()
        assert np.array_equal(word[took], w_claims[0][took]), "spec_elect"
        assert (plan[0].numpy()[took] >= 0).all()
        reference.spec_fill(plan, status)
        assert np.array_equal(plan[6].numpy(), w_counts[0]), "spec_fill counts"
        assert np.array_equal(status[1:].numpy(), w_need), "spec_fill need"
        claims = torch.full((1, Np), -1, dtype=torch.int32)
        counts = torch.zeros((1, Np), dtype=torch.int32)
        reference.spec_apply(
            plan, tabs.trow, node["smt"], node["nic_sw"], tabs.cpu_g, tabs.cpu_m,
            tabs.gpu_g, tabs.nic_occ, tabs.gpu_uk, tabs.nic_rx, tabs.nic_tx,
            node["busy"], node["hp_free"], node["cpu_free"], node["gpu_free"],
            node["nic_free"], node["gpu_free_sw"], claims, counts,
            torch.ones(1, dtype=torch.int32), **kw)
        assert np.array_equal(claims.numpy(), w_claims), "spec_apply claims"
        assert np.array_equal(counts.numpy(), w_counts), "spec_apply counts"
        for n in _MUTABLE:
            assert np.array_equal(node[n].numpy(), np.asarray(ref._dev[n])), n
        if not took.any():
            break
        needs = [w_need[off[b]: off[b + 1]] for b in range(len(pods))]
    assert iterations >= 1


def test_wrap_ties_instance_reaches_the_lane_wrap():
    """The "wrap_ties" instance, which the two tests above hold to the
    reference's megaround, reaches the election's edge: more than 32
    global type rows, and at its first iteration nodes whose largest key
    is held by a row below 32 and by one above; the lowest row wins."""
    cluster, pods, needs, respect_busy = _encode("wrap_ties")
    port = PtState(cluster, "cpu")
    pts = [port.pod_tensors(p) for p in pods]
    node = port._dev
    tabs = pt_spec.spec_tables(pods, pts, cluster.U, cluster.K, port.Np,
                               torch.device("cpu"))
    for p, pt, view in zip(pods, pts, tabs.views):
        solve_planes(p.G, cluster.U, cluster.K, [node[n] for n in _ARG_ORDER], pt,
                     out=view)
    need = torch.from_numpy(np.concatenate(needs).astype(np.int32))
    assert need.shape[0] > 32
    rows = tabs.plane_off[:, :1] + torch.arange(port.Np)[None, :]
    cand = tabs.planes[rows + tabs.plane_off[:, 1:]] != 0
    pref = tabs.planes[rows + 2 * tabs.plane_off[:, 1:]]
    elig = cand & (need > 0)[:, None]
    key = torch.where(elig, pref * (1 << 24) + need[:, None], -1)
    top = key == key.max(0).values
    wrap = elig.any(0) & top[:32].any(0) & top[32:].any(0)
    assert int(wrap.sum()) >= cluster.n_nodes // 2
    status = torch.cat([torch.ones(1, dtype=torch.int32), need])
    plan = reference.spec_elect(
        tabs.planes, tabs.plane_off, tabs.trow, node["smt"], node["cpu_free"],
        node["gpu_free"], node["hp_free"], node["nic_free"], tabs.cpu_g,
        tabs.cpu_m, tabs.gpu_g, tabs.nic_occ, status, sharing=False,
        respect_busy=respect_busy)
    first = top.int().argmax(0)
    assert torch.equal(plan[0][wrap], first[wrap].int())


def _sweep_tensors(case):
    return {k: torch.from_numpy(np.array(v, copy=True)) if isinstance(v, np.ndarray)
            else v for k, v in case.items()}


@pytest.mark.parametrize("fill", ["tie", "multi"])
def test_sweep_ties_and_consume_match_the_jax_step(fill):
    """The claim kernels' edge cases on sweep inputs, plain versions
    against a transcription, in jnp, of the reference's expressions
    (not a call into the reference: a change there does not reach this
    test): the election's key and jnp.argmax
    (nhd_tpu/solver/speculate.py:303-311) where a node's eligible rows
    tie, and the sharing-off NIC consumption (:496-501, with k * nic_occ
    at the elected (c, a), :365-369) where nodes take several copies and
    some consume more NICs than their NUMA node has free. The "wrap_ties"
    instance holds the tie to the reference's megaround itself; the
    consumption past the free NICs has no megaround instance, as the
    solve elects only picks whose NICs are free and a copy past the
    capacity is the fill's one copy at capacity 0."""
    import jax.numpy as jnp

    from nhd_tpu_torch.kernels import sweep

    rows = [(i, s) for i, s in enumerate(sweep.SPEC_SWEEP) if s[7] == fill]
    assert rows
    for i, shape in rows:
        N, U, K = shape[:3]
        case = sweep.spec_case(i, *shape)
        t = _sweep_tensors(case)
        kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
        plan = reference.spec_elect(*(t[k] for k in sweep.SPEC_ELECT_ARGS), **kw)

        off = case["plane_off"]
        at = off[:, :1] + np.arange(N)[None, :]
        cand = case["planes"][at + off[:, 1:]] != 0
        pref = case["planes"][at + 2 * off[:, 1:]]
        need = jnp.asarray(case["status"][1:])
        elig = jnp.asarray(cand) & (need > 0)[:, None]
        key = jnp.where(elig, jnp.asarray(pref) * (1 << 24)
                        + jnp.minimum(need, 1 << 20)[:, None], -1)
        elect = np.asarray(jnp.argmax(key, axis=0))
        has = np.asarray(elig.any(0))
        assert np.array_equal(plan[0].numpy(), np.where(has, elect, -1)), shape
        if fill == "tie":
            key = np.asarray(key)
            top = key == key.max(0)
            tied = has & (top.sum(0) > 1)
            assert tied.sum() > N // 4
            # across the lane wrap: a tie between a row below 32 and one above
            assert (tied & top[:32].any(0) & top[32:].any(0)).any()
            continue

        reference.spec_fill(plan, t["status"])
        k = plan[6].numpy()
        took = (plan[0].numpy() >= 0) & (k > 0)
        e = np.maximum(plan[0].numpy(), 0)
        trow = case["trow"]
        cb = np.clip(plan[3].numpy(), 0, trow[e, 1] - 1)
        ab = np.clip(plan[5].numpy(), 0, trow[e, 0] - 1)
        occ = case["nic_occ"][e, cb * trow[e, 0] + ab]                   # [N, U]
        nic_consume = jnp.asarray(np.where(took, k, 0).astype(np.float32))[:, None] * occ
        nic_free = jnp.asarray(case["nic_free"])
        unocc = nic_free[..., 0] > 0
        used = unocc & (jnp.cumsum(unocc.astype(jnp.int32), axis=2)
                        <= nic_consume[..., None])
        want = np.asarray(jnp.where(used[..., None], 0.0, nic_free))
        reference.spec_apply(plan, *(t[k] for k in sweep.SPEC_APPLY_ARGS), **kw)
        assert np.array_equal(t["nic_free"].numpy(), want), shape
        free = np.asarray(unocc.sum(2))
        assert (k[took] > 1).any()
        assert (took[:, None] & (np.asarray(nic_consume) > free)).any()
        assert (took[:, None] & (np.asarray(nic_consume) > 0)
                & (np.asarray(nic_consume) < free)).any()


def test_pack_roundtrip():
    """decode_claims inverts the claim word, per bucket (the example of
    tests/test_speculate.py), and both packages decode random words, with
    their copy counts, alike."""
    U, K = 2, 3
    shapes = ((1, 8), (2, 8))
    keys = (1, 2)
    a1 = pt_spec.get_tables(1, U, K).A
    a2 = pt_spec.get_tables(2, U, K).A
    claims = np.full((2, 4), -1, np.int32)
    claims[0, 1] = 2 * (1 << pt_spec._T_SHIFT) + (1 * U + 0) * a1 + 2
    claims[1, 3] = (8 + 1) * (1 << pt_spec._T_SHIFT) + (3 * U + 1) * a2 + 5
    out = pt_spec.decode_claims(claims, shapes, keys, U, K)
    assert out[1] == {2: [(1, 1, 0, 2)]}
    assert out[2] == {1: [(3, 3, 1, 5)]}

    rng = np.random.default_rng(5)
    iters, N = 6, 40
    t = rng.integers(0, 16, (iters, N))
    A = np.where(t < 8, a1, a2)
    C = np.where(t < 8, pt_spec.get_tables(1, U, K).C, pt_spec.get_tables(2, U, K).C)
    words = (t * (1 << pt_spec._T_SHIFT)
             + (rng.integers(0, C) * U + rng.integers(0, U, (iters, N))) * A
             + rng.integers(0, A))
    words = np.where(rng.random((iters, N)) < 0.4, words, -1).astype(np.int32)
    counts = np.where(words >= 0, rng.integers(1, 4, (iters, N)), 0).astype(np.int32)
    assert pt_spec._T_SHIFT == jx_spec._T_SHIFT
    assert (pt_spec.decode_claims(words, shapes, keys, U, K, counts)
            == jx_spec.decode_claims(words, shapes, keys, U, K, counts))


def _fingerprint(results, stats):
    return [
        (r.key, r.node, None if r.mapping is None else dict(r.mapping),
         tuple(r.nic_list or ()), r.round_no, r.failed)
        for r in results
    ], stats.rounds, stats.scheduled, stats.failed


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("name", ["capacity", "random11", "pci_numa", "switch_cap",
                                  "respect_busy", "certificate", "mixed_caps",
                                  "seed1", "seed4"])
def test_schedule_matches_reference(name, pipeline, monkeypatch):
    """BatchScheduler.schedule with the speculative round 0: every pod on
    the same node, with the same mapping, NICs and round, the same round
    count, and the saturation certificate where the reference gives it."""
    monkeypatch.setenv("NHD_PIPELINE", pipeline)
    out = []
    for pkg, sched, item in (
        (PORT_PKG, lambda rb: PtScheduler(device="cpu", respect_busy=rb,
                                          register_pods=False), PtItem),
        (JAX_PKG, lambda rb: JxScheduler(device_state=True, mesh=None, respect_busy=rb,
                                         register_pods=False), JxItem),
    ):
        nodes, reqs, now, respect_busy = INSTANCES[name](pkg)
        items = [item(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
        results, stats = sched(respect_busy).schedule(nodes, items, now=now)
        out.append((_fingerprint(results, stats),
                    stats.counters.get("certified_unschedulable", 0),
                    stats.counters.get("claims_r0", 0)))
    assert out[0] == out[1]
    assert out[0][2] > 0  # round 0 claimed: the megaround ran


# ---------------------------------------------------------------------------
# the megaround on a node mesh (tests/test_speculate.py:174): the shards'
# plans join for one balanced fill; claims, counts, need left, iterations
# and node state bit-identical to one device and to the reference
# ---------------------------------------------------------------------------


def _mesh(n):
    from nhd_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(["cpu"] * n)


_REF_MEGAROUND = {}


def _reference_megaround(name):
    """(instance, the reference's megaround and node state), once per
    instance for the mesh cases below."""
    if name not in _REF_MEGAROUND:
        inst = _encode(name)
        ref = JxState(inst[0], None)
        want = [np.asarray(x) for x in ref.megaround(*inst[1:])]
        _REF_MEGAROUND[name] = inst, want, [np.asarray(ref._dev[n]) for n in _MUTABLE]
    return _REF_MEGAROUND[name]


#: (instance, shard count) of the mesh cases
MESH_CASES = [
    (name, shards)
    for name in ("capacity", "random11", "pci_numa", "respect_busy", "wrap_ties",
                 "seed3", "seed4")
    for shards in ((8,) if name in ("capacity", "random11") else (2, 3, 8))
]


@pytest.mark.parametrize("name,shards", MESH_CASES)
def test_megaround_on_a_mesh_matches_reference(name, shards):
    (cluster, pods, needs, respect_busy), want, want_state = _reference_megaround(name)
    port = PtState(cluster, "cpu", _mesh(shards))
    assert port.mesh is not None and len(port.shards) == shards
    got = [t.numpy() for t in port.megaround(pods, needs, respect_busy)]
    N = cluster.n_nodes
    # three shards pad the node axis further: the padded columns claim
    # nothing, and the rest are the reference's
    for g, w, label in zip(got[:2], want[:2], ("claims", "counts")):
        assert g.dtype == w.dtype and g.shape[0] == w.shape[0], label
        assert np.array_equal(g[:, :N], w[:, :N]), label
        assert (g[:, N:] == (-1 if label == "claims" else 0)).all(), label
    _assert_identical(got[2:], want[2:], ("need_left", "iterations"))
    got_state = [port.resident(n).numpy()[:N] for n in _MUTABLE]
    _assert_identical(got_state, [w[:N] for w in want_state], _MUTABLE)


@pytest.mark.parametrize("name,shards", MESH_CASES)
def test_mesh_graph_equals_its_host_loop(name, shards):
    """The mesh's megaround (CPU shards: one device, so one graph over
    the shards, ``pt_spec.GRAPHS``) against the mesh's host loop
    (``run_megaround_shards``) from the same state: claims and counts at
    every column, padding included, need left, iterations and every
    shard's node state, bit for bit."""
    (cluster, pods, needs, respect_busy), _want, _state = _reference_megaround(name)
    pt_spec.GRAPHS.clear()
    graph, loop = PtState(cluster, "cpu", _mesh(shards)), PtState(cluster, "cpu", _mesh(shards))
    got = [t.numpy() for t in graph.megaround(pods, needs, respect_busy)]
    (entry,) = pt_spec.GRAPHS.entries()
    assert len(entry.shards) == shards
    uploads = [loop.shard_pod_tensors(p) for p in pods]
    want = [t.numpy() for t in pt_spec.run_megaround_shards(
        loop.shards, pods, [[pt[s] for pt in uploads] for s in range(shards)], needs,
        cluster.U, cluster.K, pt_spec.spec_iters(), respect_busy)]
    _assert_identical(got, want, ("claims", "counts", "need_left", "iterations"))
    for s in range(shards):
        _assert_identical([graph.shards[s][n].numpy() for n in _MUTABLE],
                          [loop.shards[s][n].numpy() for n in _MUTABLE], _MUTABLE)


def test_speculative_mesh_equals_single_device():
    """The megaround over the 8-shard mesh, through BatchScheduler, places
    every pod as the single-device speculative run and as the reference's
    mesh ("auto": the conftest's 8 virtual devices)."""
    outs = {}
    for label, pkg, make in (
        ("mesh", PORT_PKG, lambda: PtScheduler(
            device="cpu", respect_busy=False, register_pods=False, mesh=_mesh(8))),
        ("single", PORT_PKG, lambda: PtScheduler(
            device="cpu", respect_busy=False, register_pods=False, mesh=None)),
        ("jax mesh", JAX_PKG, lambda: JxScheduler(
            respect_busy=False, register_pods=False, device_state=True, mesh="auto")),
    ):
        item = PtItem if pkg is PORT_PKG else JxItem
        reqs = _wl(pkg).workload_mix(200, G3)
        nodes = _wl(pkg).cap_cluster(16, G3)
        results, stats = make().schedule(
            nodes, [item(("ns", f"p{i}"), r) for i, r in enumerate(reqs)], now=0.0)
        outs[label] = (
            [(r.node, None if r.mapping is None else dict(r.mapping), r.round_no)
             for r in results],
            stats.scheduled,
        )
    assert outs["mesh"] == outs["single"] == outs["jax mesh"]
    assert outs["mesh"][1] == sum(1 for n, _, _ in outs["mesh"][0] if n) > 0
