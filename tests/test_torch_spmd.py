"""The mesh-sharded production path of the port against one device and
against the JAX package's mesh (tests/test_spmd.py, and the three legs of
``__graft_entry__.dryrun_multichip``).

The port's mesh is 8 shards on the CPU device (``make_mesh(["cpu"] * 8)``,
every kernel its plain PyTorch version); the reference's is the 8 virtual
CPU devices of tests/conftest.py. Each case runs both packages on the
same inputs, built from the same seed with each package's own generator
(or, for the device-state cases, the same arrays from the reference's
encoder):

* resident mesh solves equal the single-device rank and the reference's
  mesh on every val > 0 slot (ties at val 0 may order differently);
* per-shard row updates pay O(changed rows) with zero wholesale uploads,
  the ``mesh_*`` and ``device_state_*`` counters moving as the
  reference's do, and the shards equal the padded host mirror;
* mesh-qualified kernel-cache keys record, prewarm and stay flat;
* BatchScheduler placements and mappings equal one device's and the
  reference's, with ``NHD_TPU_SPECULATE`` and ``NHD_PIPELINE`` set alike
  on both sides.

Integer decisions throughout: every tolerance is exact equality.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import random

import numpy as np
import pytest

from nhd_tpu.k8s.retry import API_COUNTERS as JX_COUNTERS
from nhd_tpu.solver.device_state import DeviceClusterState as JxState
from nhd_tpu.solver.encode import encode_cluster as jx_encode_cluster
from nhd_tpu.solver.encode import encode_pods as jx_encode_pods
from nhd_tpu_torch.k8s.retry import API_COUNTERS as PT_COUNTERS
from nhd_tpu_torch.solver.device_state import DeviceClusterState as PtState
from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _pad_rows_to, solve_bucket_ranked
from tests.test_torch_kernel import JAX_PKG, PORT_PKG, random_cluster, random_request
from tests.test_torch_sharding import assert_live_equal, cpu_mesh, jax_mesh

COUNTERS = ("device_state_rows_uploaded_total", "mesh_rows_uploaded_total",
            "mesh_wholesale_uploads_total")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Both packages' knobs alike: no speculation or pipelining unless a
    case turns them on, and the reference keeps resident state."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")


def _instance(n_nodes, seed, n_reqs):
    """(JAX-encoded cluster, sorted [(G, pods)]) from the shared generator."""
    rng = random.Random(seed)
    nodes = random_cluster(JAX_PKG, rng, n_nodes)
    reqs = [random_request(JAX_PKG, rng) for _ in range(n_reqs)]
    cluster = jx_encode_cluster(nodes, now=1010.0)
    return cluster, sorted(jx_encode_pods(reqs, cluster.interner).items())


def _moved(counters, before):
    now = counters.snapshot()
    return {k: now.get(k, 0) - before.get(k, 0) for k in COUNTERS}


def _assert_resident(dev, cluster):
    for name in _ARG_ORDER:
        want = _pad_rows_to(getattr(cluster, name), dev.Np)
        np.testing.assert_array_equal(dev.resident(name).numpy(), want,
                                      err_msg=name)


@pytest.mark.parametrize("seed,n_nodes", [(0, 8), (1, 13), (2, 21)])
def test_device_state_mesh_solve_ranked_bit_exact(seed, n_nodes):
    """Resident mesh solves, even and uneven node splits: equal to the
    port's single device and to the reference's mesh."""
    cluster, buckets = _instance(n_nodes, seed, 8)
    port = PtState(cluster, "cpu", cpu_mesh())
    assert port.mesh is not None and len(port.shards) == 8
    assert port.Np == JxState(cluster, jax_mesh()).Np
    ref = JxState(cluster, jax_mesh())
    for G, pods in buckets:
        got = port.solve_ranked(pods, 16).numpy()
        assert_live_equal(got, solve_bucket_ranked(cluster, pods, 16, device="cpu"),
                          f"G={G} vs one device")
        assert_live_equal(got, np.asarray(ref.solve_ranked(pods, 16)),
                          f"G={G} vs the reference's mesh")


def test_mesh_respect_busy_split_parity():
    """Busy-marked rows survive the shard boundary."""
    cluster, buckets = _instance(12, 3, 6)
    cluster.busy[::3] = True
    port = PtState(cluster, "cpu", cpu_mesh())
    ref = JxState(cluster, jax_mesh())
    for G, pods in buckets:
        got = port.solve_ranked(pods, 8).numpy()
        assert_live_equal(got, solve_bucket_ranked(cluster, pods, 8, device="cpu"))
        assert_live_equal(got, np.asarray(ref.solve_ranked(pods, 8)))


def test_mesh_scatter_rows_o_changed_rows_and_bit_exact():
    """Churn rows reach the shards as per-shard row updates: the counters
    tick O(changed rows) exactly as the reference's, no wholesale
    upload, and every shard equals the padded host mirror."""
    cluster, _ = _instance(11, 5, 1)
    port = PtState(cluster, "cpu", cpu_mesh())
    ref = JxState(cluster, jax_mesh())
    # churn-shaped host mutations across several shards
    cluster.active[1] = False
    cluster.maintenance[4] = True
    cluster.cpu_free[7] = 0
    cluster.hp_free[9] = 0
    rows = np.asarray([1, 4, 7, 9], np.int64)
    c_pt, c_jx = PT_COUNTERS.snapshot(), JX_COUNTERS.snapshot()
    port.scatter_rows(rows)
    ref.scatter_rows(rows)
    moved = _moved(PT_COUNTERS, c_pt)
    assert moved == _moved(JX_COUNTERS, c_jx)
    assert moved == {"device_state_rows_uploaded_total": 4,
                     "mesh_rows_uploaded_total": 4,
                     "mesh_wholesale_uploads_total": 0}
    _assert_resident(port, cluster)


def test_mesh_staged_claims_scatter_matches_wholesale():
    """Staged in-batch claims take the per-shard row update on a mesh and
    the next solve sees exactly the host-mirror truth: the same answer as
    a wholesale re-upload of the same state."""
    cluster, buckets = _instance(10, 7, 5)
    delta = PtState(cluster, "cpu", cpu_mesh())
    cluster.busy[2] = True
    cluster.gpu_free[6] = 0
    delta.stage_rows([2, 6])
    wholesale = PtState(cluster, "cpu", cpu_mesh())
    ref = JxState(cluster, jax_mesh())
    for G, pods in buckets:
        got = delta.solve_ranked(pods, 8).numpy()
        assert_live_equal(got, wholesale.solve_ranked(pods, 8).numpy(), f"G={G}")
        assert_live_equal(got, np.asarray(ref.solve_ranked(pods, 8)), f"G={G}")
    _assert_resident(delta, cluster)


def _scheduler(pkg, mesh, **kw):
    if pkg is PORT_PKG:
        from nhd_tpu_torch.solver.batch import BatchItem, BatchScheduler

        return BatchScheduler(device="cpu", mesh=mesh, **kw), BatchItem
    from nhd_tpu.solver.batch import BatchItem, BatchScheduler

    return BatchScheduler(device_state=True, mesh=mesh, **kw), BatchItem


def _delta_context(pkg, n_nodes, seed):
    """A delta-built mesh ScheduleContext over a live node dict."""
    rng = random.Random(seed)
    nodes = random_cluster(pkg, rng, n_nodes)
    port = pkg is PORT_PKG
    sched, item = _scheduler(pkg, cpu_mesh() if port else jax_mesh(),
                             respect_busy=False, register_pods=False)
    encode = importlib.import_module(
        f"{'nhd_tpu_torch' if port else 'nhd_tpu'}.solver.encode")
    delta = encode.ClusterDelta(nodes, now=0.0, respect_busy=False)
    ctx = sched.make_context(nodes, now=0.0, delta=delta)
    assert ctx.dev is not None and ctx.dev.mesh is not None
    return nodes, sched, item, delta, ctx, rng


def test_delta_context_churn_on_mesh_pays_changed_rows():
    """refresh_context over a delta-built mesh context: noted churn
    reaches the shards as row updates, the counters move as the
    reference's, and the delta parity invariant holds."""
    out = {}
    for pkg, counters in ((PORT_PKG, PT_COUNTERS), (JAX_PKG, JX_COUNTERS)):
        nodes, sched, item, delta, ctx, rng = _delta_context(pkg, 12, 9)
        items = [item(("ns", f"p{i}"), random_request(pkg, rng)) for i in range(6)]
        results, _ = sched.schedule(ctx.nodes, items, context=ctx)
        names = list(nodes)
        nodes[names[0]].active = not nodes[names[0]].active
        nodes[names[5]].maintenance = True
        delta.note(names[0])
        delta.note(names[5])
        before = counters.snapshot()
        sched.refresh_context(ctx, now=0.0)
        moved = _moved(counters, before)
        assert 0 < moved["device_state_rows_uploaded_total"] <= 4, moved
        assert moved["mesh_wholesale_uploads_total"] == 0
        assert delta.parity_errors() == []
        out[pkg.sim.__name__] = (moved, [r.node for r in results])
        if pkg is PORT_PKG:
            _assert_resident(ctx.dev, ctx.cluster)
    assert out["nhd_tpu_torch.sim"] == out["nhd_tpu.sim"]


def _rederived(ctx):
    """After a structural fallback: parity holds, the shards equal the
    padded host mirror, and a mesh solve agrees with a from-scratch
    encode of the live dict on the number of candidates per type."""
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    assert ctx.delta.parity_errors() == []
    _assert_resident(ctx.dev, ctx.cluster)
    live = {n: ctx.delta.nodes[n] for n in ctx.delta.nodes}
    fresh = encode_cluster(live, now=0.0)
    fresh.busy[:] = False
    reqs = [random_request(PORT_PKG, random.Random(11)) for _ in range(4)]
    for G, pods in sorted(encode_pods(reqs, fresh.interner).items()):
        got = ctx.dev.solve_ranked(
            encode_pods(pods.requests, ctx.cluster.interner)[G], 8).numpy()
        want = solve_bucket_ranked(fresh, pods, 8, device="cpu").numpy()
        R = min(got.shape[2], want.shape[2])
        np.testing.assert_array_equal((got[0, :, :R] > 0).sum(1),
                                      (want[0, :, :R] > 0).sum(1))


def test_mesh_delta_tombstone_readd_rebuilds_and_stays_bit_exact():
    """A removed node re-added under the same name while its tombstone
    holds a mid-array slot forces the tombstone-readd rebuild; the mesh
    context re-derives exactly."""
    from nhd_tpu_torch.solver.encode import rebuild_reasons_snapshot

    nodes, sched, _, delta, ctx, _ = _delta_context(PORT_PKG, 12, 11)
    victim = list(nodes)[3]
    node_obj = nodes.pop(victim)
    delta.note(victim)
    sched.refresh_context(ctx, now=0.0)
    assert victim in delta._tombstones and ctx.dev.mesh is not None
    r0 = rebuild_reasons_snapshot().get("tombstone-readd", 0)
    node_obj.active = True
    nodes[victim] = node_obj
    delta.note(victim)
    sched.refresh_context(ctx, now=0.0)
    assert rebuild_reasons_snapshot().get("tombstone-readd", 0) == r0 + 1
    assert ctx.dev is not None and ctx.dev.mesh is not None
    _rederived(ctx)


def test_mesh_delta_compaction_rebuilds_and_stays_bit_exact():
    """Tombstones past the occupancy threshold compact: the mesh context
    re-derives wholesale (fresh capacity, fresh shard layout) exactly."""
    from nhd_tpu_torch.solver.encode import rebuild_reasons_snapshot

    nodes, sched, _, delta, ctx, _ = _delta_context(PORT_PKG, 16, 13)
    r0 = rebuild_reasons_snapshot().get("compaction", 0)
    for victim in list(nodes)[2:8]:
        nodes.pop(victim)
        delta.note(victim)
    sched.refresh_context(ctx, now=0.0)
    assert rebuild_reasons_snapshot().get("compaction", 0) == r0 + 1
    assert delta._tombstones == set()
    assert ctx.dev is not None and ctx.dev.mesh is not None
    _rederived(ctx)


# ---------------------------------------------------------------------------
# the kernel cache's mesh-qualified keys (solver/aot.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def aot_dir(tmp_path):
    from nhd_tpu_torch.solver import aot

    aot.reset()
    aot.configure(directory=str(tmp_path), save=True)
    yield tmp_path
    aot.reset()


def test_mesh_aot_export_prewarm_compiles_flat(aot_dir):
    """Mesh dispatches record under mesh-qualified keys, prewarm back over
    the caller's mesh, and the next mesh dispatch finds every key warm,
    serving identical results."""
    from nhd_tpu_torch.obs.jitstats import JIT_STATS
    from nhd_tpu_torch.solver import aot

    cluster, buckets = _instance(9, 11, 6)
    dev = PtState(cluster, "cpu", cpu_mesh())
    outs = {G: dev.solve_ranked(pods, 8).numpy() for G, pods in buckets}
    aot.AOT.drain()
    mesh_keys = [f for f in os.listdir(aot_dir)
                 if f.endswith(".json") and "_mnodes8" in f]
    assert mesh_keys, sorted(os.listdir(aot_dir))

    JIT_STATS.reset()
    aot.reset()
    aot.configure(directory=str(aot_dir), save=False)
    summary = aot.prewarm(device="cpu", mesh=cpu_mesh())
    assert summary["quarantined"] == 0 and summary["skipped"] == 0
    assert any("_mnodes8" in k for k in summary["keys"]), summary
    warm = JIT_STATS.snapshot()
    dev2 = PtState(cluster, "cpu", cpu_mesh())
    for G, pods in buckets:
        np.testing.assert_array_equal(dev2.solve_ranked(pods, 8).numpy(), outs[G])
    escaped = sorted(k for k in JIT_STATS.snapshot()["shapes"]
                     if k.startswith("solve_ranked:") and k not in warm["shapes"])
    assert escaped == []


def test_mesh_prewarm_skips_oversized_mesh_artifacts(aot_dir):
    """A key recorded on a BIGGER mesh than this host can build (64
    shards; and 8 shards without a caller's mesh, since the CPU is one
    device) is skipped — neither warmed nor quarantined — and stays for
    the host that can run it."""
    from nhd_tpu_torch.solver import aot

    for desc in ("nodes64", "nodes8"):
        meta = {
            "aot_schema": aot.AOT_SCHEMA_VERSION, "kind": "ranked",
            "key": f"G1_U2_K2_R8_T8_N64_M{desc}",
            "fingerprint": aot.program_fingerprint(),
            "spec": {"G": 1, "U": 2, "K": 2, "R": 8, "Tp": 8, "Np": 64,
                     "mesh": desc, "node": [], "pod": []},
        }
        key = aot.ShapeKey("ranked", meta["key"])
        (aot_dir / f"{key.name()}.json").write_text(json.dumps(meta))
    aot.configure(save=False)
    summary = aot.prewarm(device="cpu")
    assert (summary["loaded"], summary["quarantined"], summary["skipped"]) == (0, 0, 2)
    assert len(list(aot_dir.glob("*_mnodes*.json"))) == 2


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip: the full batch over the mesh, three legs
# ---------------------------------------------------------------------------


def _dryrun_items(pkg, n_devices):
    """dryrun_multichip's mixed batch: 1-group NUMA with a NIC, 1-group
    PCI, 2-group NUMA and a CPU-only gang."""
    R, T = pkg.request, pkg.topology

    def group(proc=4, gpus=0, rx=0.0, tx=0.0):
        return R.GroupRequest(proc=R.CpuRequest(proc, T.SmtMode.ON),
                              misc=R.CpuRequest(1, T.SmtMode.ON), gpus=gpus,
                              nic_rx_gbps=rx, nic_tx_gbps=tx)

    def pod(groups, map_mode=T.MapMode.NUMA, hp=2):
        return R.PodRequest(groups=tuple(groups), misc=R.CpuRequest(1, T.SmtMode.ON),
                            hugepages_gb=hp, map_mode=map_mode)

    reqs = []
    for _ in range(2 * n_devices):
        reqs.extend([
            pod([group(4, gpus=1, rx=10.0, tx=5.0)]),
            pod([group(4, gpus=1, rx=10.0, tx=5.0)], map_mode=T.MapMode.PCI),
            pod([group(3, rx=5.0, tx=5.0), group(2, gpus=1)]),
            pod([group(2)], hp=0),
        ])
    return reqs


def _dryrun_leg(pkg, mesh, n_nodes, respect_busy):
    sched, item = _scheduler(pkg, mesh, respect_busy=respect_busy)
    base = pkg.sim.make_cluster(
        n_nodes, pkg.sim.SynthNodeSpec(phys_cores=24, gpus_per_numa=2))
    nodes = copy.deepcopy(base)
    items = [item(("ns", f"pod{i}"), r) for i, r in enumerate(_dryrun_items(pkg, 8))]
    results, stats = sched.schedule(nodes, items, now=0.0)
    return ([r.node for r in results],
            [None if r.mapping is None else dict(r.mapping) for r in results],
            stats.scheduled, stats.rounds)


@pytest.mark.parametrize("leg,n_nodes,respect_busy,speculate", [
    ("even", 16, False, "0"), ("even", 16, False, "1"),
    ("uneven", 13, False, "0"), ("respect_busy", 17, True, "0"),
])
def test_dryrun_multichip_legs(leg, n_nodes, respect_busy, speculate, monkeypatch):
    """Each leg places every pod of the mixed batch as one device does and
    as the reference's mesh does: same nodes, same mappings."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", speculate)
    mesh = _dryrun_leg(PORT_PKG, cpu_mesh(), n_nodes, respect_busy)
    assert mesh[2] > 0, f"{leg}: nothing placed"
    assert mesh == _dryrun_leg(PORT_PKG, None, n_nodes, respect_busy)
    assert mesh == _dryrun_leg(JAX_PKG, jax_mesh(), n_nodes, respect_busy)
    if leg == "even" and speculate == "0":
        assert mesh[3] >= 2, "the mixed batch should need several rounds"
