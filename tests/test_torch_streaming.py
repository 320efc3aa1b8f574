"""The port's streaming tiler (nhd_tpu_torch/solver/streaming.py) against
the JAX tiler (nhd_tpu/solver/streaming.py).

Each case of tests/test_streaming.py runs as one script through both
packages, at the sizes it uses there, each package building its own
nodes and requests from the same seed with its own ``sim``: the
reference on the JAX CPU backend (no mesh) and the port with
``device="cpu"``, where every kernel is its plain PyTorch version. Where
the reference case asserts a property (the first-fit prefix,
conservation, a ``ValueError``), the script asserts it on the port too.
Both runs must then agree exactly — placements are integers, so the
tolerance is "exact": every pod's node, mapping, NIC list, round and
failure flag, ``stats.scheduled``, and each node's free cores per NUMA
node, free GPUs and free hugepages.

Three more groups of cases: ``BatchScheduler.schedule(encoded=,
offer=)`` on its own (one chunk encoded once, offered in three subsets
through one persistent context), a cfg5-shaped federation at small depth
(5 groups, 120 cap_cluster nodes in tiles of 40, 1,200 workload_mix
pods; first-fit, routed, and a persistent run with node churn), and the
port's daemon past ``NHD_STREAM_NODES`` (tests/test_torch_daemon.py).

Every parity case runs one tile worker on both sides
(``NHD_STREAM_WORKERS=1``): the reference's threaded tiler is timing-
sensitive under load (ROADMAP Queue 3). One port-only case holds three
workers equal to one. No case sleeps or waits on a timeout.

tests/test_streaming.py's mesh case (:152) runs the tiler over the
port's 8 CPU shards and the reference's 8 virtual devices, each against
its own single-device run.
"""

from __future__ import annotations

import copy
import importlib
import os
import random
from dataclasses import replace
from types import SimpleNamespace

import pytest

PACKAGES = ("nhd_tpu", "nhd_tpu_torch")
FED_GROUPS = ["default", "edge", "batch", "fed1", "fed2"]


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    solver = mod("solver")
    port = root == "nhd_tpu_torch"

    def kw(extra):
        if port:
            return {"device": "cpu", **extra}
        # the reference's resident state carries its megaround; the mesh
        # case is not ported, so both sides solve on one device
        spec = os.environ.get("NHD_TPU_SPECULATE") == "1"
        return {"mesh": None, "device_state": spec, **extra}

    return SimpleNamespace(
        root=root, port=port, sim=mod("sim"), synth=mod("sim.synth"),
        workloads=mod("sim.workloads"), request=mod("core.request"),
        topology=mod("core.topology"), kernel=mod("solver.kernel"),
        batch_mod=mod("solver.batch"), encode=mod("solver.encode"),
        BatchItem=solver.BatchItem,
        Streaming=lambda **k: mod("solver.streaming").StreamingScheduler(**kw(k)),
        Batch=lambda **k: solver.BatchScheduler(**kw(k)),
    )


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NHD_STREAM_WORKERS", "1")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")


# ---------------------------------------------------------------------------
# each package's inputs, from the generators of tests/test_batch.py and
# tests/test_jax_matcher.py (same draws in the same order)
# ---------------------------------------------------------------------------


def simple_request(pkg, gpus=0, rx=10.0, proc=4):
    R, T = pkg.request, pkg.topology
    return R.PodRequest(
        groups=(R.GroupRequest(
            proc=R.CpuRequest(proc, T.SmtMode.ON),
            misc=R.CpuRequest(1, T.SmtMode.ON),
            gpus=gpus, nic_rx_gbps=rx, nic_tx_gbps=5.0,
        ),),
        misc=R.CpuRequest(1, T.SmtMode.ON),
        hugepages_gb=2,
        map_mode=T.MapMode.NUMA,
    )


def items(pkg, reqs):
    return [pkg.BatchItem(("ns", f"pod{i}"), r) for i, r in enumerate(reqs)]


def random_cluster(pkg, rng: random.Random, n_nodes: int):
    nodes = {}
    for i in range(n_nodes):
        spec = pkg.sim.SynthNodeSpec(
            name=f"node{i:03d}", sockets=2,
            phys_cores=rng.choice([8, 12, 16]),
            smt=rng.random() < 0.7,
            reserved_cores=rng.choice([0, 2]),
            nics_per_numa=rng.choice([1, 2, 3]),
            nic_speed_mbps=rng.choice([25000, 100000]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            hugepages_gb=rng.choice([16, 64]),
            groups=rng.choice(["default", "default.edge", "edge"]),
        )
        node = pkg.sim.make_node(spec)
        for core in node.cores:
            if rng.random() < 0.2:
                core.used = True
        for gpu in node.gpus:
            if rng.random() < 0.3:
                gpu.used = True
        for nic in node.nics:
            if rng.random() < 0.2:
                nic.pods_used = 1
        node.mem.free_hugepages_gb -= rng.choice([0, 0, 8])
        if rng.random() < 0.1:
            node.maintenance = True
        if rng.random() < 0.1:
            node.active = False
        if rng.random() < 0.2:
            node.set_busy(now=1000.0)
        nodes[node.name] = node
    return nodes


def random_request(pkg, rng: random.Random):
    R, T = pkg.request, pkg.topology
    n_groups = rng.choice([1, 1, 2, 3])

    def group():
        rx = rng.choice([0.0, 5.0, 20.0, 80.0])
        tx = rng.choice([0.0, 5.0, 20.0])
        proc_min = 2 if (rx or tx) else 1
        return R.GroupRequest(
            proc=R.CpuRequest(rng.randint(proc_min, 6), rng.choice(list(T.SmtMode))),
            misc=R.CpuRequest(rng.randint(0, 2), rng.choice(list(T.SmtMode))),
            gpus=rng.choice([0, 0, 1, 2]),
            nic_rx_gbps=rx, nic_tx_gbps=tx,
        )

    groups = tuple(group() for _ in range(n_groups))
    return R.PodRequest(
        groups=groups,
        misc=R.CpuRequest(rng.randint(0, 3), rng.choice(list(T.SmtMode))),
        hugepages_gb=rng.choice([0, 4, 16]),
        map_mode=rng.choice([T.MapMode.NUMA, T.MapMode.NUMA, T.MapMode.PCI]),
        node_groups=frozenset(rng.choice([["default"], ["edge"], ["default", "edge"]])),
    )


def _free_state(nodes):
    return sorted(
        (name, tuple(n.free_cpu_cores_per_numa()), n.free_gpu_count(),
         n.mem.free_hugepages_gb)
        for name, n in nodes.items()
    )


def _placements(results):
    return [
        (r.key, r.node, None if r.mapping is None else dict(r.mapping),
         tuple(r.nic_list or ()), r.round_no, r.failed)
        for r in results
    ]


def _obs(results, stats, nodes):
    """What both tilers must agree on after one schedule."""
    return {"placements": _placements(results), "scheduled": stats.scheduled,
            "free": _free_state(nodes)}


def _both(script, monkeypatch):
    got = {}
    for root in PACKAGES:
        with monkeypatch.context() as mp:
            got[root] = script(_pkg(root), mp)
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]
    return got["nhd_tpu_torch"]


# ---------------------------------------------------------------------------
# the cases of tests/test_streaming.py, one script each
# ---------------------------------------------------------------------------


def s_single_tile_single_chunk_equals_batch(pkg, mp):
    reqs = [simple_request(pkg, gpus=i % 2) for i in range(30)]
    nodes_s = pkg.sim.make_cluster(4)
    nodes_b = copy.deepcopy(nodes_s)
    rs, ss = pkg.Streaming(respect_busy=False).schedule(
        nodes_s, items(pkg, reqs), now=0.0)
    rb, sb = pkg.Batch(respect_busy=False).schedule(
        nodes_b, items(pkg, reqs), now=0.0)
    assert [r.node for r in rs] == [r.node for r in rb]
    assert [r.mapping for r in rs] == [r.mapping for r in rb]
    assert ss.scheduled == sb.scheduled
    assert _free_state(nodes_s) == _free_state(nodes_b)
    return _obs(rs, ss, nodes_s), _obs(rb, sb, nodes_b)


def _tiled_first_fit(tile, chunk):
    def script(pkg, mp):
        reqs = [simple_request(pkg, gpus=i % 2) for i in range(24)]
        nodes = pkg.sim.make_cluster(6)
        results, stats = pkg.Streaming(
            tile_nodes=tile, chunk_pods=chunk, respect_busy=False,
        ).schedule(nodes, items(pkg, reqs), now=0.0)
        placed = [r.node for r in results if r.node]
        assert len(placed) == 24 and stats.scheduled == 24
        used = sorted(set(placed))
        assert used == sorted(nodes.keys())[: len(used)]
        assert stats.bind_latency_percentile(results, 99) >= 0.0
        return _obs(results, stats, nodes)
    return script


def s_tiled_equals_untiled_on_homogeneous_cluster(pkg, mp):
    nodes_t = pkg.sim.make_cluster(9)
    nodes_u = copy.deepcopy(nodes_t)
    reqs = [simple_request(pkg, gpus=i % 2, proc=2 + 2 * (i % 3)) for i in range(24)]
    rt, st = pkg.Streaming(tile_nodes=3, chunk_pods=11, respect_busy=False).schedule(
        nodes_t, items(pkg, reqs), now=0.0)
    ru, su = pkg.Batch(respect_busy=False).schedule(
        nodes_u, items(pkg, reqs), now=0.0)
    assert st.scheduled == su.scheduled == 24
    used = sorted(set(r.node for r in rt))
    assert used == sorted(nodes_t.keys())[: len(used)]
    return _obs(rt, st, nodes_t), _obs(ru, su, nodes_u)


def s_tiled_heterogeneous_is_valid_and_conserving(pkg, mp):
    rng = random.Random(5)
    reqs = [random_request(pkg, rng) for _ in range(40)]
    nodes = random_cluster(pkg, rng, 9)
    capacity = {name: n.total_gpus() for name, n in nodes.items()}
    results, stats = pkg.Streaming(
        tile_nodes=3, chunk_pods=11, respect_busy=False,
    ).schedule(nodes, items(pkg, reqs), now=1010.0)
    assert stats.scheduled == sum(1 for r in results if r.node) > 0
    for name, n in nodes.items():
        assert 0 <= n.free_gpu_count() <= capacity[name]
        assert all(c >= 0 for c in n.free_cpu_cores_per_numa())
        assert n.mem.free_hugepages_gb >= 0
        for nic in n.nics:
            rx, tx = nic.free_bw()
            assert rx >= 0 and tx >= 0
    return _obs(results, stats, nodes)


def s_saturation_marks_unschedulable(pkg, mp):
    nodes = pkg.sim.make_cluster(1, pkg.sim.SynthNodeSpec(gpus_per_numa=0))
    reqs = [simple_request(pkg, gpus=1) for _ in range(3)]
    results, stats = pkg.Streaming(
        tile_nodes=1, chunk_pods=2, respect_busy=False,
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    assert all(r.node is None for r in results)
    assert stats.scheduled == 0
    return _obs(results, stats, nodes)


def s_oversized_pods_take_serial_prepass(pkg, mp):
    R, T = pkg.request, pkg.topology
    big = R.PodRequest(
        groups=tuple(
            R.GroupRequest(R.CpuRequest(1, T.SmtMode.ON),
                           R.CpuRequest(0, T.SmtMode.OFF), 0, 0.0, 0.0)
            for _ in range(3)
        ),
        misc=R.CpuRequest(0, T.SmtMode.OFF), hugepages_gb=0,
        map_mode=T.MapMode.NUMA,
    )
    mp.setattr(pkg.kernel, "MAX_LATTICE", 4)  # the 3-group pod goes serial
    nodes = pkg.sim.make_cluster(4)
    reqs = [simple_request(pkg), big, simple_request(pkg)]
    results, stats = pkg.Streaming(
        tile_nodes=2, chunk_pods=2, respect_busy=False,
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    assert all(r.node for r in results)
    assert stats.scheduled == 3
    return _obs(results, stats, nodes)


def s_many_groups_fall_back_to_per_tile_interners(pkg, mp):
    n_groups = 60
    group_names = [f"region{i:02d}" for i in range(n_groups)]
    nodes = pkg.sim.make_cluster(n_groups, groups=group_names)
    reqs = [
        replace(simple_request(pkg, gpus=i % 2),
                node_groups=frozenset({group_names[i % n_groups]}))
        for i in range(n_groups)
    ]
    results, stats = pkg.Streaming(
        tile_nodes=16, chunk_pods=25, respect_busy=False,
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    assert len([r for r in results if r.node]) == n_groups
    for r, req in zip(results, reqs):
        assert set(nodes[r.node].groups) & req.node_groups
    return _obs(results, stats, nodes)


def s_round_cap_does_not_certify_exhaustion(pkg, mp):
    cls = pkg.batch_mod.BatchScheduler
    orig = cls._capacity_at
    mp.setattr(cls, "_capacity_at",
               lambda self, pods, rank: orig(self, pods, rank) * 4)
    nodes = pkg.sim.make_cluster(2)
    reqs = [simple_request(pkg, gpus=1) for _ in range(16)]
    results, stats = pkg.Streaming(
        tile_nodes=2, chunk_pods=8, respect_busy=False, max_rounds=1,
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    placed = [r.node for r in results if r.node]
    assert len(placed) == 4
    assert all(n == sorted(nodes)[0] for n in placed)
    return _obs(results, stats, nodes)


def s_bucket_cache_pins_requests_list(pkg, mp):
    nodes = pkg.sim.make_cluster(2)
    sched = pkg.Batch(respect_busy=False)
    ctx = sched.make_context(nodes, now=0.0)
    results, stats = sched.schedule(
        nodes, items(pkg, [simple_request(pkg) for _ in range(3)]), context=ctx)
    assert ctx.fast._bucket_cache, "round path did not populate the cache"
    for key, (reqs_list, _arrays) in ctx.fast._bucket_cache.items():
        assert id(reqs_list) == key
    if pkg.port:
        # the device uploads are cached the same way, and pin their list
        assert ctx.dev._pods
        for key, (reqs_list, _tensors) in ctx.dev._pods.items():
            assert id(reqs_list) == key
    return _obs(results, stats, nodes)


def s_context_reuse_pays_once(pkg, mp):
    nodes = pkg.sim.make_cluster(2)
    sched = pkg.Batch(respect_busy=False)
    ctx = sched.make_context(nodes, now=0.0)
    r1, s1 = sched.schedule(
        nodes, items(pkg, [simple_request(pkg, gpus=1) for _ in range(4)]),
        context=ctx)
    free_after_1 = _free_state(nodes)
    r2, s2 = sched.schedule(
        nodes, items(pkg, [simple_request(pkg, gpus=1) for _ in range(4)]),
        context=ctx)
    assert all(r.node for r in r1) and all(r.node for r in r2)
    assert _free_state(nodes) != free_after_1
    with pytest.raises(ValueError):
        sched.schedule(pkg.sim.make_cluster(2), items(pkg, [simple_request(pkg)]),
                       context=ctx)
    return _placements(r1), _obs(r2, s2, nodes)


def s_routed_places_everything_capacity_matched(pkg, mp):
    reqs = [simple_request(pkg, gpus=i % 2) for i in range(32)]
    nodes_r = pkg.sim.make_cluster(8)
    nodes_f = copy.deepcopy(nodes_r)
    rr, sr = pkg.Streaming(
        tile_nodes=2, chunk_pods=8, placement="routed", respect_busy=False,
    ).schedule(nodes_r, items(pkg, reqs), now=0.0)
    rf, sf = pkg.Streaming(
        tile_nodes=2, chunk_pods=8, respect_busy=False,
    ).schedule(nodes_f, items(pkg, reqs), now=0.0)
    assert sr.scheduled == sf.scheduled == 32
    assert all(r.node for r in rr)

    def totals(nodes):
        return sorted((tuple(n.free_cpu_cores_per_numa()), n.free_gpu_count())
                      for n in nodes.values())

    assert totals(nodes_r) == totals(nodes_f)
    return _obs(rr, sr, nodes_r), _obs(rf, sf, nodes_f)


def s_routed_spill_wraps_to_earlier_tiles(pkg, mp):
    nodes = pkg.sim.make_cluster(4)
    names = sorted(nodes)
    prefill = [simple_request(pkg, gpus=1)] * 100
    pkg.Batch(respect_busy=False).schedule(
        {n: nodes[n] for n in names[1:]}, items(pkg, prefill), now=0.0)
    reqs = [simple_request(pkg, gpus=1) for _ in range(2)]
    res, stats = pkg.Streaming(
        tile_nodes=1, chunk_pods=1, placement="routed", respect_busy=False,
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    placed = [r.node for r in res if r.node]
    assert placed and all(n == names[0] for n in placed)
    return _obs(res, stats, nodes)


def s_routed_rejects_bad_placement(pkg, mp):
    with pytest.raises(ValueError, match="placement") as exc:
        pkg.Streaming(placement="best-fit")
    return str(exc.value)


def s_persistent_tiles_survive_churn_and_equal_fresh(pkg, mp):
    reqs1 = [simple_request(pkg, gpus=i % 2) for i in range(12)]
    reqs2 = [simple_request(pkg, gpus=(i + 1) % 2) for i in range(12)]
    nodes_p = pkg.sim.make_cluster(6)
    sched_p = pkg.Streaming(tile_nodes=2, respect_busy=False, persistent=True)
    r1, s1 = sched_p.schedule(nodes_p, items(pkg, reqs1), now=0.0)
    assert sched_p._pstate is not None
    victim = next(r.node for r in r1 if r.node is not None)
    nodes_p[victim].active = False
    sched_p.note_nodes((victim,))
    nodes_f = copy.deepcopy(nodes_p)
    r2p, s2p = sched_p.schedule(nodes_p, items(pkg, reqs2), now=1.0)
    r2f, s2f = pkg.Streaming(tile_nodes=2, respect_busy=False).schedule(
        nodes_f, items(pkg, reqs2), now=1.0)
    assert [r.node for r in r2p] == [r.node for r in r2f]
    assert _free_state(nodes_p) == _free_state(nodes_f)
    for d in sched_p._pstate["deltas"]:
        if d is not None:
            assert d.parity_errors() == []
    assert all(r.node != victim for r in r2p if r.node)
    return _placements(r1), _obs(r2p, s2p, nodes_p), _obs(r2f, s2f, nodes_f)


def s_persistent_tiles_reset_on_membership_change(pkg, mp):
    reqs = [simple_request(pkg) for _ in range(6)]
    nodes = pkg.sim.make_cluster(4)
    sched = pkg.Streaming(tile_nodes=2, respect_busy=False, persistent=True)
    r1, _ = sched.schedule(nodes, items(pkg, reqs), now=0.0)
    first = sched._pstate
    assert first is not None
    spec = pkg.synth.SynthNodeSpec(name="latecomer")
    nodes[spec.name] = pkg.synth.make_node(spec)
    sched.note_nodes((spec.name,))
    r2, s2 = sched.schedule(nodes, items(pkg, reqs), now=1.0)
    assert sched._pstate is not first
    for d in sched._pstate["deltas"]:
        if d is not None:
            assert d.parity_errors() == []
    return _placements(r1), _obs(r2, s2, nodes)


def s_empty_node_dict_reports_unschedulable(pkg, mp):
    res, stats = pkg.Streaming(tile_nodes=2, respect_busy=False).schedule(
        {}, items(pkg, [simple_request(pkg)]), now=0.0)
    assert [r.node for r in res] == [None]
    assert stats.scheduled == 0
    return _obs(res, stats, {})


SCENARIOS = {
    "single_tile_single_chunk_equals_batch": s_single_tile_single_chunk_equals_batch,
    "tiled_first_fit_2_7": _tiled_first_fit(2, 7),
    "tiled_first_fit_3_100": _tiled_first_fit(3, 100),
    "tiled_first_fit_100_5": _tiled_first_fit(100, 5),
    **{f.__name__[2:]: f for f in (
        s_tiled_equals_untiled_on_homogeneous_cluster,
        s_tiled_heterogeneous_is_valid_and_conserving,
        s_saturation_marks_unschedulable,
        s_oversized_pods_take_serial_prepass,
        s_many_groups_fall_back_to_per_tile_interners,
        s_round_cap_does_not_certify_exhaustion,
        s_bucket_cache_pins_requests_list,
        s_context_reuse_pays_once,
        s_routed_places_everything_capacity_matched,
        s_routed_spill_wraps_to_earlier_tiles,
        s_routed_rejects_bad_placement,
        s_persistent_tiles_survive_churn_and_equal_fresh,
        s_persistent_tiles_reset_on_membership_change,
        s_empty_node_dict_reports_unschedulable,
    )},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tiler_matches_the_jax_tiler(name, monkeypatch):
    _both(SCENARIOS[name], monkeypatch)


# ---------------------------------------------------------------------------
# schedule(encoded=, offer=) on its own
# ---------------------------------------------------------------------------


def s_encoded_offer(pkg, mp):
    """One chunk of 40 pods encoded once against a persistent context's
    interner, then offered in three disjoint, shrinking subsets (24, 12
    and 4 pods) through that context: slots outside each offer stay
    None, and on the port every offer reuses the chunk's device upload."""
    uploads = []
    if pkg.port:
        import nhd_tpu_torch.solver.device_state as ds

        upload = ds.upload_pods
        mp.setattr(ds, "upload_pods",
                   lambda *a, **k: uploads.append(a[0].requests) or upload(*a, **k))
    nodes = pkg.sim.make_cluster(12)
    reqs = [simple_request(pkg, gpus=i % 2, proc=2 + 2 * (i % 3)) for i in range(40)]
    chunk = items(pkg, reqs)
    sched = pkg.Batch(respect_busy=False)
    delta = pkg.encode.ClusterDelta(nodes, now=0.0, respect_busy=False)
    ctx = sched.make_context(nodes, now=0.0, delta=delta)
    encoded = pkg.encode.encode_pods([it.request for it in chunk],
                                     ctx.cluster.interner)
    offers = [list(range(0, 40, 5)) + list(range(1, 40, 5)) + list(range(2, 40, 5)),
              list(range(3, 40, 5)) + list(range(4, 24, 5)),
              list(range(24, 40, 5))[:4]]
    assert [len(o) for o in offers] == [24, 12, 4]
    out = []
    for offer in offers:
        res, stats = sched.schedule(ctx.nodes, chunk, context=ctx,
                                    encoded=encoded, offer=sorted(offer))
        outside = [i for i in range(len(chunk)) if i not in offer]
        assert all(res[i] is None for i in outside)
        assert all(res[i] is not None for i in offer)
        assert stats.scheduled > 0
        out.append((_placements([res[i] for i in sorted(offer)]),
                    stats.scheduled, stats.rounds))
    if pkg.port:
        # one upload per bucket of the encode, whatever the offer: every
        # membership view shares the encode's requests list
        lists = {id(b.requests) for b in encoded.values()}
        assert uploads and {id(x) for x in uploads} <= lists
        assert len(uploads) == len({id(x) for x in uploads})
        assert all(id(v[0]) == k for k, v in ctx.dev._pods.items())
    return out, _free_state(nodes)


@pytest.mark.parametrize("speculate", ["0", "1"])
def test_encoded_offer_matches_the_reference(speculate, monkeypatch):
    monkeypatch.setenv("NHD_TPU_SPECULATE", speculate)
    _both(s_encoded_offer, monkeypatch)


# ---------------------------------------------------------------------------
# cfg5 (bench.py cfg5:100kx10k-stream) at small depth
# ---------------------------------------------------------------------------

FED_NODES, FED_TILE, FED_PODS = 120, 40, 1200


def _fed(pkg):
    nodes = pkg.workloads.cap_cluster(FED_NODES, FED_GROUPS)
    return nodes, items(pkg, pkg.workloads.workload_mix(FED_PODS, FED_GROUPS))


def _megarounds(pkg):
    stats = importlib.import_module(f"{pkg.root}.obs.jitstats").JIT_STATS
    return sum(v for k, v in stats.snapshot()["shapes"].items()
               if k.startswith("megaround:"))


def _fed_script(placement):
    def script(pkg, mp):
        nodes, chunk = _fed(pkg)
        before = _megarounds(pkg)
        results, stats = pkg.Streaming(
            tile_nodes=FED_TILE, chunk_pods=500, placement=placement,
            respect_busy=False, register_pods=False,
        ).schedule(nodes, chunk, now=0.0)
        # capacity-matched at 10 pods a node: every pod places, and with
        # speculation on every tile's round 0 is the megaround
        assert stats.scheduled == FED_PODS
        if os.environ.get("NHD_TPU_SPECULATE") == "1":
            assert _megarounds(pkg) >= FED_NODES // FED_TILE, "no megaround ran"
        return _obs(results, stats, nodes)
    return script


def s_fed_persistent_churn(pkg, mp):
    """Two calls through one persistent tiler, with a cordon and a node
    freed between them (the pattern of test_streaming.py:322)."""
    nodes, chunk = _fed(pkg)
    sched = pkg.Streaming(tile_nodes=FED_TILE, chunk_pods=500, respect_busy=False,
                          persistent=True)
    r1, s1 = sched.schedule(nodes, chunk[:700], now=0.0)
    victim = r1[0].node
    nodes[victim].active = False
    freed = r1[1].node
    nodes[freed].reset_resources()
    sched.note_nodes((victim, freed))
    r2, s2 = sched.schedule(nodes, chunk[700:], now=1.0)
    assert all(r.node != victim for r in r2 if r.node)
    for d in sched._pstate["deltas"]:
        if d is not None:
            assert d.parity_errors() == []
    return _obs(r1, s1, {}), _obs(r2, s2, nodes)


@pytest.mark.parametrize("placement", ["first-fit", "routed"])
def test_cfg5_shape_matches_the_reference(placement, monkeypatch):
    """Speculation on both sides, as on the card."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    _both(_fed_script(placement), monkeypatch)


def test_cfg5_shape_persistent_churn_matches_the_reference(monkeypatch):
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    _both(s_fed_persistent_churn, monkeypatch)


@pytest.mark.parametrize("placement", ["first-fit", "routed"])
def test_port_workers_do_not_change_placements(placement, monkeypatch):
    """Three tile workers place exactly as one: each tile is served by
    one worker at a time, so its claim stream is the serial sweep's.
    Round numbers are left out: a sub-call's rounds join the streaming
    timeline in the order the sub-calls finish, which is the threads'."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    got = []
    for workers in ("1", "3"):
        monkeypatch.setenv("NHD_STREAM_WORKERS", workers)
        obs = _fed_script(placement)(_pkg("nhd_tpu_torch"), monkeypatch)
        obs["placements"] = [p[:4] + p[5:] for p in obs["placements"]]
        got.append(obs)
    assert got[0] == got[1]


def test_port_default_workers_read_the_device(monkeypatch):
    """The accelerator default (4 workers) follows the scheduler's
    device, not a process-wide backend: a CPU scheduler keeps the
    reference's CPU default."""
    from nhd_tpu_torch.solver import streaming

    seen = []

    class Pool(streaming.ThreadPoolExecutor):
        def __init__(self, max_workers, **kw):
            seen.append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.delenv("NHD_STREAM_WORKERS")
    monkeypatch.setattr(streaming, "ThreadPoolExecutor", Pool)
    pkg = _pkg("nhd_tpu_torch")
    nodes = pkg.sim.make_cluster(12)
    pkg.Streaming(tile_nodes=2, respect_busy=False).schedule(
        nodes, items(pkg, [simple_request(pkg) for _ in range(4)]), now=0.0)
    assert seen == [min(6, min(4, max(1, (os.cpu_count() or 2) // 2)))]


def test_launch_counts_add_up_across_threads():
    """The tiler's workers count launches from several threads at once:
    with more threads than cores and a short switch interval, the total is
    exact (a lost update would show), and each thread's own counts are
    what it added."""
    import sys
    import threading

    from nhd_tpu_torch import kernels

    n_threads, reps = 2 * (os.cpu_count() or 4) + 1, 500
    saved, interval = dict(kernels.LAUNCHES), sys.getswitchinterval()
    kernels.reset_launches()
    per_thread = {}

    def work(k):
        before = kernels.thread_launches()
        for _ in range(reps):
            for name in kernels.KERNELS[: k % len(kernels.KERNELS) + 1]:
                kernels._count(name)
        after = kernels.thread_launches()
        per_thread[k] = {n: after[n] - before[n] for n in kernels.KERNELS}

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
        total = dict(kernels.LAUNCHES)
        kernels.LAUNCHES.update(saved)
    want = {n: reps * sum(1 for k in range(n_threads) if k % len(kernels.KERNELS) >= i)
            for i, n in enumerate(kernels.KERNELS)}
    assert total == want
    assert {n: sum(c[n] for c in per_thread.values()) for n in kernels.KERNELS} == want


def test_streaming_over_mesh_equals_single_device(monkeypatch):
    """Streaming composes with the sharded batch path: tiles over time,
    nodes within a tile over the 8-shard mesh — placements, totals and
    end state equal the single-device streaming run, on both packages."""
    from nhd_tpu.parallel.sharding import make_mesh as jx_make_mesh
    from nhd_tpu_torch.parallel.sharding import make_mesh

    import jax

    outs = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        reqs = [simple_request(pkg, gpus=i % 2, proc=2 + 2 * (i % 3))
                for i in range(30)]
        mesh = make_mesh(["cpu"] * 8) if pkg.port else jx_make_mesh(jax.devices()[:8])
        for label, m in (("mesh", mesh), ("single", None)):
            nodes = pkg.sim.make_cluster(10)
            kw = {"mesh": m} if pkg.port else {"mesh": m, "device_state": True}
            streaming = pkg.Streaming if pkg.port else (
                lambda **k: importlib.import_module(
                    "nhd_tpu.solver.streaming").StreamingScheduler(**k))
            results, stats = streaming(
                tile_nodes=4, chunk_pods=9, respect_busy=False, **kw,
            ).schedule(nodes, items(pkg, reqs), now=0.0)
            outs[root, label] = _obs(results, stats, nodes)
        assert outs[root, "mesh"] == outs[root, "single"]
    assert outs["nhd_tpu_torch", "mesh"] == outs["nhd_tpu", "mesh"]
    assert outs["nhd_tpu_torch", "mesh"]["scheduled"] > 0
