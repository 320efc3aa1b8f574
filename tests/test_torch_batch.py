"""The slice end to end: the port's ``BatchScheduler(device="cpu")``
against the JAX reference's ``nhd_tpu.solver.BatchScheduler`` on the
seeds and generators of tests/test_batch.py, test_pipeline.py and
test_policy.py — same placements, mappings, consumed NICs, round numbers
and round counts — under ``NHD_PIPELINE=0`` and ``1``. The reference runs
classic rounds (``NHD_TPU_SPECULATE=0``, host solve path). Also the
port's ``find_nodes`` against the serial oracle.
"""

import random

import pytest

import nhd_tpu.sim.workloads as jx_workloads
import nhd_tpu_torch.sim.workloads as pt_workloads
from nhd_tpu.policy.scoring import set_matrix as jx_set_matrix
from nhd_tpu.solver import BatchItem as JxItem
from nhd_tpu.solver import BatchScheduler as JxScheduler
from nhd_tpu.solver import find_node as jx_oracle
from nhd_tpu.solver.encode import ClusterDelta as JxDelta
from nhd_tpu_torch.policy.scoring import set_matrix as pt_set_matrix
from nhd_tpu_torch.solver import BatchItem as PtItem
from nhd_tpu_torch.solver import BatchScheduler as PtScheduler
from nhd_tpu_torch.solver.encode import ClusterDelta as PtDelta
from nhd_tpu_torch.solver.matcher import find_node as pt_find_node
from nhd_tpu_torch.solver.matcher import find_nodes as pt_find_nodes
from tests.test_torch_kernel import JAX_PKG, PORT_PKG, random_cluster, random_request

GROUPS = ["default", "edge"]


def _fingerprint(results, stats):
    return [
        (
            r.key, r.node,
            None if r.mapping is None else dict(r.mapping),
            tuple(r.nic_list or ()), r.round_no, r.failed,
        )
        for r in results
    ], stats.rounds, stats.scheduled, stats.failed


def _both(monkeypatch, pipeline, make_nodes, make_reqs, *, now=0.0,
          topologies=False, apply=True, **kw):
    """Schedule one batch on both packages; returns (port, reference)
    fingerprints. ``make_nodes(pkg)``/``make_reqs(pkg)`` build each
    package's own objects from the same seed."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", pipeline)
    out = []
    for pkg, sched, item in (
        (PORT_PKG, PtScheduler(device="cpu", **kw), PtItem),
        (JAX_PKG, JxScheduler(device_state=False, mesh=None, **kw), JxItem),
    ):
        nodes = make_nodes(pkg)
        reqs = make_reqs(pkg)
        if topologies:
            from importlib import import_module

            to_top = import_module(
                pkg.sim.__name__ + ".requests"
            ).request_to_topology
            items = [item(("ns", f"p{i}"), r, to_top(r)) for i, r in enumerate(reqs)]
        else:
            items = [item(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
        results, stats = sched.schedule(nodes, items, now=now, apply=apply)
        assert stats.scheduled > 0 or not apply
        if pipeline == "1" and pkg is PORT_PKG and apply:
            assert stats.rounds <= 1 or stats.counters.get("prelaunched_rounds", 0) > 0
        out.append(_fingerprint(results, stats))
    return out


def _workloads(pkg):
    return pt_workloads if pkg is PORT_PKG else jx_workloads


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_gang_mix_matches_reference(monkeypatch, pipeline):
    """tests/test_pipeline.py's classic posture: workload_mix on cap_cluster."""
    port, ref = _both(
        monkeypatch, pipeline,
        lambda pkg: _workloads(pkg).cap_cluster(12, GROUPS),
        lambda pkg: _workloads(pkg).workload_mix(96, GROUPS),
        respect_busy=False, register_pods=False,
    )
    assert port == ref


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_contended_seeds_match_reference(monkeypatch, pipeline, seed):
    """tests/test_pipeline.py's contended sweep: saturated clusters,
    rejects and multi-round retries."""
    rng = random.Random(seed)
    n_nodes = rng.choice((4, 6, 8))
    n_pods = rng.choice((64, 96))
    port, ref = _both(
        monkeypatch, pipeline,
        lambda pkg: _workloads(pkg).bench_cluster(n_nodes, GROUPS),
        lambda pkg: _workloads(pkg).workload_mix(n_pods, GROUPS),
        respect_busy=False, register_pods=False,
    )
    assert port == ref


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("seed", [7000, 7007])
def test_random_mixed_batches_match_reference(monkeypatch, pipeline, seed):
    """tests/test_batch.py's random clusters and requests (NUMA and PCI
    map modes, 1-3 groups), busy back-off on, pods registered with
    topologies filled."""
    n = 8

    def nodes(pkg):
        return random_cluster(pkg, random.Random(seed), n)

    def reqs(pkg):
        rng = random.Random(seed + 1)
        return [random_request(pkg, rng) for _ in range(30)]

    port, ref = _both(
        monkeypatch, pipeline, nodes, reqs, now=1010.0, topologies=True,
        respect_busy=True, register_pods=True,
    )
    assert port == ref


@pytest.mark.parametrize("variant", ["object-path", "dry-run"])
def test_fallback_paths_match_reference(monkeypatch, variant):
    """The per-pod object-assignment path (use_fast=False) and the dry
    run (apply=False) of the round loop, on a contended gang."""
    kw = dict(use_fast=False) if variant == "object-path" else dict(apply=False)
    port, ref = _both(
        monkeypatch, "1",
        lambda pkg: _workloads(pkg).bench_cluster(6, GROUPS),
        lambda pkg: _workloads(pkg).workload_mix(48, GROUPS),
        respect_busy=True, register_pods=False, **kw,
    )
    assert port == ref
    assert any(entry[1] for entry in port[0])


def test_policy_scores_match_reference(monkeypatch):
    """tests/test_policy.py's mixed-class fleet under a live scoring
    matrix: the score term moves placements, identically on both."""
    monkeypatch.setenv("NHD_POLICY", "1")
    matrix = {"gpu": {"gen-a": 0.3, "gen-b": 1.0}, "cpu": {"gen-c": 1.0}}
    jx_set_matrix(matrix)
    pt_set_matrix(matrix)

    def nodes(pkg):
        out = {}
        for i in range(6):
            spec = pkg.sim.SynthNodeSpec(
                name=f"node{i:03d}", node_class=("gen-a", "gen-b", "gen-c")[i % 3],
            )
            out[spec.name] = pkg.sim.make_node(spec)
        return out

    def reqs(pkg):
        R, T = pkg.request, pkg.topology
        return [
            R.PodRequest(
                groups=(R.GroupRequest(
                    proc=R.CpuRequest(3 + i % 3, T.SmtMode.ON),
                    misc=R.CpuRequest(1, T.SmtMode.ON),
                    gpus=i % 2, nic_rx_gbps=10.0, nic_tx_gbps=5.0,
                ),),
                misc=R.CpuRequest(1, T.SmtMode.ON), hugepages_gb=2,
                map_mode=T.MapMode.NUMA, node_groups=frozenset({"default"}),
            ).interned()
            for i in range(12)
        ]

    try:
        port, ref = _both(monkeypatch, "0", nodes, reqs, respect_busy=False)
    finally:
        jx_set_matrix(None)
        pt_set_matrix(None)
    assert port == ref


def test_persistent_context_with_churn_matches_reference(monkeypatch):
    """make_context over a ClusterDelta, a batch, churn noted on the
    delta, refresh_context, a second batch: same on both packages."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    outs = []
    for pkg, sched, item, delta_cls in (
        (PORT_PKG, PtScheduler(device="cpu", respect_busy=False,
                               register_pods=False), PtItem, PtDelta),
        (JAX_PKG, JxScheduler(device_state=False, mesh=None,
                              respect_busy=False, register_pods=False),
         JxItem, JxDelta),
    ):
        wl = _workloads(pkg)
        nodes = wl.cap_cluster(10, GROUPS)
        delta = delta_cls(nodes, now=0.0, respect_busy=False)
        ctx = sched.make_context(nodes, now=0.0, delta=delta)
        reqs = wl.workload_mix(60, GROUPS)
        fp = []
        for batch in (reqs[:30], reqs[30:]):
            items = [item(("ns", f"p{i}"), r) for i, r in enumerate(batch)]
            results, stats = sched.schedule(ctx.nodes, items, context=ctx)
            fp.append(_fingerprint(results, stats))
            # churn: cordon one node, release another's resources
            names = list(nodes)
            nodes[names[1]].maintenance = not nodes[names[1]].maintenance
            nodes[names[3]].reset_resources()
            delta.note_all([names[1], names[3]])
            sched.refresh_context(ctx, now=1.0)
        outs.append(fp)
    assert outs[0] == outs[1]


def test_group_bits_past_32_match_oracle():
    """Node groups past the 32nd interned bit: the port ANDs the int64
    group masks in full and agrees with the serial oracle. (The JAX
    reference runs without x64, so its masks are cut to int32 and it
    finds no node here — a reference fault the port does not copy.)"""
    R, T = PORT_PKG.request, PORT_PKG.topology
    nodes = {
        f"n{i}": PORT_PKG.sim.make_node(
            PORT_PKG.sim.SynthNodeSpec(name=f"n{i}", groups=f"g{i}")
        )
        for i in range(34)
    }
    req = R.PodRequest(
        groups=(R.GroupRequest(
            proc=R.CpuRequest(2, T.SmtMode.ON), misc=R.CpuRequest(0, T.SmtMode.ON),
            gpus=0, nic_rx_gbps=0.0, nic_tx_gbps=0.0,
        ),),
        misc=R.CpuRequest(0, T.SmtMode.ON), hugepages_gb=0,
        map_mode=T.MapMode.NUMA, node_groups=frozenset({"g33"}),
    )
    from nhd_tpu_torch.solver.oracle import find_node as pt_oracle

    want = pt_oracle(nodes, req, now=0.0)
    got = pt_find_node(nodes, req, now=0.0, device="cpu")
    assert want is not None and want.node == "n33"
    assert got is not None and (got.node, dict(got.mapping)) == (
        want.node, dict(want.mapping)
    )


@pytest.mark.parametrize("seed", range(6))
def test_find_nodes_matches_oracle(seed):
    """The port's batched matcher against the serial oracle on the
    tests/test_jax_matcher.py generators: same node, same mapping."""
    jn = random_cluster(JAX_PKG, random.Random(seed), random.Random(seed).randint(2, 8))
    pn = random_cluster(PORT_PKG, random.Random(seed), random.Random(seed).randint(2, 8))
    rj, rp = random.Random(50 + seed), random.Random(50 + seed)
    jreqs = [random_request(JAX_PKG, rj) for _ in range(6)]
    preqs = [random_request(PORT_PKG, rp) for _ in range(6)]
    got = pt_find_nodes(pn, preqs, now=1010.0, device="cpu")
    for jr, pr, g in zip(jreqs, preqs, got):
        want = jx_oracle(jn, jr, now=1010.0)
        assert (want is None) == (g is None)
        if want is not None:
            assert g.node == want.node and g.mapping == want.mapping
        single = pt_find_node(pn, pr, now=1010.0, device="cpu")
        assert (single is None) == (g is None)
        if single is not None:
            assert single.node == g.node and single.mapping == g.mapping
