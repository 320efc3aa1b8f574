"""The round path's topology fill (nhd_tpu_torch/solver/topology_plan.py)
on the CPU.

Each placed pod's topology is built, or the caller's filled in place,
straight from the native round's buffers. Here every registered topology
is held to the route it replaces, on the same buffers:
``request_to_topology`` + ``apply_record_to_topology`` of
``FastCluster.record_from_round`` (the buffers are copied as each
``assign_round`` call returns them). Every ``BatchAssignment`` and every
registered topology is also held to the JAX package's scheduler on the
same seeds, the round path as it was before the plans. Then the fill's
counters, the plan cache (one plan a request value, bounded) and a
request ``request_to_topology`` rejects.

Tolerance: exact (integers, names and dataclass equality).
"""

from __future__ import annotations

import dataclasses
import random

import pytest

import nhd_tpu.sim.workloads as jx_workloads
import nhd_tpu_torch.sim.workloads as pt_workloads
from nhd_tpu.sim.requests import request_to_topology as jx_to_top
from nhd_tpu.solver import BatchItem as JxItem
from nhd_tpu.solver import BatchScheduler as JxScheduler
from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
from nhd_tpu_torch.core.topology import MapMode, SmtMode
from nhd_tpu_torch.sim.requests import request_to_topology
from nhd_tpu_torch.solver import BatchItem, BatchScheduler
from nhd_tpu_torch.solver import topology_plan
from nhd_tpu_torch.solver.fast_assign import FastCluster, apply_record_to_topology
from tests.test_torch_kernel import JAX_PKG, PORT_PKG, random_cluster, random_request

#: the benchmark cell's node groups (bench_port/configs/cap1k.json)
GROUPS3 = ["default", "edge", "batch"]


def _cell(pkg):
    """The cell's three pod types over its three node groups, on a
    cap-shaped fleet cut to 8 nodes."""
    wl = pt_workloads if pkg is PORT_PKG else jx_workloads
    return wl.cap_cluster(8, GROUPS3), wl.workload_mix(72, GROUPS3), {}


def _random(seed):
    """tests/test_torch_kernel.py's generators: 1-3 groups, NUMA and PCI,
    SMT on and off, 0-2 GPUs, 0-2 helpers, 0-3 misc, NIC-less groups."""
    def make(pkg):
        nodes = random_cluster(pkg, random.Random(seed), 8)
        rng = random.Random(seed + 1)
        reqs = [random_request(pkg, rng) for _ in range(30)]
        return nodes, reqs, dict(now=1010.0)
    return make


def _two_gpus(pkg):
    """Groups of two GPUs: two feeders ahead of rx, tx and a worker; a
    GPU left without a feeder beside a NIC-less group with helpers."""
    wl = pt_workloads if pkg is PORT_PKG else jx_workloads
    R, T = pkg.request, pkg.topology

    def grp(proc, gpus, helpers, rx, tx):
        return R.GroupRequest(proc=R.CpuRequest(proc, T.SmtMode.ON),
                              misc=R.CpuRequest(helpers, T.SmtMode.OFF),
                              gpus=gpus, nic_rx_gbps=rx, nic_tx_gbps=tx)

    types = [
        R.PodRequest(groups=(grp(5, 2, 1, 10.0, 5.0),),
                     misc=R.CpuRequest(2, T.SmtMode.ON), hugepages_gb=2,
                     map_mode=T.MapMode.NUMA),
        R.PodRequest(groups=(grp(2, 1, 0, 20.0, 0.0), grp(3, 1, 2, 0.0, 0.0)),
                     misc=R.CpuRequest(0, T.SmtMode.OFF), hugepages_gb=0,
                     map_mode=T.MapMode.PCI),
    ]
    return wl.cap_cluster(4, ["default"]), [types[i % 2] for i in range(24)], {}


CASES = {
    "cell": (_cell, False, dict(respect_busy=False)),
    "two-gpus": (_two_gpus, False, dict(respect_busy=False)),
    "two-gpus-given": (_two_gpus, True, dict(respect_busy=False)),
    **{f"random-{s}": (_random(s), False, dict(respect_busy=True))
       for s in (7000, 7007, 7013)},
    **{f"given-{s}": (_random(s), True, dict(respect_busy=True))
       for s in (7000, 7007)},
}


def _spy_rounds(monkeypatch):
    """Copies of every native round call's inputs and buffers."""
    calls = []
    orig = FastCluster.assign_round

    def spy(self, pods, w_node, w_type, w_c, w_m, *, set_busy):
        buffers = orig(self, pods, w_node, w_type, w_c, w_m, set_busy=set_busy)
        calls.append((self, pods, w_node.tolist(), w_type.tolist(),
                      tuple(b.copy() for b in buffers)))
        return buffers

    monkeypatch.setattr(FastCluster, "assign_round", spy)
    return calls


def _record_route(calls):
    """node name → the topologies the record route gives each placed
    winner of the captured calls."""
    out = {}
    for fast, pods, w_node, w_type, buffers in calls:
        for w, (n, t) in enumerate(zip(w_node, w_type)):
            if buffers[0][w] < 0:
                continue
            top = request_to_topology(pods.requests[t])
            apply_record_to_topology(
                fast.record_from_round(pods, w, n, t, buffers), top)
            out.setdefault(fast.names[n], []).append(top)
    return out


def _fingerprint(results):
    return [(r.key, r.node, None if r.mapping is None else dict(r.mapping),
             tuple(r.nic_list or ()), r.round_no, r.failed) for r in results]


def _registered(nodes):
    return {(name, key): dataclasses.asdict(top)
            for name, node in nodes.items() for key, top in node.pod_info.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_fill_matches_record_route(monkeypatch, case):
    make, given, kw = CASES[case]
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    calls = _spy_rounds(monkeypatch)

    nodes, reqs, call_kw = make(PORT_PKG)
    items = [BatchItem(("ns", f"p{i}"), r, request_to_topology(r) if given else None)
             for i, r in enumerate(reqs)]
    results, stats = BatchScheduler(device="cpu", **kw).schedule(nodes, items, **call_kw)

    want = _record_route(calls)
    placed = sum(len(v) for v in want.values())
    assert placed == stats.scheduled > 0
    c = stats.counters
    assert (c["fill_planned"], c["fill_given"]) == ((0, placed) if given else (placed, 0))
    for name, node in nodes.items():
        got = list(node.pod_info.values())
        assert sorted(map(repr, got)) == sorted(map(repr, want.get(name, [])))
        for top in got:
            assert top in want[name]
    for item, r in zip(items, results):
        if r.node is None:
            continue
        ns, pod = item.key
        top = nodes[r.node].pod_info[(pod, ns)]
        if given:
            assert top is item.topology

    # the same batch through the JAX package's scheduler
    jnodes, jreqs, _ = make(JAX_PKG)
    jitems = [JxItem(("ns", f"p{i}"), r, jx_to_top(r) if given else None)
              for i, r in enumerate(jreqs)]
    jresults, _ = JxScheduler(device_state=False, mesh=None, **kw).schedule(
        jnodes, jitems, **call_kw)
    assert _fingerprint(results) == _fingerprint(jresults)
    assert _registered(nodes) == _registered(jnodes)


@pytest.fixture
def fresh_plans(monkeypatch):
    plans = {}
    monkeypatch.setattr(topology_plan, "_PLANS", plans)
    return plans


def _gang(reqs, n_nodes=9):
    nodes = pt_workloads.cap_cluster(n_nodes, GROUPS3)
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    results, stats = BatchScheduler(device="cpu", respect_busy=False).schedule(
        nodes, items)
    return nodes, items, results, stats


def test_plans_built_once_per_request_value(fresh_plans):
    reqs = pt_workloads.workload_mix(72, GROUPS3)
    for gang, built in ((0, 9), (1, 0)):
        nodes, _, results, stats = _gang(reqs)
        assert stats.scheduled == len(reqs)
        c = stats.counters
        assert (c["fill_planned"], c["fill_given"], c["topology_plans_built"]) == (
            len(reqs), 0, built), gang
        assert sum(len(n.pod_info) for n in nodes.values()) == len(reqs)
    assert len(fresh_plans) == len(set(reqs)) == 9


def _request(proc=4, rx=10.0, misc=1):
    """A request built afresh each call (not interned)."""
    return PodRequest(
        groups=(GroupRequest(proc=CpuRequest(proc, SmtMode.ON),
                             misc=CpuRequest(1, SmtMode.ON), gpus=1,
                             nic_rx_gbps=rx, nic_tx_gbps=5.0),),
        misc=CpuRequest(misc, SmtMode.ON), hugepages_gb=2, map_mode=MapMode.NUMA,
    )


def test_equal_requests_share_a_plan(fresh_plans):
    a, b = _request(), _request()
    assert a is not b and a == b
    plan, built = topology_plan.plan_for(a)
    assert built and topology_plan.plan_for(b) == (plan, False)

    fresh_plans.clear()
    _, _, _, stats = _gang([_request() for _ in range(12)])
    assert stats.scheduled == 12
    assert stats.counters["topology_plans_built"] == 1
    assert stats.counters["fill_planned"] == 12


def test_plan_cache_is_bounded(monkeypatch, fresh_plans):
    monkeypatch.setattr(topology_plan, "_PLANS_MAX", 4)
    reqs = [_request(misc=m) for m in range(10)]
    for r in reqs:
        plan, built = topology_plan.plan_for(r)
        assert built and len(fresh_plans) <= 4
        assert topology_plan.plan_for(r) == (plan, False)


class _Log:
    """A stand-in for the scheduler's logger that keeps what it is told."""

    def __init__(self):
        self.lines = []

    def __getattr__(self, level):
        return lambda msg, *a, **k: self.lines.append((level, msg))


def test_rejected_request_is_scheduled_not_registered(fresh_plans):
    """A NIC group of one proc core: request_to_topology has no rx/tx
    pair for it, so the pod is placed but its topology is not made."""
    bad = _request(proc=1)
    with pytest.raises(ValueError) as exc:
        request_to_topology(bad)
    nodes = pt_workloads.cap_cluster(2, ["default"])
    sched = BatchScheduler(device="cpu", respect_busy=False)
    sched.logger = log = _Log()
    items = [BatchItem(("ns", "p0"), bad), BatchItem(("ns", "p1"), _request())]
    results, stats = sched.schedule(nodes, items)
    assert results[0].node is not None and results[1].node is not None
    assert not any(("p0", "ns") in n.pod_info for n in nodes.values())
    assert ("p1", "ns") in nodes[results[1].node].pod_info
    assert log.lines == [(
        "warning", f"skipping pod registration for ('ns', 'p0'): {exc.value}")]
    c = stats.counters
    assert (c["fill_planned"], c["topology_plans_built"]) == (1, 2)
