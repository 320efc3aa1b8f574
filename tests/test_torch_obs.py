"""The flight recorder through the port's scheduler (nhd_tpu_torch/
scheduler/core.py, solver/batch.py, sim/chaos.py) against the JAX
package's, on the CPU.

Each scheduler-driving case of tests/test_obs.py (:191, :226, :253,
:266) and each ChaosSim, trace-context and federation case of
tests/test_fleet.py (:70-232, :233-272) runs through both packages, the
port on ``device="cpu"``. Both runs must record the same thing: each
pod's span names (over every correlation ID a span naming the pod was
recorded under), each decision record (pod, outcome, node, the keys of
its phases, its explain reasons), the validity of the Chrome trace, and
for the federation the cross-replica journeys by pod and the fleet
payload. Tolerance: exact, with times, wall stamps and the process's
correlation counters masked (each package counts its own IDs, from
whatever ran before in the worker).

One case forces the speculative megaround (``NHD_TPU_SPECULATE=1``,
the card's default) on both sides, so the spans and decisions of pods
placed inside round 0 are held too, with the round spans' claim counts;
one shows that a ring too small for the run fails the port's trace
demo.
"""

from __future__ import annotations

import importlib
import os
import queue
from types import SimpleNamespace

import pytest

from chip_smoke import cross_journeys, decision_view, pod_span_names
from chip_smoke import masked as _mask
from nhd_tpu_torch.sim import pending
from tests.test_torch_daemon import _pkg, make_backend, make_scheduler, pod_cfg

PACKAGES = ("nhd_tpu", "nhd_tpu_torch")


def _obs(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        obs=mod("obs"), chrome=mod("obs.chrome"), fleet=mod("obs.fleet"),
        recorder=mod("obs.recorder"), histo=mod("obs.histo"),
        chaos=mod("sim.chaos"), faults=mod("sim.faults"),
        iface=mod("k8s.interface"), slo=mod("obs.slo"),
        jitstats=mod("obs.jitstats"), retry=mod("k8s.retry"),
    )


def _chaos(root, *args, **kw):
    if root == "nhd_tpu_torch":
        kw.setdefault("device", "cpu")
    return _obs(root).chaos.ChaosSim(*args, **kw)


def _recorded(o, rec):
    """What a run left in *rec*: each pod's span names, the decisions
    (newest first), the trace's schema errors and the drops."""
    return {
        "pods": {p: sorted(n) for p, n in pod_span_names(rec.spans()).items()},
        "decisions": [decision_view(d) for d in rec.recent_decisions(256)],
        "schema": o.chrome.validate_chrome_trace(o.obs.chrome_trace(rec)),
        "dropped": rec.dropped(),
    }


def _diff(a, b, path=""):
    """The paths at which two JSON-shaped values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b), key=str)
                for d in (_diff(a[k], b[k], f"{path}/{k}")
                          if k in a and k in b else [f"{path}/{k}"])]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def _both(fn, monkeypatch):
    """*fn(root)* on the reference, then on the port, each with its own
    process-global recorder on (capacity 4,096, as test_obs.py's
    fixture) and off again after."""
    got = {}
    for root in PACKAGES:
        o = _obs(root)
        rec = o.obs.enable(capacity=4096)
        try:
            with monkeypatch.context() as mp:
                got[root] = fn(root, o, rec, mp)
        finally:
            o.obs.disable()
    return got["nhd_tpu"], got["nhd_tpu_torch"]


def _drain(sched):
    while not sched.nqueue.empty():
        sched.run_once()


# ---------------------------------------------------------------------------
# tests/test_obs.py's scheduler-driving cases
# ---------------------------------------------------------------------------


def test_watch_to_bind_shares_one_corr_id(monkeypatch):
    """test_obs.py:191: watch receipt to bind under one corr per pod."""

    def run(root, o, rec, mp):
        pkg = _pkg(root)
        backend = make_backend(pkg, n_nodes=2)
        sched = make_scheduler(pkg, backend)
        ctrl = pkg.Controller(backend, sched.nqueue)
        backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
        ctrl.run_once()
        _drain(sched)
        assert backend.pods[("default", "triad-0")].node is not None
        (d,) = [d for d in rec.recent_decisions(10) if d["pod"] == "triad-0"]
        by_corr = {}
        for s in rec.spans():
            by_corr.setdefault(s.corr, set()).add(s.name)
        assert {"watch_event", "queue_wait", "solve", "select", "assign",
                "bind"} <= by_corr[d["corr"]]
        assert o.histo.HISTOGRAMS["queue_wait_seconds"].snapshot()[2] >= 1
        return _recorded(o, rec)

    ref, port = _both(run, monkeypatch)
    assert port == ref
    assert port["schema"] == [] and port["dropped"] == 0
    assert port["decisions"][0][2] == "scheduled"


def test_requeued_pod_keeps_its_corr_id(monkeypatch):
    """test_obs.py:226: a transient bind failure requeues the pod; both
    attempts' spans and decisions stay under one corr."""

    def run(root, o, rec, mp):
        pkg = _pkg(root)
        backend = make_backend(pkg, n_nodes=2)
        sched = make_scheduler(pkg, backend)
        ctrl = pkg.Controller(backend, sched.nqueue)
        sched.backend = o.faults.FaultyBackend(
            backend, o.faults.FaultProfile(name="t", transient_bind=1.0))
        backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
        for _ in range(8):
            ctrl.run_once(now=0.0)
            _drain(sched)
        decisions = [d for d in rec.recent_decisions(20)
                     if d["pod"] == "triad-0"]
        assert len({d["corr"] for d in decisions}) == 1
        assert {s.corr for s in rec.spans() if s.name == "bind"} == {
            decisions[0]["corr"]}
        return _recorded(o, rec)

    ref, port = _both(run, monkeypatch)
    assert port == ref
    assert {"requeued", "scheduled"} <= {d[2] for d in port["decisions"]}


def test_unschedulable_decision_carries_explain_reasons(monkeypatch):
    """test_obs.py:253: the unschedulable decision's explain reasons."""

    def run(root, o, rec, mp):
        pkg = _pkg(root)
        backend = make_backend(pkg, n_nodes=2)
        sched = make_scheduler(pkg, backend)
        backend.create_pod("greedy-0",
                           cfg_text=pod_cfg(pkg, hugepages_gb=100000))
        sched.check_pending_pods()
        return _recorded(o, rec)

    ref, port = _both(run, monkeypatch)
    assert port == ref
    (d,) = [d for d in port["decisions"] if d[1] == "greedy-0"]
    assert d[2] == "unschedulable"
    assert dict(d[5]).get("insufficient-hugepages") == 2


def test_chaos_run_with_tracing_produces_valid_trace(monkeypatch):
    """test_obs.py:266: a ChaosSim run with tracing on; every pod's span
    names and every decision equal, the trace valid on both."""

    def run(root, o, rec, mp):
        stats = _chaos(root, seed=3, n_nodes=4).run(steps=15)
        assert stats.violations == []
        return _recorded(o, rec)

    ref, port = _both(run, monkeypatch)
    assert port == ref
    assert port["schema"] == [] and port["decisions"]
    assert any({"solve", "select", "assign", "bind"} <= set(n)
               for n in port["pods"].values())


def test_megaround_pods_carry_their_spans(monkeypatch):
    """cfg4's pending set (30 nodes x 300 pods) with round 0 the
    speculative megaround on both packages (``NHD_TPU_SPECULATE=1`` and
    the resident state, the card's default): each pod placed inside the
    megaround has its solve/select/assign/bind spans and its decision as
    the reference records them, and the round spans carry the same claim
    and reject counts (``claims_r0`` set from the megaround's winners)."""

    def run(root, o, rec, mp):
        mp.setenv("NHD_TPU_SPECULATE", "1")
        mp.setenv("NHD_TPU_DEVICE_STATE", "1")
        stats = o.jitstats.JIT_STATS

        def megarounds():
            return sum(v for k, v in stats.snapshot()["shapes"].items()
                       if k.startswith("megaround:"))

        pkg = _pkg(root)
        before = megarounds()
        backend = pkg.Backend()
        pending.fill_cfg4(backend, pkg.sim, 30, 300)
        sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                              respect_busy=False)
        got = pending.drive(sched)
        assert megarounds() > before, "no speculative round ran"
        rounds = [(s.name, s.attrs["claims"], s.attrs["rejects"])
                  for s in rec.spans() if s.name.startswith("round")]
        return dict(_recorded(o, rec), rounds=rounds, bound=got["bound"],
                    nodes={f"{k[0]}/{k[1]}": p.node
                           for k, p in backend.pods.items()})

    ref, port = _both(run, monkeypatch)
    assert port == ref
    assert port["bound"] > 200 and port["dropped"] == 0
    assert port["rounds"][0][0] == "round0" and port["rounds"][0][1]
    for pod, node in port["nodes"].items():
        if node is not None:
            assert {"solve", "select", "assign", "bind"} <= set(
                port["pods"][pod]), pod


def test_small_ring_fails_the_trace_demo(tmp_path, capsys):
    """A ring too small for the run fails the port's trace demo (the
    gate refuses a thinned trace) and the default ring passes it."""
    from nhd_tpu_torch import obs
    from nhd_tpu_torch.sim import trace_demo

    try:
        code, rec, _backend = trace_demo.demo(
            pods=6, nodes=4, device="cpu", out=str(tmp_path), capacity=20)
    finally:
        obs.disable()
    assert code == 1 and rec.dropped() > 0
    out = capsys.readouterr().out
    assert "dropped" in out and "recent decisions" not in out
    assert trace_demo.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    assert obs.get_recorder() is None
    assert "6 correlation id(s) carry the full" in capsys.readouterr().out
    assert trace_demo.ring_capacity(6) == 16384
    assert trace_demo.ring_capacity(10_000) == 131072


# ---------------------------------------------------------------------------
# tests/test_fleet.py: trace context, the federation, the SLO clock
# ---------------------------------------------------------------------------


def _fleet_scheduler(root, backend, *, identity, slo=None):
    o, pkg = _obs(root), _pkg(root)
    sched = pkg.Scheduler(
        backend, pkg.WatchQueue(), queue.Queue(), respect_busy=False,
        recorder=o.recorder.FlightRecorder(capacity=256, identity=identity),
        slo=slo,
    )
    sched.build_initial_node_list()
    sched.load_deployed_configs()
    return sched


def _per_package(fn):
    return fn("nhd_tpu"), fn("nhd_tpu_torch")


def test_corr_stamped_and_adopted_by_a_later_replica():
    """test_fleet.py:70: replica A stamps the pod's corr at first
    receipt; replica B adopts it."""

    def run(root):
        o, pkg = _obs(root), _pkg(root)
        backend = make_backend(pkg, n_nodes=1)
        backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
        a = _fleet_scheduler(root, backend, identity="rep-a")
        got_a = a._resolve_trace_corr("triad-0", "default", "c-from-a")
        pod = backend.pods[("default", "triad-0")]
        stamped = o.iface.parse_trace_record(
            pod.annotations[o.iface.TRACE_ANNOTATION])
        b = _fleet_scheduler(root, backend, identity="rep-b")
        got_b = b._resolve_trace_corr("triad-0", "default", "c-from-b")
        again = o.iface.parse_trace_record(
            pod.annotations[o.iface.TRACE_ANNOTATION])
        return (got_a, got_b, _mask(stamped), stamped == again,
                a.replica_id)

    ref, port = _per_package(run)
    assert port == ref
    assert port[:2] == ("c-from-a", "c-from-a") and port[3]


def test_adoption_realiases_the_recorded_watch_leg():
    """test_fleet.py:95: a watch leg recorded under a local corr joins
    the adopted journey."""

    def run(root):
        pkg = _pkg(root)
        backend = make_backend(pkg, n_nodes=1)
        backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
        a = _fleet_scheduler(root, backend, identity="rep-a")
        a._resolve_trace_corr("triad-0", "default", "c-origin")
        b = _fleet_scheduler(root, backend, identity="rep-b")
        rec = b._rec()
        rec.record("watch_event", 0.0, 0.0, cat="event", corr="c-local",
                   attrs={"pod": "default/triad-0"})
        b.attempt_scheduling_batch(
            [("triad-0", "default", "uid-0")],
            meta={("default", "triad-0"): ("c-local", 0.0)},
        )
        return sorted((s.name, _mask(s.corr), s.replica) for s in rec.spans())

    ref, port = _per_package(run)
    assert port == ref
    assert all(corr != "c-local" for _n, corr, _r in port)
    assert ("watch_event", "c-origin", "rep-b") in port


def test_resolve_trace_corr_best_effort_on_a_missing_pod():
    """test_fleet.py:122."""

    def run(root):
        backend = make_backend(_pkg(root), n_nodes=1)
        a = _fleet_scheduler(root, backend, identity="rep-a")
        return a._resolve_trace_corr("ghost", "default", "c-x")

    assert _per_package(run) == ("c-x", "c-x")


def test_federation_spill_journey_merges_across_replicas(monkeypatch):
    """test_fleet.py:133 at its first seed (3): the same cross-replica
    journeys by pod, a valid merged trace, and the same fleet payload
    with times masked (``NHD_MESH=off``: the reference's auto mesh would
    take the test session's virtual devices, the port's counts GPUs)."""
    monkeypatch.setenv("NHD_MESH", "off")

    def run(root):
        o = _obs(root)
        # process-wide tallies, which earlier cases of the worker moved
        o.retry.API_COUNTERS.reset()
        importlib.import_module(f"{root}.solver.guard").GUARD.reset()
        sim = _chaos(root, seed=3, n_nodes=6, federation=3, n_replicas=3)
        sim.run(40)
        sim.quiesce()
        merged = sim.merged_trace()
        art = sim.fleet_artifact()
        return {
            "violations": sim.stats.violations,
            "schema": o.chrome.validate_chrome_trace(merged),
            "journeys": cross_journeys(merged),
            "artifact_errors": o.fleet.validate_fleet_artifact(art),
            "payload": _mask(art["payload"]),
        }

    ref, port = _per_package(run)
    assert _diff(port, ref) == []
    assert port["violations"] == [] and port["schema"] == []
    assert port["artifact_errors"] == []
    assert any(len(shards) >= 2 and "spill" in names
               for _r, names, shards in port["journeys"].values())
    assert port["payload"]["spillover"]["cross_replica_journeys"] >= 1


def test_fleet_artifact_captured_around_violation(tmp_path, monkeypatch):
    """test_fleet.py:176: the one-shot capture on the first violation."""

    def run(root):
        monkeypatch.setenv("NHD_FLEET_DIR", str(tmp_path / root))
        sim = _chaos(root, seed=0, n_nodes=4, federation=2, n_replicas=2)
        sim.run(5)
        sim.stats.violations.append("synthetic violation (capture test)")
        sim._maybe_capture_violation()
        path = sim.violation_artifact_path
        import json

        with open(path) as fh:
            art = json.load(fh)
        sim.stats.violations.append("second")
        sim._maybe_capture_violation()
        return (os.path.basename(path), sim.violation_artifact_path == path,
                _obs(root).fleet.validate_fleet_artifact(art),
                art["payload"]["violations"])

    ref, port = _per_package(run)
    assert port == ref
    assert port[1:] == (True, [], ["synthetic violation (capture test)"])


def test_fleet_views_outside_federation_and_private_counters():
    """test_fleet.py:195 and :209: ha-mode views degrade to identity and
    empty shards; the replicas' private elector counters fold into the
    fleet payload, banked through a replica's replacement."""

    def run(root):
        ha = _chaos(root, seed=0, n_nodes=4, ha=True)
        ha.run(3)
        views = [(v["replica"], v["shards"], v["trace"])
                 for v in ha.fleet_views()]
        traced = ha.fleet_artifact()["payload"]["journeys"]["pods_traced"]
        sim = _chaos(root, seed=0, n_nodes=4, federation=2, n_replicas=2)
        sim.run(4)
        sim.replicas[0].counters.inc("shard_handoffs_total")
        sim.replicas[1].counters.inc("ha_renewal_failures_total")
        f1 = sim.fleet_artifact()["payload"]["fencing"]
        sim._replace_replica(0)
        f2 = sim.fleet_artifact()["payload"]["fencing"]
        return views, traced, f1, f2

    ref, port = _per_package(run)
    views, traced, f1, f2 = port
    assert views == ref[0] and traced == ref[1] == 0
    assert [v[0] for v in views] == ["sched-a", "sched-b"]
    assert f1["handoffs_total"] >= 1 and f1["renewal_failures_total"] >= 1
    assert f2["handoffs_total"] >= f1["handoffs_total"]


def test_slo_clock_survives_replica_restart():
    """test_fleet.py:233: time-to-bind from the cluster's creation
    stamp, through a fresh incarnation."""

    def run(root):
        o, pkg = _obs(root), _pkg(root)
        clock = {"t": 0.0}
        backend = make_backend(pkg, n_nodes=1)
        backend.clock = lambda: clock["t"]
        backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
        clock["t"] = 50.0
        slo = o.slo.SloTracker(clock=lambda: clock["t"])
        sched = _fleet_scheduler(root, backend, identity="reborn", slo=slo)
        sched.check_pending_pods()
        snap = slo.snapshot()
        return (backend.pods[("default", "triad-0")].node,
                snap["observations_total"], snap["max_seconds"])

    ref, port = _per_package(run)
    assert port == ref
    assert port[0] is not None and port[1:] == (1, pytest.approx(50.0))


def test_slo_clock_survives_kill_restart_wave():
    """test_fleet.py:253: federation churn with kill/restart waves; the
    SLO observations of every incarnation, as the reference's."""

    def run(root):
        sim = _chaos(root, seed=5, n_nodes=6, federation=3, n_replicas=3)
        sim.run(40)
        sim.quiesce()
        total_obs = sum(v["slo"]["observations_total"]
                        for v in sim.fleet_views() if v.get("slo"))
        return (sim.stats.violations, sim.stats.restarts, total_obs,
                len(sim.base.bind_log))

    ref, port = _per_package(run)
    assert port == ref
    violations, restarts, total_obs, binds = port
    assert violations == [] and restarts > 0 and 0 < total_obs <= binds
