"""The port's fault vocabulary (nhd_tpu_torch/sim/faults.py, a verbatim
copy) and the recovery machinery it exercises, case by case from
tests/test_faults.py on the port's modules.

Every chaos run and scheduler here solves on the CPU (``device="cpu"``:
the kernels' plain versions); the seeded storms, fault tallies,
requeue semantics and counters are the reference's. Tolerance: exact
equality — every compared output is a count, a placement or text.
"""

import functools
import queue

import pytest

from nhd_tpu_torch.k8s.fake import FakeClusterBackend
from nhd_tpu_torch.k8s.interface import TransientBackendError
from nhd_tpu_torch.k8s.retry import API_COUNTERS
from nhd_tpu_torch.rpc.metrics import render_metrics
from nhd_tpu_torch.scheduler.controller import Controller
from nhd_tpu_torch.scheduler.core import REQUEUE_MAX, PodStatus, Scheduler
from nhd_tpu_torch.scheduler.events import WatchQueue
from nhd_tpu_torch.sim.chaos import ChaosSim as _ChaosSim
from nhd_tpu_torch.sim.faults import PROFILES, FaultProfile, FaultyBackend
from nhd_tpu_torch.sim.synth import SynthNodeSpec, make_node_labels, make_triad_config

#: every storm of this file solves on the CPU
ChaosSim = functools.partial(_ChaosSim, device="cpu")


# ---------------------------------------------------------------------------
# the tier-1 fault-storm case (fast: one seed, short storm; the full
# seeds × profiles matrix runs via python -m nhd_tpu_torch.sim.storm)
# ---------------------------------------------------------------------------


def test_chaos_api_fault_storm_converges():
    sim = ChaosSim(seed=1, n_nodes=4, api_faults=PROFILES["storm"])
    stats = sim.run(steps=30)
    assert stats.violations == []
    # the storm actually stormed the API layer
    fs = sim.backend.fault_stats
    assert fs["dropped_events"] > 0
    assert fs["poisoned_events"] > 0
    assert fs["transient_binds"] > 0
    # faults off → the cluster must converge: invariants still clean and
    # no pod stranded by an API fault
    sim.quiesce()
    assert stats.violations == []
    assert sim.stuck_pods() == []
    # backend state == scheduler view
    bound = {
        (p.namespace, p.name): p.node
        for p in sim.backend.pods.values() if p.node
    }
    mirrored = {
        (ns, pod): name
        for name, node in sim.sched.nodes.items()
        for (pod, ns) in node.pod_info
    }
    assert bound == mirrored


def test_chaos_churn_profile_keeps_delta_parity():
    """The churn profile (heavy event loss/poisoning
    + transient commits + structural node flaps) may cost the
    incremental cluster state full rebuilds, but NEVER a divergent
    resident state — ClusterDelta.parity_errors runs as a per-step sim
    invariant and must stay empty through storm and quiesce."""
    sim = ChaosSim(seed=2, n_nodes=4, api_faults=PROFILES["churn"])
    stats = sim.run(steps=40)
    assert stats.violations == []
    fs = sim.backend.fault_stats
    assert fs["dropped_events"] > 0 or fs["poisoned_events"] > 0
    # the incremental path actually engaged (the parity invariant is
    # not vacuous): the scheduler holds a delta-built context
    if sim.sched._delta is None:
        sim.backend.create_pod("probe", cfg_text=make_triad_config())
        sim._drive_control_plane()
    assert sim.sched._delta is not None
    assert sim.sched._delta.parity_errors() == []
    sim.quiesce()
    assert stats.violations == []
    assert sim.stuck_pods() == []


def test_chaos_delta_parity_invariant_fires_on_divergence():
    """Negative control: corrupt one resident row behind the delta's
    back — the next invariant sweep must report it (a silent invariant
    would make every churn cell vacuously green)."""
    sim = ChaosSim(seed=3, n_nodes=4)
    sim.run(steps=10)
    if sim.sched._delta is None:
        # a restart can land on the final step; one driven batch
        # re-derives the incremental context
        sim.backend.create_pod("probe", cfg_text=make_triad_config())
        sim._drive_control_plane()
    delta = sim.sched._delta
    assert delta is not None
    delta.arrays.hp_free[0] += 1  # divergence no event can explain
    sim.check_invariants()
    assert any("resident-state parity" in v for v in sim.stats.violations)


def test_chaos_heavy_profile_still_conserves():
    sim = ChaosSim(seed=5, n_nodes=4, api_faults=PROFILES["heavy"])
    stats = sim.run(steps=25)
    sim.quiesce()
    assert stats.violations == []
    assert sim.stuck_pods() == []


def test_unhardened_stack_dies_in_the_same_storm():
    """The reference's crash-only stance (no per-event isolation) cannot
    survive a poisoned watch event: the identical seeded storm that the
    hardened stack absorbs kills the controller loop."""
    profile = FaultProfile(name="poison", poison_watch_event=1.0)
    sim = ChaosSim(seed=1, n_nodes=4, api_faults=profile, hardened=False)
    with pytest.raises(TypeError):
        sim.run(steps=10)
    # sanity: hardened, the same storm is survivable
    sim2 = ChaosSim(seed=1, n_nodes=4, api_faults=profile, hardened=True)
    stats = sim2.run(steps=10)
    assert stats.violations == []
    assert sim2.backend.fault_stats["poisoned_events"] >= 10


def test_fault_counters_visible_via_metrics_plane():
    API_COUNTERS.reset()
    sim = ChaosSim(seed=1, n_nodes=4, api_faults=PROFILES["storm"])
    sim.run(steps=30)
    sim.quiesce()
    out = render_metrics([], failed_count=0)
    # the layer's own observability rides the same exposition format
    assert "# TYPE nhd_bind_requeues_total counter" in out
    assert "# TYPE nhd_controller_event_errors_total counter" in out
    assert "# TYPE nhd_api_circuit_state gauge" in out
    snap = API_COUNTERS.snapshot()
    assert snap["bind_requeues_total"] > 0
    assert snap["controller_event_errors_total"] > 0
    assert f"nhd_bind_requeues_total {snap['bind_requeues_total']}" in out


# ---------------------------------------------------------------------------
# transient-commit requeue semantics (scheduler/core.py)
# ---------------------------------------------------------------------------


def _stack(n_nodes=2):
    backend = FakeClusterBackend()
    for i in range(n_nodes):
        spec = SynthNodeSpec(name=f"node{i}")
        backend.add_node(
            spec.name, make_node_labels(spec), hugepages_gb=spec.hugepages_gb
        )
    sched = Scheduler(backend, WatchQueue(), queue.Queue(), respect_busy=False,
                      device="cpu")
    ctrl = Controller(backend, sched.nqueue)
    sched.build_initial_node_list()
    return backend, sched, ctrl


def _drive(sched, ctrl, rounds=8):
    for _ in range(rounds):
        ctrl.run_once(now=0.0)
        while not sched.nqueue.empty():
            sched.run_once()


def test_transient_bind_requeues_and_lands():
    backend, sched, ctrl = _stack()
    faulty = FaultyBackend(
        backend, FaultProfile(name="t", transient_bind=1.0)
    )
    sched.backend = faulty  # scheduler commits through the fault shim
    backend.create_pod("p1", cfg_text=make_triad_config())
    _drive(sched, ctrl)
    pod = backend.pods[("default", "p1")]
    assert pod.node is not None              # second attempt bound it
    assert faulty.fault_stats["transient_binds"] == 1
    assert sched.failed_schedule_count == 0  # never marked failed
    assert sched.pod_state[("default", "p1")]["state"] is PodStatus.SCHEDULED
    assert sched._requeue_attempts == {}     # budget cleared on success


def test_requeue_budget_exhaustion_fails_the_pod():
    """A backend that NEVER stops failing transiently must not spin the
    scheduler forever: after REQUEUE_MAX requeues the pod takes the
    terminal-failure path (and the periodic reconcile still owns later
    retries at its own cadence)."""
    backend, sched, ctrl = _stack()

    class AlwaysTransient(FaultyBackend):
        def bind_pod_to_node(self, pod, node, ns):
            self.fault_stats["transient_binds"] += 1
            raise TransientBackendError("injected: permanently flaky")

    faulty = AlwaysTransient(backend, FaultProfile(name="t"))
    sched.backend = faulty
    backend.create_pod("p1", cfg_text=make_triad_config())
    _drive(sched, ctrl, rounds=REQUEUE_MAX + 4)
    assert backend.pods[("default", "p1")].node is None
    assert sched.pod_state[("default", "p1")]["state"] is PodStatus.FAILED
    assert sched.failed_schedule_count >= 1
    # attempts: 1 initial + REQUEUE_MAX requeues, then the budget tripped
    assert faulty.fault_stats["transient_binds"] == REQUEUE_MAX + 1


def test_transient_annotate_also_requeues():
    backend, sched, ctrl = _stack()
    faulty = FaultyBackend(
        backend, FaultProfile(name="t", transient_annotate=1.0)
    )
    sched.backend = faulty
    backend.create_pod("p1", cfg_text=make_triad_config())
    _drive(sched, ctrl)
    assert backend.pods[("default", "p1")].node is not None
    assert faulty.fault_stats["transient_annotates"] == 1
    assert sched.failed_schedule_count == 0


def test_scheduler_loop_survives_backend_outage():
    """An ApiException that survives the retry layer (outage past the
    deadline / open circuit) escaping the periodic scan must not kill the
    scheduler loop; the mirror is rebuilt once the backend recovers."""
    from nhd_tpu_torch.k8s.restclient import ApiException
    import nhd_tpu_torch.scheduler.core as core_mod

    API_COUNTERS.reset()
    backend, sched, ctrl = _stack()
    backend.create_pod("p1", cfg_text=make_triad_config())
    _drive(sched, ctrl)
    assert backend.pods[("default", "p1")].node is not None

    def down(scheduler):
        raise ApiException(status=0, reason="circuit breaker open")

    backend.service_pods = down  # total outage on the list path
    # idle path reaches the periodic scan with the backend down — the
    # pass is isolated instead of propagating out of run_once
    idle = sched.run_once(idle_count=core_mod.IDLE_CNT_THRESH - 1)
    assert idle == 0
    assert API_COUNTERS.get("scheduler_loop_errors_total") == 1
    assert sched._mirror_dirty is True

    del backend.service_pods  # the API server comes back
    backend.create_pod("p2", cfg_text=make_triad_config())
    _drive(sched, ctrl)
    # the loop kept running, rebuilt the mirror, and scheduling resumed
    assert backend.pods[("default", "p2")].node is not None
    assert sched._mirror_dirty is False
    assert sched.nodes[backend.pods[("default", "p1")].node].pod_present(
        "p1", "default"
    )


# ---------------------------------------------------------------------------
# controller event isolation
# ---------------------------------------------------------------------------


def test_poisoned_event_is_isolated_and_counted():
    API_COUNTERS.reset()
    backend, sched, ctrl = _stack()
    faulty = FaultyBackend(
        backend, FaultProfile(name="p", poison_watch_event=1.0)
    )
    ctrl.backend = faulty
    backend.create_pod("p1", cfg_text=make_triad_config())
    _drive(sched, ctrl, rounds=2)
    # the poisoned event was dropped, the real create event still landed
    assert backend.pods[("default", "p1")].node is not None
    assert API_COUNTERS.get("controller_event_errors_total") >= 1


def test_unisolated_controller_raises():
    backend, sched, _ = _stack()
    ctrl = Controller(backend, sched.nqueue, isolate_events=False)
    faulty = FaultyBackend(
        backend, FaultProfile(name="p", poison_watch_event=1.0)
    )
    ctrl.backend = faulty
    backend.create_pod("p1", cfg_text=make_triad_config())
    with pytest.raises(TypeError):
        ctrl.run_once(now=0.0)


# ---------------------------------------------------------------------------
# solver data-plane injector (sim/faults.py DeviceFaultInjector)
# ---------------------------------------------------------------------------


def test_device_injector_sites_and_step_budget():
    """Exceptions route by site under the per-step budget; slow
    dispatches sleep without consuming it."""
    import random

    from nhd_tpu_torch.sim.faults import DeviceFaultInjector
    from nhd_tpu_torch.solver.guard import InjectedDeviceFault

    sleeps = []
    inj = DeviceFaultInjector(
        FaultProfile(
            name="d", device_dispatch_error=1.0, device_upload_error=1.0,
            device_slow_dispatch=1.0, slow_seconds=0.01,
            device_faults_per_step=2,
        ),
        random.Random(0), sleep=sleeps.append,
    )
    with pytest.raises(InjectedDeviceFault, match="dispatch"):
        inj("dispatch", "G1")
    with pytest.raises(InjectedDeviceFault, match="upload"):
        inj("upload", "scatter")
    # budget spent: further calls are quiet (the guard's bounded
    # retries then provably absorb the step)
    inj("dispatch", "G1")
    inj("megaround", "B1")
    assert inj.stats["dispatch_errors"] == 1
    assert inj.stats["upload_errors"] == 1
    # slow dispatches fired on every call, budget-independent
    assert len(sleeps) == 4 and all(s == 0.01 for s in sleeps)
    inj.begin_step()
    with pytest.raises(InjectedDeviceFault):
        inj("megaround", "B1")
    # unknown sites and disabled injectors never raise
    inj.begin_step()
    inj("unknown-site", "x")
    inj.enabled = False
    inj("dispatch", "G1")
    assert inj.stats["dispatch_errors"] == 1


def test_device_profile_classification_and_registry():
    """The device-faults preset storms ONLY the data plane (API-fault
    fields zero — bind parity with a fault-free run depends on it) and
    its injected exception classifies transient."""
    from nhd_tpu_torch.sim.faults import PROFILES
    from nhd_tpu_torch.solver.guard import (
        InjectedDeviceFault, classify_device_fault,
    )

    p = PROFILES["device-faults"]
    assert p.has_device_faults()
    assert p.drop_watch_event == p.poison_watch_event == 0.0
    assert p.transient_bind == p.transient_annotate == 0.0
    assert not FaultProfile(name="api", transient_bind=0.5).has_device_faults()
    assert classify_device_fault(InjectedDeviceFault("x"))
