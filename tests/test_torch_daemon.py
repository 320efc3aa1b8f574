"""The port's daemon core (nhd_tpu_torch/scheduler/core.py) against the
JAX daemon (nhd_tpu/scheduler/core.py) on the fake cluster backend.

Each scenario of tests/test_scheduler.py's fake-backend lifecycle
(all but the kube backend gate, :443) runs as one script through both
packages, streaming past ``NHD_STREAM_NODES`` (:157) included: the reference's ``Scheduler`` on the JAX
CPU backend and the port's ``Scheduler(device="cpu")``, each on its own
``FakeClusterBackend`` built by the same script. Both runs must end
identically — each pod's node, phase, solved config and NAD
annotations, the event reasons in order, the node mirror's free GPUs,
cores and hugepages, and the RPC replies. Two more cases drive cfg4's
pending set (sim/pending.py) at 100 nodes × 1,000 pods, with classic
rounds (the CPU's default) and with the speculative round 0 (the
card's).
"""

from __future__ import annotations

import importlib
import queue
import time
from types import SimpleNamespace

import pytest

from nhd_tpu_torch.sim import pending

PACKAGES = ("nhd_tpu", "nhd_tpu_torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    core = mod("scheduler.core")
    iface = mod("k8s.interface")
    events = mod("scheduler.events")
    port = root == "nhd_tpu_torch"

    def scheduler(backend, *args, **kw):
        if port:
            kw.setdefault("device", "cpu")
        return core.Scheduler(backend, *args, **kw)

    return SimpleNamespace(
        root=root, core=core, sim=mod("sim"), libconfig=mod("config.libconfig"),
        Backend=mod("k8s.fake").FakeClusterBackend,
        Controller=mod("scheduler.controller").Controller,
        WatchQueue=events.WatchQueue, WatchItem=events.WatchItem,
        WatchType=events.WatchType, PodStatus=core.PodStatus,
        RpcMsgType=core.RpcMsgType, Scheduler=scheduler,
        CFG=iface.CFG_ANNOTATION, NAD=iface.NAD_ANNOTATION,
    )


def make_backend(pkg, n_nodes=2, spec=None):
    backend = pkg.Backend()
    spec = spec or pkg.sim.SynthNodeSpec()
    for i in range(n_nodes):
        s = pkg.sim.SynthNodeSpec(**{**spec.__dict__, "name": f"node{i}"})
        backend.add_node(s.name, pkg.sim.make_node_labels(s),
                         hugepages_gb=s.hugepages_gb)
    return backend


def make_scheduler(pkg, backend):
    sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                          respect_busy=False)
    sched.build_initial_node_list()
    sched.load_deployed_configs()
    return sched


def pod_cfg(pkg, **kw):
    kw.setdefault("gpus_per_group", 1)
    kw.setdefault("cpu_workers", 2)
    kw.setdefault("hugepages_gb", 4)
    return pkg.sim.make_triad_config(**kw)


def _mirror(sched):
    return {
        name: (n.free_gpu_count(), tuple(n.free_cpu_cores_per_numa()),
               n.mem.free_hugepages_gb, n.total_pods(), n.active,
               n.maintenance, tuple(n.groups))
        for name, n in sorted(sched.nodes.items())
    }


def _observe(pkg, backend, sched, *, placements=True):
    """Everything both daemons must agree on after a scenario."""
    pods = {
        key: (p.node, p.phase, p.annotations.get(pkg.CFG),
              p.annotations.get(pkg.NAD))
        for key, p in sorted(backend.pods.items())
    }
    return {
        "pods": pods if placements else sorted(
            (k, v[0] is not None, v[1]) for k, v in pods.items()
        ),
        "events": [(e.pod, e.reason) for e in backend.events],
        "mirror": _mirror(sched) if placements else sorted(
            _mirror(sched).values()
        ),
        "failed": sched.failed_schedule_count,
        "scheduled": sched.perf["scheduled_total"],
    }


def _reply(sched, kind):
    reply: queue.Queue = queue.Queue()
    sched._parse_rpc_req(kind, reply)
    return reply.get_nowait()


def _pod_rows(pkg, rows):
    """POD_INFO rows with the annotations cut to the solved config and
    the NAD (the trace annotation carries a wall-clock stamp)."""
    return [
        {**r, "annotations": {k: v for k, v in r["annotations"].items()
                              if k in (pkg.CFG, pkg.NAD)}}
        for r in rows
    ]


# ---------------------------------------------------------------------------
# the scenarios of tests/test_scheduler.py, one function each
# ---------------------------------------------------------------------------


def s_end_to_end(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    pod = backend.pods[("default", "triad-0")]
    assert pod.node == "node0" and pod.phase == "Running"
    cfg = pkg.libconfig.loads(pod.annotations[pkg.CFG])
    assert all(c >= 0 for c in cfg.mods[0].dp[0].rx_cores)
    return backend, sched, {}


def s_gang_batch(pkg, mp):
    backend = make_backend(pkg, n_nodes=4)
    for i in range(8):
        backend.create_pod(f"triad-{i}", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    assert len({p.node for p in backend.pods.values()}) == 4
    return backend, sched, {}


def s_delete_releases(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    before = _mirror(sched)
    list(backend.poll_watch_events())
    backend.delete_pod("triad-0")
    pkg.Controller(backend, sched.nqueue).run_once(now=100.0)
    sched.run_once()
    assert sched.nodes["node0"].total_pods() == 0
    return backend, sched, {"before": before}


def s_restart_replay(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched1 = make_scheduler(pkg, backend)
    sched1.check_pending_pods()
    sched2 = make_scheduler(pkg, backend)
    assert _mirror(sched1) == _mirror(sched2)
    return backend, sched2, {"first": _mirror(sched1)}


def s_concurrent_commits(pkg, mp):
    mp.setattr(pkg.core, "COMMIT_WORKERS", 4)
    backend = make_backend(pkg, n_nodes=3)
    for i in range(6):
        backend.create_pod(f"gang-{i}", cfg_text=pod_cfg(pkg))
    backend.fail_bind_for.add(("default", "gang-3"))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    seqs = {
        i: [e.reason for e in backend.events if e.pod == f"gang-{i}"]
        for i in range(6)
    }
    # the pool interleaves pods' events: compare each pod's own sequence
    backend.events = []
    return backend, sched, {"seqs": seqs}


def s_missed_delete(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    backend.create_pod("triad-1", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    backend.delete_pod("triad-0", emit_watch=False)
    resets = []
    orig = sched.reset_resources
    sched.reset_resources = lambda: resets.append(1) or orig()
    sched.check_pending_pods()
    suspect = ("default", "triad-0") in sched._missing_once
    sched.check_pending_pods()
    assert not resets
    return backend, sched, {"suspect": suspect}


def s_missed_delete_recreate(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("svc-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    backend.delete_pod("svc-0", emit_watch=False)
    backend.create_pod("svc-0", cfg_text=pod_cfg(pkg), emit_watch=False)
    sched.check_pending_pods()
    st = sched.pod_state[("default", "svc-0")]
    return backend, sched, {"uid": st["uid"], "state": st["state"].name}


def s_bind_failure(pkg, mp):
    backend = make_backend(pkg, n_nodes=1)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    backend.fail_bind_for.add(("default", "triad-0"))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    st = sched.pod_state[("default", "triad-0")]["state"]
    return backend, sched, {"state": st.name}


def s_cordon_maintenance(pkg, mp):
    backend = make_backend(pkg)
    sched = make_scheduler(pkg, backend)
    ctrl = pkg.Controller(backend, sched.nqueue)
    seen = []
    steps = (
        lambda: backend.cordon_node("node0", True),
        lambda: backend.cordon_node("node0", False),
        lambda: backend.update_node_labels(
            "node0", {"sigproc.viasat.io/maintenance": "draining"}),
        lambda: backend.update_node_labels(
            "node0", {"sigproc.viasat.io/maintenance": "not_scheduled"}),
    )
    for k, step in enumerate(steps):
        step()
        ctrl.run_once(now=0.1 * k)
        sched.run_once()
        seen.append(_mirror(sched)["node0"])
    return backend, sched, {"seen": seen}


def s_group_update(pkg, mp):
    backend = make_backend(pkg)
    sched = make_scheduler(pkg, backend)
    backend.update_node_labels("node0", {"NHD_GROUP": "edge.lab"})
    pkg.Controller(backend, sched.nqueue).run_once(now=0.0)
    sched.run_once()
    assert sched.nodes["node0"].groups == ["edge", "lab"]
    return backend, sched, {}


def s_triadset_reconciliation(pkg, mp):
    backend = make_backend(pkg, n_nodes=4)
    backend.add_triadset("ts1", "default", replicas=3,
                         service_name="triad", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    ctrl = pkg.Controller(backend, sched.nqueue)
    ctrl.run_once(now=10.0)
    ctrl.run_once(now=20.0)
    for _ in range(3):
        sched.run_once()
    assert all(p.node for p in backend.pods.values())
    backend.delete_pod("triad-1")
    ctrl.run_once(now=30.0)
    return backend, sched, {}


def s_duplicate_create(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    pkg.Controller(backend, sched.nqueue).run_once(now=0.0)
    sched.run_once()
    pod = backend.pods[("default", "triad-0")]
    sched.nqueue.put(pkg.WatchItem(
        pkg.WatchType.TRIAD_POD_CREATE,
        pod={"ns": "default", "name": "triad-0", "uid": pod.uid},
    ))
    sched.run_once()
    assert sched.nodes[pod.node].total_pods() == 1
    return backend, sched, {}


def s_rpc_stats(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    return backend, sched, {
        "node_info": _reply(sched, pkg.RpcMsgType.NODE_INFO),
        "pod_info": _pod_rows(pkg, _reply(sched, pkg.RpcMsgType.POD_INFO)),
        "scheduler_info": _reply(sched, pkg.RpcMsgType.SCHEDULER_INFO),
    }


def s_unschedulable(pkg, mp):
    backend = make_backend(pkg, n_nodes=1,
                           spec=pkg.sim.SynthNodeSpec(gpus_per_numa=0))
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    assert sched.failed_schedule_count == 1
    return backend, sched, {}


def s_foreign_scheduler(pkg, mp):
    backend = make_backend(pkg)
    sched = make_scheduler(pkg, backend)
    ctrl = pkg.Controller(backend, sched.nqueue)
    backend.create_pod("other-0", cfg_text=pod_cfg(pkg),
                       scheduler_name="default-scheduler")
    ctrl.run_once(now=0.0)
    empty = sched.nqueue.empty()
    sched.check_pending_pods()
    return backend, sched, {"queue_empty": empty}


def s_targeted_delete(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    backend.create_pod("triad-1", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    resets = []
    sched.reset_resources = lambda: resets.append(1)
    list(backend.poll_watch_events())
    backend.delete_pod("triad-0")
    pkg.Controller(backend, sched.nqueue).run_once(now=100.0)
    sched.run_once()
    assert not resets
    return backend, sched, {}


def s_uncordon_needs_taint(pkg, mp):
    backend = make_backend(pkg)
    n = backend.add_node("foreign", pkg.sim.make_node_labels(
        pkg.sim.SynthNodeSpec(name="foreign")))
    n.taints = []
    sched = make_scheduler(pkg, backend)
    ctrl = pkg.Controller(backend, sched.nqueue)
    backend.cordon_node("foreign", True)
    backend.cordon_node("foreign", False)
    ctrl.run_once(now=0.0)
    while not sched.nqueue.empty():
        sched.run_once()
    assert not sched.nodes["foreign"].active
    return backend, sched, {}


def s_group_label_removal(pkg, mp):
    backend = make_backend(pkg)
    sched = make_scheduler(pkg, backend)
    ctrl = pkg.Controller(backend, sched.nqueue)
    backend.update_node_labels("node0", {"NHD_GROUP": "edge"})
    ctrl.run_once(now=0.0)
    sched.run_once()
    first = list(sched.nodes["node0"].groups)
    backend.update_node_labels("node0", {"NHD_GROUP": None})
    ctrl.run_once(now=0.1)
    sched.run_once()
    return backend, sched, {"first": first}


def s_threaded_lifecycle(pkg, mp):
    """The real thread entry points. Which pod lands on which node depends
    on how the threads interleave, so this case compares what does not:
    both pods bound, the mirror's totals, a clean stop."""
    backend = make_backend(pkg, n_nodes=2)
    backend.add_triadset("ts", "default", replicas=2,
                         service_name="live", cfg_text=pod_cfg(pkg))
    sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                          respect_busy=False)
    ctrl = pkg.Controller(backend, sched.nqueue, poll_interval=0.01)
    sched.start()
    ctrl.start()
    try:
        deadline = time.time() + 20
        while time.time() < deadline:
            if len([p for p in backend.pods.values() if p.node]) == 2:
                break
            time.sleep(0.05)
    finally:
        sched.stop()
        ctrl.stop()
        sched.join(timeout=5)
        ctrl.join(timeout=5)
    stopped = not sched.is_alive() and not ctrl.is_alive()
    backend.events = sorted(backend.events, key=lambda e: (e.pod, e.reason))
    return backend, sched, {"stopped": stopped, "placements": False}


def s_triadset_status(pkg, mp):
    backend = make_backend(pkg, n_nodes=2)
    backend.add_triadset("ts1", "default", replicas=2,
                         service_name="st", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    pkg.Controller(backend, sched.nqueue).run_once(now=10.0)
    return backend, sched, {
        "status": backend.triadsets[0]["status_replicas"],
    }


def s_run_once_rpc(pkg, mp):
    backend = make_backend(pkg)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    reply: queue.Queue = queue.Queue()
    sched.rpcq.put((pkg.RpcMsgType.SCHEDULER_INFO, reply))
    sched.run_once()
    return backend, sched, {"reply": reply.get_nowait()}


def s_streams_past_node_threshold(pkg, mp):
    """Past NHD_STREAM_NODES the daemon solves through the streaming
    tiler (one tile worker on both sides: the parity cases keep the
    tiler's threads out of the comparison)."""
    mp.setenv("NHD_STREAM_WORKERS", "1")
    mp.setattr(pkg.core, "STREAM_NODE_THRESH", 1)
    backend = make_backend(pkg, n_nodes=3)
    backend.create_pod("triad-0", cfg_text=pod_cfg(pkg))
    backend.create_pod("triad-1", cfg_text=pod_cfg(pkg))
    sched = make_scheduler(pkg, backend)
    sched.check_pending_pods()
    assert sched._stream is not None, "streaming path not engaged"
    for name in ("triad-0", "triad-1"):
        assert backend.pods[("default", name)].node is not None
    assert sched.perf["scheduled_total"] == 2
    return backend, sched, {"stream": type(sched._stream).__name__}


def s_cfg4_pending_set(pkg, mp):
    """cfg4's pending set at 100 nodes × 1,000 pods through the normal
    turn (sim/pending.py): the same binds, configs and mirror."""
    backend = pkg.Backend()
    pending.fill_cfg4(backend, pkg.sim, 100, 1000)
    sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                          respect_busy=False)
    got = pending.drive(sched)
    assert got["bound"] > 800
    return backend, sched, {"bound": got["bound"], "turns": got["turns"]}


def s_cfg4_pending_set_speculative(pkg, mp):
    """The same with round 0 the speculative megaround on both packages
    (the card's default; the reference needs its resident state forced
    on for it on the CPU backend)."""
    mp.setenv("NHD_TPU_SPECULATE", "1")
    mp.setenv("NHD_TPU_DEVICE_STATE", "1")
    stats = importlib.import_module(f"{pkg.root}.obs.jitstats").JIT_STATS

    def megarounds():
        return sum(v for k, v in stats.snapshot()["shapes"].items()
                   if k.startswith("megaround:"))

    before = megarounds()
    out = s_cfg4_pending_set(pkg, mp)
    assert megarounds() > before, "no speculative round ran"
    return out


SCENARIOS = {
    f.__name__[2:]: f for f in (
        s_end_to_end, s_gang_batch, s_delete_releases, s_restart_replay,
        s_concurrent_commits, s_missed_delete, s_missed_delete_recreate,
        s_bind_failure, s_cordon_maintenance, s_group_update,
        s_triadset_reconciliation, s_duplicate_create, s_rpc_stats,
        s_unschedulable, s_foreign_scheduler, s_targeted_delete,
        s_uncordon_needs_taint, s_group_label_removal, s_threaded_lifecycle,
        s_triadset_status, s_run_once_rpc, s_streams_past_node_threshold,
        s_cfg4_pending_set, s_cfg4_pending_set_speculative,
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_daemon_matches_the_jax_daemon(name, monkeypatch):
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        with monkeypatch.context() as mp:
            backend, sched, extra = SCENARIOS[name](pkg, mp)
        placements = extra.pop("placements", True)
        got[root] = (_observe(pkg, backend, sched, placements=placements),
                     extra)
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]


def test_port_scheduler_resolves_cuda_by_default():
    """The port's daemon defaults to the card and raises without one."""
    import torch

    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.scheduler.core import Scheduler

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler(FakeClusterBackend())


@pytest.mark.parametrize("spec, refused", [
    ("auto", False), ("off", False), ("1", False), ("none", False),
    ("2", True), ("4", True),
])
def test_port_mesh_knob_is_one_device(spec, refused):
    """``auto``/``off``/``1`` resolve to no mesh; a count above 1 raises
    until the multi-GPU slice instead of solving on one card."""
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.scheduler.core import Scheduler, resolve_mesh_spec

    if refused:
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            resolve_mesh_spec(spec)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            Scheduler(FakeClusterBackend(), mesh=spec, device="cpu")
    else:
        assert resolve_mesh_spec(spec) is None
        Scheduler(FakeClusterBackend(), mesh=spec, device="cpu")
