"""A pending set on the fake cluster backend, and one drive of the daemon.

cfg4's cell (bench.py cfg4:10kx1k-cap: ``cap_cluster`` nodes and the
``workload_mix`` pods) as the daemon meets it: nodes registered on a
``FakeClusterBackend`` with NFD labels (``make_node_labels``), groups
``default``/``edge``/``batch`` in turn, and Pending pods whose Triad
configs come from ``make_triad_config`` in workload_mix's three shapes
(1-group GPU, 1-group CPU-only, 2-group GPU), their node group cycling at
workload_mix's period. ``drive`` runs the daemon's normal turn over it.

Beside it, the slice's inputs copied from bench.py's later legs: the
two-generation split of cfg8:hetero (``hetero_class``,
``HETERO_MATRIX``), its tiered-preemption micro-cell
(``preempt_micro_cell``) and tier-2 preemptors at cfg4's width
(``create_preemptors``), and cfg7-churn's seeded event mix
(``churn_script``, ``apply_events``, ``churn_turn``), applied through the
backend so the daemon meets each event on its inventory and watch path.

Package-agnostic on purpose: the caller passes its package's ``sim``
module and backend, so a parity test builds the same set on the
reference and on the port. This module imports nothing.
"""

from __future__ import annotations

import random
import time

#: cfg4's node shape (sim/workloads.py cap_cluster)
CFG4_NODE = dict(phys_cores=64, gpus_per_numa=4, nics_per_numa=7,
                 hugepages_gb=256)
GROUPS = ("default", "edge", "batch")
#: cfg8:hetero's throughput matrix (bench.py:716-719): the gen-a
#: generation twice gen-b's throughput for either workload kind
HETERO_MATRIX = {"gpu": {"gen-a": 1.0, "gen-b": 0.5},
                 "cpu": {"gen-a": 1.0, "gen-b": 0.5}}
#: the node labels the daemon reads (core/node.py MAINTENANCE_LABEL,
#: scheduler/controller.py NHD_GROUP_LABEL)
MAINTENANCE_LABEL = "sigproc.viasat.io/maintenance"
GROUP_LABEL = "NHD_GROUP"
#: cfg7-churn's event mix (bench.py:293-307), as cumulative bounds of one
#: uniform draw: creates 30%, deletes of bound pods 30%, cordon toggles
#: 16%, maintenance toggles 16%, group moves within the interned set 8%
CHURN_MIX = (("create", 0.30), ("delete", 0.60), ("cordon", 0.76),
             ("maint", 0.92), ("group", 1.0))


def pod_configs(make_triad_config):
    """Triad config texts of workload_mix's three pod shapes."""
    return (
        make_triad_config(n_groups=1, gpus_per_group=1, cpu_workers=2,
                          rx_gbps=10.0, tx_gbps=5.0, hugepages_gb=2),
        make_triad_config(n_groups=1, gpus_per_group=0, cpu_workers=4,
                          rx_gbps=20.0, tx_gbps=10.0, hugepages_gb=2),
        make_triad_config(n_groups=2, gpus_per_group=1, cpu_workers=1,
                          rx_gbps=10.0, tx_gbps=5.0, hugepages_gb=4),
    )


def hetero_class(i: int, n_nodes: int) -> str:
    """Node *i*'s generation in cfg8:hetero's fleet (bench.py:721-731):
    the slow ``gen-b`` on the first half, so the uniform ranking's
    low-node-index tiebreak prefers it, ``gen-a`` on the rest."""
    return "gen-b" if i < n_nodes // 2 else "gen-a"


def fill_cfg4(backend, sim, n_nodes: int, n_pods: int, *,
              node_class=None) -> None:
    """Register *n_nodes* cfg4 nodes and create *n_pods* Pending pods on
    *backend* (no watch events: the daemon finds them on its scan). With
    *node_class* (``hetero_class``), node i carries
    ``node_class(i, n_nodes)`` as its NHD_NODE_CLASS label."""
    for i in range(n_nodes):
        spec = sim.SynthNodeSpec(
            name=f"node{i:05d}", groups=GROUPS[i % len(GROUPS)],
            node_class=node_class(i, n_nodes) if node_class else "",
            **CFG4_NODE)
        backend.add_node(spec.name, sim.make_node_labels(spec),
                         hugepages_gb=spec.hugepages_gb)
    cfgs = pod_configs(sim.make_triad_config)
    for i in range(n_pods):
        backend.create_pod(
            f"pod-{i:05d}", cfg_text=cfgs[i % len(cfgs)],
            groups=GROUPS[(i // len(cfgs)) % len(GROUPS)], emit_watch=False,
        )


def drive(sched, max_turns: int = 16) -> dict:
    """The daemon's normal turn until the pending set settles: the node
    inventory and replay (``build_initial_node_list``,
    ``load_deployed_configs``), then ``check_pending_pods`` scans —
    each one batch — until a scan binds nothing more, draining the watch
    queue with ``run_once`` between scans. Returns the turn count and
    the wall of the scans."""
    sched.build_initial_node_list()
    sched.load_deployed_configs()
    turns = 0
    t0 = time.perf_counter()
    bound = -1
    while turns < max_turns:
        sched.check_pending_pods()
        turns += 1
        while not sched.nqueue.empty():
            sched.run_once()
            turns += 1
        now = sched.perf["scheduled_total"]
        if now == bound:
            break
        bound = now
    return {"turns": turns, "wall": time.perf_counter() - t0,
            "bound": int(sched.perf["scheduled_total"])}


def create_preemptors(backend, sim, n: int, *, tier: int = 2,
                      prefix: str = "tier2") -> list:
    """*n* Pending pods of tier *tier* in workload_mix's largest shape
    (the 2-group GPU pod), groups cycling as ``fill_cfg4``'s: the
    preemptors bench.py's micro-cell submits (bench.py:685-689) at cfg4's
    width. Returns their (pod, ns, uid) for
    ``Scheduler.attempt_scheduling_batch``."""
    cfg = pod_configs(sim.make_triad_config)[2]
    out = []
    for i in range(n):
        p = backend.create_pod(f"{prefix}-{i:04d}", cfg_text=cfg,
                               groups=GROUPS[i % len(GROUPS)], tier=tier,
                               emit_watch=False)
        out.append((p.name, p.namespace, p.uid))
    return out


def preempt_batch(sched, pods, max_turns: int = 64) -> list:
    """Admit *pods* as one batch, then drain the watch queue (the
    requeued preemptors and victims) with ``run_once`` until it is empty,
    as bench.py:690-692 does. Returns, for the first batch and each
    drained turn, the evictions it executed by namespace (the eviction
    budget is per batch, nhd policy/preempt.py)."""
    log = sched.backend.evict_log

    def evicted(since):
        by_ns: dict = {}
        for ev in log[since:]:
            by_ns[ev[0]] = by_ns.get(ev[0], 0) + 1
        return by_ns

    n0 = len(log)
    sched.attempt_scheduling_batch(pods)
    per_batch = [evicted(n0)]
    for _ in range(max_turns):
        if sched.nqueue.empty():
            break
        n0 = len(log)
        sched.run_once()
        per_batch.append(evicted(n0))
    return per_batch


def preempt_micro_cell(backend, sim, scheduler) -> int:
    """bench.py:667-692, the tiered-preemption micro-cell: 2 nodes of 8 GB
    hugepages filled by 5 tier-0 pods, then 2 tier-2 pods of the same
    shape. *scheduler(backend)* builds the caller's package's Scheduler
    over *backend*. Returns the fenced evictions executed."""
    for i in range(2):
        spec = sim.SynthNodeSpec(name=f"pre{i:04d}", hugepages_gb=8)
        backend.add_node(spec.name, sim.make_node_labels(spec),
                         hugepages_gb=spec.hugepages_gb)
    sched = scheduler(backend)
    sched.build_initial_node_list()
    cfg = sim.make_triad_config(cpu_workers=2, hugepages_gb=4)
    low = []
    for i in range(5):
        p = backend.create_pod(f"low{i}", cfg_text=cfg, tier=0)
        low.append((p.name, p.namespace, p.uid))
    sched.attempt_scheduling_batch(low)
    high = []
    for i in range(2):
        p = backend.create_pod(f"high{i}", cfg_text=cfg, tier=2)
        high.append((p.name, p.namespace, p.uid))
    sched.attempt_scheduling_batch(high)
    for _ in range(16):
        if sched.nqueue.empty():
            break
        sched.run_once()
    return len(backend.evict_log)


def churn_script(seed: int, turns: int, per_turn: int, n_nodes: int,
                 groups=GROUPS) -> list:
    """cfg7-churn's event stream (bench.py:293-307), drawn ahead of the
    run from ``random.Random(seed)`` in its mix (``CHURN_MIX``), cut into
    *turns* lists of *per_turn* events: ("create", i), ("delete", u)
    (u in [0, 1) picks among the pods bound when it applies), ("cordon",
    node), ("maint", node), ("group", node, group), nodes by index."""
    rng = random.Random(seed)
    script, seq = [], 0
    for _ in range(turns):
        events = []
        for _ in range(per_turn):
            roll = rng.random()
            if roll < CHURN_MIX[0][1]:
                events.append(("create", seq))
                seq += 1
            elif roll < CHURN_MIX[1][1]:
                events.append(("delete", rng.random()))
            elif roll < CHURN_MIX[2][1]:
                events.append(("cordon", rng.randrange(n_nodes)))
            elif roll < CHURN_MIX[3][1]:
                events.append(("maint", rng.randrange(n_nodes)))
            else:
                events.append(("group", rng.randrange(n_nodes),
                               rng.choice(groups)))
        script.append(events)
    return script


def apply_events(backend, sim, events) -> dict:
    """Apply one turn of ``churn_script`` through *backend*: a create is a
    Pending Triad pod of workload_mix's shapes (found by the daemon's
    scan, as ``fill_cfg4``'s), a delete removes a bound pod with its watch
    event, a cordon flips the node's unschedulable flag, a maintenance
    toggle sets or clears the maintenance label, a group move sets the
    node's group label (each a node watch event). Returns the events
    applied by kind (a delete with no bound pod is a no-op, as in
    bench.py)."""
    cfgs = pod_configs(sim.make_triad_config)
    names = sorted(backend.nodes)
    done: dict = {}
    for ev in events:
        kind = ev[0]
        if kind == "create":
            i = ev[1]
            backend.create_pod(
                f"churn-{i:05d}", cfg_text=cfgs[i % len(cfgs)],
                groups=GROUPS[(i // len(cfgs)) % len(GROUPS)],
                emit_watch=False)
        elif kind == "delete":
            bound = sorted(k for k, p in backend.pods.items() if p.node)
            if not bound:
                continue
            ns, name = bound[min(int(ev[1] * len(bound)), len(bound) - 1)]
            backend.delete_pod(name, ns)
        elif kind == "cordon":
            name = names[ev[1]]
            backend.cordon_node(name, not backend.nodes[name].unschedulable)
        elif kind == "maint":
            name = names[ev[1]]
            on = backend.nodes[name].labels.get(MAINTENANCE_LABEL)
            backend.update_node_labels(name, {
                MAINTENANCE_LABEL: None if on not in (None, "not_scheduled")
                else "draining"})
        else:
            backend.update_node_labels(names[ev[1]], {GROUP_LABEL: ev[2]})
        done[kind] = done.get(kind, 0) + 1
    return done


def churn_turn(sched, controller, now: float) -> int:
    """One turn of the daemon after a turn's events: the controller
    translates the backend's watch events into the scheduler's queue,
    ``run_once`` drains it (pod deletes, cordons, maintenance and group
    moves, each a row patch of the persistent state), then one
    ``check_pending_pods`` scan batches every Pending pod and the queue
    is drained again. Returns the pods bound in the turn."""
    before = sched.perf["scheduled_total"]
    controller.run_once(now=now)
    while not sched.nqueue.empty():
        sched.run_once()
    sched.check_pending_pods()
    while not sched.nqueue.empty():
        sched.run_once()
    return int(sched.perf["scheduled_total"] - before)
