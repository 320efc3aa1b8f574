"""A pending set on the fake cluster backend, and one drive of the daemon.

cfg4's cell (bench.py cfg4:10kx1k-cap: ``cap_cluster`` nodes and the
``workload_mix`` pods) as the daemon meets it: nodes registered on a
``FakeClusterBackend`` with NFD labels (``make_node_labels``), groups
``default``/``edge``/``batch`` in turn, and Pending pods whose Triad
configs come from ``make_triad_config`` in workload_mix's three shapes
(1-group GPU, 1-group CPU-only, 2-group GPU), their node group cycling at
workload_mix's period. ``drive`` runs the daemon's normal turn over it.

Package-agnostic on purpose: the caller passes its package's ``sim``
module and backend, so a parity test builds the same set on the
reference and on the port. This module imports nothing.
"""

from __future__ import annotations

import time

#: cfg4's node shape (sim/workloads.py cap_cluster)
CFG4_NODE = dict(phys_cores=64, gpus_per_numa=4, nics_per_numa=7,
                 hugepages_gb=256)
GROUPS = ("default", "edge", "batch")


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


def fill_cfg4(backend, sim, n_nodes: int, n_pods: int) -> None:
    """Register *n_nodes* cfg4 nodes and create *n_pods* Pending pods on
    *backend* (no watch events: the daemon finds them on its scan)."""
    for i in range(n_nodes):
        spec = sim.SynthNodeSpec(name=f"node{i:05d}",
                                 groups=GROUPS[i % len(GROUPS)], **CFG4_NODE)
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
