"""Process harness: spawn controller + scheduler + RPC threads, watch them.

Equivalent of the reference's bin/nhd entry script (bin/nhd:18-65): three
threads, two queues, and a 1 Hz liveness watchdog that kills the process if
any thread dies — crash-only; the Deployment restarts us and state replays
from pod annotations (README.md:85-87).

The port's version solves on ``--device`` (default ``cuda``): a CUDA
request on a machine without a usable GPU exits non-zero before any
thread starts, and ``--device cpu`` runs the kernels' plain versions.

Usage:
    nhd-tpu-torch                      # real cluster, on the GPU
    nhd-tpu-torch --fake --device cpu  # in-memory backend (demo/smoke)
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import time

from nhd_tpu_torch import __version__
from nhd_tpu_torch.device import resolve_device
from nhd_tpu_torch.scheduler.controller import Controller
from nhd_tpu_torch.scheduler.core import Scheduler
from nhd_tpu_torch.utils import get_logger


def build_threads(
    backend,
    *,
    rpc_port: int = 45655,
    metrics_port: int = 0,
    respect_busy: bool = True,
    trace_dir=None,
    ha_identity=None,
    shards: int = 1,
    shard_peers=None,
    on_demote=None,
    mesh=None,
    device="cuda",
):
    """Wire up the thread set for a backend; returns (threads, rpc_queue).

    With ``ha_identity`` set the replica runs in HA mode (k8s/lease.py):
    it starts as a STANDBY — watching, keeping its node mirror warm, but
    not acting — until the lease keeper wins the election; every commit
    is then stamped with the fencing epoch, and the stall watchdog
    releases the lease + exits crash-only if the scheduling loop wedges,
    so the other replica takes over within one renew interval.

    With ``shards`` > 1 the replica joins a SHARDED FEDERATION instead
    (k8s/lease.py ShardedElector): the node-group set is partitioned
    across ``shards`` leases, this replica rendezvous-leases a subset
    (handing shards over as peers in ``shard_peers`` come and go), every
    commit is fenced by the epoch of the shard owning the target node,
    and pods no owned shard can place spill to the untried shards
    (docs/RESILIENCE.md "Federation")."""
    from nhd_tpu_torch.ingress import AdmissionQueue

    # the daemon's watch plane runs behind the admission front door
    # (nhd_tpu/ingress/): per-tenant bounded lanes, weighted fair
    # dequeue, and the NHD_ADMIT_* load-shed ladder. NHD_ADMIT=0 keeps
    # it a pass-through FIFO.
    watch_q = AdmissionQueue()
    rpc_q: queue.Queue = queue.Queue(maxsize=128)  # reference: bin/nhd:21

    elector = None
    sharded = None
    if shards > 1:
        from nhd_tpu_torch.k8s.lease import ShardedElector

        sharded = ShardedElector(
            backend, identity=ha_identity,
            peers=shard_peers or [ha_identity], n_shards=shards,
            on_demote=on_demote,
        )
    elif ha_identity:
        from nhd_tpu_torch.k8s.lease import LeaderElector

        elector = LeaderElector(
            backend, identity=ha_identity, on_demote=on_demote
        )

    scheduler = Scheduler(
        backend, watch_q, rpc_q, respect_busy=respect_busy,
        elector=elector, sharded=sharded, mesh=mesh, device=device,
    )
    controller = Controller(backend, watch_q, elector=sharded or elector)
    threads = [controller, scheduler]

    if sharded is not None or elector is not None:
        from nhd_tpu_torch.k8s.lease import LeaseKeeper, StallWatchdog

        # the keeper ticks either elector flavor (same tick()/step_down()
        # protocol); the watchdog's release covers EVERY held shard
        active = sharded or elector
        threads.append(LeaseKeeper(active))
        threads.append(StallWatchdog(
            lambda: scheduler.last_heartbeat, elector=active
        ))

    try:
        from nhd_tpu_torch.rpc.server import StatsRpcServer

        threads.append(StatsRpcServer(rpc_q, port=rpc_port))
    except ImportError as exc:
        get_logger(__name__).warning(f"stats RPC plane disabled: {exc}")

    if metrics_port:
        from nhd_tpu_torch.rpc.metrics import MetricsServer

        threads.append(MetricsServer(
            rpc_q, port=metrics_port, trace_dir=trace_dir, backend=backend
        ))

    return threads, rpc_q


def make_fake_backend():
    """The canonical 4-node demo cluster — shared by `--fake` scheduling
    and `--fake --explain` so both see the same cluster."""
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node_labels

    backend = FakeClusterBackend()
    for i in range(4):
        spec = SynthNodeSpec(name=f"sim-node{i}")
        backend.add_node(spec.name, make_node_labels(spec),
                         hugepages_gb=spec.hugepages_gb)
    return backend


def explain_main(args, backend=None, device="cuda") -> int:
    """`nhd-tpu --explain cfg.txt` / `--explain-pod ns/pod`: why does or
    doesn't this workload schedule?

    Builds the node mirror exactly like the scheduler would (labels +
    hugepages from the backend) and prints each node's first failing
    predicate — the structured version of the reference's grep-the-logs
    debugging workflow (reference README.md:161-171). ``backend`` is
    injectable for tests; by default it is built from the flags.
    """
    from nhd_tpu_torch.config.parser import get_cfg_parser, registered_cfg_types
    from nhd_tpu_torch.core.request import PodRequest
    from nhd_tpu_torch.scheduler.core import Scheduler
    from nhd_tpu_torch.solver.explain import explain

    if args.explain and args.cfg_type not in registered_cfg_types():
        # a diagnostics tool must not fall back to the wrong parser and
        # then blame the user's config
        print(f"unknown --cfg-type {args.cfg_type!r}; registered: "
              + ", ".join(registered_cfg_types()))
        return 1

    if backend is None:
        if args.fake:
            backend = make_fake_backend()
        else:
            from nhd_tpu_torch.k8s.kube import KubeClusterBackend

            backend = KubeClusterBackend(start_watches=False)

    sched = Scheduler(backend, device=device)
    sched.build_initial_node_list()
    sched.load_deployed_configs()   # mirror reflects current claims

    live_pod = None
    if args.explain_pod:
        # live-pod mode: read the stuck pod's own ConfigMap, cfg-type and
        # groups — exactly the inputs the scheduler would use
        # (Scheduler._prepare_item), minus its event side effects
        ns, _, pod = args.explain_pod.rpartition("/")
        ns = ns or "default"
        if not backend.pod_exists(pod, ns):
            print(f"pod {ns}/{pod} not found")
            return 1
        _, cfg_text = backend.get_cfg_map(pod, ns)
        if cfg_text is None:
            print(f"pod {ns}/{pod} has no readable ConfigMap — the "
                  "scheduler fails this pod with FailedCfgParse")
            return 1
        cfg_type = backend.get_cfg_type(pod, ns)
        groups = frozenset(backend.get_pod_node_groups(pod, ns))
        live_pod = (pod, ns)
    else:
        groups = frozenset(
            g.strip() for g in args.groups.split(",") if g.strip()
        ) or frozenset({"default"})
        cfg_text = None
        cfg_type = args.cfg_type
    try:
        if cfg_text is None:
            with open(args.explain) as fh:
                cfg_text = fh.read()
        parser = get_cfg_parser(cfg_type, cfg_text)
        top = parser.to_topology(False)
        if top is None:
            raise ValueError(
                f"the {cfg_type!r} parser found no usable topology "
                "(see the parse error above)"
            )
        if live_pod is not None:
            # pod-spec hugepage requests override the config's figure,
            # like the scheduler's reservation fold-in (core.py
            # _prepare_item → _pod_reservations)
            top.add_pod_reservations(sched._pod_reservations(*live_pod))
        req = PodRequest.from_topology(top, node_groups=groups)
    except OSError as exc:
        print(f"cannot read config: {exc}")
        return 1
    except Exception as exc:
        # the tool exists to diagnose broken configs — a parse failure is
        # itself the diagnosis, not a traceback (the scheduler fails such
        # pods the same way, scheduler/core.py::_parse_pod_config)
        print(f"config does not parse (the scheduler would fail this "
              f"pod with FailedCfgParse): {exc}")
        return 1
    print(explain(sched.nodes, req).render())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="nhd_tpu_torch scheduler")
    parser.add_argument("--fake", action="store_true",
                        help="use the in-memory backend (demo mode)")
    parser.add_argument("--device", default="cuda",
                        help="the device the solver runs on: 'cuda' "
                             "(default; exits non-zero without a usable "
                             "GPU) or 'cpu' (the kernels' plain versions)")
    parser.add_argument("--rpc-port", type=int, default=45655)
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="Prometheus /metrics port (0 = disabled)")
    parser.add_argument("--explain", metavar="CFGFILE",
                        help="diagnose why this Triad config does or "
                             "doesn't schedule, then exit")
    parser.add_argument("--explain-pod", metavar="[NS/]POD",
                        help="diagnose a pod already in the cluster "
                             "(reads its own ConfigMap and node-groups)")
    parser.add_argument("--groups", default="default",
                        help="pod node-groups for --explain (comma-sep)")
    parser.add_argument("--cfg-type", default="triad",
                        help="config format for --explain files "
                             "(registered cfg_type, e.g. triad or json)")
    parser.add_argument("--ha", action="store_true",
                        help="lease-based leader election for 2+ replicas: "
                             "start as standby, act only while holding the "
                             "lease, fence every commit with the epoch "
                             "(docs/RESILIENCE.md 'HA & fencing')")
    parser.add_argument("--ha-identity", default=None,
                        help="this replica's holder identity for the lease "
                             "(default: <hostname>-<pid>)")
    parser.add_argument("--shards", type=int,
                        default=int(os.environ.get("NHD_SHARDS", "1")),
                        help="shard the node-group set across S federated "
                             "leases; this replica rendezvous-leases a "
                             "subset and fences every commit with the "
                             "owning shard's epoch. 1 = no federation "
                             "(docs/RESILIENCE.md 'Federation')")
    parser.add_argument("--shard-replicas", default=None,
                        help="comma-separated identities of ALL federation "
                             "replicas (including this one) — the peer set "
                             "the deterministic rendezvous shard assignment "
                             "and handoff protocol run over; requires "
                             "--shards > 1 and a stable --ha-identity")
    parser.add_argument("--mesh", default=os.environ.get("NHD_MESH", "auto"),
                        help="node-sharded solve posture: 'auto' "
                             "(default — shard the node tensors, the solve "
                             "and the megaround over every local GPU when "
                             "more than one exists), an explicit GPU count "
                             "N (at most the local GPUs), or 'off' to force "
                             "single-device solves (env NHD_MESH)")
    parser.add_argument("--prewarm", action="store_true",
                        help="before serving, build any missing kernel "
                             "library, load all of them and run the kernels "
                             "once at every shape the cache's manifest "
                             "holds (NHDC_AOT_DIR); shapes first seen while "
                             "serving are recorded for the next restart "
                             "(solver/aot.py)")
    parser.add_argument("--run-seconds", type=float, default=0,
                        help="exit cleanly after N seconds with a summary "
                             "(demo/smoke runs; 0 = run forever)")
    parser.add_argument("--trace-out", metavar="DIR", default=None,
                        help="enable the flight recorder and write Chrome "
                             "trace JSON here (dump triggers: clean exit, "
                             "and GET /trace?save=1 on the metrics port; "
                             "ring size via NHD_TRACE_CAPACITY)")
    parser.add_argument("--journal", metavar="DIR", default=None,
                        help="record the lossless event journal here for "
                             "deterministic replay (also via NHD_JOURNAL=1 "
                             "+ NHD_JOURNAL_DIR; finalized on clean exit — "
                             "docs/OBSERVABILITY.md 'Record/replay')")
    parser.add_argument("--replay", metavar="JOURNAL[,JOURNAL...]",
                        default=None,
                        help="replay recorded journal(s) against the real "
                             "scheduling path on a sim clock, print the "
                             "divergence diff, and exit (non-zero on "
                             "divergence; full CLI: tools/trace_replay.py)")
    args = parser.parse_args(argv)

    logger = get_logger(__name__)
    logger.warning(f"nhd_tpu_torch version {__version__}")

    if args.prewarm:
        # recording turns on now; the prewarm itself runs AFTER the
        # thread set is built (below) so each artifact can advance the
        # scheduler's heartbeat — a long prewarm must never read as a
        # wedged loop to the stall watchdog
        from nhd_tpu_torch.solver import aot

        aot.configure(save=True)

    # the device is resolved once, here, before any thread exists: a
    # CUDA request without a usable GPU ends the process with the error
    # instead of carrying on on the CPU, or killing the scheduler
    # thread and tripping the liveness watchdog below
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"nhd_tpu_torch: {exc}", file=sys.stderr)
        return 1
    logger.warning(f"solver device: {device}")

    trace_capacity = int(os.environ.get("NHD_TRACE_CAPACITY", "16384"))
    if args.trace_out:
        from nhd_tpu_torch import obs

        obs.enable(capacity=trace_capacity)
        logger.warning(f"flight recorder on; traces → {args.trace_out}")

    if args.replay:
        from nhd_tpu_torch.sim.replay import replay_journal

        paths = [p.strip() for p in args.replay.split(",") if p.strip()]
        try:
            result = replay_journal(paths, device=device)
        except (OSError, ValueError) as exc:
            print(f"replay failed: {exc}")
            return 1
        out_dir = args.journal or os.environ.get(
            "NHD_JOURNAL_DIR", "artifacts/journal"
        )
        report = result.write_report(out_dir)
        print(f"replayed {len(result.replayed)} decisions against "
              f"{len(result.recorded)} recorded; "
              f"{len(result.divergences)} divergence(s); report → {report}")
        if result.knob_drift:
            print(f"knob drift vs recorded genesis: "
                  + ", ".join(sorted(result.knob_drift)))
        first = result.first_divergence
        if first is not None:
            print(f"first divergence: corr={first.get('corr')} "
                  f"pod={first['ns']}/{first['pod']} {first['kind']}")
        return 1 if result.diverged else 0

    if args.explain or args.explain_pod:
        return explain_main(args, device=device)

    if args.fake:
        from nhd_tpu_torch.sim import make_triad_config

        # demo cluster: 4 synthetic nodes + a 6-replica TriadSet, so the
        # harness visibly discovers, reconciles, and binds
        backend = make_fake_backend()
        backend.add_triadset(
            "demo", "default", replicas=6, service_name="triad",
            cfg_text=make_triad_config(gpus_per_group=1, cpu_workers=2),
        )
    else:
        from nhd_tpu_torch.k8s.kube import KubeClusterBackend

        backend = KubeClusterBackend()

    ha_identity = None
    shard_peers = None
    if args.ha or args.shards > 1:
        import socket

        ha_identity = args.ha_identity or f"{socket.gethostname()}-{os.getpid()}"
        if args.trace_out:
            from nhd_tpu_torch import obs

            # re-install the ring with this replica's identity stamped
            # on every span (nothing has recorded yet — threads start
            # below): merged cross-replica journeys attribute each leg
            # by it (obs/chrome.py merge_chrome_traces)
            obs.enable(capacity=trace_capacity, identity=ha_identity)
    if args.shards > 1:
        shard_peers = sorted(
            {p.strip() for p in (args.shard_replicas or "").split(",")
             if p.strip()} | {ha_identity}
        )
        if not args.ha_identity:
            # a pid-derived identity changes every restart, which would
            # churn the rendezvous assignment for the whole federation
            logger.warning(
                "federation without --ha-identity: using the volatile "
                f"{ha_identity}; set a stable identity per replica"
            )
        logger.warning(
            f"federation mode: {args.shards} shard leases over replicas "
            f"{shard_peers}, joining as {ha_identity}"
        )
    elif args.ha:
        logger.warning(f"HA mode: competing for the lease as {ha_identity}")

    # record/replay journal (obs/journal.py): enabled by --journal or
    # NHD_JOURNAL=1; genesis snapshots the backend's node inventory +
    # knob registry before any thread starts, so the recording is
    # self-contained from its first line
    jnl = None
    if args.journal:
        from nhd_tpu_torch.obs.journal import enable_journal

        tag = ha_identity or str(os.getpid())
        jnl = enable_journal(
            os.path.join(args.journal, f"nhd-{tag}.journal.jsonl"),
            identity=ha_identity or "",
        )
    else:
        from nhd_tpu_torch.obs.journal import enable_journal_from_env

        jnl = enable_journal_from_env(identity=ha_identity or "")
    if jnl is not None:
        from nhd_tpu_torch.obs.journal import genesis_nodes

        jnl.genesis(genesis_nodes(backend), mode="cli", respect_busy=True)
        logger.warning(f"journal recording → {jnl.path}")

    on_demote = None
    if args.trace_out and (args.ha or args.shards > 1):
        from nhd_tpu_torch import obs

        # demotion dump (ISSUE 7 satellite): a deposed leader's final
        # batch must stay investigable — the ring used to dump only on
        # clean exit and Ctrl-C, but a demoted replica keeps running as
        # a standby and its spans would age out of the ring. Throttled:
        # a sharded handoff demotes once per lost shard, and each dump
        # is a full ring serialization.
        demote_state = {"last": 0.0}

        def on_demote(why: str) -> None:
            now = time.monotonic()
            if now - demote_state["last"] < 5.0:
                return
            demote_state["last"] = now
            rec = obs.get_recorder()
            if rec is not None:
                path = obs.dump_chrome_trace(rec, args.trace_out)
                logger.warning(f"demoted ({why}); trace dumped to {path}")

    threads, _ = build_threads(
        backend, rpc_port=args.rpc_port, metrics_port=args.metrics_port,
        trace_dir=args.trace_out, ha_identity=ha_identity,
        shards=args.shards, shard_peers=shard_peers, on_demote=on_demote,
        mesh=args.mesh, device=device,
    )
    if args.prewarm:
        # warm restart: load every kernel library and run the kernels at
        # each recorded shape NOW, before any thread starts, so the first
        # watch event finds them warm; every artifact advances
        # Scheduler.last_heartbeat (the progress hook)
        from nhd_tpu_torch.solver import aot

        sched = next(t for t in threads if isinstance(t, Scheduler))
        summary = aot.prewarm(progress=sched._beat, device=device,
                              mesh=sched.batch._resolve_mesh())
        msg = (f"prewarm: {summary['loaded']} solver program(s) warmed, "
               f"{summary['libraries']} kernel library(ies) loaded "
               f"({summary['built']} built) in {summary['seconds']:.2f}s "
               f"from {aot.AOT.directory()}")
        if summary["quarantined"]:
            msg += f" ({summary['quarantined']} stale artifact(s) quarantined)"
        logger.warning(msg)
    for t in threads:
        t.start()

    def dump_trace() -> None:
        if not args.trace_out:
            return
        from nhd_tpu_torch import obs

        rec = obs.get_recorder()
        if rec is not None:
            path = obs.dump_chrome_trace(rec, args.trace_out)
            print(f"trace written to {path}")

    def finalize_journal() -> None:
        from nhd_tpu_torch.obs.journal import disable_journal

        path = disable_journal()
        if path:
            print(f"journal written to {path}")

    def report_launches() -> None:
        """The kernels this process launched on the card, by name (all
        0 on the CPU, where the wrappers run their plain versions), and
        the megaround graphs' dispatches with their host seconds."""
        import json

        from nhd_tpu_torch import kernels
        from nhd_tpu_torch.solver.speculate import graph_stats

        print(f"kernel launches: {json.dumps(dict(kernels.LAUNCHES))}",
              flush=True)
        print(f"megaround graphs: {json.dumps(graph_stats())}", flush=True)

    def release_leadership() -> None:
        """Clean exits hand the lease over NOW: without the voluntary
        release the standby waits out the full TTL (the handover bound
        docs/OPERATIONS.md promises is one renew interval). In
        federation mode this releases every held shard AND the presence
        beacon, so peers rebalance in one tick."""
        if not args.ha and args.shards <= 1:
            return
        from nhd_tpu_torch.k8s.lease import LeaseKeeper

        for t in threads:
            if isinstance(t, LeaseKeeper):
                t.stop()
                t.elector.step_down()

    # liveness watchdog (reference: bin/nhd:43-56): crash-only — if any
    # thread dies the whole process exits and the Deployment restarts it
    deadline = time.monotonic() + args.run_seconds if args.run_seconds else None
    try:
        while True:
            time.sleep(1)
            for t in threads:
                if not t.is_alive():
                    logger.error(f"thread {t.name} died; exiting")
                    os._exit(-1)
            if deadline is not None and time.monotonic() >= deadline:
                if args.fake:
                    snap = backend.snapshot_stats()
                    print(f"demo summary: {snap['bound_pods']}/"
                          f"{snap['total_pods']} pods "
                          f"bound across {snap['nodes']} nodes")
                release_leadership()
                dump_trace()
                finalize_journal()
                report_launches()
                return 0
    except KeyboardInterrupt:
        # Ctrl-C on a run-forever daemon is the other "clean exit" the
        # --trace-out help text promises a dump for
        logger.warning("interrupted; shutting down")
        release_leadership()
        dump_trace()
        finalize_journal()
        report_launches()
        return 0


if __name__ == "__main__":
    sys.exit(main())
