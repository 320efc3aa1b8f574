"""Prometheus-format metrics endpoint + flight-recorder HTTP views.

The reference's only metrics plane is its gRPC service (SURVEY §5.5 — "No
Prometheus"). This adds a stdlib-only HTTP exporter: GET /metrics renders
the scheduler-owned stats (via the single-writer RPC queue, like the gRPC
plane) in Prometheus text exposition format, so standard scrapers work
without a sidecar. Opt-in via ``nhd-tpu --metrics-port``.

Latency-shaped series are HISTOGRAMS (obs/histo.py) — they replaced the
seed's lossy ``last_*`` gauges, which showed only whichever batch happened
to run last before a scrape. The same server also exposes the flight
recorder (obs/):

    GET /decisions?n=50      recent per-pod decisions (JSON)
    GET /journey?corr=ID     one pod's journey: spans + decisions +
                             journal refs for a correlation ID (JSON)
    GET /explain?pod=ns/name unschedulability diagnosis (JSON, via the
                             scheduler thread — solver/explain.py)
    GET /trace[?save=1]      Chrome trace JSON of the span ring; save=1
                             also writes it under --trace-out
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from nhd_tpu_torch.k8s.retry import API_COUNTERS, ApiCounters
from nhd_tpu_torch.obs import (
    chrome_trace,
    decisions_view,
    dump_chrome_trace,
    get_recorder,
)
from nhd_tpu_torch.obs.histo import render_all as render_histograms
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.rpc import ask_scheduler
from nhd_tpu_torch.scheduler.core import RpcMsgType, build_explain_request
from nhd_tpu_torch.utils import get_logger


def render_metrics(
    nodes: List[dict], failed_count: int, perf: dict | None = None,
    api_stats: dict | None = None,
) -> str:
    """Scheduler stats → Prometheus text exposition format."""
    lines = [
        "# HELP nhd_failed_schedule_total Pods that failed to schedule",
        "# TYPE nhd_failed_schedule_total counter",
        f"nhd_failed_schedule_total {failed_count}",
    ]
    if api_stats is None:
        # the scoring-mode gauge is computed at scrape (the policy env
        # and matrix can change without a scheduler restart)
        from nhd_tpu_torch.policy.scoring import score_mode

        API_COUNTERS.set("policy_score_mode", float(score_mode()))
        api_stats = API_COUNTERS.snapshot()
    # fault-tolerance layer: ApiCounters.KNOWN is the single name → (kind,
    # help) table, so a counter added there surfaces here with no edit
    for name, (kind, help_text) in ApiCounters.KNOWN.items():
        if name not in api_stats:
            continue
        # exact rendering (no :g): large monotonic counters must not lose
        # precision or rate() reads zero-then-spike past ~1e6
        lines += [
            f"# HELP nhd_{name} {help_text}",
            f"# TYPE nhd_{name} {kind}",
            f"nhd_{name} {api_stats[name]}",
        ]
    for name, kind, help_text in (
        ("batches_total", "counter", "Scheduling batches run"),
        ("scheduled_total", "counter", "Pods scheduled"),
        ("rounds_total", "counter", "Greedy solver rounds run"),
        ("solve_seconds_total", "counter",
         "Seconds in the batched feasibility solve"),
        ("select_seconds_total", "counter",
         "Seconds in candidate selection/packing"),
        ("assign_seconds_total", "counter",
         "Seconds in physical ID assignment"),
        ("event_queue_depth", "gauge",
         "Watch events waiting for the scheduler thread (under "
         "admission: control + all tenant lanes, deferred included)"),
        ("event_queue_depth_max_tenant", "gauge",
         "Deepest single tenant lane at the admission front door"),
        ("event_queue_deferred", "gauge",
         "Creates parked at the admission defer rung"),
        ("admission_rung", "gauge",
         "Load-shed ladder rung (0 admit / 1 defer / 2 shed)"),
        ("uptime_seconds", "gauge", "Seconds since the scheduler started"),
    ):
        if perf is None or name not in perf:
            continue
        lines += [
            f"# HELP nhd_{name} {help_text}",
            f"# TYPE nhd_{name} {kind}",
            f"nhd_{name} {perf[name]}",
        ]

    # shard federation: per-shard fencing epochs from the replica's
    # ownership snapshot (k8s/lease.py publish_shard_status) — the
    # labeled complement of the scalar nhd_shard_* families above
    from nhd_tpu_torch.k8s.lease import shard_status_snapshot

    shard_status = shard_status_snapshot()
    if shard_status["n_shards"]:
        lines += [
            "# HELP nhd_shard_epoch Fencing epoch of each shard lease "
            "this replica holds (absent shards are not held)",
            "# TYPE nhd_shard_epoch gauge",
        ]
        for shard, epoch in sorted(shard_status["owned"].items()):
            lines.append(f'nhd_shard_epoch{{shard="{shard}"}} {epoch}')

    # incremental cluster state: full-rebuild fallbacks by reason
    # (solver/encode.py ClusterDelta; the vocabulary is bounded —
    # encode.REBUILD_REASONS — so the label cardinality is too)
    from nhd_tpu_torch.solver.encode import rebuild_reasons_snapshot

    reasons = rebuild_reasons_snapshot()
    if reasons:
        lines += [
            "# HELP nhd_device_state_rebuilds_total Incremental-state "
            "full rebuilds by fallback reason",
            "# TYPE nhd_device_state_rebuilds_total counter",
        ]
        for reason, n in sorted(reasons.items()):
            lines.append(
                f'nhd_device_state_rebuilds_total{{reason="{reason}"}} {n}'
            )

    # policy preemptions by victim tier (nhd_tpu/policy/): the labeled
    # complement of nhd_policy_preemptions_total — tier labels clamp to
    # policy.MAX_TIER_LABEL, so cardinality is bounded (NHD603 stance)
    from nhd_tpu_torch.policy import preempt_tier_snapshot

    tiers = preempt_tier_snapshot()
    if tiers:
        lines += [
            "# HELP nhd_policy_preemptions_by_tier_total Policy "
            "preemption evictions by victim tier",
            "# TYPE nhd_policy_preemptions_by_tier_total counter",
        ]
        for tier, n in sorted(tiers.items()):
            lines.append(
                f'nhd_policy_preemptions_by_tier_total{{tier="{tier}"}} {n}'
            )

    # latency distributions (obs/histo.py) — the last_* gauge replacement
    lines += render_histograms()

    # solver JIT program accounting: compiled-shape occupancy makes a
    # recompile storm a scrapeable signal (obs/jitstats.py)
    jit = JIT_STATS.snapshot()
    for name, kind, help_text in (
        ("jit_calls_total", "counter", "Solver program dispatches"),
        ("jit_compiles_total", "counter",
         "Solver dispatches that hit a first-seen program shape "
         "(trace+compile)"),
        ("jit_cache_hits_total", "counter",
         "Solver dispatches reusing an already-compiled shape"),
        ("jit_distinct_programs", "gauge",
         "Distinct compiled solver program shapes resident"),
    ):
        key = name[len("jit_"):]
        lines += [
            f"# HELP nhd_{name} {help_text}",
            f"# TYPE nhd_{name} {kind}",
            f"nhd_{name} {jit[key]}",
        ]
    if jit["shapes"]:
        lines += [
            "# HELP nhd_jit_shape_uses_total Dispatches per compiled "
            "program shape (bucket-shape occupancy)",
            "# TYPE nhd_jit_shape_uses_total counter",
        ]
        for key, uses in sorted(jit["shapes"].items()):
            lines.append(f'nhd_jit_shape_uses_total{{shape="{key}"}} {uses}')
    if jit.get("phase_seconds"):
        # round-phase attribution per shape bucket (ISSUE 7 perf
        # pipeline): where each cluster shape's wall time actually went
        lines += [
            "# HELP nhd_jit_phase_seconds_total Solver round wall "
            "seconds by phase and shape bucket",
            "# TYPE nhd_jit_phase_seconds_total counter",
        ]
        for key, secs in sorted(jit["phase_seconds"].items()):
            pname, _, shape = key.partition(":")
            lines.append(
                f'nhd_jit_phase_seconds_total'
                f'{{phase="{pname}",shape="{shape}"}} {secs}'
            )

    # SLO plane (obs/slo.py): true creation→bind time against the
    # multi-window burn-rate objective
    from nhd_tpu_torch.obs.slo import SLO

    lines += SLO.render()

    # flight-recorder ring state. The dropped counter reads the banked
    # total (obs/recorder.dropped_total), not the live ring's snapshot:
    # a counter that reset on every enable()/clear() made rate() read a
    # negative spike and drop the window.
    from nhd_tpu_torch.obs.recorder import dropped_total

    rec = get_recorder()
    for name, kind, help_text, value in (
        ("trace_enabled", "gauge", "Flight recorder active",
         int(rec is not None)),
        ("trace_ring_spans", "gauge", "Spans currently in the trace ring",
         rec.occupancy() if rec else 0),
        ("trace_ring_capacity", "gauge", "Trace ring capacity",
         rec.capacity if rec else 0),
        ("trace_ring_dropped_total", "counter",
         "Spans evicted from the trace ring (monotonic across ring "
         "generations)",
         dropped_total()),
    ):
        lines += [
            f"# HELP nhd_{name} {help_text}",
            f"# TYPE nhd_{name} {kind}",
            f"nhd_{name} {value}",
        ]

    # record/replay journal state (obs/journal.py)
    from nhd_tpu_torch.obs.journal import journal_view

    jv = journal_view()
    lines += [
        "# HELP nhd_journal_enabled Record/replay journal active",
        "# TYPE nhd_journal_enabled gauge",
        f"nhd_journal_enabled {int(bool(jv.get('enabled')))}",
    ]
    if jv.get("enabled"):
        lines += [
            "# HELP nhd_journal_bytes_total Bytes written to the journal "
            "(header + flushed events)",
            "# TYPE nhd_journal_bytes_total counter",
            f"nhd_journal_bytes_total {jv.get('bytes', 0)}",
            "# HELP nhd_journal_events_total Journal events captured, "
            "by event kind",
            "# TYPE nhd_journal_events_total counter",
        ]
        for ev_kind, count in sorted((jv.get("counts") or {}).items()):
            lines.append(
                f'nhd_journal_events_total{{ev="{ev_kind}"}} {count}'
            )

    lines += [
        "# HELP nhd_node_free_cpus Free logical CPU cores per node",
        "# TYPE nhd_node_free_cpus gauge",
        "# HELP nhd_node_free_gpus Free GPUs per node",
        "# TYPE nhd_node_free_gpus gauge",
        "# HELP nhd_node_free_hugepages_gb Free 1Gi hugepages per node",
        "# TYPE nhd_node_free_hugepages_gb gauge",
        "# HELP nhd_node_pods Scheduled pods per node",
        "# TYPE nhd_node_pods gauge",
        "# HELP nhd_node_active Node schedulable by NHD",
        "# TYPE nhd_node_active gauge",
        "# HELP nhd_nic_used_gbps NIC bandwidth booked per node/nic/direction",
        "# TYPE nhd_nic_used_gbps gauge",
    ]
    for n in nodes:
        label = f'node="{n["name"]}"'
        lines.append(f'nhd_node_free_cpus{{{label}}} {n["freecpu"]}')
        lines.append(f'nhd_node_free_gpus{{{label}}} {n["freegpu"]}')
        lines.append(
            f'nhd_node_free_hugepages_gb{{{label}}} {max(n["freehuge_gb"], 0)}'
        )
        lines.append(f'nhd_node_pods{{{label}}} {n["totalpods"]}')
        lines.append(f'nhd_node_active{{{label}}} {int(n["active"])}')
        for i, (rx, tx) in enumerate(n["nicstats"]):
            lines.append(
                f'nhd_nic_used_gbps{{{label},nic="{i}",dir="rx"}} {rx}'
            )
            lines.append(
                f'nhd_nic_used_gbps{{{label},nic="{i}",dir="tx"}} {tx}'
            )
    return "\n".join(lines) + "\n"


class MetricsServer(threading.Thread):
    """HTTP thread serving /metrics (plus the flight-recorder views) off
    the scheduler's RPC queue. ``trace_dir``: where /trace?save=1 writes
    dump files (the --trace-out directory). ``backend``: the cluster
    backend, used by /explain to read the queried pod's config on THIS
    thread (the scheduler thread only evaluates the finished request —
    a degraded API server must never head-of-line-block scheduling)."""

    def __init__(
        self, sched_queue: queue.Queue, *, port: int = 9464,
        trace_dir: Optional[str] = None, backend=None,
    ):
        super().__init__(name="nhd-metrics", daemon=True)
        self.logger = get_logger(__name__)
        self.mainq = sched_queue
        self.trace_dir = trace_dir
        self.backend = backend
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                parsed = urllib.parse.urlsplit(self.path)
                path = parsed.path.rstrip("/")
                q = urllib.parse.parse_qs(parsed.query)
                try:
                    if path in ("", "/metrics"):
                        self._reply(
                            200, outer._collect().encode(),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/decisions":
                        self._reply_json(200, outer._decisions(q))
                    elif path == "/journey":
                        status, body = outer._journey(q)
                        self._reply_json(status, body)
                    elif path == "/explain":
                        status, body = outer._explain(q)
                        self._reply_json(status, body)
                    elif path == "/trace":
                        status, body = outer._trace(q)
                        self._reply_json(status, body)
                    else:
                        self.send_error(404)
                except Exception as exc:  # scheduler unavailable
                    self.send_error(503, str(exc))

            def _reply(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, status: int, obj: object) -> None:
                self._reply(
                    status, json.dumps(obj).encode(), "application/json"
                )

            def log_message(self, *args) -> None:
                pass  # keep scrapes out of the logs

        self.server = ThreadingHTTPServer(("", port), Handler)
        self.port = self.server.server_address[1]
        # _started gates stop(): HTTPServer.shutdown() blocks forever if
        # serve_forever never entered its loop, and the old plain-bool
        # handshake raced a stop() issued right after start()
        self._started = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False

    def _collect(self) -> str:
        nodes = ask_scheduler(self.mainq, RpcMsgType.NODE_INFO)
        failed = ask_scheduler(self.mainq, RpcMsgType.SCHEDULER_INFO)
        perf = ask_scheduler(self.mainq, RpcMsgType.PERF_INFO)
        return render_metrics(nodes, failed, perf)

    def _decisions(self, q: dict) -> dict:
        try:
            n = int(q.get("n", ["50"])[0])
        except ValueError:
            n = 50
        return decisions_view(n)

    def _journey(self, q: dict) -> tuple:
        corr = q.get("corr", [""])[0]
        if not corr:
            return 400, {"error": "missing ?corr=<correlation id>"}
        from nhd_tpu_torch.obs.chrome import journey_view

        body = journey_view(corr)
        if not body["enabled"] and body["journal"] is None:
            return 404, {
                "error": "flight recorder and journal both disabled "
                "(start with --trace-out or NHD_JOURNAL=1)"
            }
        return 200, body

    def _explain(self, q: dict) -> tuple:
        raw = q.get("pod", [""])[0]
        if not raw:
            return 400, {"error": "missing ?pod=[ns/]name"}
        if self.backend is None:
            return 503, {"error": "explain unavailable (no backend wired)"}
        ns, _, pod = raw.rpartition("/")
        ns = ns or "default"
        # backend reads happen HERE, on the HTTP thread; the scheduler
        # thread only evaluates the finished request against its mirror
        req, err = build_explain_request(self.backend, pod, ns)
        if err is not None:
            kind, msg = err
            status = {"not-found": 404, "bad-query": 400}.get(kind, 200)
            return status, {"error": msg, "kind": kind}
        reply = ask_scheduler(
            self.mainq, RpcMsgType.EXPLAIN_INFO,
            {"request": req, "label": f"{ns}/{pod}"},
        )
        return 200, reply

    def _trace(self, q: dict) -> tuple:
        rec = get_recorder()
        if rec is None:
            return 404, {
                "error": "flight recorder disabled "
                "(start with --trace-out or enable via nhd_tpu_torch.obs)"
            }
        trace = chrome_trace(rec)
        if q.get("save", ["0"])[0] == "1":
            out_dir = self.trace_dir or "."
            path = dump_chrome_trace(rec, out_dir)
            self.logger.warning(f"trace dumped to {path}")
            trace["savedTo"] = path
        return 200, trace

    def run(self) -> None:
        self._started.set()
        self.logger.warning(f"metrics endpoint on :{self.port}/metrics")
        # short poll: shutdown() waits out one poll interval, and the
        # 0.5 s default is pure teardown latency for every embedder
        self.server.serve_forever(poll_interval=0.05)

    def stop(self) -> None:
        """Idempotent, and safe on a never-started server (shutdown() would
        otherwise block forever waiting for the serve loop)."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        if self.is_alive() or self._started.is_set():
            # the thread exists: wait for run() to reach serve_forever so
            # shutdown() has a loop to stop (a stop() racing start() used
            # to skip shutdown and leave the serve loop running forever)
            self._started.wait(timeout=2.0)
            if self._started.is_set():
                self.server.shutdown()
        self.server.server_close()  # release the listening socket
