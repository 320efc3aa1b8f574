"""Scheduler core: the reconciliation loop around the batched solver.

Keeps the reference's architecture (NHDScheduler.py:36-570) — single owner
thread for all mutable state, event-driven fast path plus periodic full
reconciliation, crash-only recovery by replaying solved configs from pod
annotations — with one structural change: pending pods are scheduled as a
*batch* through BatchScheduler instead of one at a time, which is the whole
point of the rebuild (BASELINE.json north star). Single pending pods take
the same path with a batch of one, reproducing reference behavior exactly.

The port's copy of the reference's nhd_tpu/scheduler/core.py, with its
device seams rewired (everything else is the reference's text):

* ``Scheduler(device="cuda")`` resolves the device
  (``nhd_tpu_torch.device.resolve_device``, which raises without a GPU)
  and hands it to ``BatchScheduler``; tests pass ``device="cpu"``.
* ``_stream_tile_nodes`` reads that device's type, not a global backend
  probe.
* The mesh knob (``--mesh``/``NHD_MESH``) resolves through the port's
  ``parallel.sharding.resolve_mesh_spec``, which counts distinct local
  GPUs: ``auto`` shards over every GPU when there are several, ``N``
  takes the first N and a count above the GPUs raises, as the
  reference refuses it.
* Past ``NHD_STREAM_NODES`` nodes the batch solves through the port's
  streaming tiler (solver/streaming.py) on the scheduler's device and
  mesh.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from nhd_tpu_torch import NHD_SCHED_NAME
from nhd_tpu_torch.config.parser import CfgParser, get_cfg_parser
from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.k8s.interface import (
    SPILLOVER_ANNOTATION,
    TRACE_ANNOTATION,
    ClusterBackend,
    EventType,
    StaleLeaseError,
    TransientBackendError,
    parse_spill_record,
    parse_trace_record,
    render_spill_record,
    render_trace_record,
)
from nhd_tpu_torch.k8s.lease import LeaderElector, ShardedElector, shard_for_groups
from nhd_tpu_torch.k8s.retry import API_COUNTERS
from nhd_tpu_torch.obs import histo as obs_histo
from nhd_tpu_torch.obs import slo as obs_slo
from nhd_tpu_torch.obs.journal import get_journal
from nhd_tpu_torch.obs.recorder import (
    FlightRecorder,
    correlate,
    get_recorder,
    new_corr_id,
)
from nhd_tpu_torch.parallel.sharding import resolve_mesh_spec
from nhd_tpu_torch.sanitizer.races import maybe_watch
from nhd_tpu_torch.scheduler.events import WatchItem, WatchQueue, WatchType
from nhd_tpu_torch.solver.batch import BatchItem, BatchScheduler
from nhd_tpu_torch.utils import get_logger

IDLE_CNT_THRESH = 60        # reference: NHDScheduler.py:24
Q_BLOCK_TIME_SEC = 0.5      # reference: NHDScheduler.py:25

# bound on the recently-shed /explain map (ns, pod) → reason: old
# refusals age out FIFO once the map is full — /explain answers for the
# overload in progress, not for history (the journal keeps that)
SHED_RECENT_MAX = 512

# above this node count the scheduler solves through the streaming tiler
# (solver/streaming.py) instead of one whole-cluster batch — bounded
# per-solve memory at federation scale (SURVEY §5.7)
STREAM_NODE_THRESH = int(os.environ.get("NHD_STREAM_NODES", "4096"))

# streaming tiler shape knobs (latency/memory trade-off, OPERATIONS.md):
# smaller tiles bound per-solve memory and shorten each tile's turn;
# larger chunks amortize encode cost across more pods per offer.
# Validated here so a misconfigured value fails at startup, not when the
# node count first crosses STREAM_NODE_THRESH mid-run on the scheduler
# thread (StreamingScheduler's own constructor check would fire there).
# The tile default is backend-dependent (resolved lazily at first
# streaming use, _stream_tile_nodes): on an accelerator every tile
# costs a relay flush plus a serialized host tail, so tiles size up to
# the device-memory budget; on CPU the host pays the solve compute
# directly and smaller pipelined tiles win (measured r5; bench.py
# run_stream's docstring carries the numbers).
_STREAM_TILE_ENV = os.environ.get("NHD_STREAM_TILE_NODES")
STREAM_TILE_NODES = int(_STREAM_TILE_ENV) if _STREAM_TILE_ENV else 0


def _stream_tile_nodes(device) -> int:
    if STREAM_TILE_NODES:
        return STREAM_TILE_NODES
    # both defaults are the reference's measured configurations (bench.py
    # run_stream: 16384 = one-flush federation tile on the accelerator,
    # 4096 = the best pipelined CPU tiling), kept until a measured cell
    # on the card argues for another (chip_smoke.py phase 9 times both)
    return 16384 if device.type == "cuda" else 4096


STREAM_CHUNK_PODS = int(os.environ.get("NHD_STREAM_CHUNK_PODS", "16384"))
STREAM_PLACEMENT = os.environ.get("NHD_STREAM_PLACEMENT", "first-fit")
if (_STREAM_TILE_ENV and STREAM_TILE_NODES < 1) or STREAM_CHUNK_PODS < 1:
    raise ValueError(
        "NHD_STREAM_TILE_NODES and NHD_STREAM_CHUNK_PODS must be >= 1, got "
        f"{STREAM_TILE_NODES} / {STREAM_CHUNK_PODS}"
    )
if STREAM_PLACEMENT not in ("first-fit", "routed"):
    raise ValueError(
        "NHD_STREAM_PLACEMENT must be 'first-fit' or 'routed', got "
        f"{STREAM_PLACEMENT!r}"
    )

# commit-path concurrency: 1 (default) = the reference's strictly serial
# annotate→bind sequence; >1 = per-pod commit sequences on a thread pool
# (API-server round trips dominate gang bind latency on real clusters)
COMMIT_WORKERS = int(os.environ.get("NHD_COMMIT_WORKERS", "1"))

# overlapped fenced commit (scheduler/commitpipe.py, docs/PERFORMANCE.md
# "Host round loop"): batch b's API-bound bind commits drain on a
# bounded in-order pipeline while the scheduler thread admits and
# solves batch b+1. Per-node order is preserved (strict FIFO), the
# fencing epoch is read at drain (_commit_write runs on the worker when
# the write happens), and outcomes — pod_state, unwind, requeue — are
# processed back on the single-writer thread at its drain points.
# NHD_ASYNC_COMMIT=1/0 overrides the backend default: off on the fake
# backend (tests and chaos drive commits synchronously), on for kube,
# where commits are real API round trips worth hiding. Depth bounds the
# in-flight window; past it, submission backpressures the loop.
COMMIT_DEPTH = int(os.environ.get("NHD_COMMIT_DEPTH", "256"))

# incremental device-resident cluster state (solver/encode.py
# ClusterDelta, docs/PERFORMANCE.md "Incremental device-resident
# state"): the scheduler keeps ONE packed encode + FastCluster +
# device-resident context alive across batches and folds watch/claim
# events in as row deltas — a steady round pays host encode + upload
# proportional to changed rows, not cluster size. NHD_DELTA_STATE=0
# restores the per-batch full re-encode.
DELTA_STATE = os.environ.get("NHD_DELTA_STATE", "1") == "1"

# a transiently-failing commit (TransientBackendError: the backend's retry
# budget spent on a 429/5xx/network fault) requeues the pod instead of
# marking it failed — but only this many times in a row, so a persistent
# outage degrades to the periodic-reconcile cadence instead of a hot
# requeue loop against a down API server
REQUEUE_MAX = int(os.environ.get("NHD_BIND_REQUEUE_MAX", "8"))

# cross-shard spillover orphan bound (docs/RESILIENCE.md "Federation"):
# a pod's spill record older than this is force-exhausted by its
# home-shard owner — the pod gets its explicit unschedulable verdict and
# a fresh cycle even when the shards that never tried it sit orphaned
# mid-rebalance, so no spilled pod waits past a bounded window
SPILLOVER_MAX_AGE_SEC = float(
    os.environ.get("NHD_SPILLOVER_MAX_AGE_SEC", "120")
)

# _gate_pod sentinel: "spill record not read yet" — distinct from None,
# which means the pod was unreadable (gone or API down)
_SPILL_UNREAD = object()

# unschedulable-pod explain budget for the flight recorder: with tracing
# on, batches at or below EXPLAIN_MAX pods on clusters at or below
# EXPLAIN_MAX_NODES nodes get a per-pod solver/explain.py reason summary
# attached to their decision record. Explain is a serial per-node oracle
# walk running on the single-writer thread — its cost scales with BOTH
# dimensions (pods × nodes), so both are gated; past either bound the
# decision records only the coarse outcome and GET /explain remains the
# on-demand (off-thread-prepared) path
EXPLAIN_MAX = int(os.environ.get("NHD_TRACE_EXPLAIN_MAX", "16"))
EXPLAIN_MAX_NODES = int(os.environ.get("NHD_TRACE_EXPLAIN_MAX_NODES", "512"))


def pod_spec_reservations(backend: ClusterBackend, pod: str, ns: str) -> Dict[str, int]:
    """Pod-spec-native resources worth enforcing (reference:
    NHDScheduler.py:214-225 — hugepages only). Module-level so the
    explain query can build a request on a non-scheduler thread."""
    res = backend.get_requested_pod_resources(pod, ns)
    out = {}
    if "hugepages-1Gi" in res:
        raw = str(res["hugepages-1Gi"])
        out["hugepages-1Gi"] = int(raw[: raw.find("G")]) if "G" in raw else int(raw)
    return out


def build_explain_request(
    backend: ClusterBackend, pod: str, ns: str
) -> Tuple[Optional[PodRequest], Optional[Tuple[str, str]]]:
    """The backend-I/O half of an explain query: read the live pod's
    config, type, reservations and groups, and build its PodRequest.
    Returns (request, None) or (None, (kind, message)) — ``kind`` is a
    stable machine token ("bad-query" / "not-found" / "bad-config") so
    transports map errors to status codes structurally, never by
    substring-matching message text.

    Runs on the CALLER's thread (HTTP/gRPC handler), never on the
    single-writer scheduler thread — on a real cluster every read here
    is an API round trip through the retry layer (up to its per-call
    deadline), and a degraded API server must cost the *query*, not
    head-of-line-block scheduling. The scheduler thread only evaluates
    the finished request against its in-memory mirror
    (RpcMsgType.EXPLAIN_INFO)."""
    if not pod:
        return None, ("bad-query", "missing pod name")
    if not backend.pod_exists(pod, ns):
        return None, ("not-found", f"pod {ns}/{pod} not found")
    _, cfg_text = backend.get_cfg_map(pod, ns)
    if cfg_text is None:
        return None, (
            "bad-config", f"pod {ns}/{pod} has no readable config"
        )
    cfg_type = backend.get_cfg_type(pod, ns)
    try:
        parser = get_cfg_parser(cfg_type, cfg_text)
        top = parser.to_topology(False)
        if top is None:
            raise ValueError("no usable topology in config")
        top.add_pod_reservations(pod_spec_reservations(backend, pod, ns))
        groups = frozenset(backend.get_pod_node_groups(pod, ns))
        from nhd_tpu_torch import policy as _policy

        tier = backend.get_pod_tier(pod, ns) if _policy.enabled() else 0
        return (
            PodRequest.from_topology(top, node_groups=groups, tier=tier),
            None,
        )
    except Exception as exc:
        # user-supplied config text: any parse failure IS the diagnosis
        # (the scheduler fails such pods with FailedCfgParse)
        return None, (
            "bad-config",
            f"config for {ns}/{pod} does not parse (the scheduler fails "
            f"this pod with FailedCfgParse): {exc}",
        )


class CommitOutcome(Enum):
    """Result of one pod's annotate→bind commit sequence."""

    OK = 0
    FAILED = 1      # terminal: the request is wrong; fail the pod
    RETRY = 2       # transient: server health; requeue the pod


class PodStatus(Enum):
    """Reference: NHDScheduler.py:29-34."""

    SCHEDULED = 0
    FAILED = 1
    SUCCEEDED = 2
    RUNNING = 3
    COMPLETED = 4


class RpcMsgType(Enum):
    """Reference: NHDCommon.py:69-73 (PERF_INFO is a rebuild addition —
    the solver-phase counters the reference never had)."""

    NODE_INFO = 0
    SCHEDULER_INFO = 1
    POD_INFO = 2
    PERF_INFO = 3
    EXPLAIN_INFO = 4   # rebuild addition: solver/explain.py over the live
    #                    mirror, payload = {'pod': ..., 'ns': ...}


class Scheduler(threading.Thread):
    """The single-writer scheduling thread (reference: NHDScheduler.py:43)."""

    def __init__(
        self,
        backend: ClusterBackend,
        watch_queue: Optional[WatchQueue] = None,
        rpc_queue: Optional[queue.Queue] = None,
        *,
        sched_name: str = NHD_SCHED_NAME,
        respect_busy: bool = True,
        elector: Optional[LeaderElector] = None,
        sharded: Optional[ShardedElector] = None,
        clock: Callable[[], float] = time.time,
        recorder: Optional[FlightRecorder] = None,
        slo: Optional[obs_slo.SloTracker] = None,
        mesh: Optional[str] = None,
        device: DeviceLike = "cuda",
    ):
        super().__init__(name="nhd-scheduler", daemon=True)
        self.logger = get_logger(__name__)
        self.backend = backend
        # HA mode (k8s/lease.py): with an elector wired, this replica
        # acts (schedules, commits, scans) only while it holds the
        # lease; without one it is the reference's single-replica
        # stance — always acting, writes unfenced
        self.elector = elector
        # federation mode (k8s/lease.py ShardedElector): the node-group
        # set is partitioned into S shards, this replica leases a
        # subset, and every commit is fenced by the epoch of the shard
        # owning the TARGET NODE. "Acting" means "holds at least one
        # shard"; pods are routed by their home shard, and pods no
        # owned shard can place flow through the spillover queue
        # (docs/RESILIENCE.md "Federation"). Mutually exclusive with
        # ``elector`` — a one-shard federation IS the single lease.
        self.sharded = sharded
        if elector is not None and sharded is not None:
            raise ValueError("pass elector OR sharded, not both")
        self._acting = elector is None and sharded is None
        # {shard: epoch} snapshot from the last leadership poll;
        # poll_leadership diffs it to find freshly gained shards that
        # need the scoped promotion replay before any write. The epoch
        # matters: a shard lost and RE-acquired between polls comes back
        # at a higher epoch (every acquisition bumps it), and its slice
        # must replay — a rival may have bound pods in the interim
        self._owned_prev: Dict[int, int] = {}
        # injectable wall clock for spillover 'since' stamps (chaos runs
        # drive the orphan window off the sim's step clock)
        self._spill_clock = clock
        # per-replica flight recorder (None → the process-global one):
        # the chaos harness runs N replicas in one process and each must
        # own its span ring for the cross-replica journey merge
        self._recorder = recorder
        # per-replica SLO tracker (None → the process-global obs.slo.SLO)
        self._slo = slo
        # this replica's identity in merged journeys / trace stamps
        self.replica_id = (
            sharded.identity if sharded is not None
            else elector.identity if elector is not None
            else f"solo-{os.getpid()}"
        )
        # loop-liveness heartbeat, observed by the stall watchdog
        # (k8s/lease.py StallWatchdog): refreshed at the top of every
        # run_once turn — the same turn the flight-recorder spans and
        # histograms are fed from, so a wedged loop goes silent on both
        self.last_heartbeat = time.monotonic()
        # _beat() runs on the loop thread AND on the commitpipe worker
        # (per-drain heartbeat callback) — two unsynchronized writers
        # until this lock (NHD811; see docs/STATIC_ANALYSIS.md)
        self._hb_lock = threading.Lock()
        self.nqueue = watch_queue or WatchQueue()
        # ingress admission (nhd_tpu/ingress/): detected by duck-typing
        # so every plain-WatchQueue construction (tests, legacy wiring)
        # keeps the exact pre-admission single-get behavior. With an
        # AdmissionQueue wired, the loop switches to batched DRR drain,
        # publishes shed verdicts, and couples the queue's ladder to the
        # commit pipeline's occupancy (docs/RESILIENCE.md "Layer 9").
        self._admission = (
            self.nqueue if hasattr(self.nqueue, "get_creates") else None
        )
        if (
            self._admission is not None
            and self._admission.pressure_fn is None
        ):
            self._admission.pressure_fn = self._commit_pressure
        # /explain reasons for recently shed pods: bounded (ns, pod) →
        # reason map fed by _publish_shed_verdicts, read by
        # explain_request — a refused pod answers "why" without a trace
        self._shed_recent: "OrderedDict[Tuple[str, str], str]" = (
            OrderedDict()
        )
        self.rpcq = rpc_queue or queue.Queue(maxsize=128)
        self.sched_name = sched_name
        self.nodes: Dict[str, HostNode] = {}
        self.pod_state: Dict[Tuple[str, str], dict] = {}
        self.failed_schedule_count = 0
        # the solve device (the port's seam): CUDA unless the caller
        # asks for the CPU, resolved once and shared by every solve path
        self.device = resolve_device(device)
        # multi-chip posture: --mesh / NHD_MESH decides whether the solve
        # shards over a node mesh — "auto" (every local GPU when there
        # are several), an explicit GPU count, or "off". Resolved ONCE
        # here and handed to both the batch scheduler and the streaming
        # tiler, so every solve path (and its persistent device-resident
        # contexts) shares one posture.
        self._mesh = resolve_mesh_spec(
            mesh if mesh is not None else os.environ.get("NHD_MESH", "auto")
        )
        if self._mesh not in ("auto", None):
            self.logger.warning(
                f"solve mesh: {self._mesh.size} device(s) "
                f"(--mesh/NHD_MESH)"
            )
        self.batch = BatchScheduler(
            respect_busy=respect_busy, device=self.device, mesh=self._mesh
        )
        # solver data-plane guard (solver/guard.py): recovery retries
        # and resident-state audits are legitimate intra-turn work — let
        # them advance the loop heartbeat so the stall watchdog measures
        # "no progress", never "one long repair". Process-global like
        # the device plane itself; the last replica constructed in a
        # multi-replica test process owns the hook, which is harmless
        # (any live replica's progress is loop progress).
        from nhd_tpu_torch.solver.guard import GUARD

        GUARD.heartbeat = self._beat
        self._stream = None   # built lazily past STREAM_NODE_THRESH
        # overlapped fenced commit (COMMIT_DEPTH comment above): env
        # override wins, else the backend's own default — kube turns it
        # on, the fake backend stays synchronous
        env_async = os.environ.get("NHD_ASYNC_COMMIT", "").lower()
        if env_async in ("1", "true", "on"):
            self._async_commit = True
        elif env_async in ("0", "false", "off"):
            self._async_commit = False
        elif env_async in ("", "auto"):
            self._async_commit = bool(
                getattr(backend, "ASYNC_COMMIT_DEFAULT", False)
            )
        else:
            # same word sets as NHD_PIPELINE; a typo'd value must fail
            # loud, not silently flip a commit-path posture
            raise ValueError(
                f"NHD_ASYNC_COMMIT must be 1/0/true/false/on/off/auto, "
                f"got {env_async!r}"
            )
        self._commitpipe = None   # lazy CommitPipeline when enabled
        # incremental cluster state (NHD_DELTA_STATE): the ClusterDelta
        # over self.nodes plus its delta-built ScheduleContext, reused
        # across batches; None until the first batch (and after
        # restart-grade events invalidate it)
        self._delta = None
        self._delta_ctx = None
        # vanished-pod suspects from the previous reconcile scan
        # (reconcile_deleted_pods two-scan release rule)
        self._missing_once: set = set()
        # consecutive transient-commit requeues per pod (capped by
        # REQUEUE_MAX; cleared on success, terminal failure, or delete)
        self._requeue_attempts: Dict[Tuple[str, str], int] = {}
        # preemption attempts per pod (policy engine; capped by
        # policy.preempt.max_attempts — the livelock bound: a pod that
        # preempts and still can't place stops burning victims and takes
        # the plain unschedulable verdict). Cleared on success or delete.
        self._preempt_attempts: Dict[Tuple[str, str], int] = {}
        # set when a run-loop pass died mid-mutation (API outage past the
        # retry deadline); the next successful pass rebuilds the mirror
        # from the cluster before trusting it (_guarded)
        self._mirror_dirty = False
        # cumulative solver-phase accounting (exported via PERF_INFO /
        # the Prometheus plane; the north-star metric is p99 bind latency,
        # SURVEY §5.1/§5.5). Latency DISTRIBUTIONS live in the histogram
        # registry (obs/histo.py), which replaced the lossy last_* gauges:
        # a scrape now sees every batch since process start, not just the
        # most recent one.
        self.perf: Dict[str, float] = {
            "batches_total": 0,
            "scheduled_total": 0,
            "solve_seconds_total": 0.0,
            "select_seconds_total": 0.0,
            "assign_seconds_total": 0.0,
            "rounds_total": 0,
        }
        self.t_started = time.monotonic()
        self._stop_event = threading.Event()
        # dynamic race layer (NHD_RACE=1): last_heartbeat is written by
        # the loop thread AND the commitpipe worker (both under
        # _hb_lock) — registered post-init so construction stays exempt
        maybe_watch(self, ("last_heartbeat",))

    # ------------------------------------------------------------------
    # startup / node inventory
    # ------------------------------------------------------------------

    def _init_node(self, name: str) -> HostNode:
        """Discover one node: labels, address, hugepages (reference:
        NHDScheduler.py:61-105). Shared by the startup inventory build
        and the live NODE_ADD event path."""
        node = HostNode(name, self.backend.is_node_active(name))
        self.nodes[name] = node
        try:
            node.addr = self.backend.get_node_addr(name)
            if not node.parse_labels(self.backend.get_node_labels(name)):
                self.logger.error(f"label parse failed for {name}; deactivating")
                node.active = False
                return node
            alloc, free = self.backend.get_node_hugepage_resources(name)
            if alloc == 0 or not node.set_hugepages(alloc, free):
                self.logger.error(f"no hugepages on {name}; deactivating")
                node.active = False
        except Exception as exc:
            self.logger.error(f"node setup failed for {name}: {exc}")
            node.active = False
        return node

    def build_initial_node_list(self) -> None:
        """Discover nodes, parse labels, read hugepages
        (reference: NHDScheduler.py:61-105)."""
        for name in self.backend.get_nodes():
            self._init_node(name)

    # ------------------------------------------------------------------
    # incremental cluster state (solver/encode.py ClusterDelta)
    # ------------------------------------------------------------------

    def _note_node(self, name: Optional[str]) -> None:
        """Tell the incremental cluster state an event touched *name*:
        the next batch folds it in as a row patch (and a device row
        scatter) instead of paying a full re-encode. Every mirror
        mutation site calls this; a missed site is caught by the
        delta's continuous parity check (chaos wires it as a sim
        invariant)."""
        if not name:
            return
        if self._delta is not None:
            self._delta.note(name)
        if self._stream is not None:
            self._stream.note_nodes((name,))

    def _invalidate_delta(self) -> None:
        """Drop the incremental context entirely — for restart-grade
        events (promotion replay, mirror rebuild after an isolated loop
        failure) that replace node OBJECTS wholesale: row patches have
        nothing stable to patch, so the next batch re-derives from the
        fresh mirror."""
        self._delta = None
        self._delta_ctx = None
        if self._stream is not None:
            self._stream.reset_state()

    def _delta_context(self, nodes_view: Dict[str, HostNode]):
        """The delta-built ScheduleContext for this batch, or None when
        the incremental path does not apply (disabled; a federation node
        slice, whose membership is leadership-dependent). Never fails
        the batch: any maintenance error degrades to the contextless
        full re-encode."""
        if (
            not DELTA_STATE
            or self.sharded is not None
            or nodes_view is not self.nodes
            or not nodes_view
        ):
            return None
        from nhd_tpu_torch.solver.encode import ClusterDelta

        try:
            if self._delta is None or self._delta.nodes is not nodes_view:
                self._delta = ClusterDelta(
                    nodes_view, respect_busy=self.batch.respect_busy
                )
                self._delta_ctx = self.batch.make_context(
                    nodes_view, delta=self._delta
                )
            else:
                self.batch.refresh_context(self._delta_ctx)
        except Exception:
            # the incremental state is an optimization; failing to
            # maintain it must cost this batch a full encode, never the
            # batch itself
            self.logger.exception(
                "delta context refresh failed; dropping incremental state"
            )
            self._delta = None
            self._delta_ctx = None
            return None
        return self._delta_ctx

    # ------------------------------------------------------------------
    # claim / release (restart replay)
    # ------------------------------------------------------------------

    def _parse_pod_config(
        self, pod: str, ns: str, cfg_text: str, parse_net: bool
    ) -> Tuple[Optional[CfgParser], Optional[object]]:
        cfg_type = self.backend.get_cfg_type(pod, ns)
        try:
            parser = get_cfg_parser(cfg_type, cfg_text)
            top = parser.to_topology(parse_net)
        except Exception as exc:
            # broad on purpose: the config is user-supplied text and parse
            # failures of any species must fail the pod, not the scheduler
            # (the reference would crash the whole process here via the
            # kopf exception handler, TriadController.py:147-152)
            self.logger.error(f"config parse failed for {ns}.{pod}: {exc}")
            return (None, None)
        return (parser, top)

    def claim_pod_resources(self, pod: str, ns: str, uid: str) -> None:
        """Re-claim a deployed pod's resources from its solved-config
        annotation (reference: NHDScheduler.py:107-144)."""
        cfg = self.backend.get_cfg_annotations(pod, ns)
        if not cfg:
            self.logger.error(f"no solved config for {ns}.{pod}")
            return
        _, top = self._parse_pod_config(pod, ns, cfg, parse_net=True)
        if top is None:
            return
        node_name = self.backend.get_pod_node(pod, ns)
        if not node_name or node_name not in self.nodes:
            self.logger.error(f"{ns}.{pod} bound to unknown node {node_name}")
            return
        node = self.nodes[node_name]
        if node.pod_present(pod, ns):
            self.logger.error(f"{ns}.{pod} already claimed on {node_name}")
            return
        if not node.claim_from_topology(top):
            return
        node.add_scheduled_pod(pod, ns, top)
        self._note_node(node_name)
        from nhd_tpu_torch import policy as _policy

        self.pod_state[(ns, pod)] = {
            "state": PodStatus.SCHEDULED, "time": time.time(), "uid": uid,
            # replayed pods re-read their tier (victim eligibility after
            # a restart); bound_at 0.0 = "bound before this process" —
            # the FTF tiebreak then prefers evicting fresher binds first
            "tier": (
                self.backend.get_pod_tier(pod, ns)
                if _policy.enabled() else 0
            ),
            "node": node_name, "bound_at": 0.0,
        }

    def load_deployed_configs(self) -> None:
        """Replay all bound pods after restart (reference: NHDScheduler.py:161-172)."""
        for pod, ns, uid, phase in self.backend.get_scheduled_pods(self.sched_name):
            if phase in ("Running", "CrashLoopBackOff", "Pending"):
                self.claim_pod_resources(pod, ns, uid)

    def reset_resources(self) -> None:
        """Wipe and rebuild all claims from the cluster — drift repair
        (reference: NHDScheduler.py:146-159)."""
        for node in self.nodes.values():
            node.reset_resources()
        self.pod_state.clear()
        self.load_deployed_configs()
        if self._delta is not None:
            # every row changed: one sanctioned full rebuild beats N
            # row patches (the node OBJECTS survived, so the delta's
            # view stays structurally valid)
            self._delta.rebuild("manual")
        if self._stream is not None:
            # the streaming tiler's persistent per-tile contexts have no
            # note trail for a wholesale claim rebuild — drop them
            self._stream.reset_state()

    def release_pod_resources(
        self,
        pod: str,
        ns: str,
        *,
        cfg: Optional[str] = None,
        node_name: Optional[str] = None,
    ) -> None:
        """Free a completed/removed pod's claims (reference: NHDScheduler.py:174-205).

        Delete watches fire after the pod object is gone, so the event
        carries the last-seen solved config + node (controller.py); the
        backend read is only a fallback for callers without one. Only when
        neither source yields the config does this degrade to the
        reference's full-cluster rescan.
        """
        cfg = cfg or self.backend.get_cfg_annotations(pod, ns)
        if not cfg:
            self.logger.warning(
                f"{ns}.{pod} gone before release; rescanning cluster"
            )
            self.reset_resources()
            return
        _, top = self._parse_pod_config(pod, ns, cfg, parse_net=True)
        if top is None:
            return
        node_name = node_name or self.backend.get_pod_node(pod, ns)
        if not node_name:
            # last resort: the host mirror knows where the pod sits
            node_name = next(
                (n for n, v in self.nodes.items() if v.pod_present(pod, ns)), None
            )
        if not node_name or node_name not in self.nodes:
            return
        node = self.nodes[node_name]
        if not node.pod_present(pod, ns):
            self.logger.error(f"{ns}.{pod} not on node {node_name}; cannot release")
            return
        node.release_from_topology(top)
        node.remove_scheduled_pod(pod, ns)
        node.set_busy()
        self._note_node(node_name)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _pod_reservations(self, pod: str, ns: str) -> Dict[str, int]:
        return pod_spec_reservations(self.backend, pod, ns)

    def _prepare_item(self, pod: str, ns: str) -> Optional[Tuple[CfgParser, BatchItem]]:
        """Parse one pending pod's config into a BatchItem."""
        _, cfg_text = self.backend.get_cfg_map(pod, ns)
        if cfg_text is None:
            self.backend.generate_pod_event(
                pod, ns, "FailedCfgParse", EventType.WARNING,
                f"No config found for pod {pod}",
            )
            return None
        parser, top = self._parse_pod_config(pod, ns, cfg_text, parse_net=False)
        if top is None:
            self.backend.generate_pod_event(
                pod, ns, "FailedCfgParse", EventType.WARNING,
                f"Error while processing config for pod {pod}",
            )
            return None
        top.add_pod_reservations(self._pod_reservations(pod, ns))
        groups = frozenset(self.backend.get_pod_node_groups(pod, ns))
        from nhd_tpu_torch import policy as _policy

        # tier read gated on the policy switch: with it off the request
        # is built exactly as before (no extra annotation read per pod)
        tier = self.backend.get_pod_tier(pod, ns) if _policy.enabled() else 0
        jnl = get_journal()
        if jnl is not None:
            # the one point where the pod's config text is in hand: a
            # journal recorded from a live cluster stays self-contained
            # (replay reconstructs the configmap from this event)
            jnl.pod_spec(ns, pod, cfg_text, groups=groups, tier=tier)
        req = PodRequest.from_topology(top, node_groups=groups, tier=tier)
        return parser, BatchItem((ns, pod), req, top)

    # ------------------------------------------------------------------
    # observability seams (per-replica recorder / SLO / trace context)
    # ------------------------------------------------------------------

    def _rec(self) -> Optional[FlightRecorder]:
        """This replica's flight recorder: the injected per-replica ring
        under the chaos harness (N replicas, one process), else the
        process-global one. One read — the recorder-off hot path stays
        one module-global load."""
        return self._recorder if self._recorder is not None else get_recorder()

    def _slo_tracker(self) -> obs_slo.SloTracker:
        return self._slo if self._slo is not None else obs_slo.SLO

    def _backend_now(self) -> float:
        """Now in the backend's clock domain (the creationTimestamp
        domain) — the only clock time-to-bind may be computed in."""
        fn = getattr(self.backend, "clock_now", None)
        return fn() if fn is not None else time.time()

    def _resolve_trace_corr(self, pod: str, ns: str, corr: str) -> str:
        """Cross-replica trace continuity: ADOPT the corr ID another
        replica already stamped onto the pod (spillover hop, shard
        handoff, restart retry — the journey keeps ONE ID), or stamp
        ours at first receipt so later replicas adopt it. Best-effort on
        both legs: an unreadable pod or a fenced-off stamp costs trace
        continuity for this attempt, never scheduling. Watch-level
        freshness suffices for best-effort tracing, so the read is the
        cached one — no per-pod GET per batch on the kube backend."""
        try:
            annots = self.backend.get_pod_annotations_cached(pod, ns)
        except TransientBackendError:
            return corr
        trace = parse_trace_record((annots or {}).get(TRACE_ANNOTATION))
        if trace is not None:
            return trace["corr"]
        if annots is None:
            return corr  # pod gone: nothing to stamp
        payload = render_trace_record({
            "corr": corr, "origin": self.replica_id,
            "t0": self._backend_now(),
        })
        try:
            if self.sharded is not None:
                owned = self._owned_shards()
                if not owned:
                    return corr
                self._commit_write(
                    self.backend.annotate_pod_meta, ns, pod,
                    TRACE_ANNOTATION, payload, shard=min(owned),
                )
            else:
                self._commit_write(
                    self.backend.annotate_pod_meta, ns, pod,
                    TRACE_ANNOTATION, payload,
                )
        except TransientBackendError:
            pass
        return corr

    def _observe_slo_bind(self, pod: str, ns: str) -> None:
        """Feed the SLO engine one bound pod's TRUE end-to-end
        time-to-bind: creationTimestamp → now, both in the backend's
        clock domain. Unlike the local t_enqueue stamp this survives
        spillover hops, shard handoffs and replica restarts — the
        cluster owns the origin stamp (obs/slo.py)."""
        try:
            created = self.backend.get_pod_created(pod, ns)
        except TransientBackendError:
            return
        if created is None:
            return
        now = self._backend_now()
        tt = max(now - created, 0.0)
        obs_histo.observe("time_to_bind_seconds", tt)
        # tt is a duration, valid in any domain — but the window stamp
        # must come from the TRACKER's own clock (the one burn_rate and
        # render cut windows with). Passing the backend's now here mixes
        # domains: on a fake backend (monotonic clock) vs the global
        # tracker (wall clock) every burn-rate gauge would read 0
        # forever. Chaos stays exact: its trackers run on the sim clock.
        # The namespace rides along as the tenant label: the per-tenant
        # p99 view is what the tenant-storm isolation invariant gates on
        self._slo_tracker().observe(tt, tenant=ns)

    def attempt_scheduling_batch(
        self,
        pods: List[Tuple[str, str, str]],
        meta: Optional[Dict[Tuple[str, str], Tuple[Optional[str], float]]] = None,
    ) -> int:
        """Schedule a set of (pod, ns, uid) as one batched solve, then walk
        the reference's annotate→bind commit path per winner
        (reference: NHDScheduler.py:249-353).

        ``meta`` maps (ns, pod) → (corr_id, t_enqueue) for pods arriving
        off the watch queue; their correlation ID (minted at watch-event
        receipt, controller.py) threads through every span this batch
        records. Scan-path pods get a fresh ID at admission.
        """
        self._beat()
        t_adm = time.monotonic()
        rec = self._rec()
        uids = {(ns, pod): uid for pod, ns, uid in pods}
        corrs: Dict[Tuple[str, str], str] = {}
        waits: Dict[Tuple[str, str], float] = {}
        adopted: Dict[str, str] = {}
        for pod, ns, _uid in pods:
            key = (ns, pod)
            corr, t_enq = (meta or {}).get(key, (None, 0.0))
            corrs[key] = corr or new_corr_id(
                rec.identity if rec is not None else ""
            )
            if rec is not None:
                # cross-replica journey continuity: adopt (or stamp) the
                # pod's cluster-held corr ID — one annotation read per
                # pod per batch, paid only with tracing on
                resolved = self._resolve_trace_corr(pod, ns, corrs[key])
                if resolved != corrs[key]:
                    # the watch-receipt span was recorded under the
                    # locally minted corr before the cluster's was
                    # readable — re-join that leg to the journey
                    adopted[corrs[key]] = resolved
                    corrs[key] = resolved
            if t_enq:
                wait = max(t_adm - t_enq, 0.0)
                waits[key] = wait
                obs_histo.observe("queue_wait_seconds", wait)
                if rec is not None:
                    rec.record(
                        "queue_wait", t_enq, wait, cat="pod",
                        corr=corrs[key], attrs={"pod": f"{ns}/{pod}"},
                    )
        if rec is not None and adopted:
            # one ring pass for the whole batch (the pass holds the ring
            # lock every producer thread shares — never per pod)
            rec.realias_corrs(adopted)
        prepared: List[Tuple[CfgParser, BatchItem]] = []
        for pod, ns, _uid in pods:
            if not self.backend.pod_exists(pod, ns):
                continue
            self.backend.generate_pod_event(
                pod, ns, "StartedScheduling", EventType.NORMAL,
                f"Started scheduling {ns}/{pod}",
            )
            got = self._prepare_item(pod, ns)
            if got is None:
                self.pod_state[(ns, pod)] = {
                    "state": PodStatus.FAILED, "time": time.time(), "uid": "0"
                }
                self.failed_schedule_count += 1
                if rec is not None or get_journal() is not None:
                    self._publish_decision(rec, self._decision(
                        pod, ns, corrs[(ns, pod)], "config-parse-failed",
                    ))
                continue
            prepared.append(got)
        if not prepared:
            return 0
        # priority tiers (policy engine): higher tiers admit first —
        # claims apply in batch order, so a contended batch gives
        # high-tier pods first pick. Stable sort: with the policy off
        # every tier is 0 and the order (and placements) are untouched.
        if any(item.request.tier for _parser, item in prepared):
            prepared.sort(key=lambda pi: -pi[1].request.tier)

        t_batch = time.perf_counter()
        t_batch_mono = time.monotonic()
        # under federation, solve only over the owned shards' nodes —
        # commits onto them are fenceable; everything else is another
        # replica's control plane
        nodes_view = self._solve_nodes()
        batch_items = [item for _, item in prepared]
        if len(nodes_view) > STREAM_NODE_THRESH:
            from nhd_tpu_torch.solver.streaming import StreamingScheduler

            if self._stream is None:
                self._stream = StreamingScheduler(
                    tile_nodes=_stream_tile_nodes(self.device),
                    chunk_pods=STREAM_CHUNK_PODS,
                    placement=STREAM_PLACEMENT,
                    respect_busy=self.batch.respect_busy,
                    persistent=DELTA_STATE,
                    device=self.device,
                    mesh=self._mesh,
                )
            results, bstats = self._stream.schedule(nodes_view, batch_items)
        else:
            context = self._delta_context(nodes_view)
            if context is not None:
                # incremental path: the persistent context absorbed this
                # inter-batch churn as row deltas; solve over its
                # row-aligned view (live dict order + tombstone slots)
                results, bstats = self.batch.schedule(
                    context.nodes, batch_items, context=context
                )
            else:
                results, bstats = self.batch.schedule(
                    nodes_view, batch_items
                )
        self._beat()   # one solve finished: loop progress, not a wedge
        self.perf["batches_total"] += 1
        self.perf["solve_seconds_total"] += bstats.solve_seconds
        self.perf["select_seconds_total"] += bstats.select_seconds
        self.perf["assign_seconds_total"] += bstats.assign_seconds
        self.perf["rounds_total"] += bstats.rounds
        # per-batch phase distributions (these histograms replaced the
        # lossy last_* gauges: a scrape now sees every batch, not the
        # most recent one)
        obs_histo.observe("solve_phase_seconds", bstats.solve_seconds)
        obs_histo.observe("select_phase_seconds", bstats.select_seconds)
        obs_histo.observe("assign_phase_seconds", bstats.assign_seconds)
        # fine-grained device-phase attribution (encode / materialize /
        # upload / solve / readback ...): the solver's per-batch phase
        # breakdown, as one labeled histogram family — the per-shape
        # split lands in the jit-stats table (BatchStats.phase_add)
        for pname, pdt in bstats.phases.items():
            obs_histo.observe_labeled("round_phase_seconds", pname, pdt)
        if rec is not None:
            rec.record(
                "batch", t_batch_mono, time.perf_counter() - t_batch,
                cat="batch", corr=new_corr_id(rec.identity),
                attrs={"pods": len(prepared), "rounds": bstats.rounds},
            )
            # per-pod phase spans: the batch's solve/select/assign wall
            # attributed to each pod under ITS correlation ID, laid out
            # sequentially from batch start (phases are batch-level
            # aggregates — the trace shows where the pod's batch spent
            # its time, docs/OBSERVABILITY.md "span model")
            t_sel0 = t_batch_mono + bstats.solve_seconds
            t_asn0 = t_sel0 + bstats.select_seconds
            for _parser, item in prepared:
                p_attrs = {"pod": f"{item.key[0]}/{item.key[1]}"}
                c = corrs.get(item.key)
                rec.record("solve", t_batch_mono, bstats.solve_seconds,
                           cat="pod", corr=c, attrs=p_attrs)
                rec.record("select", t_sel0, bstats.select_seconds,
                           cat="pod", corr=c, attrs=p_attrs)
                rec.record("assign", t_asn0, bstats.assign_seconds,
                           cat="pod", corr=c, attrs=p_attrs)

        # bounded preemption (policy engine): one eviction budget per
        # scheduling batch — the per-ROUND bound of the policy contract
        from nhd_tpu_torch import policy as _policy

        preempt_budget = None
        pod_tiers: Optional[Dict[Tuple[str, str], Tuple[int, float]]] = None
        if _policy.preemption_enabled() and self.sharded is None:
            from nhd_tpu_torch.policy.preempt import PreemptBudget

            preempt_budget = PreemptBudget.fresh()
            # the victim-eligibility projection, built ONCE per batch (a
            # quota storm can carry hundreds of unplaceable high-tier
            # pods; per-pod rebuilds were O(unplaceable × bound) on the
            # single-writer thread). _maybe_preempt prunes the entries
            # it evicts — the only in-batch mutation source.
            pod_tiers = {
                k: (st.get("tier", 0), st.get("bound_at", 0.0))
                for k, st in self.pod_state.items()
                if st.get("state") == PodStatus.SCHEDULED
            }

        winners: List[Tuple[CfgParser, BatchItem, object]] = []
        for (parser, item), result in zip(prepared, results):
            ns, pod = item.key
            if result.node is None:
                if self.sharded is not None:
                    # federation: "no candidate HERE" is not a verdict —
                    # spill to the untried shards (the explicit failure
                    # fires only once every shard has tried)
                    self._spill_unplaced(pod, ns, corrs.get(item.key))
                    continue
                if preempt_budget is not None and self._maybe_preempt(
                    item, corrs.get(item.key), uids.get(item.key, "0"),
                    preempt_budget, nodes_view, pod_tiers,
                ):
                    # victims evicted (fenced) + requeued; the preemptor
                    # requeued behind the freed capacity — no verdict yet
                    continue
                self.backend.generate_pod_event(
                    pod, ns, "FailedScheduling", EventType.WARNING,
                    f"No valid candidate nodes found for scheduling pod {pod}",
                )
                self.failed_schedule_count += 1
                self.pod_state[(ns, pod)] = {
                    "state": PodStatus.FAILED, "time": time.time(), "uid": "0"
                }
                if rec is not None or get_journal() is not None:
                    d = self._decision(
                        pod, ns, corrs.get(item.key), "unschedulable",
                        queue_wait=waits.get(item.key), stats=bstats,
                    )
                    if (
                        len(prepared) <= EXPLAIN_MAX
                        and len(nodes_view) <= EXPLAIN_MAX_NODES
                    ):
                        # small batches on small clusters get the full
                        # rejection reason from the explainer (per-node
                        # first failing predicate)
                        d["reasons"] = self._explain_summary(item, nodes_view)
                    self._publish_decision(rec, d)
            else:
                winners.append((parser, item, result))

        # overlapped fenced commit: submit the winners' commit closures
        # to the bounded in-order pipeline and return — the API round
        # trips drain on the worker (fencing epoch read at drain) while
        # this thread admits and solves the next batch. Outcomes already
        # completed (usually the PREVIOUS batch's) are processed now, on
        # this thread; the rest land at the next run_once drain point.
        # An explicit NHD_COMMIT_WORKERS>1 wins over the backend's async
        # default: the pipeline's single FIFO worker overlaps batches
        # but serializes WITHIN one, and silently disabling the
        # operator's intra-batch commit parallelism would regress gang
        # bind tails N-fold.
        if self._async_commit and COMMIT_WORKERS <= 1 and winners:
            from nhd_tpu_torch.scheduler.commitpipe import CommitUnit

            units = []
            for parser, item, result in winners:
                corr = corrs.get(item.key)
                units.append(CommitUnit(
                    item.key,
                    (lambda p=parser, i=item, r=result, c=corr:
                        self._commit_traced(p, i, r, c)),
                    (parser, item, result, corr,
                     uids.get(item.key, "0"), waits.get(item.key),
                     bstats, t_adm),
                ))
            self._commit_pipeline().submit(units)
            return self._drain_commits(block=False)

        # the commit path is >= 5 serial API round trips per pod — at gang
        # scale the API server, not the solver, bounds bind latency. With
        # NHD_COMMIT_WORKERS > 1 the per-pod backend call sequences run on
        # a thread pool (each pod's own events stay ordered); every
        # scheduler-state mutation (pod_state, failure unwind) happens
        # here, on the single-writer thread, after the pool joins.
        # Default 1 = the reference's strictly serial behavior.
        if COMMIT_WORKERS > 1 and len(winners) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=COMMIT_WORKERS) as pool:
                outcomes = list(pool.map(
                    lambda w: self._commit_traced(*w, corrs.get(w[1].key)),
                    winners,
                ))
        else:
            outcomes = [
                self._commit_traced(*w, corrs.get(w[1].key)) for w in winners
            ]

        scheduled = 0
        for (parser, item, result), (outcome, t_done) in zip(winners, outcomes):
            self._beat()   # one commit outcome processed: progress
            if self._finish_commit(
                parser, item, result, corrs.get(item.key),
                uids.get(item.key, "0"), waits.get(item.key), bstats,
                t_adm, outcome, t_done,
            ):
                scheduled += 1
        return scheduled

    def _finish_commit(
        self, parser: CfgParser, item: BatchItem, result, corr: Optional[str],
        uid: str, wait: Optional[float], bstats, t_adm: float,
        outcome: CommitOutcome, t_done: float,
    ) -> bool:
        """Process one pod's commit outcome on the single-writer thread
        — every mirror mutation (pod_state, unwind, requeue) lives here,
        shared by the synchronous loop and the async pipeline's drain.
        Returns True when the pod ended up bound."""
        ns, pod = item.key
        rec = self._rec()
        jnl = get_journal()
        if jnl is not None:
            # every commit outcome — OK, RETRY (incl. fenced rejections,
            # StaleLeaseError classifies transient) and terminal FAILED —
            # lands in the journal at the drain point
            jnl.commit(pod, ns, corr, outcome.name, node=result.node)
        # the commit may have drained after the node left the mirror
        # (async pipeline + NODE_REMOVE): its claims died with the node,
        # so unwind becomes a no-op but the state machine still runs
        node = self.nodes.get(result.node)
        if outcome is CommitOutcome.OK:
            # admission → commit-complete, the operator-facing figure
            # (queue wait is its own histogram; their sum is receipt
            # → bound). Commit-level count: a pod is "scheduled" only
            # once bound (a pod the solver placed but whose commit
            # failed counts as failed, not both — dashboards divide
            # these).
            self.perf["scheduled_total"] += 1
            obs_histo.observe(
                "bind_latency_seconds", max(t_done - t_adm, 0.0)
            )
            # SLO plane: creation → bound on the cluster's clock
            # (one backend read per successful bind)
            self._observe_slo_bind(pod, ns)
            self._requeue_attempts.pop((ns, pod), None)
            self._preempt_attempts.pop((ns, pod), None)
            # tier/bound_at/corr/node feed the policy engine: victim
            # eligibility (strictly lower tier), finish-time-fairness
            # tiebreak, and the preserved corr ID a preempted pod
            # requeues under
            self.pod_state[(ns, pod)] = {
                "state": PodStatus.SCHEDULED, "time": time.time(),
                "uid": uid, "tier": item.request.tier, "corr": corr,
                "node": result.node, "bound_at": time.monotonic(),
            }
            if rec is not None or jnl is not None:
                self._publish_decision(rec, self._decision(
                    pod, ns, corr, "scheduled", node=result.node,
                    queue_wait=wait, stats=bstats,
                    bind=max(t_done - t_adm, 0.0),
                ))
            return True
        if outcome is CommitOutcome.RETRY and self._requeue_pod(
            pod, ns, uid, node, item, corr=corr,
        ):
            # claim unwound, pod back on the queue
            if rec is not None or jnl is not None:
                self._publish_decision(rec, self._decision(
                    pod, ns, corr, "requeued", node=result.node,
                    queue_wait=wait, stats=bstats,
                ))
            return False
        self._requeue_attempts.pop((ns, pod), None)
        self._unwind(pod, ns, node, item)
        self.failed_schedule_count += 1
        self.pod_state[(ns, pod)] = {
            "state": PodStatus.FAILED, "time": time.time(), "uid": "0"
        }
        if rec is not None or jnl is not None:
            self._publish_decision(rec, self._decision(
                pod, ns, corr, "commit-failed", node=result.node,
                queue_wait=wait, stats=bstats,
            ))
        return False

    # ------------------------------------------------------------------
    # overlapped fenced commit (scheduler/commitpipe.py)
    # ------------------------------------------------------------------

    def _commit_pipeline(self):
        """The lazy commit pipeline (NHD_ASYNC_COMMIT); its worker
        advances the loop heartbeat per drained commit so a long queue
        against a slow API server reads as progress, not a stall."""
        if self._commitpipe is None:
            from nhd_tpu_torch.scheduler.commitpipe import CommitPipeline

            self._commitpipe = CommitPipeline(
                depth=COMMIT_DEPTH, heartbeat=self._beat,
            )
        return self._commitpipe

    def _drain_commits(self, *, block: bool) -> int:
        """Process completed async-commit outcomes on this (the
        single-writer) thread; returns how many pods ended up bound.
        ``block`` = full barrier: used before any pass that re-reads
        cluster state (periodic scan, mirror rebuild, promotion replay)
        — an in-flight bind must not race a listing that still shows
        its pod Pending."""
        if self._commitpipe is None:
            return 0
        pairs = (
            self._commitpipe.drain_all() if block
            else self._commitpipe.drain_ready()
        )
        scheduled = 0
        for unit, result in pairs:
            self._beat()   # one commit outcome processed: progress
            if isinstance(result, tuple):
                outcome, t_done = result
            else:
                # the closure raised (contract violation, logged by the
                # worker): the pod takes the terminal-failure path
                outcome, t_done = CommitOutcome.FAILED, time.monotonic()
            (parser, item, res, corr, uid, wait, bstats, t_adm) = unit.ctx
            if self._finish_commit(
                parser, item, res, corr, uid, wait, bstats, t_adm,
                outcome, t_done,
            ):
                scheduled += 1
        return scheduled

    def _commit_barrier_for(self, ns: str, pod: str) -> None:
        """Drain the pipeline before acting on a pod event whose commit
        is still in flight (delete racing a bind, a duplicate create) —
        the single-writer contract demands the outcome lands first."""
        if (
            self._commitpipe is not None
            and (ns, pod) in self._commitpipe.inflight_keys()
        ):
            self._drain_commits(block=True)

    def _commit_pressure(self) -> float:
        """Bind-pipeline backpressure (0..1) for the admission ladder:
        the commit pipeline's occupancy when async commit is live, else
        0 — synchronous commits apply their own backpressure by blocking
        the loop. Called from producer threads (controller put paths),
        so it reads only the lazily-built pipe reference."""
        pipe = self._commitpipe
        return pipe.occupancy() if pipe is not None else 0.0

    def _decision(
        self,
        pod: str,
        ns: str,
        corr: Optional[str],
        outcome: str,
        *,
        node: Optional[str] = None,
        queue_wait: Optional[float] = None,
        stats=None,
        bind: Optional[float] = None,
    ) -> dict:
        """One entry for the flight recorder's recent-decisions view."""
        phases: Dict[str, float] = {}
        if queue_wait is not None:
            phases["queue_wait"] = queue_wait
        if stats is not None:
            phases["solve"] = stats.solve_seconds
            phases["select"] = stats.select_seconds
            phases["assign"] = stats.assign_seconds
        if bind is not None:
            phases["bind"] = bind
        return {
            "pod": pod, "ns": ns, "corr": corr, "outcome": outcome,
            "node": node, "phases": phases, "time": time.time(),
        }

    def _publish_decision(
        self, rec: Optional[FlightRecorder], decision: dict
    ) -> None:
        """Fan one decision record out to both consumers: the flight
        recorder's bounded ring (when tracing is on) and the lossless
        journal (when recording is on, obs/journal.py — the divergence
        diff's ground truth). Callers guard on
        ``rec is not None or get_journal() is not None`` so the
        everything-off hot path still costs one module-global read."""
        if rec is not None:
            rec.record_decision(decision)
        jnl = get_journal()
        if jnl is not None:
            jnl.decision(decision)

    def _explain_summary(
        self, item: BatchItem, nodes: Optional[Dict[str, HostNode]] = None
    ) -> dict:
        """Reason histogram from the unschedulability explainer — why the
        solver had no candidate node (reason → node count)."""
        from nhd_tpu_torch.solver.explain import explain

        try:
            return explain(
                self.nodes if nodes is None else nodes, item.request,
                respect_busy=self.batch.respect_busy,
            ).summary
        except Exception as exc:
            # diagnosis decoration must never fail the batch: the pod's
            # terminal outcome is already recorded; report the explainer
            # breakage in its place
            self.logger.warning(f"explain failed for {item.key}: {exc}")
            return {"explain-error": 1}

    def _commit_traced(
        self, parser: CfgParser, item: BatchItem, result, corr: Optional[str]
    ) -> Tuple[CommitOutcome, float]:
        """_commit_pod_calls plus flight-recorder dressing: the per-pod
        bind span, and the correlation ID bound into the context so JSON
        log records emitted by the backend calls join the trace. Runs on
        commit-pool threads; returns (outcome, completion stamp)."""
        t0 = time.monotonic()
        with correlate(corr):
            outcome = self._commit_pod_calls(parser, item, result)
        t_done = time.monotonic()
        rec = self._rec()
        if rec is not None:
            # federation coordinates on the commit-path span: which
            # shard lease and fencing epoch covered this bind (merged
            # journeys show every leadership a pod's life ran under)
            shard = epoch = None
            if self.sharded is not None:
                node = self.nodes.get(result.node)
                if node is not None:
                    shard = self._node_shard(node)
                    epoch = self.sharded.fencing_epoch_for(shard)
            elif self.elector is not None:
                epoch = self.elector.fencing_epoch()
            rec.record(
                "bind", t0, t_done - t0, cat="pod", corr=corr,
                attrs={
                    "pod": f"{item.key[0]}/{item.key[1]}",
                    "node": result.node, "outcome": outcome.name,
                },
                shard=shard, epoch=epoch,
            )
        return outcome, t_done

    def _requeue_put(self, item: WatchItem) -> None:
        """Enqueue a scheduler-originated requeue (transient-bind retry,
        preemptor, victim): with admission wired it takes the requeue
        lane — rate/defer exempt (the pod's first admission already
        paid them) but still hard-capped, and a refusal yields exactly
        one shed verdict; a plain WatchQueue keeps plain put."""
        put = getattr(self.nqueue, "put_requeue", None)
        if put is not None:
            put(item)
        else:
            self.nqueue.put(item)

    def _requeue_pod(
        self, pod: str, ns: str, uid: str, node: Optional[HostNode],
        item: BatchItem, *, corr: Optional[str] = None,
    ) -> bool:
        """Requeue a pod whose commit failed transiently (API-server
        health, not a verdict on the pod). Returns False once the per-pod
        budget is spent — the caller then takes the terminal-failure path,
        and the periodic reconcile scan still retries at its own cadence.

        ``corr`` rides the requeued WatchItem so the retry's spans stay
        under the pod's original correlation ID (one ID per pod across
        transient-fault retries), and the fresh enqueue stamp makes the
        requeue wait show up in queue_wait_seconds."""
        key = (ns, pod)
        attempts = self._requeue_attempts.get(key, 0) + 1
        if attempts > REQUEUE_MAX:
            self.logger.error(
                f"{ns}/{pod}: transient commit failures exceeded "
                f"{REQUEUE_MAX} requeues; marking failed until reconcile"
            )
            return False
        self._requeue_attempts[key] = attempts
        self._unwind(pod, ns, node, item)
        self.pod_state.pop(key, None)
        API_COUNTERS.inc("bind_requeues_total")
        self.logger.warning(
            f"{ns}/{pod}: transient commit failure; requeued "
            f"(attempt {attempts}/{REQUEUE_MAX})"
        )
        self._requeue_put(WatchItem(
            WatchType.TRIAD_POD_CREATE,
            pod={"ns": ns, "name": pod, "uid": uid, "cfg": "", "node": ""},
            corr=corr,
            t_enqueue=time.monotonic(),
        ))
        return True

    def _commit_pod_calls(
        self, parser: CfgParser, item: BatchItem, result
    ) -> CommitOutcome:
        """The backend-only commit sequence: NAD → GPU map → solved config
        → bind (reference: NHDScheduler.py:286-353). Touches no scheduler
        state (node reads only), so commits for different pods may run on
        worker threads; the failure unwind stays on the scheduler thread
        (attempt_scheduling_batch's outcome loop).

        Never raises: backend methods return bools by contract, but an
        exception escaping one commit (an unwrapped client error) must
        not skip the outcome loop — on the serial path it would kill the
        scheduler thread with the mirror mutated and no unwind recorded;
        on the pool path it would abort ``pool.map`` before any other
        winner's outcome ran. TransientBackendError maps to RETRY (the
        backend's own retry budget is spent but the failure is server
        health, docs/RESILIENCE.md); anything else to FAILED.
        """
        try:
            ok = self._commit_pod_calls_inner(parser, item, result)
            return CommitOutcome.OK if ok else CommitOutcome.FAILED
        except TransientBackendError as exc:
            self.logger.warning(
                f"transient commit failure for {item.key}: {exc}"
            )
            return CommitOutcome.RETRY
        except Exception:
            self.logger.exception(
                f"commit raised for {item.key}; treating as failed"
            )
            return CommitOutcome.FAILED

    def _fence_epoch(self) -> Optional[int]:
        """The epoch to stamp on a fenced write. None in single-replica
        mode (no elector: unfenced, the pre-HA behavior). With an elector,
        a replica that is no longer leader raises StaleLeaseError — the
        local half of fencing, catching a deposition this replica already
        KNOWS about before a single API call is spent; the backend's
        epoch check catches the depositions it doesn't."""
        if self.elector is None:
            return None
        epoch = self.elector.fencing_epoch()
        if epoch is None:
            raise StaleLeaseError(
                "this replica is not the leader (deposed mid-commit)"
            )
        return epoch

    def _commit_write(
        self, fn, *args,
        node: Optional[str] = None, shard: Optional[int] = None,
    ):
        """THE fenced-commit chokepoint: every mutating backend call on
        the commit path routes through here (nhdlint NHD501 flags any
        that doesn't) so the current fencing epoch is stamped onto the
        write and a stale epoch is rejected BY THE BACKEND — a deposed
        leader's in-flight batch cannot land. StaleLeaseError subclasses
        TransientBackendError, so rejection unwinds onto the existing
        requeue path and the new leader owns the pod's next attempt.

        Under federation the fence is PER SHARD: the write is checked
        against the lease of the shard owning the target ``node`` (or
        the explicitly named ``shard`` for pod-level writes with no node,
        e.g. the spillover record), so losing one shard fences exactly
        that shard's in-flight commits and nothing else."""
        if self.sharded is not None:
            s = self._shard_for_commit(node, shard)
            epoch = self.sharded.fencing_epoch_for(s)
            if epoch is None:
                raise StaleLeaseError(
                    f"this replica no longer holds shard {s} "
                    "(handed off or deposed mid-commit)"
                )
            return fn(
                *args, epoch=epoch,
                fence_lease=self.sharded.lease_name_of(s),
            )
        epoch = self._fence_epoch()
        if epoch is None:
            # keep duck-typed test backends without the epoch kwarg
            # working in single-replica mode
            return fn(*args)
        return fn(*args, epoch=epoch)

    # ------------------------------------------------------------------
    # federation: shard routing + cross-shard spillover
    # ------------------------------------------------------------------

    def _owned_shards(self) -> Dict[int, int]:
        """{shard: fencing epoch} this replica currently holds."""
        return self.sharded.owned_shards() if self.sharded else {}

    def _node_shard(self, node: HostNode) -> int:
        """A node's home shard, from its live group set — group moves
        re-home the node on the spot (both sides compute the same
        deterministic answer, k8s/lease.py shard_for_groups)."""
        return shard_for_groups(node.groups, self.sharded.n_shards)

    def _shard_for_commit(
        self, node: Optional[str], shard: Optional[int]
    ) -> int:
        if shard is not None:
            return shard
        if node is not None and node in self.nodes:
            return self._node_shard(self.nodes[node])
        # unknown target: refusing to guess keeps the fence sound — the
        # transient path requeues and the scan retries with fresh state
        raise StaleLeaseError(
            f"cannot fence a write for unknown target node {node!r}"
        )

    def _solve_nodes(self) -> Dict[str, HostNode]:
        """The nodes this replica may place onto: all of them outside
        federation; under federation only the nodes whose home shard it
        currently leases (commits onto them carry that shard's epoch)."""
        if self.sharded is None:
            return self.nodes
        owned = set(self._owned_shards())
        return {
            name: node for name, node in self.nodes.items()
            if self._node_shard(node) in owned
        }

    def _read_spill_record(self, pod: str, ns: str) -> Optional[dict]:
        """The pod's parsed spillover record, or None when the pod is
        unreadable (gone, or the API is down — skip it this pass)."""
        try:
            annots = self.backend.get_pod_annotations(pod, ns)
        except TransientBackendError:
            return None
        if annots is None:
            return None
        return parse_spill_record(annots.get(SPILLOVER_ANNOTATION))

    def _gate_pod(
        self, pod: str, ns: str, now: float, rec: Any = _SPILL_UNREAD,
    ) -> bool:
        """May THIS replica drive this pending pod right now?

        Home-shard pods with no spill record need no coordination —
        home-shard ownership IS the mutual exclusion (and a handoff's
        old/new owners racing the same home pod are serialized by that
        one shard's epoch, exactly the PR 5 single-lease semantics). A
        pod carrying a spill record is contended across shards: every
        attempt must first win the annotation claim, fenced by the
        claiming shard's epoch, which closes the cross-shard double-bind
        hole. A record older than the orphan window is force-exhausted
        by the home owner (explicit verdict + fresh cycle) so orphaned
        shards mid-rebalance cannot strand a pod indefinitely."""
        owned = set(self._owned_shards())
        if not owned:
            return False
        if rec is _SPILL_UNREAD:
            rec = self._read_spill_record(pod, ns)
        if rec is None:
            return False
        try:
            groups = self.backend.get_pod_node_groups(pod, ns)
        except TransientBackendError:
            return False
        home = shard_for_groups(groups, self.sharded.n_shards)
        if not rec["tried"] and rec["claim"] is None:
            return home in owned
        if (
            home in owned and rec["since"] is not None
            and now - rec["since"] > SPILLOVER_MAX_AGE_SEC
        ):
            self._declare_shards_exhausted(pod, ns, home, aged_out=True)
            return False
        untried = owned - rec["tried"]
        if not untried:
            return False
        shard = min(untried)
        epoch = self.sharded.fencing_epoch_for(shard)
        if epoch is None:
            return False
        try:
            got = self._commit_write(
                self.backend.claim_spillover_pod, ns, pod,
                self.sharded.lease_name_of(shard), epoch,
                shard=shard,
            )
        except TransientBackendError:
            return False
        if got:
            API_COUNTERS.inc("shard_spillover_claims_total")
        return bool(got)

    def _filter_responsible(
        self, pods: List[Tuple[str, str, str]]
    ) -> List[Tuple[str, str, str]]:
        """Federation routing for a scan's pending set: keep the pods
        this replica must drive, claim the spilled ones it can take, and
        refresh the spillover gauges while walking."""
        now = self._spill_clock()
        out: List[Tuple[str, str, str]] = []
        depth, oldest = 0, 0.0
        for pod, ns, uid in pods:
            rec = self._read_spill_record(pod, ns)
            if rec is not None and rec["since"] is not None:
                depth += 1
                oldest = max(oldest, now - rec["since"])
            # hand the record down — _gate_pod would otherwise re-issue
            # the same annotation GET per pod per scan
            if self._gate_pod(pod, ns, now, rec=rec):
                out.append((pod, ns, uid))
        API_COUNTERS.set("shard_spillover_depth", depth)
        API_COUNTERS.set("shard_spillover_oldest_age_seconds", oldest)
        if oldest > API_COUNTERS.get("shard_spillover_orphan_age_max_seconds"):
            API_COUNTERS.set(
                "shard_spillover_orphan_age_max_seconds", oldest
            )
        return out

    def _spill_unplaced(self, pod: str, ns: str, corr: Optional[str]) -> None:
        """No owned node could place this pod: extend its spillover
        record with every shard this attempt covered, releasing our
        claim so the next shard's owner can take it. Once every shard in
        the federation has tried, the pod gets its explicit verdict and
        the record resets — the next scan cycle starts a fresh window."""
        owned = set(self._owned_shards())
        rec = self._read_spill_record(pod, ns)
        if rec is None or not owned:
            return
        rec["tried"] = set(rec["tried"]) | owned
        rec["claim"] = None
        if rec["since"] is None:
            rec["since"] = self._spill_clock()
        fence_shard = min(owned)
        if rec["tried"] >= set(range(self.sharded.n_shards)):
            self._declare_shards_exhausted(pod, ns, fence_shard,
                                           aged_out=False)
            outcome = "shards-exhausted"
        else:
            try:
                self._commit_write(
                    self.backend.annotate_pod_meta, ns, pod,
                    SPILLOVER_ANNOTATION, render_spill_record(rec),
                    shard=fence_shard,
                )
            except TransientBackendError as exc:
                # best-effort: the periodic scan re-attempts, and an
                # unwritten record just means the home owner retries
                self.logger.warning(
                    f"spill record write failed for {ns}/{pod}: {exc}"
                )
                return
            API_COUNTERS.inc("shard_spillover_spilled_total")
            self.backend.generate_pod_event(
                pod, ns, "SpilloverScheduling", EventType.NORMAL,
                f"No candidate in shards {sorted(owned)}; spilling "
                f"{ns}/{pod} to the untried shards",
            )
            self.pod_state.pop((ns, pod), None)
            outcome = "spilled"
        rec_sink = self._rec()
        if rec_sink is not None:
            # the spill hop is a journey leg: record it as a span too,
            # so a merged cross-replica trace shows WHERE the pod left
            # this replica's shards (shard = the fencing shard the
            # record write was stamped under)
            rec_sink.record(
                "spill", time.monotonic(), 0.0, cat="pod", corr=corr,
                attrs={"pod": f"{ns}/{pod}", "outcome": outcome,
                       "tried": sorted(rec["tried"])},
                shard=fence_shard,
                epoch=self.sharded.fencing_epoch_for(fence_shard),
            )
        if rec_sink is not None or get_journal() is not None:
            self._publish_decision(
                rec_sink, self._decision(pod, ns, corr, outcome)
            )

    def _declare_shards_exhausted(
        self, pod: str, ns: str, fence_shard: int, *, aged_out: bool
    ) -> None:
        """The bounded-orphan-window verdict: every shard tried (or the
        record aged out mid-rebalance) — the pod is EXPLICITLY
        unschedulable for this cycle, never silently pending forever."""
        why = (
            "spillover record exceeded the orphan window"
            if aged_out else
            f"all {self.sharded.n_shards} shards tried"
        )
        self.backend.generate_pod_event(
            pod, ns, "FailedScheduling", EventType.WARNING,
            f"No valid candidate nodes found for scheduling pod {pod} "
            f"in any shard ({why})",
        )
        API_COUNTERS.inc("shard_spillover_exhausted_total")
        self.failed_schedule_count += 1
        self.pod_state[(ns, pod)] = {
            "state": PodStatus.FAILED, "time": time.time(), "uid": "0"
        }
        try:
            self._commit_write(
                self.backend.annotate_pod_meta, ns, pod,
                SPILLOVER_ANNOTATION, "", shard=fence_shard,
            )
        except TransientBackendError as exc:
            self.logger.warning(
                f"spill record reset failed for {ns}/{pod}: {exc}"
            )

    def _commit_pod_calls_inner(self, parser: CfgParser, item: BatchItem, result) -> bool:
        ns, pod = item.key
        node = self.nodes.get(result.node)
        if node is None:
            # async drain path: the node left the mirror while this
            # commit sat queued (the NODE_REMOVE barrier closes the
            # common window; a same-turn removal can still win). The
            # bind target is gone — transient, so the pod requeues and
            # the next attempt solves against the current mirror.
            raise TransientBackendError(
                f"target node {result.node} left the mirror before "
                f"{ns}/{pod}'s commit drained"
            )
        self.backend.generate_pod_event(
            pod, ns, "Scheduling", EventType.NORMAL,
            f"Node {result.node} selected for scheduling",
        )

        nic_indices = sorted({x[0] for x in (result.nic_list or [])})
        nad = ",".join(f"{x}@{x}" for x in node.nad_names_from_indices(nic_indices))
        if nad and not self._commit_write(
            self.backend.add_nad_to_pod, pod, ns, nad, node=result.node
        ):
            self.logger.error(f"NAD annotation failed for {ns}/{pod}")
            return False

        solved = parser.to_config()
        gpu_map = parser.to_gpu_map()

        if gpu_map and not self._commit_write(
            self.backend.annotate_pod_gpu_map, ns, pod, gpu_map,
            node=result.node,
        ):
            self.backend.generate_pod_event(
                pod, ns, "PodCfgFailed", EventType.WARNING,
                "Failed to annotate pod's GPU configuration",
            )
            return False

        if not self._commit_write(
            self.backend.annotate_pod_config, ns, pod, solved,
            node=result.node,
        ):
            self.backend.generate_pod_event(
                pod, ns, "PodCfgFailed", EventType.WARNING,
                "Failed to annotate pod's configuration",
            )
            return False
        self.backend.generate_pod_event(
            pod, ns, "PodCfgSuccess", EventType.NORMAL,
            "Successfully added pod's configuration to annotations",
        )

        if not self._commit_write(
            self.backend.bind_pod_to_node, pod, result.node, ns,
            node=result.node,
        ):
            self.backend.generate_pod_event(
                pod, ns, "FailedScheduling", EventType.WARNING,
                f"Failed to schedule {ns}/{pod} to {result.node}",
            )
            return False

        self.backend.generate_pod_event(
            pod, ns, "Scheduled", EventType.NORMAL,
            f"Successfully assigned {ns}/{pod} to {result.node}",
        )
        return True


    def _unwind(
        self, pod: str, ns: str, node: Optional[HostNode], item: BatchItem,
    ) -> None:
        """Roll back an applied batch claim when the K8s commit path fails.

        The batch already mutated the host mirror, so release directly from
        the solved topology (the reference re-reads the annotation,
        NHDScheduler.py:174-205; at this point the annotation may not exist
        yet, but the topology object in hand is the same data). ``node``
        may be None on the async drain path — the node left the mirror
        while the commit was in flight, taking the claims with it.
        """
        if node is None:
            return
        if item.topology is not None:
            node.release_from_topology(item.topology)
        node.remove_scheduled_pod(pod, ns)
        node.set_busy()
        self._note_node(node.name)

    # ------------------------------------------------------------------
    # bounded preemption (policy engine, nhd_tpu/policy/preempt)
    # ------------------------------------------------------------------

    def _maybe_preempt(
        self, item: BatchItem, corr: Optional[str], uid: str,
        budget, nodes_view: Dict[str, HostNode],
        pod_tiers: Dict[Tuple[str, str], Tuple[int, float]],
    ) -> bool:
        """Try to free capacity for an unplaceable higher-tier pod by
        evicting a minimal lower-tier victim set, within the batch's
        budgets. Returns True when evictions executed (the preemptor and
        every victim are requeued; the next batch re-solves against the
        freed capacity), False when the pod should take its normal
        unschedulable verdict.

        Safety: every eviction routes through the fenced
        ``_commit_write`` chokepoint — a deposed leader's in-flight
        preemption is rejected by the backend (StaleLeaseError), the
        victim keeps its claims here and its binding there, and the new
        leader owns the pod's next attempt. A victim's mirror claims are
        released only AFTER its eviction landed, through the same
        stored-topology release the unwind path uses. Victims keep their
        corr IDs, so the flight recorder shows one preempt→rebind
        journey per victim."""
        from nhd_tpu_torch import policy as _policy
        from nhd_tpu_torch.policy import preempt as _preempt

        tier = item.request.tier
        if tier <= 0 or budget.round_left <= 0:
            return False
        ns, pod = item.key
        key = (ns, pod)
        attempts = self._preempt_attempts.get(key, 0)
        if attempts >= _preempt.max_attempts():
            # livelock bound spent: plain verdict, counter reset so a
            # later incarnation starts fresh
            self._preempt_attempts.pop(key, None)
            return False
        plan, why = _preempt.plan_preemption(
            nodes_view, item.request, tier, pod_tiers, budget,
            respect_busy=self.batch.respect_busy,
        )
        rec = self._rec()
        if plan is None:
            if why == "budget-exhausted":
                API_COUNTERS.inc("policy_preempt_budget_exhausted_total")
                if rec is not None or get_journal() is not None:
                    d = self._decision(
                        pod, ns, corr, "preempt-budget-exhausted",
                    )
                    d["budget"] = budget.state()
                    self._publish_decision(rec, d)
            return False

        # execute: fenced evictions first (cluster truth moves before
        # mirror truth — the reverse order could release claims for a
        # victim whose eviction then fences off)
        evicted: List[Tuple[str, str, int]] = []
        for vns, vpod, vtier in plan.victims:
            try:
                ok = self._commit_write(
                    self.backend.evict_pod, vpod, vns, node=plan.node,
                )
            except TransientBackendError as exc:
                self.logger.warning(
                    f"preemption evict of {vns}/{vpod} fenced off or "
                    f"failed transiently: {exc}; aborting the remaining "
                    "victim set"
                )
                break
            if not ok:
                break
            evicted.append((vns, vpod, vtier))
        if not evicted:
            return False
        budget.charge(evicted)

        # the preemptor requeues FIRST: the watch queue is FIFO, so its
        # next solve runs before any victim's — a victim requeued ahead
        # of it would re-bind straight into the capacity just freed and
        # starve the higher-tier pod into its attempts cap (observed in
        # the end-to-end cell; tests/test_policy.py pins the order)
        self._preempt_attempts[key] = attempts + 1
        self.pod_state.pop(key, None)
        self._requeue_put(WatchItem(
            WatchType.TRIAD_POD_CREATE,
            pod={"ns": ns, "name": pod, "uid": uid, "cfg": "", "node": ""},
            corr=corr,
            t_enqueue=time.monotonic(),
        ))

        node = self.nodes.get(plan.node)
        for vns, vpod, vtier in evicted:
            pod_tiers.pop((vns, vpod), None)  # no longer a victim candidate
            vstate = self.pod_state.pop((vns, vpod), None) or {}
            vcorr = vstate.get("corr")
            vuid = vstate.get("uid", "0")
            # release the victim's claims from the stored topology (the
            # same mirror-held release the unwind and reconcile paths
            # use); fall back to the annotation-driven release if the
            # mirror has no record
            top = node.pod_info.get((vpod, vns)) if node is not None else None
            if node is not None and top is not None:
                node.release_from_topology(top)
                node.remove_scheduled_pod(vpod, vns)
                # deliberately NO set_busy() here, unlike the unwind and
                # release paths: the busy stamp rate-limits GPU
                # *placements* per node, and stamping the freed node
                # would make it infeasible for a GPU preemptor for
                # MIN_BUSY_SECS — evicting victims and then hiding the
                # freed capacity from the very pod it was freed for
                # (self-defeating; pinned by test_policy.py)
                self._note_node(node.name)
            else:
                self.release_pod_resources(vpod, vns, node_name=plan.node)
            _policy.note_preemption(tier, vtier)
            API_COUNTERS.inc("policy_preemptions_total")
            self.backend.generate_pod_event(
                vpod, vns, "Preempted", EventType.WARNING,
                f"Preempted from {plan.node} by higher-tier pod "
                f"{ns}/{pod} (tier {tier} > {vtier})",
            )
            if rec is not None or get_journal() is not None:
                d = self._decision(
                    vpod, vns, vcorr, "preempted", node=plan.node,
                )
                d["preemptor"] = f"{ns}/{pod}"
                self._publish_decision(rec, d)
            # requeue the victim under its ORIGINAL corr ID: the flight
            # recorder's journey view shows preempt→rebind as one trace
            self._requeue_put(WatchItem(
                WatchType.TRIAD_POD_CREATE,
                pod={"ns": vns, "name": vpod, "uid": vuid, "cfg": "",
                     "node": ""},
                corr=vcorr,
                t_enqueue=time.monotonic(),
            ))

        self.backend.generate_pod_event(
            pod, ns, "PreemptionScheduling", EventType.NORMAL,
            f"Preempted {len(evicted)} lower-tier pod(s) on {plan.node}; "
            f"requeued for placement",
        )
        if rec is not None:
            now_mono = time.monotonic()
            rec.record(
                "preempt", now_mono, 0.0, cat="pod", corr=corr,
                attrs={
                    "pod": f"{ns}/{pod}", "node": plan.node,
                    "victims": [f"{v[0]}/{v[1]}" for v in evicted],
                    "budget": budget.state(),
                },
            )
        if rec is not None or get_journal() is not None:
            d = self._decision(
                pod, ns, corr, "preempt-requeued", node=plan.node,
            )
            d["victims"] = [
                {"pod": f"{v[0]}/{v[1]}", "tier": v[2]} for v in evicted
            ]
            d["budget"] = budget.state()
            self._publish_decision(rec, d)
        return True

    # ------------------------------------------------------------------
    # reconciliation
    # ------------------------------------------------------------------

    def check_pending_pods(self) -> None:
        """Full-cluster scan: batch-schedule Pending pods, release Failed
        ones (reference: NHDScheduler.py:425-441), and reconcile the host
        mirror against the live pod list."""
        self._beat()
        # async-commit barrier: a pod whose bind is still in flight must
        # not be re-admitted off a listing that still shows it Pending
        self._drain_commits(block=True)
        podlist = self.backend.service_pods(self.sched_name)
        self.reconcile_deleted_pods(
            {(ns, pod): uid for (ns, pod, uid) in podlist}
        )
        to_schedule: List[Tuple[str, str, str]] = []
        for (ns, pod, uid), (phase, node) in podlist.items():
            key = (ns, pod)
            if phase == "Pending" and node is None and (
                key not in self.pod_state
                or self.pod_state[key]["state"] != PodStatus.SCHEDULED
            ):
                to_schedule.append((pod, ns, uid))
            elif (
                phase == "Failed"
                and key in self.pod_state
                and self.pod_state[key]["state"] == PodStatus.SCHEDULED
            ):
                self.release_pod_resources(pod, ns)
                self.pod_state[key] = {
                    "state": PodStatus.FAILED, "time": time.time(), "uid": "0"
                }
        if self.sharded is not None:
            # federation routing: home-shard pods plus claimable spills
            to_schedule = self._filter_responsible(to_schedule)
        if to_schedule:
            self.attempt_scheduling_batch(to_schedule)

    def reconcile_deleted_pods(self, live: Dict[Tuple[str, str], str]) -> None:
        """Release claims for pod incarnations the cluster no longer has.

        The delete-safety net: the reference pins deletions with a
        finalizer so the solved config stays readable at release time
        (TriadController.py:19-23); this rebuild instead keeps the solved
        topology in the host mirror (node.pod_info), so a delete whose
        watch event was missed (controller down, queue loss) is caught by
        this periodic mirror-vs-live diff and released from the stored
        topology directly — no finalizer, no full-cluster rescan.

        ``live`` maps (ns, pod) → uid from the same service_pods snapshot
        the caller is about to schedule from, so anything in the mirror
        but not in ``live`` was bound before the snapshot and is truly
        gone (single-writer loop: no claim can interleave). The uid also
        catches delete+recreate under the same name (TriadSet ordinals):
        a live pod whose uid differs from the claimed incarnation's means
        the claimed one is dead — release it so the new Pending pod can
        schedule this very scan instead of stalling behind a stale
        SCHEDULED record (the event path's uid check, mirrored here).

        A single listing can be transiently inconsistent on a real API
        server, so a *vanished* pod (absent from ``live``, vs the
        uid-mismatch case where a live pod positively proves replacement)
        is only released once it has been missing on two consecutive
        scans. Costs no extra API calls (a point-GET confirm would stall
        the single-writer loop for the exact mass-delete scenario this
        net exists for) and delays a missed-delete release by one scan —
        the watch path handles ordinary deletes immediately.
        """
        suspects: set = set()
        for node in self.nodes.values():
            for pod, ns in list(node.pod_info):
                key = (ns, pod)
                live_uid = live.get(key)
                if live_uid is not None:
                    st = self.pod_state.get(key)
                    claimed_uid = st.get("uid") if st else None
                    if claimed_uid in (None, "0") or claimed_uid == live_uid:
                        continue  # same incarnation (or unknown): keep
                    why = (f"replaced (uid {claimed_uid} -> {live_uid}) "
                           "without a delete event")
                else:
                    if key not in self._missing_once:
                        suspects.add(key)  # first miss: wait one scan
                        continue
                    why = "vanished without a delete event (2 scans)"
                self.logger.warning(
                    f"{ns}.{pod} {why}; releasing its claims on "
                    f"{node.name} from the mirror"
                )
                top = node.pod_info[(pod, ns)]
                node.release_from_topology(top)
                node.remove_scheduled_pod(pod, ns)
                self._note_node(node.name)
                self.pod_state.pop(key, None)
        # rebuilt every scan: a pod that reappears in a later listing
        # drops back out of the suspect set
        self._missing_once = suspects

    # ------------------------------------------------------------------
    # stats (consumed by the RPC plane)
    # ------------------------------------------------------------------

    def get_basic_node_stats(self) -> List[dict]:
        """Reference: NHDScheduler.py:355-378."""
        out = []
        for name, v in self.nodes.items():
            out.append(
                {
                    "name": name,
                    "freegpu": v.free_gpu_count(),
                    "totalgpu": v.total_gpus(),
                    "freecpu": v.free_cpu_core_count(),
                    "totalcpu": v.total_cpus(),
                    "freehuge_gb": v.mem.free_hugepages_gb,
                    "totalhuge_gb": v.mem.ttl_hugepages_gb,
                    "totalpods": v.total_pods(),
                    "active": v.active,
                    "nicstats": v.nic_used_speeds(),
                }
            )
        return out

    def get_pod_stats(self) -> List[dict]:
        """Reference: NHDScheduler.py:380-406."""
        out = []
        for node_name, v in self.nodes.items():
            for (pod, ns), top in v.pod_info.items():
                annots = self.backend.get_pod_annotations(pod, ns)
                if annots is None:
                    continue
                out.append(
                    {
                        "namespace": ns,
                        "podname": pod,
                        "node": node_name,
                        "annotations": annots,
                        "hugepages": top.hugepages_gb,
                        "proc_cores": [
                            c.core for pg in top.proc_groups for c in pg.proc_cores
                        ],
                        "proc_helper_cores": [
                            c.core for pg in top.proc_groups for c in pg.misc_cores
                        ],
                        "misc_cores": [c.core for c in top.misc_cores],
                        "gpus": [
                            g.device_id for pg in top.proc_groups for g in pg.gpus
                        ],
                        "nics": [p.mac for p in top.nic_pairs],
                    }
                )
        return out

    def _parse_rpc_req(
        self, msg_type: RpcMsgType, reply_q: queue.Queue, arg=None
    ) -> None:
        """Reference: NHDScheduler.py:408-423 (``arg`` is a rebuild
        addition: EXPLAIN_INFO carries the queried pod)."""
        if msg_type == RpcMsgType.NODE_INFO:
            reply_q.put(self.get_basic_node_stats())
        elif msg_type == RpcMsgType.SCHEDULER_INFO:
            reply_q.put(self.failed_schedule_count)
        elif msg_type == RpcMsgType.POD_INFO:
            reply_q.put(self.get_pod_stats())
        elif msg_type == RpcMsgType.PERF_INFO:
            perf = dict(self.perf)
            # TRUE ingress backlog: under admission, qsize() sums the
            # control lane plus every tenant lane (deferred included) —
            # the same number depths() reports, so /metrics and the
            # fleet payload can never disagree about the backlog
            perf["event_queue_depth"] = self.nqueue.qsize()
            if self._admission is not None:
                d = self._admission.depths()
                perf["event_queue_depth_max_tenant"] = d["max_tenant"]
                perf["event_queue_deferred"] = d["deferred"]
                perf["admission_rung"] = d["rung"]
            perf["uptime_seconds"] = time.monotonic() - self.t_started
            reply_q.put(perf)
        elif msg_type == RpcMsgType.EXPLAIN_INFO:
            arg = arg or {}
            reply_q.put(self.explain_request(
                arg.get("request"), arg.get("label", "?")
            ))

    def explain_request(self, req: Optional[PodRequest], label: str) -> dict:
        """Unschedulability diagnosis for a pre-built request against the
        current mirror (solver/explain.py as data, served over GET
        /explain). Runs on the scheduler thread — the single owner of
        ``self.nodes`` — via RpcMsgType.EXPLAIN_INFO; the backend I/O
        that built ``req`` already happened on the caller's thread
        (build_explain_request), so this handler touches only in-memory
        state and cannot stall the scheduling loop on a degraded API
        server. Never raises: the reply is a diagnosis either way."""
        try:
            if req is None:
                return {"error": "no request supplied"}
            from nhd_tpu_torch.solver.explain import explain

            rep = explain(
                self.nodes, req, respect_busy=self.batch.respect_busy
            )
            out = {
                "pod": label,
                "request": rep.pod_summary,
                "summary": rep.summary,
                "schedulable_nodes": rep.schedulable_nodes,
                "verdicts": [
                    {"node": v.node, "reason": v.reason, "detail": v.detail}
                    for v in rep.verdicts
                ],
            }
            if rep.policy is not None:
                # policy verdict (NHD_POLICY=1): tier, scoring mode and
                # the per-schedulable-node score-term breakdown
                out["policy"] = rep.policy
            self._attach_admission_explain(out, label)
            return out
        except Exception as exc:
            # a diagnostics query must answer with the failure, not kill
            # the single-writer thread
            self.logger.exception(f"explain failed for {label}")
            return {"error": f"explain failed: {exc}"}

    def _attach_admission_explain(self, out: dict, label: str) -> None:
        """Decorate an /explain reply with the front door's state: the
        current rung and lane depths always, plus the shed reason when
        this pod was recently refused — "why is my pod not scheduling"
        must answer "admission refused it", never shrug."""
        if self._admission is None:
            return
        adm: Dict[str, Any] = {"depths": self._admission.depths()}
        ns, _, pod = label.partition("/")
        reason = self._shed_recent.get((ns, pod))
        if reason is not None:
            adm["shed"] = reason
        out["admission"] = adm

    # ------------------------------------------------------------------
    # event handling
    # ------------------------------------------------------------------

    def handle_watch_item(self, item: WatchItem) -> None:
        """One controller event (reference: NHDScheduler.py:492-570)."""
        if item.type in (
            WatchType.TRIAD_POD_DELETE, WatchType.TRIAD_POD_CREATE
        ):
            # async-commit barrier, per pod: the event's outcome depends
            # on whether the in-flight bind landed
            self._commit_barrier_for(item.pod["ns"], item.pod["name"])
        elif (
            item.type == WatchType.NODE_REMOVE
            and self._commitpipe is not None
            and self._commitpipe.inflight_keys()
        ):
            # node events carry no pod key, and any in-flight commit may
            # target the vanishing node (whose HostNode the worker reads
            # unsynchronized) — full barrier before the mirror drops it
            self._drain_commits(block=True)
        if item.type == WatchType.TRIAD_POD_DELETE:
            ns, pod = item.pod["ns"], item.pod["name"]
            self.release_pod_resources(
                pod, ns,
                cfg=item.pod.get("cfg") or None,
                node_name=item.pod.get("node") or None,
            )
            self.pod_state.pop((ns, pod), None)
            self._requeue_attempts.pop((ns, pod), None)
            self._preempt_attempts.pop((ns, pod), None)

        elif item.type == WatchType.TRIAD_POD_CREATE:
            ns, pod, uid = item.pod["ns"], item.pod["name"], item.pod["uid"]
            if self.sharded is not None and not self._gate_pod(
                pod, ns, self._spill_clock()
            ):
                return  # another shard's owner drives this pod
            state = self.pod_state.get((ns, pod))
            if state and state["state"] == PodStatus.SCHEDULED:
                if state["uid"] == uid:
                    return  # already scheduled; stale event
                # uid changed: stale record — release and resync
                self.release_pod_resources(pod, ns)
                self.pod_state.pop((ns, pod), None)
            self.attempt_scheduling_batch(
                [(pod, ns, uid)],
                meta={(ns, pod): (item.corr, item.t_enqueue)},
            )

        elif item.type in (WatchType.NODE_CORDON, WatchType.NODE_UNCORDON):
            node = self.nodes.get(item.node)
            if node is not None:
                node.active = item.type == WatchType.NODE_UNCORDON
                self._note_node(item.node)

        elif item.type == WatchType.NODE_MAINT_START:
            node = self.nodes.get(item.node)
            if node is not None:
                node.maintenance = True
                self._note_node(item.node)

        elif item.type == WatchType.NODE_MAINT_END:
            node = self.nodes.get(item.node)
            if node is not None:
                node.maintenance = False
                self._note_node(item.node)

        elif item.type == WatchType.GROUP_UPDATE:
            node = self.nodes.get(item.node)
            if node is not None:
                node.set_groups(item.groups)
                self._note_node(item.node)

        elif item.type == WatchType.NODE_ADD:
            # live scale-up: fold the node into the mirror (and, as a
            # padded-slot row append, into the incremental state) —
            # the reference only discovers nodes at restart
            if item.node and item.node not in self.nodes:
                self._init_node(item.node)
                self._note_node(item.node)

        elif item.type == WatchType.NODE_REMOVE:
            # decommission: drop the mirror entry; the incremental state
            # tombstones its row in place (compaction reclaims it). Any
            # pods the mirror still holds on it are released by the
            # periodic reconcile net as their deletes surface.
            if item.node and self.nodes.pop(item.node, None) is not None:
                self._note_node(item.node)

    def _handle_admitted_batch(self, first: WatchItem) -> None:
        """The admission-queue form of the TRIAD_POD_CREATE path: fold
        the blocking get's create plus up to batch_limit()-1 more (DRR
        order across tenant lanes, so the fold itself is fair) into ONE
        batched solve — the solver amortization the front door feeds.
        batch_limit() shrinks with the ladder: under pressure the loop
        takes smaller bites, coupling solve admission to queue and
        commit-pipeline depth. Each pod still walks the per-pod gates
        the single-item path walks (commit barrier, shard gate,
        SCHEDULED dedup)."""
        items = [first]
        limit = self._admission.batch_limit() - 1
        if limit > 0:
            items.extend(self._admission.get_creates(limit))
        batch: List[Tuple[str, str, str]] = []
        meta: Dict[Tuple[str, str], Tuple[Optional[str], float]] = {}
        for it in items:
            ns, pod, uid = it.pod["ns"], it.pod["name"], it.pod["uid"]
            key = (ns, pod)
            if key in meta:
                continue  # duplicate create within the fold: one solve
            self._commit_barrier_for(ns, pod)
            if self.sharded is not None and not self._gate_pod(
                pod, ns, self._spill_clock()
            ):
                continue  # another shard's owner drives this pod
            state = self.pod_state.get(key)
            if state and state["state"] == PodStatus.SCHEDULED:
                if state["uid"] == uid:
                    continue  # already scheduled; stale event
                self.release_pod_resources(pod, ns)
                self.pod_state.pop(key, None)
            batch.append((pod, ns, uid))
            meta[key] = (it.corr, it.t_enqueue)
        if batch:
            self.attempt_scheduling_batch(batch, meta=meta)

    def _publish_shed_verdicts(self) -> None:
        """Turn every pending admission refusal into its explicit
        verdict — decision record, journal entry, pod event, /explain
        reason. Runs on the scheduler thread (the single writer) once
        per loop turn, idle turns included, so a shed pod's verdict
        lands within one Q_BLOCK_TIME even when nothing else is
        admitted. drain_shed pops each record exactly once, so a
        refusal can neither lose its verdict nor double-issue it."""
        if self._admission is None:
            return
        records = self._admission.drain_shed()
        if not records:
            return
        rec = self._rec()
        for r in records:
            ns, pod = r["ns"], r["pod"]
            self._shed_recent[(ns, pod)] = r["reason"]
            while len(self._shed_recent) > SHED_RECENT_MAX:
                self._shed_recent.popitem(last=False)
            try:
                self.backend.generate_pod_event(
                    pod, ns, "AdmissionShed", EventType.WARNING,
                    f"Refused by admission: {r['reason']}",
                )
            except Exception:
                # the event is best-effort decoration; the decision
                # record and journal entry below must still land
                self.logger.warning(
                    f"{ns}/{pod}: AdmissionShed event emit failed"
                )
            if rec is not None or get_journal() is not None:
                d = self._decision(pod, ns, r.get("corr"), "admission-shed")
                d["reason"] = r["reason"]
                if r.get("requeued"):
                    d["requeued"] = True
                self._publish_decision(rec, d)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def _beat(self) -> None:
        """Refresh the loop-liveness heartbeat. Called at every run_once
        turn AND at intra-turn progress points (batch admission, solve
        completion, each commit outcome, replay phases), so the stall
        watchdog measures 'no progress', not 'one long turn' — a
        legitimate big batch never trips it, a wedged solve still does.

        Runs on the loop thread and on the commitpipe worker (the
        heartbeat= ctor callback), so the write is locked: a monotonic
        refresh can never be lost to an interleaved stale store."""
        with self._hb_lock:
            self.last_heartbeat = time.monotonic()

    def startup(self) -> None:
        """Initialization sequence (reference: NHDScheduler.py:443-464).
        A standby replica builds its mirror but does NOT scan: acting
        starts at election. A replica whose keeper already WON the
        election by now skips poll_leadership's promotion replay —
        startup itself just ran the same crash-only replay, and paying
        it twice would double every node read and config load against
        the API server."""
        self.build_initial_node_list()
        self.load_deployed_configs()
        if self.elector is not None:
            self._acting = self.elector.is_leader
        if self.sharded is not None:
            # the full startup replay just claimed every bound pod, so
            # shards already held by now are replayed by construction
            self._owned_prev = dict(self._owned_shards())
            self._acting = bool(self._owned_prev)
        if self._acting:
            self.check_pending_pods()
        # flush any watch events raised while we replayed existing pods
        try:
            while True:
                self.nqueue.get(block=False)
        except queue.Empty:
            pass

    def poll_leadership(self) -> bool:
        """Reconcile this replica's acting state with the election;
        returns True when it may mutate cluster state.

        A standby→leader flip runs the **promotion replay**: the same
        crash-only recovery path a restart takes (wipe the mirror,
        re-claim every bound pod from its solved-config annotation, scan
        for pending pods) — the standby's possibly-stale mirror is never
        trusted, the cluster's annotations are the durable truth. A
        leader→standby flip just stops acting; in-flight commits are
        fenced off by their stale epoch at the backend.

        Under federation the same contract holds PER SHARD: freshly
        gained shards run the promotion replay scoped to their node
        slice before this replica writes a byte on their behalf, and a
        failed scoped replay hands those shards back."""
        if self.sharded is not None:
            return self._poll_shard_leadership()
        if self.elector is None:
            return True
        lead = self.elector.is_leader
        if lead and not self._acting:
            self.logger.warning(
                f"promoted to leader (epoch {self.elector.epoch}); "
                "replaying cluster state from annotations"
            )
            if not self._guarded("promotion replay", self._promotion_replay):
                # the crash-only contract holds for promotions too:
                # without replayed state, LEADING is wrong — release the
                # lease so a healthy replica can take over instead of
                # this one holding it with an empty/partial mirror (the
                # loop is alive, so the watchdog would never fire)
                self.logger.error(
                    "promotion replay failed; releasing the lease"
                )
                self.elector.step_down()
                self._acting = False
                return False
            API_COUNTERS.inc("ha_promotions_total")
        elif not lead and self._acting:
            self.logger.warning(
                "demoted to standby; suspending scheduling "
                "(in-flight commits are fenced off by epoch)"
            )
        self._acting = lead
        return self._acting

    def _promotion_replay(self) -> None:
        # the crash-only restart path reused (startup minus the queue
        # flush): rebuild the node inventory from the cluster — standby
        # watch coverage is best-effort, a cordon it never saw must not
        # survive into leadership — then re-claim every bound pod from
        # its solved-config annotation and scan for pending pods. The
        # heartbeat advances per phase: on a large cluster a legitimate
        # replay can outlast the watchdog's whole-turn budget, and a
        # crash mid-promotion would hand the NEXT replica the same wall
        self._drain_commits(block=True)  # fenced-off stragglers resolve
        self.nodes.clear()
        self._invalidate_delta()  # node objects replaced wholesale
        self.build_initial_node_list()
        self._beat()
        self.pod_state.clear()
        self._missing_once.clear()
        self._requeue_attempts.clear()
        self._preempt_attempts.clear()
        self.load_deployed_configs()
        self._beat()
        self.check_pending_pods()

    def _poll_shard_leadership(self) -> bool:
        """The federation form of poll_leadership: diff the owned shard
        set against the last poll; gained shards run the SCOPED
        promotion replay (and are handed back if it fails — a shard is
        never led without replayed state), lost shards just stop being
        acted on (their in-flight commits are fenced off by epoch).

        The diff is EPOCH-aware, not a set diff: a shard that lapsed and
        was re-acquired between polls (keeper thread demoted + re-won
        while the loop sat in a long solve) shows the same shard id at a
        HIGHER epoch. A rival may have bound pods during the lapse, so
        holding the current epoch is not enough — the mirror is stale in
        a way fencing cannot catch, and the slice must replay."""
        owned = dict(self._owned_shards())
        gained = {
            s for s, ep in owned.items() if self._owned_prev.get(s) != ep
        }
        lost = set(self._owned_prev) - set(owned)
        if lost:
            self.logger.warning(
                f"shards {sorted(lost)} handed off or lost; their "
                "in-flight commits are fenced off by epoch"
            )
        if gained:
            self.logger.warning(
                f"gained shards {sorted(gained)}; replaying their slice "
                "of cluster state from annotations"
            )
            if self._guarded(
                "shard promotion replay",
                self._shard_promotion_replay, gained,
            ):
                API_COUNTERS.inc("ha_promotions_total")
            else:
                # the crash-only contract holds per shard: leading a
                # shard whose state never replayed is wrong — give the
                # gained shards back so a healthy replica (or a later,
                # successful tick) takes them
                self.logger.error(
                    "shard promotion replay failed; releasing "
                    f"gained shards {sorted(gained)}"
                )
                for s in gained:
                    self.sharded.release_shard(s)
                    owned.pop(s, None)
        self._owned_prev = owned
        self._acting = bool(owned)
        return self._acting

    def _shard_promotion_replay(self, gained: Set[int]) -> None:
        """The PR 5 promotion replay scoped to freshly gained shards:
        rebuild THOSE shards' node slice from the cluster (a cordon or
        group move the previous owner saw last must not survive the
        handoff), re-claim their bound pods from solved-config
        annotations, then scan. Nodes on shards this replica already
        held keep their live mirror — gaining one shard must not pay a
        fleet-wide replay."""
        self._drain_commits(block=True)  # held-shard stragglers resolve
        old = self.nodes
        self.nodes = {}
        try:
            self.build_initial_node_list()
            self._beat()
            fresh = self.nodes
            merged: Dict[str, HostNode] = {}
            for name, node in fresh.items():
                prev = old.get(name)
                # shard membership judged on the FRESH labels: a node
                # that group-moved into a gained shard gets the fresh
                # (replayed) state, one that never left our held shards
                # keeps its live mirror
                if prev is not None and self._node_shard(node) not in gained:
                    merged[name] = prev
                else:
                    merged[name] = node
            self.nodes = merged
            self._invalidate_delta()  # the mirror dict was replaced
            self._missing_once.clear()
            for pod, ns, uid, phase in self.backend.get_scheduled_pods(
                self.sched_name
            ):
                if phase not in ("Running", "CrashLoopBackOff", "Pending"):
                    continue
                node_name = self.backend.get_pod_node(pod, ns)
                node = self.nodes.get(node_name or "")
                if node is None or self._node_shard(node) not in gained:
                    continue
                self.pod_state.pop((ns, pod), None)
                self._requeue_attempts.pop((ns, pod), None)
                self.claim_pod_resources(pod, ns, uid)
        except BaseException:
            # a failed replay releases only the GAINED shards — the
            # held shards keep leading, so their live mirror must
            # survive the failure intact. Restoring the pre-replay map
            # is sound: held-shard nodes are the very same objects
            # (replay claims touch only gained-shard nodes, which are
            # fresh objects discarded with the exception)
            self.nodes = old
            raise
        self._beat()
        self.check_pending_pods()

    def _handle_standby_item(self, item: WatchItem) -> None:
        """Standby replicas keep their NODE mirror warm (cordons, groups,
        maintenance — cheap, read-only-against-the-cluster updates) so a
        promotion starts from a current node view, but never act on pod
        events: the promotion replay rebuilds claims from the cluster,
        which owns that information."""
        if item.type in (
            WatchType.NODE_CORDON, WatchType.NODE_UNCORDON,
            WatchType.NODE_MAINT_START, WatchType.NODE_MAINT_END,
            WatchType.GROUP_UPDATE,
        ):
            self._guarded(
                f"standby watch item {item.type.name}",
                self.handle_watch_item, item,
            )

    def run_once(self, *, idle_count: int = 0) -> int:
        """One loop iteration; returns the updated idle counter.

        Queue priority is FLIPPED from the reference (NHDScheduler.py:
        470-489): the reference polls the watch queue non-blocking and
        BLOCKS on the RPC queue, so a pod event landing just after the
        poll waits out the full Q_BLOCK_TIME window — its daemon-mode
        create→bind p50 is ~500 ms of queue latency (measured r5,
        bench[daemon-mode]). Here the blocking wait is on the WATCH
        queue (binds wake immediately) and the stats RPC queue is
        drained non-blocking each iteration — a stats call waits at
        most one loop turn, bind latency drops to solver time."""
        self._beat()
        if self._commitpipe is not None:
            # drain completed async commits first: their outcomes are
            # the oldest pending single-writer work of this turn
            self._drain_commits(block=False)
        acting = self.poll_leadership()
        try:
            rpc = self.rpcq.get(block=False)
            self._parse_rpc_req(*rpc)
            return idle_count
        except queue.Empty:
            pass
        if acting:
            # admission refusals accrued since the last turn get their
            # verdicts before any new work — including on turns that go
            # on to idle out below
            self._publish_shed_verdicts()
        try:
            item = self.nqueue.get(block=True, timeout=Q_BLOCK_TIME_SEC)
        except queue.Empty:
            idle_count += 1
            if idle_count >= IDLE_CNT_THRESH:
                idle_count = 0
                if acting:
                    self._guarded("periodic scan", self.check_pending_pods)
            return idle_count
        if acting:
            if (
                self._admission is not None
                and item.type == WatchType.TRIAD_POD_CREATE
            ):
                # front-door mode: fold further admitted creates (DRR
                # order) into one batched solve
                self._guarded(
                    "admitted batch", self._handle_admitted_batch, item
                )
            else:
                self._guarded(
                    f"watch item {item.type.name}",
                    self.handle_watch_item, item,
                )
        else:
            self._handle_standby_item(item)
        return idle_count

    def _guarded(self, what: str, fn, *args) -> bool:
        """Backend-fault isolation for the run loop; returns True when
        the pass completed.

        An ApiException that survives the retry layer — outage past the
        per-call deadline, open circuit — escaping ``service_pods`` or a
        release path would kill the single-writer thread permanently for
        what is a *transient* server-health problem. Isolate it: log,
        count, and mark the mirror dirty, because the failed pass may
        have mutated claims it never finished reconciling. The next pass
        that gets through rebuilds the mirror from the cluster first
        (``reset_resources``, the reference's own drift repair), so
        nothing is trusted after a half-completed pass. Startup stays
        crash-only — without initial state a process restart is right —
        and so does the promotion replay (poll_leadership steps down on
        a False return rather than lead without state).
        """
        try:
            if self._mirror_dirty:
                # outcomes of commits submitted before the failed pass
                # must land before the mirror is rebuilt over them
                self._drain_commits(block=True)
                self.reset_resources()
                self._mirror_dirty = False
            fn(*args)
            return True
        except Exception:
            API_COUNTERS.inc("scheduler_loop_errors_total")
            self._mirror_dirty = True
            self.logger.exception(
                f"{what} failed (backend unavailable?); mirror will be "
                "rebuilt from the cluster on the next successful pass"
            )
            return False

    def run(self) -> None:
        self.startup()
        idle = 0
        while not self._stop_event.is_set():
            idle = self.run_once(idle_count=idle)
        if self._commitpipe is not None:
            # flush accepted commits, then process their outcomes here —
            # the last single-writer act of the loop
            self._drain_commits(block=True)
            self._commitpipe.stop(flush=False)

    def stop(self) -> None:
        self._stop_event.set()
