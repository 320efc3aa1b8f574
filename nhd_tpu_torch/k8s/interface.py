"""Cluster backend interface: every API-server interaction behind one seam.

The reference funnels all Kubernetes I/O through the K8SMgr singleton
(K8SMgr.py:21-53) — mockable but never mocked (SURVEY §4). Here the seam is
an explicit ABC with two implementations:

* k8s.fake.FakeClusterBackend — in-memory cluster for tests, simulation and
  benchmarks (the "multi-node without a real cluster" story the reference
  lacks);
* k8s.kube.KubeClusterBackend — the real kubernetes-client backend, method
  for method the reference's K8SMgr surface.

Annotation keys and taints match the reference so both systems can coexist
on one cluster.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional, Tuple

# Reference annotation/label/taint vocabulary (K8SMgr.py:139,160,182,496;
# Node.py:108; TriadController.py:19-23)
from nhd_tpu_torch.core.node import MAINTENANCE_LABEL  # noqa: F401 — re-export seam

DOMAIN = "sigproc.viasat.io"
CFG_ANNOTATION = f"{DOMAIN}/nhd_config"
CFG_TYPE_ANNOTATION = f"{DOMAIN}/cfg_type"
GROUPS_ANNOTATION = f"{DOMAIN}/nhd_groups"
GPU_MAP_ANNOTATION_PREFIX = f"{DOMAIN}/nhd_gpu_devices"
SCHEDULER_TAINT = f"{DOMAIN}/nhd_scheduler"
NAD_ANNOTATION = "k8s.v1.cni.cncf.io/networks"

#: the election lease every replica competes for, and the lease fenced
#: writes are checked against (k8s/lease.py, docs/RESILIENCE.md "HA").
#: Under a sharded federation (k8s/lease.py shard_lease_name) each shard
#: gets its own lease derived from this name; S=1 degenerates to exactly
#: this single lease.
LEASE_NAME = "nhd-scheduler-leader"

#: cross-shard spillover record (docs/RESILIENCE.md "Federation"): one
#: JSON annotation carrying which shards already failed to place the pod
#: ("tried"), the current claim ([lease, epoch] of the shard attempting
#: it now — claims go stale the moment that lease's epoch advances), and
#: the first-spill stamp ("since", for the orphan-age metrics)
SPILLOVER_ANNOTATION = f"{DOMAIN}/nhd_spillover"

#: scheduling priority tier (policy engine, nhd_tpu/policy/ +
#: docs/SCHEDULING_POLICIES.md): integer annotation, 0/absent =
#: best-effort; higher tiers may trigger bounded preemption of strictly
#: lower tiers when unplaceable
TIER_ANNOTATION = f"{DOMAIN}/nhd_tier"

#: cross-replica trace context (docs/OBSERVABILITY.md "Federation"): one
#: JSON annotation stamped at a pod's FIRST receipt by any replica —
#: the correlation ID, the origin replica, and the receipt wall stamp.
#: Every later replica that drives the pod (spillover claim, shard
#: handoff, post-restart retry) ADOPTS the recorded corr ID instead of
#: minting its own, so N processes' flight-recorder dumps merge into one
#: journey per pod (obs/chrome.py merge_chrome_traces).
TRACE_ANNOTATION = f"{DOMAIN}/nhd_trace"


def parse_trace_record(raw: Optional[str]) -> Optional[dict]:
    """Decode a trace-context annotation; None for absence or garbage
    (a malformed record just means the next replica re-stamps — trace
    continuity is best-effort, never load-bearing for scheduling)."""
    if not raw:
        return None
    import json

    try:
        data = json.loads(raw)
        corr = str(data["corr"])
        if not corr:
            return None
        return {
            "corr": corr,
            "origin": str(data.get("origin", "")),
            "t0": float(data["t0"]) if data.get("t0") is not None else None,
        }
    except (ValueError, TypeError, KeyError):
        return None


def render_trace_record(rec: dict) -> str:
    import json

    return json.dumps({
        "corr": rec["corr"],
        "origin": rec.get("origin", ""),
        "t0": rec.get("t0"),
    }, sort_keys=True)


def parse_spill_record(raw: Optional[str]) -> dict:
    """Decode a spillover annotation; tolerant of absence and garbage
    (a malformed record reads as 'never spilled' — the pod just re-enters
    the cycle at its home shard)."""
    out: dict = {"tried": set(), "claim": None, "since": None}
    if not raw:
        return out
    import json

    try:
        data = json.loads(raw)
        out["tried"] = {int(s) for s in data.get("tried", [])}
        claim = data.get("claim")
        if claim:
            out["claim"] = (str(claim[0]), int(claim[1]))
        if data.get("since") is not None:
            out["since"] = float(data["since"])
    except (ValueError, TypeError, KeyError, IndexError):
        return {"tried": set(), "claim": None, "since": None}
    return out


def render_spill_record(rec: dict) -> str:
    import json

    return json.dumps({
        "tried": sorted(int(s) for s in rec.get("tried", ())),
        "claim": list(rec["claim"]) if rec.get("claim") else None,
        "since": rec.get("since"),
    }, sort_keys=True)


class EventType(Enum):
    NORMAL = "Normal"
    WARNING = "Warning"


class TransientBackendError(Exception):
    """A backend write failed for a *retryable* reason (429/5xx/network)
    after the in-call retry budget was spent.

    Distinct from a ``False`` return (terminal failure: the request is
    wrong, e.g. 409 on a bind) so the scheduler can requeue the pod for
    another pass instead of marking it failed (scheduler/core.py commit
    path; docs/RESILIENCE.md). Raised by KubeClusterBackend when the
    retry policy gives up on a retryable error, and by the fault-injection
    shim (sim/faults.py) to simulate exactly that."""


class StaleLeaseError(TransientBackendError):
    """A fenced write carried an epoch older than the backend's current
    lease epoch: the caller was deposed mid-commit and a newer leader has
    already taken over. Subclasses TransientBackendError so the deposed
    leader's commit path takes the existing unwind+requeue route — the
    claim rolls back locally and the NEW leader owns the pod's next
    attempt (docs/RESILIENCE.md "HA & fencing")."""


@dataclass(frozen=True)
class LeaseView:
    """Point-in-time state of a coordination lease.

    ``epoch`` is the monotonic fencing token: bumped on EVERY acquisition
    (even a same-holder re-acquisition after expiry), never reused, so a
    write stamped with epoch N can be rejected the instant any lease
    acquisition advances past N. ``expires`` is in the backend's own
    clock domain — callers compare holders and epochs, not clocks."""

    name: str
    holder: str        # "" = unheld
    epoch: int
    expires: float


@dataclass
class PodEvent:
    """A recorded scheduling event (reference: K8SMgr.py:518-559)."""

    pod: str
    namespace: str
    reason: str
    event_type: EventType
    message: str


@dataclass
class WatchEvent:
    """Backend→controller change notification (what kopf watches deliver
    in the reference, TriadController.py:41-144)."""

    kind: str                    # 'pod_create' | 'pod_delete' | 'node_update'
    name: str
    namespace: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    old_labels: Dict[str, str] = field(default_factory=dict)
    uid: str = ""
    scheduler_name: str = ""     # pod events: spec.schedulerName
    node: str = ""               # pod events: spec.nodeName at event time
    unschedulable: bool = False
    was_unschedulable: bool = False
    taints: List[str] = field(default_factory=list)
    old_taints: List[str] = field(default_factory=list)


class ClusterBackend(ABC):
    """The K8SMgr surface (reference file:line cited per method)."""

    #: default posture for the overlapped commit pipeline
    #: (scheduler/commitpipe.py, NHD_ASYNC_COMMIT): off unless the
    #: backend's commits are real API round trips worth hiding — the
    #: kube backend flips this to True; the fake backend (tests, chaos,
    #: bench) stays synchronous so direct drives see their outcomes
    #: before attempt_scheduling_batch returns
    ASYNC_COMMIT_DEFAULT = False

    # ---- node reads ----

    @abstractmethod
    def get_nodes(self) -> List[str]:
        """Names of KubeletReady nodes (K8SMgr.py:55-69)."""

    @abstractmethod
    def is_node_active(self, node: str) -> bool:
        """Has the scheduler taint and is not unschedulable (K8SMgr.py:167-192)."""

    @abstractmethod
    def get_node_labels(self, node: str) -> Dict[str, str]:
        """(K8SMgr.py:108-110)"""

    @abstractmethod
    def get_node_addr(self, node: str) -> str:
        """First InternalIP (K8SMgr.py:91-106)."""

    @abstractmethod
    def get_node_hugepage_resources(self, node: str) -> Tuple[int, int]:
        """(capacity GiB, allocatable GiB) of 1Gi hugepages (K8SMgr.py:71-89)."""

    # ---- pod reads ----

    @abstractmethod
    def pod_exists(self, pod: str, ns: str) -> bool:
        """(K8SMgr.py:128-135)"""

    @abstractmethod
    def get_pod_node(self, pod: str, ns: str) -> Optional[str]:
        """(K8SMgr.py:112-126)"""

    @abstractmethod
    def get_pod_annotations(self, pod: str, ns: str) -> Optional[Dict[str, str]]:
        """(K8SMgr.py:194-202)"""

    def get_pod_annotations_cached(
        self, pod: str, ns: str
    ) -> Optional[Dict[str, str]]:
        """Annotations at watch-level freshness: backends with a
        watch-derived pod mirror may serve this without an API read.
        For consumers where slightly-stale is acceptable (trace-corr
        adoption) — NEVER for fenced CAS paths, which must read live.
        Default: the live read."""
        return self.get_pod_annotations(pod, ns)

    @abstractmethod
    def get_cfg_annotations(self, pod: str, ns: str) -> Optional[str]:
        """The solved-config annotation, if present (K8SMgr.py:137-150)."""

    @abstractmethod
    def get_cfg_type(self, pod: str, ns: str) -> Optional[str]:
        """(K8SMgr.py:494-506)"""

    @abstractmethod
    def get_pod_node_groups(self, pod: str, ns: str) -> List[str]:
        """Requested node groups, defaulting to ['default'] (K8SMgr.py:152-165)."""

    @abstractmethod
    def get_requested_pod_resources(self, pod: str, ns: str) -> Dict[str, str]:
        """First container's resource requests (K8SMgr.py:215-225)."""

    def get_pod_created(self, pod: str, ns: str) -> Optional[float]:
        """The pod's creationTimestamp in THIS backend's clock domain
        (``clock_now``), or None when unknown. This is the SLO engine's
        time-to-bind origin (obs/slo.py): unlike the local enqueue
        stamp, it survives spillover hops, shard handoffs, and replica
        restarts — the cluster, not any one process, owns it. Default
        None keeps duck-typed test backends working (SLO observation is
        simply skipped)."""
        return None

    def clock_now(self) -> float:
        """Now, in the same clock domain ``get_pod_created`` reports in
        (wall time against a real API server; the injectable sim clock
        on the fake). Callers compute time-to-bind as
        ``clock_now() - get_pod_created(...)`` — never by mixing in a
        local monotonic stamp."""
        import time

        return time.time()

    @abstractmethod
    def get_scheduled_pods(self, scheduler: str) -> List[Tuple[str, str, str, str]]:
        """(pod, ns, uid, phase) for pods already bound by this scheduler
        (K8SMgr.py:204-213)."""

    @abstractmethod
    def service_pods(self, scheduler: str) -> Dict[Tuple[str, str, str], Tuple[str, Optional[str]]]:
        """{(ns, pod, uid): (phase, node)} for pods requesting this
        scheduler (K8SMgr.py:227-242)."""

    @abstractmethod
    def get_cfg_map(self, pod: str, ns: str) -> Tuple[Optional[str], Optional[str]]:
        """(configmap name, first file's text) for the pod's config volume
        (K8SMgr.py:328-356)."""

    # ---- writes ----
    #
    # Every mutating call on the scheduling commit path takes an optional
    # ``epoch`` fencing token (k8s/lease.py). ``None`` means unfenced —
    # the single-replica stance, exactly the pre-HA behavior. With an
    # epoch, the backend MUST reject the write with StaleLeaseError when
    # a newer lease epoch exists, atomically with the write itself, so a
    # deposed leader's in-flight commit can never land after a standby's
    # promotion (docs/RESILIENCE.md "HA & fencing").
    #
    # ``fence_lease`` names WHICH lease the epoch is checked against —
    # under the sharded federation every write is fenced by the lease of
    # the shard owning the target node, not one global lease. ``None``
    # keeps the PR 5 single-lease behavior (the backend's default fence
    # lease).

    @abstractmethod
    def add_nad_to_pod(
        self, pod: str, ns: str, nad: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """CNI NetworkAttachmentDefinition annotation (K8SMgr.py:284-298)."""

    @abstractmethod
    def annotate_pod_config(
        self, ns: str, pod: str, cfg: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Persist the solved config (K8SMgr.py:379-393)."""

    @abstractmethod
    def annotate_pod_gpu_map(
        self, ns: str, pod: str, gpu_map: Dict[str, int],
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Per-device GPU annotations (K8SMgr.py:359-376)."""

    @abstractmethod
    def annotate_pod_meta(
        self, ns: str, pod: str, key: str, value: str,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """One arbitrary pod annotation (rebuild addition: the spillover
        record SPILLOVER_ANNOTATION rides this). Fenced like every other
        commit-path mutator."""

    @abstractmethod
    def claim_spillover_pod(
        self, ns: str, pod: str, claim_lease: str, claim_epoch: int,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Atomically claim a spilled pod for one shard's attempt: write
        ``claim = (claim_lease, claim_epoch)`` into the spillover record
        UNLESS a live foreign claim exists (a claim is live while its
        lease's current epoch still equals the claim's — a crashed or
        deposed claimant's claim goes stale the moment its shard lease
        is re-acquired, which bounds the orphan window). Returns False
        when another shard's live claim blocks us, True when the claim
        is ours (re-claiming our own claim is idempotent). Two shards
        racing the same spilled pod is the cross-shard double-bind hole;
        this is the gate that closes it."""

    @abstractmethod
    def bind_pod_to_node(
        self, pod: str, node: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """THE schedule commit point — V1Binding (K8SMgr.py:468-492)."""

    def evict_pod(
        self, pod: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Preemption eviction (policy engine, nhd_tpu/policy/preempt):
        unbind the pod so it returns to Pending and can requeue — the
        solved-config annotations survive so the scheduler's unwind path
        can release the victim's claims exactly like a transient-commit
        unwind. Fenced like every other commit-path mutator (nhdlint
        NHD501: callable only through Scheduler._commit_write). Default:
        unsupported — a backend that can't evict disables preemption
        rather than faking it."""
        return False

    def get_pod_tier(self, pod: str, ns: str) -> int:
        """The pod's scheduling priority tier (TIER_ANNOTATION; 0 =
        best-effort / absent / unparseable — a malformed tier must never
        unschedule a pod, only deprioritize it)."""
        try:
            annots = self.get_pod_annotations(pod, ns)
            return max(0, int((annots or {}).get(TIER_ANNOTATION, "0")))
        except (TransientBackendError, ValueError, TypeError):
            return 0

    @abstractmethod
    def generate_pod_event(
        self, pod: str, ns: str, reason: str, event_type: EventType, message: str
    ) -> None:
        """Operator-facing audit trail, 'NHD:'-prefixed (K8SMgr.py:518-559)."""

    # ---- coordination leases (leader election, k8s/lease.py) ----
    #
    # Lease times live in the BACKEND's clock domain (the fake's
    # injectable clock for tests/chaos, wall time against a real API
    # server); callers reason about holders and epochs only.

    @abstractmethod
    def lease_try_acquire(self, name: str, holder: str, ttl: float) -> LeaseView:
        """Atomically acquire the lease if it is unheld or expired,
        bumping the fencing epoch; returns the RESULTING lease state
        either way (``view.holder == holder`` tells the caller it won).
        Losing an acquisition race is a normal outcome, not an error."""

    @abstractmethod
    def lease_renew(self, name: str, holder: str, epoch: int, ttl: float) -> bool:
        """Extend the lease iff (holder, epoch) still match the current
        record — a compare-and-swap. False means the lease was lost
        (expired and re-acquired, or force-taken): step down NOW."""

    @abstractmethod
    def lease_release(self, name: str, holder: str, epoch: int) -> bool:
        """Voluntary step-down: clear the holder iff (holder, epoch)
        still match, so a standby can acquire without waiting out the
        TTL. The epoch is NOT reset — fencing tokens never go back."""

    @abstractmethod
    def lease_read(self, name: str) -> Optional[LeaseView]:
        """Current lease state, or None when no such lease exists."""

    @abstractmethod
    def lease_live(self, name: str) -> str:
        """The holder iff the lease exists AND is unexpired, else "".
        Expiry is evaluated in the BACKEND's own clock domain — this is
        the one liveness question callers cannot answer from a LeaseView
        alone (federation membership + shard-orphan patience need it,
        k8s/lease.py ShardedElector)."""

    # ---- watch plane (consumed by the controller) ----

    @abstractmethod
    def poll_watch_events(self, timeout: float = 0.0) -> Iterable[WatchEvent]:
        """Drain pending cluster-change notifications (the kopf watch
        equivalent, TriadController.py:41-144)."""

    # ---- TriadSet support ----

    @abstractmethod
    def list_triadsets(self) -> List[dict]:
        """TriadSet CRD objects: {name, ns, replicas, service_name, template}
        (TriadController.py:87-120, deploy/triad-crd.1.16.yaml)."""

    @abstractmethod
    def list_pods_of_triadset(self, ts: dict) -> List[str]:
        """Existing pod names for a TriadSet."""

    @abstractmethod
    def create_pod_for_triadset(self, ts: dict, ordinal: int) -> bool:
        """Create the missing '{service}-{ordinal}' pod with hostname/
        subdomain patched in (TriadController.py:101-120)."""

    @abstractmethod
    def update_triadset_status(self, ts: dict, replicas: int) -> bool:
        """Write status.replicas — backs the CRD's scale subresource
        (deploy/triadset-crd.yaml; the reference declares the subresource,
        triad-crd.1.16.yaml:57-62, but never updates it). Returns success
        so callers only cache acknowledged writes."""
