"""In-memory cluster backend: the hermetic test/simulation seam.

Gives the framework what the reference never had (SURVEY §4): a way to run
the full scheduler — watches, binding, annotations, restart replay —
without a live cluster. State layout intentionally mirrors what the API
server would hold, so the scheduler can't tell the difference.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from nhd_tpu_torch.k8s.interface import (
    CFG_ANNOTATION,
    CFG_TYPE_ANNOTATION,
    GPU_MAP_ANNOTATION_PREFIX,
    GROUPS_ANNOTATION,
    LEASE_NAME,
    NAD_ANNOTATION,
    SCHEDULER_TAINT,
    SPILLOVER_ANNOTATION,
    TIER_ANNOTATION,
    ClusterBackend,
    LeaseView,
    PodEvent,
    StaleLeaseError,
    WatchEvent,
    parse_spill_record,
    render_spill_record,
)
from nhd_tpu_torch.k8s.retry import API_COUNTERS
from nhd_tpu_torch.utils import get_logger


@dataclass
class FakeNode:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    addr: str = "10.0.0.1"
    hugepages_capacity_gb: int = 64
    hugepages_allocatable_gb: int = 64
    ready: bool = True
    unschedulable: bool = False
    taints: List[str] = field(default_factory=lambda: [SCHEDULER_TAINT])


@dataclass
class FakeLease:
    """One coordination lease record (the API server's Lease object)."""

    name: str
    holder: str = ""
    epoch: int = 0          # leaseTransitions: the fencing token
    expires: float = 0.0    # backend-clock deadline


@dataclass
class FakePod:
    name: str
    namespace: str
    uid: str
    scheduler_name: str = "nhd-scheduler"
    phase: str = "Pending"
    node: Optional[str] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    resources: Dict[str, str] = field(default_factory=dict)
    configmap_name: Optional[str] = None
    hostname: str = ""
    subdomain: str = ""
    # creationTimestamp in the backend's clock domain (the sim clock
    # under chaos) — the SLO engine's time-to-bind origin
    created: float = 0.0


class FakeClusterBackend(ClusterBackend):
    """A thread-safe in-memory API server stand-in."""

    def __init__(self) -> None:
        self.logger = get_logger(__name__)
        self._lock = threading.RLock()
        # wakes a blocked poll_watch_events the moment an event lands
        self._watch_cv = threading.Condition(self._lock)
        self.nodes: Dict[str, FakeNode] = {}
        self.pods: Dict[Tuple[str, str], FakePod] = {}
        self.configmaps: Dict[Tuple[str, str], str] = {}  # (ns, name) → text
        self.events: List[PodEvent] = []
        self.triadsets: List[dict] = []
        self._watch: List[WatchEvent] = []
        self._uid = itertools.count(1)
        self.fail_bind_for: set = set()      # (ns, pod) forced bind failures
        self.bind_count = 0
        # record/replay scenario sink (obs/journal.py): when set, every
        # simulation-control mutation below reports (op, kwargs) so a
        # journal can script the exact cluster timeline for replay.
        # Deliberately NOT set on replay's own backend — re-driving a
        # journal must not journal itself.
        self.scenario_sink = None
        # coordination leases (leader election, k8s/lease.py). The clock
        # is injectable so chaos runs drive lease expiry deterministically
        # off the sim's step clock instead of wall time.
        self.clock = time.monotonic
        self.leases: Dict[str, FakeLease] = {}
        # the DEFAULT lease fenced writes are checked against when the
        # caller names none (interface.py); federated writes name the
        # shard lease per call via ``fence_lease``
        self.fence_lease_name = LEASE_NAME
        # every SUCCESSFUL bind: (ns, pod, uid, node, epoch, lease) — the
        # chaos harness's "no pod ever bound under two shard epochs"
        # invariant reads this
        self.bind_log: List[
            Tuple[str, str, str, str, Optional[int], Optional[str]]
        ] = []
        # every SUCCESSFUL preemption eviction: (ns, pod, uid, node,
        # epoch, lease) — the policy-chaos harness's preemption-bound /
        # no-cascade invariants read this (sim/chaos.py)
        self.evict_log: List[
            Tuple[str, str, str, str, Optional[int], Optional[str]]
        ] = []

    # ------------------------------------------------------------------
    # simulation controls (test-facing, not part of ClusterBackend)
    # ------------------------------------------------------------------

    def _scenario(self, op: str, payload: dict) -> None:
        """Report one simulation-control mutation to the scenario sink
        (called OUTSIDE self._lock — the sink does its own locking and
        may do file I/O)."""
        sink = self.scenario_sink
        if sink is not None:
            sink(op, payload)

    def arm_bind_failure(self, ns: str, pod: str) -> None:
        """Force the next bind attempt of (ns, pod) to fail — the
        scenario-visible counterpart of mutating ``fail_bind_for``
        directly, so chaos-armed bind failures land in the journal."""
        with self._lock:
            self.fail_bind_for.add((ns, pod))
        self._scenario("arm_bind_failure", {"ns": ns, "pod": pod})

    def snapshot_stats(self) -> Dict[str, int]:
        """Consistent point-in-time counts while scheduler/controller
        threads are still mutating the backend (CLI demo summary)."""
        with self._lock:
            return {
                "bound_pods": sum(1 for p in self.pods.values() if p.node),
                "total_pods": len(self.pods),
                "nodes": len(self.nodes),
            }

    def add_node(self, name: str, labels: Dict[str, str], *,
                 hugepages_gb: int = 64, addr: str = "",
                 emit_watch: bool = False) -> FakeNode:
        with self._lock:
            node = FakeNode(
                name=name, labels=dict(labels), addr=addr or f"10.0.1.{len(self.nodes) + 1}",
                hugepages_capacity_gb=hugepages_gb, hugepages_allocatable_gb=hugepages_gb,
            )
            self.nodes[name] = node
            if emit_watch:
                # live node arrival (cluster scale-up): the controller
                # translates this into WatchType.NODE_ADD and the
                # scheduler folds the node in without a restart
                self._emit_watch(
                    WatchEvent(kind="node_add", name=name,
                               labels=dict(node.labels))
                )
        self._scenario("add_node", {
            "name": name, "labels": dict(labels),
            "hugepages_gb": hugepages_gb, "addr": node.addr,
            "emit_watch": emit_watch,
        })
        return node

    def remove_node(self, name: str, *, emit_watch: bool = True) -> None:
        """Drop a node from the inventory (decommission/scale-down).
        Emits a ``node_delete`` watch event so the scheduler can retire
        the mirror entry (and its packed row) without a restart."""
        with self._lock:
            node = self.nodes.pop(name, None)
            if node is not None and emit_watch:
                self._emit_watch(
                    WatchEvent(kind="node_delete", name=name,
                               labels=dict(node.labels))
                )
        if node is not None:
            self._scenario("remove_node", {
                "name": name, "emit_watch": emit_watch,
            })

    def create_pod(
        self,
        name: str,
        ns: str = "default",
        *,
        cfg_text: Optional[str] = None,
        cfg_type: str = "triad",
        groups: Optional[str] = None,
        resources: Optional[Dict[str, str]] = None,
        scheduler_name: str = "nhd-scheduler",
        emit_watch: bool = True,
        tier: int = 0,
    ) -> FakePod:
        """Create a Pending pod with its ConfigMap, like a TriadSet would."""
        with self._lock:
            uid = f"uid-{next(self._uid)}"
            pod = FakePod(name=name, namespace=ns, uid=uid,
                          scheduler_name=scheduler_name,
                          resources=dict(resources or {}),
                          created=self.clock())
            pod.annotations[CFG_TYPE_ANNOTATION] = cfg_type
            if groups:
                pod.annotations[GROUPS_ANNOTATION] = groups
            if tier:
                pod.annotations[TIER_ANNOTATION] = str(int(tier))
            if cfg_text is not None:
                cm = f"{name}-cfg"
                self.configmaps[(ns, cm)] = cfg_text
                pod.configmap_name = cm
            self.pods[(ns, name)] = pod
            if emit_watch:
                self._emit_watch(
                    WatchEvent(kind="pod_create", name=name, namespace=ns,
                               annotations=dict(pod.annotations), uid=uid,
                               scheduler_name=pod.scheduler_name)
                )
        self._scenario("create_pod", {
            "name": name, "ns": ns, "cfg_text": cfg_text,
            "cfg_type": cfg_type, "groups": groups,
            "resources": dict(resources or {}),
            "scheduler_name": scheduler_name,
            "emit_watch": emit_watch, "tier": tier,
        })
        return pod

    def delete_pod(self, name: str, ns: str = "default",
                   emit_watch: bool = True) -> None:
        with self._lock:
            pod = self.pods.pop((ns, name), None)
            if pod and emit_watch:
                self._emit_watch(
                    WatchEvent(kind="pod_delete", name=name, namespace=ns,
                               annotations=dict(pod.annotations), uid=pod.uid,
                               scheduler_name=pod.scheduler_name,
                               node=pod.node or "")
                )
        if pod is not None:
            self._scenario("delete_pod", {
                "name": name, "ns": ns, "emit_watch": emit_watch,
            })

    def set_pod_phase(self, name: str, ns: str, phase: str) -> None:
        with self._lock:
            self.pods[(ns, name)].phase = phase

    def cordon_node(self, name: str, cordon: bool = True) -> None:
        with self._lock:
            node = self.nodes[name]
            was = node.unschedulable
            node.unschedulable = cordon
            self._emit_watch(
                WatchEvent(kind="node_update", name=name,
                           labels=dict(node.labels), old_labels=dict(node.labels),
                           unschedulable=cordon, was_unschedulable=was,
                           taints=list(node.taints), old_taints=list(node.taints))
            )
        self._scenario("cordon_node", {"name": name, "cordon": cordon})

    def update_node_labels(self, name: str, new_labels: Dict[str, Optional[str]]) -> None:
        """Merge label changes; a value of None removes the label."""
        with self._lock:
            node = self.nodes[name]
            old = dict(node.labels)
            for k, v in new_labels.items():
                if v is None:
                    node.labels.pop(k, None)
                else:
                    node.labels[k] = v
            self._emit_watch(
                WatchEvent(kind="node_update", name=name,
                           labels=dict(node.labels), old_labels=old,
                           unschedulable=node.unschedulable,
                           was_unschedulable=node.unschedulable,
                           taints=list(node.taints), old_taints=list(node.taints))
            )
        self._scenario("update_node_labels", {
            "name": name, "new_labels": dict(new_labels),
        })

    def add_triadset(self, name: str, ns: str, replicas: int,
                     service_name: str, cfg_text: str) -> None:
        with self._lock:
            self.triadsets.append(
                {"name": name, "ns": ns, "replicas": replicas,
                 "service_name": service_name, "cfg_text": cfg_text}
            )

    # ------------------------------------------------------------------
    # ClusterBackend: node reads
    # ------------------------------------------------------------------

    def get_nodes(self) -> List[str]:
        with self._lock:
            return [n.name for n in self.nodes.values() if n.ready]

    def is_node_active(self, node: str) -> bool:
        with self._lock:
            n = self.nodes.get(node)
            return bool(n and SCHEDULER_TAINT in n.taints and not n.unschedulable)

    def get_node_labels(self, node: str) -> Dict[str, str]:
        with self._lock:
            return dict(self.nodes[node].labels)

    def get_node_addr(self, node: str) -> str:
        with self._lock:
            return self.nodes[node].addr

    def get_node_hugepage_resources(self, node: str) -> Tuple[int, int]:
        with self._lock:
            n = self.nodes[node]
            return (n.hugepages_capacity_gb, n.hugepages_allocatable_gb)

    # ------------------------------------------------------------------
    # ClusterBackend: pod reads
    # ------------------------------------------------------------------

    def _pod(self, pod: str, ns: str) -> Optional[FakePod]:
        return self.pods.get((ns, pod))

    def pod_exists(self, pod: str, ns: str) -> bool:
        with self._lock:
            return (ns, pod) in self.pods

    def get_pod_node(self, pod: str, ns: str) -> Optional[str]:
        with self._lock:
            p = self._pod(pod, ns)
            return p.node if p else None

    def get_pod_annotations(self, pod: str, ns: str) -> Optional[Dict[str, str]]:
        with self._lock:
            p = self._pod(pod, ns)
            return dict(p.annotations) if p else None

    def get_cfg_annotations(self, pod: str, ns: str) -> Optional[str]:
        with self._lock:
            p = self._pod(pod, ns)
            return p.annotations.get(CFG_ANNOTATION) if p else None

    def get_cfg_type(self, pod: str, ns: str) -> Optional[str]:
        with self._lock:
            p = self._pod(pod, ns)
            return p.annotations.get(CFG_TYPE_ANNOTATION) if p else None

    def get_pod_node_groups(self, pod: str, ns: str) -> List[str]:
        with self._lock:
            p = self._pod(pod, ns)
            if p and GROUPS_ANNOTATION in p.annotations:
                return p.annotations[GROUPS_ANNOTATION].split(".")
            return ["default"]

    def get_requested_pod_resources(self, pod: str, ns: str) -> Dict[str, str]:
        with self._lock:
            p = self._pod(pod, ns)
            return dict(p.resources) if p else {}

    def get_pod_created(self, pod: str, ns: str) -> Optional[float]:
        with self._lock:
            p = self._pod(pod, ns)
            return p.created if p else None

    def clock_now(self) -> float:
        return self.clock()

    def get_scheduled_pods(self, scheduler: str) -> List[Tuple[str, str, str, str]]:
        with self._lock:
            return [
                (p.name, p.namespace, p.uid, p.phase)
                for p in self.pods.values()
                if p.scheduler_name == scheduler and p.node is not None
            ]

    def service_pods(self, scheduler: str):
        with self._lock:
            return {
                (p.namespace, p.name, p.uid): (p.phase, p.node)
                for p in self.pods.values()
                if p.scheduler_name == scheduler
            }

    def get_cfg_map(self, pod: str, ns: str) -> Tuple[Optional[str], Optional[str]]:
        with self._lock:
            p = self._pod(pod, ns)
            if not p or not p.configmap_name:
                return (None, None)
            return (p.configmap_name, self.configmaps.get((ns, p.configmap_name)))

    # ------------------------------------------------------------------
    # ClusterBackend: writes
    # ------------------------------------------------------------------

    def _check_fence(
        self, epoch: Optional[int], lease_name: Optional[str] = None
    ) -> None:
        """Reject a fenced write whose epoch a newer acquisition of the
        named lease has already overtaken. Caller holds ``self._lock``,
        so the check is atomic with the write itself — the property that
        makes fencing tokens sound (a deposed leader can't slip a write
        in between the check and the mutation). ``lease_name`` selects
        the shard lease under federation; None = the default lease."""
        if epoch is None:
            return
        lease = self.leases.get(lease_name or self.fence_lease_name)
        if lease is not None and epoch < lease.epoch:
            API_COUNTERS.inc("ha_stale_writes_rejected_total")
            raise StaleLeaseError(
                f"write fenced off: epoch {epoch} is stale "
                f"(current lease epoch {lease.epoch}, "
                f"holder {lease.holder!r})"
            )

    def add_nad_to_pod(
        self, pod: str, ns: str, nad: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None:
                return False
            p.annotations[NAD_ANNOTATION] = nad
            return True

    def annotate_pod_config(
        self, ns: str, pod: str, cfg: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None:
                return False
            p.annotations[CFG_ANNOTATION] = cfg
            return True

    def annotate_pod_gpu_map(
        self, ns: str, pod: str, gpu_map: Dict[str, int],
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None:
                return False
            for dev, devid in gpu_map.items():
                p.annotations[f"{GPU_MAP_ANNOTATION_PREFIX}.{dev}"] = str(devid)
            return True

    def annotate_pod_meta(
        self, ns: str, pod: str, key: str, value: str,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None:
                return False
            p.annotations[key] = value
            return True

    def claim_spillover_pod(
        self, ns: str, pod: str, claim_lease: str, claim_epoch: int,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None:
                return False
            rec = parse_spill_record(p.annotations.get(SPILLOVER_ANNOTATION))
            cur = rec.get("claim")
            if cur is not None and cur != (claim_lease, claim_epoch):
                # a foreign claim blocks us only while it is LIVE: its
                # lease still held under the claimed epoch. A crashed or
                # deposed claimant's shard lease re-acquires with a
                # higher epoch, so its claim goes stale by itself.
                lease = self.leases.get(cur[0])
                if (
                    lease is not None and lease.holder
                    and lease.expires > self.clock()
                    and lease.epoch == cur[1]
                ):
                    return False
            rec["claim"] = (claim_lease, claim_epoch)
            p.annotations[SPILLOVER_ANNOTATION] = render_spill_record(rec)
            return True

    def bind_pod_to_node(
        self, pod: str, node: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None or (ns, pod) in self.fail_bind_for:
                return False
            p.node = node
            p.phase = "Running"  # kubelet admission, fast-forwarded
            self.bind_count += 1
            self.bind_log.append((
                ns, pod, p.uid, node, epoch,
                (fence_lease or self.fence_lease_name)
                if epoch is not None else None,
            ))
            return True

    def evict_pod(
        self, pod: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Preemption eviction: unbind the pod back to Pending. The
        solved-config annotations (and the ConfigMap) survive so the
        scheduler's unwind/release path works from them, and the pod
        keeps its uid — an evicted pod is the SAME incarnation requeued,
        which is what lets the flight recorder show one preempt→rebind
        journey per victim. Fenced exactly like bind (a deposed leader's
        in-flight preemption must not land)."""
        with self._lock:
            self._check_fence(epoch, fence_lease)
            p = self._pod(pod, ns)
            if p is None or p.node is None:
                return False
            self.evict_log.append((
                ns, pod, p.uid, p.node, epoch,
                (fence_lease or self.fence_lease_name)
                if epoch is not None else None,
            ))
            p.node = None
            p.phase = "Pending"
            return True

    def generate_pod_event(self, pod, ns, reason, event_type, message) -> None:
        with self._lock:
            self.events.append(
                PodEvent(pod, ns, reason, event_type, f"NHD: {message}")
            )

    # ------------------------------------------------------------------
    # coordination leases (leader election, k8s/lease.py)
    # ------------------------------------------------------------------

    def _lease_view(self, lease: FakeLease) -> LeaseView:
        return LeaseView(
            name=lease.name, holder=lease.holder,
            epoch=lease.epoch, expires=lease.expires,
        )

    def lease_try_acquire(self, name: str, holder: str, ttl: float) -> LeaseView:
        with self._lock:
            now = self.clock()
            lease = self.leases.setdefault(name, FakeLease(name=name))
            taken = lease.holder and lease.expires > now
            if taken and lease.holder != holder:
                return self._lease_view(lease)   # held by someone else
            # unheld, expired, or our own stale incarnation: every
            # acquisition bumps the epoch — the token must be fresh even
            # for a same-holder re-acquire after a crash/restart
            lease.holder = holder
            lease.epoch += 1
            lease.expires = now + ttl
            return self._lease_view(lease)

    def lease_renew(self, name: str, holder: str, epoch: int, ttl: float) -> bool:
        with self._lock:
            lease = self.leases.get(name)
            if lease is None or lease.holder != holder or lease.epoch != epoch:
                return False
            lease.expires = self.clock() + ttl
            return True

    def lease_release(self, name: str, holder: str, epoch: int) -> bool:
        with self._lock:
            lease = self.leases.get(name)
            if lease is None or lease.holder != holder or lease.epoch != epoch:
                return False
            lease.holder = ""
            lease.expires = 0.0      # epoch survives: tokens never rewind
            return True

    def lease_read(self, name: str) -> Optional[LeaseView]:
        with self._lock:
            lease = self.leases.get(name)
            return self._lease_view(lease) if lease else None

    def lease_live(self, name: str) -> str:
        with self._lock:
            lease = self.leases.get(name)
            if lease is None or not lease.holder:
                return ""
            return lease.holder if lease.expires > self.clock() else ""

    # ------------------------------------------------------------------
    # watch + TriadSets
    # ------------------------------------------------------------------

    def _emit_watch(self, ev: WatchEvent) -> None:
        with self._watch_cv:
            self._watch.append(ev)
            self._watch_cv.notify_all()

    def poll_watch_events(self, timeout: float = 0.0) -> Iterable[WatchEvent]:
        with self._watch_cv:
            if not self._watch and timeout:
                # block until an emitter notifies (or the timeout lapses):
                # the controller's event loop wakes on arrival instead of
                # sleeping out its poll interval (bind latency is queue
                # latency on this path)
                self._watch_cv.wait(timeout)
            out, self._watch = self._watch, []
            return out

    def list_triadsets(self) -> List[dict]:
        with self._lock:
            return list(self.triadsets)

    def list_pods_of_triadset(self, ts: dict) -> List[str]:
        with self._lock:
            prefix = ts["service_name"] + "-"
            return [
                p.name for p in self.pods.values()
                if p.namespace == ts["ns"] and p.name.startswith(prefix)
                and p.name[len(prefix):].isdigit()
            ]

    def create_pod_for_triadset(self, ts: dict, ordinal: int) -> bool:
        name = f"{ts['service_name']}-{ordinal}"
        pod = self.create_pod(name, ts["ns"], cfg_text=ts["cfg_text"])
        pod.hostname = name
        pod.subdomain = ts["service_name"]
        return True

    def update_triadset_status(self, ts: dict, replicas: int) -> bool:
        with self._lock:
            for item in self.triadsets:
                if item["name"] == ts["name"] and item["ns"] == ts["ns"]:
                    item["status_replicas"] = replicas
                    return True
            return False
