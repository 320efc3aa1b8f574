"""Real Kubernetes backend: the reference K8SMgr surface on kubernetes-client.

Method-for-method port of the reference's API-server interactions
(K8SMgr.py), behind the ClusterBackend seam. Import is gated: the
kubernetes package is only required when this backend is actually
constructed, so hermetic environments (tests, benchmarks, this dev image)
never need it.

The watch plane differs from the reference by design: instead of kopf's
asyncio operators (TriadController.py:161-171), watches run in daemon
threads that translate raw API events into WatchEvent records drained by
the controller — same information, no framework dependency.
"""

from __future__ import annotations

import os
import queue
import threading
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
    ClusterBackend,
    LeaseView,
    StaleLeaseError,
    TransientBackendError,
    WatchEvent,
    parse_spill_record,
    render_spill_record,
)
from nhd_tpu_torch.k8s.retry import API_COUNTERS, RetryPolicy, RetryingApi, retryable
from nhd_tpu_torch.sanitizer.races import maybe_watch
from nhd_tpu_torch.utils import get_logger

# Periodic full-relist resync cadence (seconds; 0 disables). A dropped
# watch event — queue overflow, proxy hiccup, the etcd compaction window —
# would otherwise leave the backend stale FOREVER; the resync diffs a full
# list against watch-derived state and emits synthetic events for anything
# missed (docs/RESILIENCE.md).
_RESYNC_DEFAULT_SEC = float(os.environ.get("NHD_RESYNC_SEC", "300"))

# last-seen pod snapshot: (uid, annotations, scheduler_name, node,
# created) — what a synthetic delete event must carry after the object is
# gone, plus the creationTimestamp (epoch seconds or None) so the SLO
# engine's per-bind get_pod_created is a dict lookup, not a pod GET
_PodSnap = Tuple[str, Dict[str, str], str, str, Optional[float]]

# namespace holding the election Lease object (the scheduler Deployment's
# own namespace in the 2-replica recipe, docs/OPERATIONS.md)
_LEASE_NS_DEFAULT = os.environ.get("NHD_LEASE_NS", "default")

# fence-check cache window (seconds; 0 = a fresh Lease GET per fenced
# write). A pod commit runs up to 4 fenced mutators — without the cache
# that is 4 serial Lease GETs per pod on the hot bind path. Caching only
# delays noticing a NEWER epoch by at most this window, which is the same
# order as the check-then-write race the kube fence already has (the
# atomic rejection lives in the fake backend / chaos harness); keep it
# well under the lease TTL.
_FENCE_CACHE_SEC = float(os.environ.get("NHD_FENCE_CACHE_SEC", "1.0"))

# K8s MicroTime wire format (Lease spec.acquireTime/renewTime)
_MICRO_TIME_FMT = "%Y-%m-%dT%H:%M:%S.%fZ"


def _micro_time(ts: float) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime(_MICRO_TIME_FMT)


def _parse_micro_time(raw: Optional[str]) -> Optional[float]:
    if not raw:
        return None
    import datetime

    for fmt in (_MICRO_TIME_FMT, "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.datetime.strptime(raw, fmt).replace(
                tzinfo=datetime.timezone.utc
            ).timestamp()
        except ValueError:
            continue
    return None


class KubeClusterBackend(ClusterBackend):
    """kubernetes-client implementation (reference: K8SMgr.py)."""

    #: real API round trips per commit: overlap them with the next
    #: batch's admission+solve by default (scheduler/commitpipe.py;
    #: NHD_ASYNC_COMMIT=0 restores the strictly synchronous path)
    ASYNC_COMMIT_DEFAULT = True

    def __init__(
        self,
        start_watches: bool = True,
        *,
        retry_policy: Optional[RetryPolicy] = None,
        resync_interval: Optional[float] = None,
    ):
        using_restclient = False
        try:
            import kubernetes  # noqa: F401
            from kubernetes import client, config, watch
        except ImportError:
            # no kubernetes package: fall back to the in-repo REST client
            # (nhd_tpu/k8s/restclient.py — same surface over real HTTP, the
            # way config/libconfig.py replaces libconf)
            from nhd_tpu_torch.k8s import restclient

            client = restclient.client
            config = restclient.config
            watch = restclient.watch
            using_restclient = True

        self.logger = get_logger(__name__)
        self._client = client
        self._watch_mod = watch
        try:
            config.load_incluster_config()
        except Exception:
            # outside a pod: fall back to kubeconfig (K8SMgr.py:43-46)
            try:
                config.load_kube_config()
            except Exception as exc:
                raise RuntimeError(
                    "no cluster configuration found (neither in-cluster "
                    "env nor a kubeconfig); KubeClusterBackend needs an "
                    "API server to talk to — use FakeClusterBackend for "
                    f"hermetic runs ({exc})"
                ) from exc
        # every non-watch call runs under the retry policy (transient
        # 429/5xx/network faults never surface to the scheduler); watch
        # establishment passes through — the reconnect loop below owns it
        self._retry = retry_policy or RetryPolicy(
            exc_class=client.exceptions.ApiException
        )
        self.v1 = RetryingApi(client.CoreV1Api(), self._retry)
        self.crd = RetryingApi(client.CustomObjectsApi(), self._retry)
        self._events: "queue.Queue[WatchEvent]" = queue.Queue()
        # pause between watch reconnects (the API server ends streams
        # routinely; an immediate retry loop would hammer it)
        self._watch_backoff = 1.0
        self._watch_stop = threading.Event()
        # registered Watch objects, for stop; appended by the watch
        # threads while stop_watches may iterate from another thread, so
        # all access goes through _watch_lock (nhdlint NHD201)
        self._watch_lock = threading.Lock()
        self._watchers: List[object] = []
        # watch-derived state, diffed by resync(); written by the watch
        # threads and read by the resync thread → _state_lock. The touch
        # sequence orders watch updates against resync's relist: anything
        # the watch touched AFTER the relist began is fresher than the
        # listing, and resync must not "repair" it with stale data
        self._state_lock = threading.Lock()
        self._known_pods: Dict[Tuple[str, str], _PodSnap] = {}
        self._node_last: Dict[str, tuple] = {}
        self._watch_seq = 0
        self._pod_touched: Dict[Tuple[str, str], int] = {}
        self._node_touched: Dict[str, int] = {}
        # sequence point of the relist currently in flight (None when
        # none is): delete tombstones older than this are prunable
        self._relist_floor: Optional[int] = None
        self._resync_interval = (
            _RESYNC_DEFAULT_SEC if resync_interval is None else resync_interval
        )
        # HA lease plumbing (k8s/lease.py): the namespace the election
        # Lease lives in, and the DEFAULT lease fenced writes are checked
        # against when the caller names none (shard leases arrive per
        # call via the fence_lease kwarg)
        self._lease_ns = _LEASE_NS_DEFAULT
        self.fence_lease_name = LEASE_NAME
        # fence-check cache, per lease name: (valid-until monotonic
        # stamp, LeaseView or None); written by commit threads under
        # _fence_lock. Only _check_fence reads through it — the election
        # itself (lease_renew/lease_try_acquire) always goes to the
        # server. _lease_epoch_hwm is the per-lease epoch high-water
        # mark: EVERY lease state this process observes (acquire, renew,
        # read) advances it, so a rival acquisition seen through any
        # lease operation fences stale writes immediately — ahead of the
        # cache window (tests/test_kube_faults.py pins this).
        self._fence_lock = threading.Lock()
        self._fence_cached: Dict[str, Tuple[float, Optional[LeaseView]]] = {}
        self._lease_epoch_hwm: Dict[str, int] = {}
        # dead-socket defense on the watch plane: the restclient bakes a
        # finite read timeout into stream requests itself; the real
        # kubernetes client needs it passed per stream() call. Gated on
        # the Watch.stream signature accepting **kwargs so stub Watch
        # implementations (tests) keep working unchanged.
        self._watch_kwargs: Dict[str, object] = {}
        if not using_restclient:
            import inspect

            try:
                params = inspect.signature(watch.Watch.stream).parameters
                accepts_kw = any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()
                )
            except (TypeError, ValueError):
                accepts_kw = False
            if accepts_kw:
                # one parse site for the timeout (restclient owns it) so
                # the two client paths can never drift apart
                from nhd_tpu_torch.k8s.restclient import _WATCH_READ_TIMEOUT

                self._watch_kwargs = {
                    "_request_timeout": (30.0, _WATCH_READ_TIMEOUT)
                }
        # dynamic race layer (NHD_RACE=1): the watch/resync sequence
        # fields are written by three watcher threads, always under
        # _state_lock — registered before the watchers spawn
        maybe_watch(self, ("_watch_seq", "_relist_floor"))
        if start_watches:
            self._start_watches()

    # ------------------------------------------------------------------
    # node reads
    # ------------------------------------------------------------------

    def get_nodes(self) -> List[str]:
        """KubeletReady nodes (K8SMgr.py:55-69)."""
        out = []
        for item in self.v1.list_node().items:
            for cond in item.status.conditions or []:
                if cond.reason == "KubeletReady" and cond.status == "True":
                    out.append(item.metadata.name)
        return out

    def is_node_active(self, node: str) -> bool:
        """Scheduler taint present and node not cordoned (K8SMgr.py:167-192)."""
        obj = self.v1.read_node(node)
        has_taint = any(
            t.key == SCHEDULER_TAINT and t.effect == "NoSchedule"
            for t in (obj.spec.taints or [])
        )
        return has_taint and not bool(obj.spec.unschedulable)

    def get_node_labels(self, node: str) -> Dict[str, str]:
        return dict(self.v1.read_node(node).metadata.labels or {})

    def get_node_addr(self, node: str) -> str:
        """First InternalIP (K8SMgr.py:91-106)."""
        for addr in self.v1.read_node(node).status.addresses or []:
            if addr.type == "InternalIP":
                return addr.address
        return ""

    def get_node_hugepage_resources(self, node: str) -> Tuple[int, int]:
        """1Gi hugepage capacity/allocatable in GiB (K8SMgr.py:71-89)."""
        obj = self.v1.read_node(node)

        def gi(res: Optional[dict]) -> int:
            if not res:
                return 0
            val = res.get("hugepages-1Gi", "0")
            return int(str(val).rstrip("Gi")) if "Gi" in str(val) else int(val)

        return (gi(obj.status.capacity), gi(obj.status.allocatable))

    # ------------------------------------------------------------------
    # pod reads
    # ------------------------------------------------------------------

    def _read_pod(self, pod: str, ns: str):
        try:
            return self.v1.read_namespaced_pod(pod, ns)
        except self._client.exceptions.ApiException as exc:
            if retryable(exc):
                # retry budget spent / circuit open: 'unavailable' must
                # not masquerade as 'pod does not exist' — that would
                # mass-fail healthy pods with FailedCfgParse during an
                # outage. Callers' loop isolation owns the recovery.
                raise TransientBackendError(
                    f"read of {ns}/{pod} failed transiently: {exc}"
                ) from exc
            return None

    def pod_exists(self, pod: str, ns: str) -> bool:
        return self._read_pod(pod, ns) is not None

    def get_pod_node(self, pod: str, ns: str) -> Optional[str]:
        obj = self._read_pod(pod, ns)
        return obj.spec.node_name if obj else None

    def get_pod_annotations(self, pod: str, ns: str) -> Optional[Dict[str, str]]:
        obj = self._read_pod(pod, ns)
        return dict(obj.metadata.annotations or {}) if obj else None

    def get_pod_annotations_cached(
        self, pod: str, ns: str
    ) -> Optional[Dict[str, str]]:
        """Watch-level freshness from the _PodSnap mirror — the
        trace-corr adoption read per pod per batch stays a dict lookup
        instead of a pod GET; live read only for pods the watch has not
        delivered."""
        with self._state_lock:
            snap = self._known_pods.get((ns, pod))
        if snap is not None:
            return dict(snap[1])
        return self.get_pod_annotations(pod, ns)

    def get_pod_created(self, pod: str, ns: str) -> Optional[float]:
        """metadata.creationTimestamp as epoch seconds (the wall-clock
        domain clock_now reports in) — the SLO time-to-bind origin,
        owned by the API server so it survives spills and restarts.
        Served from the watch-derived snapshot (creationTimestamp is
        immutable, and _known_pods tracks delete/re-create) so the
        per-bind SLO observation costs a dict lookup, not a pod GET;
        the GET is only the cold-start fallback for pods the watch has
        not delivered."""
        with self._state_lock:
            snap = self._known_pods.get((ns, pod))
        if snap is not None and snap[4] is not None:
            return snap[4]
        return self._created_ts(self._read_pod(pod, ns))

    def get_cfg_annotations(self, pod: str, ns: str) -> Optional[str]:
        annots = self.get_pod_annotations(pod, ns)
        return annots.get(CFG_ANNOTATION) if annots else None

    def get_cfg_type(self, pod: str, ns: str) -> Optional[str]:
        annots = self.get_pod_annotations(pod, ns)
        return annots.get(CFG_TYPE_ANNOTATION) if annots else None

    def get_pod_node_groups(self, pod: str, ns: str) -> List[str]:
        annots = self.get_pod_annotations(pod, ns) or {}
        if GROUPS_ANNOTATION in annots:
            return annots[GROUPS_ANNOTATION].split(".")
        return ["default"]

    def get_requested_pod_resources(self, pod: str, ns: str) -> Dict[str, str]:
        """First container only, like the reference (K8SMgr.py:215-225)."""
        obj = self._read_pod(pod, ns)
        if not obj or not obj.spec.containers:
            return {}
        res = obj.spec.containers[0].resources
        return dict(res.requests or {}) if res else {}

    def get_scheduled_pods(self, scheduler: str) -> List[Tuple[str, str, str, str]]:
        out = []
        for p in self.v1.list_pod_for_all_namespaces().items:
            if p.spec.scheduler_name == scheduler and p.spec.node_name:
                out.append(
                    (p.metadata.name, p.metadata.namespace, p.metadata.uid,
                     p.status.phase)
                )
        return out

    def service_pods(self, scheduler: str):
        out = {}
        for p in self.v1.list_pod_for_all_namespaces().items:
            if p.spec.scheduler_name == scheduler:
                key = (p.metadata.namespace, p.metadata.name, p.metadata.uid)
                out[key] = (p.status.phase, p.spec.node_name)
        return out

    def get_cfg_map(self, pod: str, ns: str) -> Tuple[Optional[str], Optional[str]]:
        """Find the pod's ConfigMap volume, return its first file
        (K8SMgr.py:328-356)."""
        obj = self._read_pod(pod, ns)
        if obj is None:
            return (None, None)
        for vol in obj.spec.volumes or []:
            if vol.config_map is None:
                continue
            try:
                cm = self.v1.read_namespaced_config_map(vol.config_map.name, ns)
            except self._client.exceptions.ApiException as exc:
                if retryable(exc):
                    raise TransientBackendError(
                        f"configmap {ns}/{vol.config_map.name} read failed "
                        f"transiently: {exc}"
                    ) from exc
                # a pod can reference a ConfigMap that doesn't exist (yet);
                # that fails the pod (FailedCfgParse), never the scheduler
                self.logger.error(
                    f"configmap {ns}/{vol.config_map.name} unreadable: {exc}"
                )
                continue
            if cm.data:
                return (vol.config_map.name, next(iter(cm.data.values())))
        return (None, None)

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def _patch_annotation(self, pod: str, ns: str, annots: Dict[str, str]) -> bool:
        try:
            self.v1.patch_namespaced_pod(
                pod, ns, {"metadata": {"annotations": annots}}
            )
            return True
        except self._client.exceptions.ApiException as exc:
            if retryable(exc):
                # retry budget already spent inside the policy: surface as
                # transient so the scheduler requeues instead of failing
                # the pod (scheduler/core.py commit path)
                raise TransientBackendError(
                    f"annotation patch for {ns}/{pod} failed transiently: {exc}"
                ) from exc
            self.logger.error(f"annotation patch failed for {ns}/{pod}: {exc}")
            return False

    def _note_lease_epoch(self, name: str, view: Optional[LeaseView]) -> None:
        """Advance the per-lease epoch high-water mark with an observed
        lease state. Called from every lease-reading path, so any rival
        acquisition this process sees — its own elector's CAS loss, a
        federation peer's shard acquisition through the same backend, a
        fence-check read — immediately fences writes stamped with older
        epochs, without waiting out the fence cache window."""
        if view is None:
            return
        with self._fence_lock:
            if view.epoch > self._lease_epoch_hwm.get(name, 0):
                self._lease_epoch_hwm[name] = view.epoch

    def _check_fence(
        self, epoch: Optional[int], lease_name: Optional[str] = None
    ) -> None:
        """Reject a fenced write whose epoch a newer lease acquisition has
        overtaken. Kubernetes has no conditional bind, so unlike the fake
        backend this is check-then-write, not atomic — the check (a Lease
        GET under the retry policy, cached per lease for
        NHD_FENCE_CACHE_SEC so a pod commit's fenced mutators don't pay
        serial round trips) narrows the deposed-leader window to one
        round trip plus the cache window, and the epoch high-water mark
        (_note_lease_epoch) closes the cache window entirely for any
        rival leadership this process has already observed; the atomic
        form of the rejection is what the split-brain chaos harness
        proves against the fake (docs/RESILIENCE.md)."""
        if epoch is None:
            return
        name = lease_name or self.fence_lease_name
        import time as _time

        now = _time.monotonic()
        with self._fence_lock:
            hwm = self._lease_epoch_hwm.get(name, 0)
        if epoch < hwm:
            API_COUNTERS.inc("ha_stale_writes_rejected_total")
            raise StaleLeaseError(
                f"write fenced off: epoch {epoch} is stale (epoch {hwm} "
                f"already observed for lease {name!r})"
            )
        view = None
        fresh = False
        if _FENCE_CACHE_SEC > 0:
            with self._fence_lock:
                cached = self._fence_cached.get(name)
            if cached is not None and now < cached[0]:
                view, fresh = cached[1], True
        if not fresh:
            view = self.lease_read(name)
            with self._fence_lock:
                self._fence_cached[name] = (now + _FENCE_CACHE_SEC, view)
        if view is not None and epoch < view.epoch:
            API_COUNTERS.inc("ha_stale_writes_rejected_total")
            raise StaleLeaseError(
                f"write fenced off: epoch {epoch} is stale (current lease "
                f"epoch {view.epoch}, holder {view.holder!r})"
            )

    def add_nad_to_pod(
        self, pod: str, ns: str, nad: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        self._check_fence(epoch, fence_lease)
        return self._patch_annotation(pod, ns, {NAD_ANNOTATION: nad})

    def annotate_pod_config(
        self, ns: str, pod: str, cfg: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        self._check_fence(epoch, fence_lease)
        return self._patch_annotation(pod, ns, {CFG_ANNOTATION: cfg})

    def annotate_pod_gpu_map(
        self, ns: str, pod: str, gpu_map: Dict[str, int],
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        self._check_fence(epoch, fence_lease)
        return self._patch_annotation(
            pod, ns,
            {f"{GPU_MAP_ANNOTATION_PREFIX}.{d}": str(i) for d, i in gpu_map.items()},
        )

    def annotate_pod_meta(
        self, ns: str, pod: str, key: str, value: str,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        self._check_fence(epoch, fence_lease)
        return self._patch_annotation(pod, ns, {key: value})

    def claim_spillover_pod(
        self, ns: str, pod: str, claim_lease: str, claim_epoch: int,
        *, epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Check-then-write like every kube fence (no conditional patch
        on the annotation surface): read the spillover record, honor a
        live foreign claim, else write ours. The window is one RTT — the
        atomic form is what the fake backend provides the chaos proofs."""
        self._check_fence(epoch, fence_lease)
        annots = self.get_pod_annotations(pod, ns)
        if annots is None:
            return False
        rec = parse_spill_record(annots.get(SPILLOVER_ANNOTATION))
        cur = rec.get("claim")
        if cur is not None and cur != (claim_lease, claim_epoch):
            view = self.lease_read(cur[0])
            import time as _time

            if (
                view is not None and view.holder
                and view.expires > _time.time()
                and view.epoch == cur[1]
            ):
                return False  # live foreign claim
        rec["claim"] = (claim_lease, claim_epoch)
        return self._patch_annotation(
            pod, ns, {SPILLOVER_ANNOTATION: render_spill_record(rec)}
        )

    def bind_pod_to_node(
        self, pod: str, node: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """V1Binding; the known kubernetes-client ValueError on the empty
        response is swallowed like the reference does (K8SMgr.py:487-491)."""
        self._check_fence(epoch, fence_lease)
        client = self._client
        body = client.V1Binding(
            metadata=client.V1ObjectMeta(name=pod),
            target=client.V1ObjectReference(
                api_version="v1", kind="Node", name=node, namespace=ns
            ),
        )
        try:
            self.v1.create_namespaced_pod_binding(pod, ns, body)
        except ValueError:
            pass  # client chokes on the empty 201 body; bind succeeded
        except client.exceptions.ApiException as exc:
            if retryable(exc):
                # the policy's retries are exhausted but the failure is a
                # server-health problem, not a verdict on this bind —
                # requeue the pod rather than failing it (docs/RESILIENCE.md)
                raise TransientBackendError(
                    f"bind for {ns}/{pod} -> {node} failed transiently: {exc}"
                ) from exc
            self.logger.error(f"bind failed for {ns}/{pod} -> {node}: {exc}")
            return False
        return True

    def evict_pod(
        self, pod: str, ns: str, *,
        epoch: Optional[int] = None, fence_lease: Optional[str] = None,
    ) -> bool:
        """Preemption eviction via the Eviction subresource (the API
        server honors PodDisruptionBudgets, which is exactly the extra
        guard an operator wants under policy preemption). Fenced like
        bind; a transient server fault surfaces as
        TransientBackendError so the scheduler's preemption attempt
        aborts cleanly (unevicted victims keep their bindings, the
        preemptor requeues).

        Semantics note (docs/SCHEDULING_POLICIES.md): Kubernetes has no
        unbind — Eviction DELETES the pod, and its owning controller
        (TriadSet) recreates it as a NEW incarnation with a fresh uid.
        The scheduler's same-incarnation victim requeue is therefore a
        best-effort fast path here: the deleted pod fails its
        pod_exists gate at re-admission and the replacement schedules
        through the normal create path instead. The fake backend's
        unbind-to-Pending (same uid, one corr journey) is the
        SIMULATION model the chaos invariants run against."""
        self._check_fence(epoch, fence_lease)
        client = self._client
        body = client.V1Eviction(
            metadata=client.V1ObjectMeta(name=pod, namespace=ns),
        )
        try:
            self.v1.create_namespaced_pod_eviction(pod, ns, body)
        except ValueError:
            pass  # empty-body client quirk, same as bind: evict succeeded
        except client.exceptions.ApiException as exc:
            if retryable(exc):
                raise TransientBackendError(
                    f"evict of {ns}/{pod} failed transiently: {exc}"
                ) from exc
            self.logger.error(f"evict failed for {ns}/{pod}: {exc}")
            return False
        return True

    def generate_pod_event(self, pod, ns, reason, event_type, message) -> None:
        """'NHD:'-prefixed V1Event on the pod (K8SMgr.py:518-559)."""
        import datetime

        client = self._client
        obj = self._read_pod(pod, ns)
        if obj is None:
            return
        now = datetime.datetime.now(datetime.timezone.utc)
        body = client.CoreV1Event(
            metadata=client.V1ObjectMeta(generate_name=f"{pod}.nhd."),
            involved_object=client.V1ObjectReference(
                api_version="v1", kind="Pod", name=pod, namespace=ns,
                uid=obj.metadata.uid,
            ),
            reason=reason, message=f"NHD: {message}",
            type=event_type.value, count=1,
            first_timestamp=now, last_timestamp=now,
            source=client.V1EventSource(component="nhd-scheduler"),
        )
        try:
            self.v1.create_namespaced_event(ns, body)
        except client.exceptions.ApiException as exc:
            self.logger.error(f"event post failed for {ns}/{pod}: {exc}")

    # ------------------------------------------------------------------
    # watch plane
    # ------------------------------------------------------------------

    def _start_watches(self) -> None:
        self._seed_known_state()
        threading.Thread(target=self._watch_pods, daemon=True).start()
        threading.Thread(target=self._watch_nodes, daemon=True).start()
        if self._resync_interval > 0:
            threading.Thread(target=self._resync_loop, daemon=True).start()

    def _seed_known_state(self) -> None:
        """Baseline _known_pods/_node_last from a relist before the
        watches start. A watch established without a resourceVersion does
        NOT replay existing objects, so without this every pre-existing
        pod's first MODIFIED would look like a missed create (one
        synthetic pod_create + warning per pod, cluster-wide, on every
        process start). Consumers don't need those events at startup —
        the scheduler replays deployed state from the cluster itself
        (load_deployed_configs / check_pending_pods)."""
        try:
            with self._state_lock:
                for p in self.v1.list_pod_for_all_namespaces().items:
                    key = (p.metadata.namespace, p.metadata.name)
                    self._known_pods[key] = self._pod_snap(p)
                for n in self.v1.list_node().items:
                    self._node_last[n.metadata.name] = self._node_snap(n)
        except Exception as exc:
            # seeding is an optimization, not a correctness requirement:
            # the watch threads and resync cope with an empty baseline
            self.logger.warning(f"initial state seed failed: {exc}")

    def _register_watcher(self, w: object) -> None:
        with self._watch_lock:
            self._watchers.append(w)
            stopping = self._watch_stop.is_set()
        if stopping:
            # stop_watches already swept the list; a watcher registering
            # after its snapshot would never be stopped (leaked stream) —
            # stop it here instead of racing the sweep
            self._stop_watcher(w)

    @staticmethod
    def _created_ts(obj) -> Optional[float]:
        ts = getattr(obj.metadata, "creation_timestamp", None) if obj else None
        if ts is None:
            return None
        try:
            return ts.timestamp()
        except (AttributeError, ValueError):
            return None

    @staticmethod
    def _pod_snap(obj) -> _PodSnap:
        return (
            obj.metadata.uid,
            dict(obj.metadata.annotations or {}),
            obj.spec.scheduler_name or "",
            obj.spec.node_name or "",
            KubeClusterBackend._created_ts(obj),
        )

    def _note_pod(self, ev_type: str, obj) -> Optional[WatchEvent]:
        """Update watch-derived pod state; return the event to emit (or
        None when the event is state-only).

        After a 410 Gone the fresh full-replay watch re-delivers ADDED for
        every live object — an already-known (ns, name, uid) upserts the
        snapshot quietly instead of double-emitting pod_create (the
        regression test pins this, tests/test_kube_faults.py). MODIFIED
        events for a *known* pod are state-only: the snapshot stays fresh
        so a later delete event carries current annotations/node, but
        nothing is emitted (same information policy as before). A MODIFIED
        for an UNKNOWN pod means its create event was lost — emit the
        pod_create now; recording it silently would mark the pod 'known'
        and stop resync from ever repairing the miss."""
        if ev_type not in ("ADDED", "MODIFIED", "DELETED"):
            # BOOKMARK/ERROR/unknown: the object isn't a Pod (an in-band
            # ERROR carries a Status) — never reach into it
            return None
        key = (obj.metadata.namespace, obj.metadata.name)
        snap = self._pod_snap(obj)
        with self._state_lock:
            self._watch_seq += 1
            if ev_type == "DELETED":
                self._known_pods.pop(key, None)
                self._pod_touched[key] = self._watch_seq
                # opportunistic tombstone prune: delete entries only guard
                # in-flight relists, so anything older than the active
                # relist floor (or everything, when no relist runs — e.g.
                # resync disabled) is dead weight on a churny cluster
                if len(self._pod_touched) > 2 * len(self._known_pods) + 256:
                    floor = self._relist_floor
                    for k in list(self._pod_touched):
                        if k not in self._known_pods and (
                            floor is None or self._pod_touched[k] < floor
                        ):
                            del self._pod_touched[k]
            else:
                prior = self._known_pods.get(key)
                self._known_pods[key] = snap
                self._pod_touched[key] = self._watch_seq
                if ev_type == "ADDED" and prior is not None and prior[0] == snap[0]:
                    API_COUNTERS.inc("watch_dedup_replays_total")
                    return None
        if ev_type == "DELETED":
            kind = "pod_delete"
        elif ev_type == "ADDED":
            kind = "pod_create"
        elif ev_type == "MODIFIED" and prior is None:
            # first sight of this pod: the ADDED was missed upstream
            self.logger.warning(
                f"MODIFIED for unknown pod {key[0]}/{key[1]}; emitting "
                "the missed pod_create"
            )
            kind = "pod_create"
        else:
            return None
        return WatchEvent(
            kind=kind, name=key[1], namespace=key[0],
            annotations=dict(snap[1]), uid=snap[0],
            scheduler_name=snap[2], node=snap[3],
        )

    def _note_watch_exc(self, plane: str, exc: Exception) -> None:
        """Log a watch-stream failure at the right volume. On the real
        kubernetes client the finite read timeout surfaces HERE as an
        exception every quiet 60s (the restclient translates it to a
        silent stream end internally) — that expected recycling must not
        produce an ERROR line per minute on a healthy idle cluster."""
        name = type(exc).__name__
        if isinstance(exc, OSError) or "Timeout" in name:
            API_COUNTERS.inc("watch_read_timeouts_total")
            self.logger.info(f"{plane} watch stream ended ({name}); reconnecting")
        else:
            self.logger.error(f"{plane} watch restarted: {exc}")

    def _watch_error(self, w: object, ev: dict) -> bool:
        """Handle an in-band ERROR watch event (expired resourceVersion
        delivered as a Status object instead of an HTTP 410). Clears the
        tracked resourceVersion so the reconnect starts a fresh watch —
        without this, every reconnect replays the same stale RV and the
        watch degenerates into a permanent error loop."""
        if ev.get("type") != "ERROR":
            return False
        if getattr(w, "resource_version", None) is not None:
            w.resource_version = None
        self.logger.warning(
            "in-band watch ERROR (expired resourceVersion?); "
            "reconnecting with a fresh watch"
        )
        return True

    def _watch_pods(self) -> None:
        w = self._watch_mod.Watch()
        self._register_watcher(w)
        first = True
        while not self._watch_stop.is_set():
            if not first:
                API_COUNTERS.inc("watch_reconnects_total")
            first = False
            try:
                for ev in w.stream(
                    self.v1.list_pod_for_all_namespaces, **self._watch_kwargs
                ):
                    if self._watch_error(w, ev):
                        break  # in-band expiry: reconnect fresh
                    out = self._note_pod(ev["type"], ev["object"])
                    if out is not None:
                        self._events.put(out)
            except Exception as exc:
                self._note_watch_exc("pod", exc)
            # the server ends watch streams routinely; reconnect after a
            # pause rather than spinning
            self._watch_stop.wait(self._watch_backoff)

    @staticmethod
    def _node_snap(obj) -> tuple:
        return (
            dict(obj.metadata.labels or {}),
            bool(obj.spec.unschedulable),
            [t.key for t in (obj.spec.taints or [])],
        )

    def _note_node(
        self, obj, *, emit_unchanged: bool = True,
        if_untouched_since: Optional[int] = None,
    ) -> Optional[WatchEvent]:
        """Update watch-derived node state; return the node_update event.

        With ``emit_unchanged=False`` (resync path) an unchanged node
        produces no event — the controller's handlers are diff-driven, so
        replaying identical state would only churn the queue.
        ``if_untouched_since`` makes the freshness check and the state
        write one atomic step: a node the watch touched after that
        sequence point is left alone entirely (writing the stale relist
        snapshot would revert a cordon the watch just delivered)."""
        name = obj.metadata.name
        cur = self._node_snap(obj)
        with self._state_lock:
            if (if_untouched_since is not None
                    and self._node_touched.get(name, 0) > if_untouched_since):
                return None  # the watch already knows better
            old = self._node_last.get(name)
            self._node_last[name] = cur
            if emit_unchanged:  # watch path: mark fresher than any relist
                self._watch_seq += 1
                self._node_touched[name] = self._watch_seq
        if old is None:
            old = cur
        if not emit_unchanged and old == cur:
            return None
        return WatchEvent(
            kind="node_update", name=name, labels=dict(cur[0]),
            old_labels=dict(old[0]), unschedulable=cur[1],
            was_unschedulable=old[1], taints=list(cur[2]),
            old_taints=list(old[2]),
        )

    def _watch_nodes(self) -> None:
        w = self._watch_mod.Watch()
        self._register_watcher(w)
        first = True
        while not self._watch_stop.is_set():
            if not first:
                API_COUNTERS.inc("watch_reconnects_total")
            first = False
            try:
                for ev in w.stream(self.v1.list_node, **self._watch_kwargs):
                    if self._watch_error(w, ev):
                        break  # in-band expiry: reconnect fresh
                    if ev["type"] not in ("ADDED", "MODIFIED", "DELETED"):
                        continue  # BOOKMARK etc.: not a Node object
                    out = self._note_node(ev["object"])
                    if out is not None:
                        self._events.put(out)
            except Exception as exc:
                self._note_watch_exc("node", exc)
            self._watch_stop.wait(self._watch_backoff)

    # ------------------------------------------------------------------
    # resync: the safety net under the watch plane
    # ------------------------------------------------------------------

    def _resync_loop(self) -> None:
        while not self._watch_stop.wait(self._resync_interval):
            try:
                self.resync()
            except Exception as exc:
                # a transient API failure here costs one cadence, nothing
                # else — the next tick relists from scratch
                self.logger.error(f"resync failed: {exc}")

    def resync(self) -> None:
        """Full relist, diffed against watch-derived state; emits synthetic
        events for anything the watch plane missed.

        Covers the gaps no reconnect can: events dropped while a stream
        was down, a resourceVersion that fell out of the compaction window
        mid-gap, a watch thread wedged long enough for deletes+recreates
        to alias. Synthetic events are indistinguishable from real ones
        downstream (same WatchEvent contract), so the controller and
        scheduler need no resync-awareness at all."""
        from nhd_tpu_torch.obs.recorder import span

        API_COUNTERS.inc("resyncs_total")
        with self._state_lock:
            # everything the watch threads touch after this point is
            # FRESHER than the listing below — resync must not "repair"
            # those keys with stale relist data (spurious deletes for
            # pods created mid-list, reverted node states)
            seq0 = self._watch_seq
            self._relist_floor = seq0  # tombstones >= seq0 must survive
        try:
            # flight-recorder visibility: a resync pass is the API plane's
            # heaviest periodic call (full relist) — it shows in traces as
            # its own interval instead of as unexplained watch latency
            with span("resync", cat="api"):
                self._resync_diff(seq0)
        finally:
            with self._state_lock:
                self._relist_floor = None

    def _resync_diff(self, seq0: int) -> None:
        live: Dict[Tuple[str, str], _PodSnap] = {}
        for p in self.v1.list_pod_for_all_namespaces().items:
            live[(p.metadata.namespace, p.metadata.name)] = self._pod_snap(p)
        synthetic: List[WatchEvent] = []
        with self._state_lock:
            for key, snap in live.items():
                if self._pod_touched.get(key, 0) > seq0:
                    continue  # the watch already knows better
                prior = self._known_pods.get(key)
                if prior is not None and prior[0] == snap[0]:
                    self._known_pods[key] = snap  # refresh annotations/node
                    continue
                if prior is not None:
                    # same name, new uid: the delete was missed too
                    synthetic.append(self._synth_pod_event(
                        "pod_delete", key, prior
                    ))
                synthetic.append(self._synth_pod_event("pod_create", key, snap))
                self._known_pods[key] = snap
            for key in list(self._known_pods):
                if key not in live and self._pod_touched.get(key, 0) <= seq0:
                    synthetic.append(self._synth_pod_event(
                        "pod_delete", key, self._known_pods.pop(key)
                    ))
            # prune touch records for long-gone pods (delete events leave
            # them behind as tombstones guarding in-flight relists)
            for key in list(self._pod_touched):
                if (key not in self._known_pods and key not in live
                        and self._pod_touched[key] <= seq0):
                    del self._pod_touched[key]
        for ev in synthetic:
            key = (ev.namespace, ev.name)
            with self._state_lock:
                if self._pod_touched.get(key, 0) > seq0:
                    # the watch delivered fresher truth for this key while
                    # we were diffing — enqueueing the stale synthetic
                    # AFTER its event would make stale state win downstream
                    continue
                API_COUNTERS.inc("resync_synthetic_events_total")
                self._events.put(ev)
            self.logger.warning(
                f"resync: watch missed {ev.kind} for "
                f"{ev.namespace}/{ev.name}; emitting synthetic event"
            )
        # nodes: emit only real diffs (cordon/label/taint changes missed)
        for n in self.v1.list_node().items:
            out = self._note_node(
                n, emit_unchanged=False, if_untouched_since=seq0
            )
            if out is not None:
                API_COUNTERS.inc("resync_synthetic_events_total")
                self.logger.warning(
                    f"resync: watch missed node_update for {out.name}; "
                    "emitting synthetic event"
                )
                self._events.put(out)

    @staticmethod
    def _synth_pod_event(
        kind: str, key: Tuple[str, str], snap: _PodSnap
    ) -> WatchEvent:
        return WatchEvent(
            kind=kind, name=key[1], namespace=key[0],
            annotations=dict(snap[1]), uid=snap[0],
            scheduler_name=snap[2], node=snap[3],
        )

    def stop_watches(self) -> None:
        """Stop watch threads: interrupt in-flight streams (Watch.stop
        closes the response to unblock the read) and prevent reconnects."""
        self._watch_stop.set()
        with self._watch_lock:
            watchers = list(self._watchers)
        for w in watchers:
            self._stop_watcher(w)

    def _stop_watcher(self, w: object) -> None:
        stop = getattr(w, "stop", None)
        if stop is not None:
            try:
                stop()
            except Exception as exc:
                # keep stopping the rest; a watcher that fails to close
                # is at worst a leaked connection on exit
                self.logger.warning(f"watch stop failed: {exc}")

    def poll_watch_events(self, timeout: float = 0.0) -> Iterable[WatchEvent]:
        out = []
        try:
            while True:
                out.append(self._events.get(block=bool(timeout), timeout=timeout or None))
                timeout = 0.0
        except queue.Empty:
            pass
        return out

    # ------------------------------------------------------------------
    # coordination leases (leader election, k8s/lease.py)
    #
    # Implemented over the generic custom-object surface — both client
    # paths (real kubernetes package and the in-repo restclient) return
    # plain JSON dicts there, and every call runs under the retry policy.
    # The CAS is the API server's own optimistic concurrency: replace()
    # carries metadata.resourceVersion, a stale one answers 409 Conflict.
    # The fencing epoch is spec.leaseTransitions, bumped on EVERY
    # acquisition (a same-holder re-acquire after restart still gets a
    # fresh token).
    # ------------------------------------------------------------------

    _LEASE_GROUP = "coordination.k8s.io"
    _LEASE_VERSION = "v1"
    _LEASE_PLURAL = "leases"

    def _lease_get_raw(self, name: str) -> Optional[dict]:
        try:
            return self.crd.get_namespaced_custom_object(
                self._LEASE_GROUP, self._LEASE_VERSION, self._lease_ns,
                self._LEASE_PLURAL, name,
            )
        except self._client.exceptions.ApiException as exc:
            if getattr(exc, "status", None) == 404:
                return None
            # retry budget spent or a terminal surprise (403, …): either
            # way the election cannot verify the lease right now — the
            # elector's grace logic owns that outcome
            raise TransientBackendError(
                f"lease read for {name} failed: {exc}"
            ) from exc

    @staticmethod
    def _lease_view_of(name: str, obj: dict) -> LeaseView:
        spec = obj.get("spec") or {}
        renewed = _parse_micro_time(
            spec.get("renewTime") or spec.get("acquireTime")
        )
        duration = float(spec.get("leaseDurationSeconds") or 0)
        return LeaseView(
            name=name,
            holder=spec.get("holderIdentity") or "",
            epoch=int(spec.get("leaseTransitions") or 0),
            expires=(renewed + duration) if renewed is not None else 0.0,
        )

    @staticmethod
    def _lease_spec(holder: str, ttl: float, epoch: int, now: float) -> dict:
        stamp = _micro_time(now)
        return {
            "holderIdentity": holder,
            "leaseDurationSeconds": max(int(round(ttl)), 1),
            "acquireTime": stamp,
            "renewTime": stamp,
            "leaseTransitions": epoch,
        }

    def _lease_replace(self, name: str, body: dict) -> Optional[dict]:
        """Conditional replace; None when the CAS lost (409 Conflict)."""
        try:
            return self.crd.replace_namespaced_custom_object(
                self._LEASE_GROUP, self._LEASE_VERSION, self._lease_ns,
                self._LEASE_PLURAL, name, body,
            )
        except self._client.exceptions.ApiException as exc:
            if getattr(exc, "status", None) in (409, 404):
                return None   # lost the race / lease deleted under us
            raise TransientBackendError(
                f"lease replace for {name} failed: {exc}"
            ) from exc

    def _viewed(self, name: str, obj: dict) -> LeaseView:
        """_lease_view_of plus the epoch high-water-mark note — every
        lease state returned to a caller also tightens the fence."""
        view = self._lease_view_of(name, obj)
        self._note_lease_epoch(name, view)
        return view

    def lease_try_acquire(self, name: str, holder: str, ttl: float) -> LeaseView:
        import time as _time

        now = _time.time()
        obj = self._lease_get_raw(name)
        if obj is None:
            body = {
                "apiVersion": f"{self._LEASE_GROUP}/{self._LEASE_VERSION}",
                "kind": "Lease",
                "metadata": {"name": name, "namespace": self._lease_ns},
                "spec": self._lease_spec(holder, ttl, epoch=1, now=now),
            }
            try:
                created = self.crd.create_namespaced_custom_object(
                    self._LEASE_GROUP, self._LEASE_VERSION, self._lease_ns,
                    self._LEASE_PLURAL, body,
                )
                return self._viewed(name, created)
            except self._client.exceptions.ApiException as exc:
                if getattr(exc, "status", None) != 409:
                    raise TransientBackendError(
                        f"lease create for {name} failed: {exc}"
                    ) from exc
                obj = self._lease_get_raw(name)   # lost the create race
                if obj is None:
                    raise TransientBackendError(
                        f"lease {name} vanished mid-acquisition"
                    ) from exc
        view = self._viewed(name, obj)
        if view.holder and view.expires > now and view.holder != holder:
            return view   # held and live: the caller stays a follower
        body = dict(obj)
        body["spec"] = self._lease_spec(
            holder, ttl, epoch=view.epoch + 1, now=now
        )
        replaced = self._lease_replace(name, body)
        if replaced is not None:
            return self._viewed(name, replaced)
        # CAS lost: someone else took it between our read and write —
        # report THEIR state so the caller correctly stays a follower
        obj = self._lease_get_raw(name)
        return (
            self._viewed(name, obj) if obj is not None
            else LeaseView(name=name, holder="", epoch=view.epoch, expires=0.0)
        )

    def lease_renew(self, name: str, holder: str, epoch: int, ttl: float) -> bool:
        import time as _time

        obj = self._lease_get_raw(name)
        if obj is None:
            return False
        view = self._viewed(name, obj)
        if view.holder != holder or view.epoch != epoch:
            return False
        body = dict(obj)
        spec = dict(obj.get("spec") or {})
        spec["renewTime"] = _micro_time(_time.time())
        spec["leaseDurationSeconds"] = max(int(round(ttl)), 1)
        body["spec"] = spec
        if self._lease_replace(name, body) is not None:
            return True
        # CAS lost — but to WHOM? A renew PUT whose response was lost is
        # resent by the retry layer and answers 409 to its own landed
        # first send. If the lease still shows (holder, epoch) == ours,
        # the only writer that can have advanced the resourceVersion
        # while preserving both is ourselves: the renewal landed. Only a
        # rival's acquisition (holder or epoch moved) is a real loss —
        # demoting a healthy leader on every response blip would bounce
        # leadership (and the epoch) once per network hiccup.
        obj = self._lease_get_raw(name)
        if obj is None:
            return False
        cur = self._viewed(name, obj)
        return cur.holder == holder and cur.epoch == epoch

    def lease_release(self, name: str, holder: str, epoch: int) -> bool:
        obj = self._lease_get_raw(name)
        if obj is None:
            return False
        view = self._viewed(name, obj)
        if view.holder != holder or view.epoch != epoch:
            return False
        body = dict(obj)
        spec = dict(obj.get("spec") or {})
        spec["holderIdentity"] = ""   # epoch survives: tokens never rewind
        body["spec"] = spec
        return self._lease_replace(name, body) is not None

    def lease_read(self, name: str) -> Optional[LeaseView]:
        obj = self._lease_get_raw(name)
        return self._viewed(name, obj) if obj is not None else None

    def lease_live(self, name: str) -> str:
        import time as _time

        view = self.lease_read(name)
        if view is None or not view.holder:
            return ""
        return view.holder if view.expires > _time.time() else ""

    # ------------------------------------------------------------------
    # TriadSets (CRD group/version per deploy/triad-crd.1.16.yaml)
    # ------------------------------------------------------------------

    _CRD_GROUP = "sigproc.viasat.io"
    _CRD_VERSION = "v1"
    _CRD_PLURAL = "triadsets"

    def list_triadsets(self) -> List[dict]:
        try:
            objs = self.crd.list_cluster_custom_object(
                self._CRD_GROUP, self._CRD_VERSION, self._CRD_PLURAL
            )
        except self._client.exceptions.ApiException as exc:
            if retryable(exc):
                # the controller's reconcile isolation retries next period
                raise TransientBackendError(
                    f"TriadSet list failed transiently: {exc}"
                ) from exc
            return []  # CRD not installed: a fact, not an outage
        out = []
        for item in objs.get("items", []):
            spec = item.get("spec", {})
            out.append(
                {
                    "name": item["metadata"]["name"],
                    "ns": item["metadata"]["namespace"],
                    "replicas": spec.get("replicas", 0),
                    "service_name": spec.get("serviceName", item["metadata"]["name"]),
                    "template": spec.get("template", {}),
                }
            )
        return out

    def list_pods_of_triadset(self, ts: dict) -> List[str]:
        prefix = ts["service_name"] + "-"
        out = []
        for p in self.v1.list_namespaced_pod(ts["ns"]).items:
            name = p.metadata.name
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                out.append(name)
        return out

    def create_pod_for_triadset(self, ts: dict, ordinal: int) -> bool:
        """Instantiate the template as '{service}-{ordinal}' with hostname
        and subdomain patched (TriadController.py:101-120)."""
        name = f"{ts['service_name']}-{ordinal}"
        template = dict(ts.get("template") or {})
        meta = dict(template.get("metadata", {}))
        spec = dict(template.get("spec", {}))
        meta["name"] = name
        spec["hostname"] = name
        spec["subdomain"] = ts["service_name"]
        body = {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec}
        try:
            self.v1.create_namespaced_pod(ts["ns"], body)
            return True
        except self._client.exceptions.ApiException as exc:
            self.logger.error(f"TriadSet pod create failed for {name}: {exc}")
            return False

    def update_triadset_status(self, ts: dict, replicas: int) -> bool:
        """status.replicas for the scale subresource."""
        try:
            self.crd.patch_namespaced_custom_object_status(
                self._CRD_GROUP, self._CRD_VERSION, ts["ns"],
                self._CRD_PLURAL, ts["name"],
                {"status": {"replicas": replicas}},
            )
            return True
        except self._client.exceptions.ApiException as exc:
            self.logger.error(f"TriadSet status update failed: {exc}")
            return False
