"""API-layer fault injection: the vocabulary chaos runs use to storm the
control plane.

sim/chaos.py injects *cluster* churn (creates, deletes, cordons); nothing
in the repo injected *API* faults — the exact failure class the retry/
resync/requeue layer (k8s/retry.py, k8s/kube.py, scheduler/core.py) exists
to absorb. This module provides that vocabulary at both seams, seeded and
scriptable:

* :class:`FaultyHttpClient` — wraps the restclient ``_HttpClient``:
  injected 5xx/429, status-0 connection resets, slow responses, 410 Gone
  on watch establishment, mid-stream watch cuts and malformed watch lines.
  Installed into a KubeClusterBackend with :func:`install_http_faults`
  (tests/test_kube_faults.py drives it against the stub API server).
* :class:`FaultyBackend` — decorates any ClusterBackend (in practice the
  fake): dropped watch events, poisoned (malformed) watch events, and
  transient bind/annotate failures. ChaosSim wires it in via its
  ``api_faults`` parameter so full chaos storms now hit the API layer too.

Every fault draws from one seeded RNG, so a failing storm replays exactly.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from nhd_tpu_torch.k8s.interface import (
    ClusterBackend,
    EventType,
    LeaseView,
    TransientBackendError,
    WatchEvent,
)
from nhd_tpu_torch.utils import get_logger


@dataclass
class FaultProfile:
    """Per-call fault probabilities. All default to 0 (no faults); the
    named presets in :data:`PROFILES` are what ``make chaos`` sweeps."""

    name: str = "custom"
    # backend-level (FaultyBackend)
    drop_watch_event: float = 0.0      # pod watch event silently lost
    poison_watch_event: float = 0.0    # inject a malformed event per poll
    transient_bind: float = 0.0        # bind raises TransientBackendError
    transient_annotate: float = 0.0    # annotate raises TransientBackendError
    # lease-level (FaultyBackend; leader-election storms, k8s/lease.py)
    lease_renew_error: float = 0.0     # renew raises TransientBackendError
    #                                    (API unreachable: grace, then demote)
    lease_renew_conflict: float = 0.0  # renew returns False (CAS lost:
    #                                    demote immediately)
    lease_acquire_error: float = 0.0   # acquire raises TransientBackendError
    #                                    (follower stays follower this tick)
    # federation-level (ChaosSim federation mode, sim/chaos.py): per-step
    # probability that one replica enters an ASYMMETRIC partition — all
    # of ITS API calls fail and its watch stream goes silent while every
    # other replica keeps working — for 1..partition_steps steps
    partition: float = 0.0
    partition_steps: int = 3
    # solver data-plane (solver/guard.py; injected through
    # guard.set_fault_injector at the dispatch/upload/megaround sites,
    # plus direct resident-row bit flips applied by ChaosSim — the
    # failure surface PRs 8-10 created and the guard ladder absorbs)
    device_dispatch_error: float = 0.0  # fused solve dispatch raises
    device_upload_error: float = 0.0    # resident-row scatter/upload raises
    device_bit_flip: float = 0.0        # per-step resident device row flip
    device_slow_dispatch: float = 0.0   # dispatch stalls slow_seconds
    #: injected device EXCEPTIONS per chaos step are capped here, like
    #: the once-per-pod transient writes above: the guard's bounded
    #: per-rung retries then provably absorb every step's faults, so a
    #: faulted storm's end state stays comparable to the fault-free run
    device_faults_per_step: int = 1
    # HTTP-level (FaultyHttpClient)
    http_error: float = 0.0            # injected HTTP error status
    http_statuses: Tuple[int, ...] = (500, 503, 429)
    http_conn_reset: float = 0.0       # status-0 connection reset
    http_slow: float = 0.0             # response delayed by slow_seconds
    slow_seconds: float = 0.02
    watch_gone: float = 0.0            # 410 Gone on watch establishment
    watch_cut: float = 0.0             # stream dies mid-line-sequence
    watch_malformed: float = 0.0       # garbage line injected, then cut
    # SLO invariant (obs/slo.py, checked by ChaosSim.quiesce under
    # federation tracing): after the storm quiesces, no replica's
    # worst-window error-budget burn rate may exceed this. None = the
    # profile makes no SLO promise (the heavy storms legitimately torch
    # the budget; calibrated profiles and the fleet demo set a bound)
    slo_burn_limit: Optional[float] = None

    def has_device_faults(self) -> bool:
        """Whether this profile storms the solver data plane (ChaosSim
        then installs a DeviceFaultInjector and the bit-flip action)."""
        return any(
            p > 0 for p in (
                self.device_dispatch_error, self.device_upload_error,
                self.device_bit_flip, self.device_slow_dispatch,
            )
        )


#: the fault-storm matrix swept by `make chaos` (tools/chaos_storm.py)
PROFILES: Dict[str, FaultProfile] = {
    "none": FaultProfile(name="none"),
    "light": FaultProfile(
        name="light", drop_watch_event=0.05, transient_bind=0.05,
        transient_annotate=0.05, poison_watch_event=0.02,
    ),
    "storm": FaultProfile(
        name="storm", drop_watch_event=0.15, transient_bind=0.20,
        transient_annotate=0.15, poison_watch_event=0.10,
    ),
    "heavy": FaultProfile(
        name="heavy", drop_watch_event=0.30, transient_bind=0.40,
        transient_annotate=0.30, poison_watch_event=0.25,
    ),
    # split-brain storms (ChaosSim ha=True, `make ha-chaos`): lease
    # renewal faults force leadership churn — ha-storm adds the API-layer
    # faults on top so fencing is exercised mid-outage
    "ha-light": FaultProfile(
        name="ha-light", lease_renew_error=0.25, lease_acquire_error=0.10,
    ),
    "ha-storm": FaultProfile(
        name="ha-storm", lease_renew_error=0.40, lease_renew_conflict=0.10,
        lease_acquire_error=0.15, drop_watch_event=0.10,
        transient_bind=0.15, transient_annotate=0.10,
        poison_watch_event=0.05,
    ),
    # incremental-state churn storm: heavy event loss/poisoning plus
    # transient commits, aimed at the delta/rebuild invariant — a
    # dropped or poisoned event may cost the incremental cluster state
    # a full rebuild, but NEVER a divergent resident state (ChaosSim
    # wires ClusterDelta.parity_errors as a per-step invariant)
    "churn": FaultProfile(
        name="churn", drop_watch_event=0.25, poison_watch_event=0.20,
        transient_bind=0.15, transient_annotate=0.10,
    ),
    # solver data-plane storm (`make device-chaos`, solo mode only —
    # the guard is process-global): injected dispatch/upload faults,
    # slow dispatches and resident-row bit flips, with every API-fault
    # field ZERO so the cell's churn sequence is bit-identical to a
    # fault-free run of the same seed — the bind-parity invariant
    # (tools/chaos_storm.py --bind-parity) compares exactly that
    "device-faults": FaultProfile(
        name="device-faults", device_dispatch_error=0.12,
        device_upload_error=0.06, device_bit_flip=0.20,
        device_slow_dispatch=0.05, slow_seconds=0.002,
    ),
    # federation storms (ChaosSim federation=S, `make fed-chaos`): the
    # ha-* fault surface PLUS asymmetric partitions; kill/restart waves
    # are a chaos ACTION in federation mode, not a profile probability
    "fed-light": FaultProfile(
        name="fed-light", lease_renew_error=0.15, lease_acquire_error=0.05,
        partition=0.04,
    ),
    "fed-storm": FaultProfile(
        name="fed-storm", lease_renew_error=0.30, lease_renew_conflict=0.08,
        lease_acquire_error=0.12, drop_watch_event=0.10,
        transient_bind=0.15, transient_annotate=0.10,
        poison_watch_event=0.05, partition=0.08,
    ),
}


def http_storm_profile() -> FaultProfile:
    """HTTP-seam preset for wire-level tests (kept out of PROFILES: the
    fake-backend chaos matrix has no HTTP layer to storm)."""
    return FaultProfile(
        name="http-storm", http_error=0.25, http_conn_reset=0.05,
        http_slow=0.10, slow_seconds=0.01, watch_gone=0.10,
        watch_cut=0.20, watch_malformed=0.10,
    )


# ---------------------------------------------------------------------------
# HTTP seam
# ---------------------------------------------------------------------------


class _FaultyStream:
    """Wraps a streamed HTTP response: may cut the stream mid-sequence or
    inject a garbled line (what a torn chunk looks like to the reader).
    Faults roll through the owning shim, so flipping its ``enabled`` off
    also quiets streams that were opened during the storm."""

    def __init__(self, resp, shim: "FaultyHttpClient"):
        self._resp = resp
        self._shim = shim

    def __iter__(self):
        for line in self._resp:
            if self._shim._roll(self._shim.profile.watch_malformed):
                self._shim.stats["watch_malformed"] += 1
                # half a JSON object then EOF: the classic mid-cut shape
                yield b'{"type": "ADDED", "object": {"metadata": {"na\n'
                return
            if self._shim._roll(self._shim.profile.watch_cut):
                self._shim.stats["watch_cuts"] += 1
                return
            yield line

    def close(self) -> None:
        self._resp.close()


class FaultyHttpClient:
    """Drop-in for restclient._HttpClient with fault injection in front."""

    def __init__(self, inner, profile: FaultProfile,
                 rng: Optional[random.Random] = None, sleep=time.sleep):
        self._inner = inner
        self.profile = profile
        self.rng = rng or random.Random(0)
        self._sleep = sleep
        # mutable holder so for_inner() clones SHARE the switch: flipping
        # enabled on any shim quiets all of them (and their open streams)
        self._flags = {"enabled": True}
        self.stats: Dict[str, int] = {
            "http_errors": 0, "conn_resets": 0, "slow": 0,
            "watch_gone": 0, "watch_cuts": 0, "watch_malformed": 0,
        }

    @property
    def enabled(self) -> bool:
        return self._flags["enabled"]

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._flags["enabled"] = bool(value)

    def _roll(self, p: float) -> bool:
        return self.enabled and p > 0 and self.rng.random() < p

    def request(self, method: str, path: str, *, stream: bool = False,
                **kwargs):
        from nhd_tpu_torch.k8s.restclient import ApiException

        if stream and "watch=true" in path and self._roll(
            self.profile.watch_gone
        ):
            self.stats["watch_gone"] += 1
            raise ApiException(status=410, reason="Gone (injected)")
        if self._roll(self.profile.http_conn_reset):
            self.stats["conn_resets"] += 1
            raise ApiException(
                status=0, reason="Connection reset by peer (injected)"
            )
        if self._roll(self.profile.http_error):
            self.stats["http_errors"] += 1
            status = self.rng.choice(self.profile.http_statuses)
            headers = {"Retry-After": "0"} if status == 429 else None
            raise ApiException(
                status=status, reason=f"Injected {status}", headers=headers
            )
        if self._roll(self.profile.http_slow):
            self.stats["slow"] += 1
            self._sleep(self.profile.slow_seconds)
        resp = self._inner.request(method, path, stream=stream, **kwargs)
        if stream:
            return _FaultyStream(resp, self)
        return resp

    def for_inner(self, inner) -> "FaultyHttpClient":
        """A sibling shim around another transport, sharing this shim's
        RNG stream, stats dict, profile and enabled switch."""
        clone = FaultyHttpClient.__new__(FaultyHttpClient)
        clone.__dict__.update(self.__dict__)  # _flags shared by reference
        clone._inner = inner
        return clone


def install_http_faults(
    backend, profile: FaultProfile, rng: Optional[random.Random] = None
) -> FaultyHttpClient:
    """Wrap the restclient HTTP core of a KubeClusterBackend (fallback
    path only) with fault injection; returns the lead shim so tests can
    read ``stats``. One seeded RNG + one stats dict span both API objects."""
    lead = FaultyHttpClient(
        backend.v1._api._http, profile, rng or random.Random(0)
    )
    backend.v1._api._http = lead
    backend.crd._api._http = lead.for_inner(backend.crd._api._http)
    return lead


# ---------------------------------------------------------------------------
# solver data-plane seam (solver/guard.py)
# ---------------------------------------------------------------------------


class DeviceFaultInjector:
    """The ``guard.set_fault_injector`` target: called at every
    device-plane dispatch site (``dispatch`` / ``upload`` /
    ``megaround``, see solver/guard.maybe_inject) with a seeded RNG of
    its own, it raises :class:`guard.InjectedDeviceFault` (classified
    transient, like the XLA runtime faults it stands in for) or sleeps
    (slow dispatch — the guard must NOT misread slowness as a fault).

    Exceptions are budgeted per chaos step (``device_faults_per_step``),
    mirroring the once-per-pod transient writes of FaultyBackend: the
    guard's bounded per-rung retries then provably absorb every step's
    injections, which is what makes the bind-parity invariant (faulted
    end state bit-identical to the fault-free run) checkable rather
    than probabilistic. ``begin_step`` refills the budget."""

    def __init__(self, profile: FaultProfile,
                 rng: Optional[random.Random] = None, sleep=time.sleep):
        self.profile = profile
        self.rng = rng or random.Random(0)
        self._sleep = sleep
        self.enabled = True
        self._left = int(profile.device_faults_per_step)
        self.stats: Dict[str, int] = {
            "dispatch_errors": 0, "upload_errors": 0, "slow_dispatches": 0,
        }

    def begin_step(self) -> None:
        self._left = int(self.profile.device_faults_per_step)

    def _roll(self, p: float) -> bool:
        return self.enabled and p > 0 and self.rng.random() < p

    def __call__(self, site: str, detail: str = "") -> None:
        from nhd_tpu_torch.solver.guard import InjectedDeviceFault

        if self._roll(self.profile.device_slow_dispatch):
            self.stats["slow_dispatches"] += 1
            self._sleep(self.profile.slow_seconds)
        if self._left <= 0:
            return
        if site == "dispatch":
            p, stat = self.profile.device_dispatch_error, "dispatch_errors"
        elif site in ("upload", "megaround"):
            p, stat = self.profile.device_upload_error, "upload_errors"
        else:
            return
        if self._roll(p):
            self._left -= 1
            self.stats[stat] += 1
            raise InjectedDeviceFault(
                f"injected device fault at {site} ({detail})"
            )


# ---------------------------------------------------------------------------
# backend seam
# ---------------------------------------------------------------------------


class FaultyBackend(ClusterBackend):
    """ClusterBackend decorator injecting API-level faults.

    Reads delegate untouched; the fault surface is exactly what the
    recovery machinery claims to absorb: lost watch events (caught by the
    resync/reconcile nets), poisoned events (caught by the controller's
    per-event isolation), transient binds (requeued by the scheduler) and
    transient annotates (retried by the periodic scan). Transient write
    faults fire at most once per pod so a converged end state stays
    provable. Unknown attributes delegate to the inner backend, so the
    fake's simulation controls (create_pod, nodes, pods, fail_bind_for…)
    stay usable through the wrapper.
    """

    def __init__(self, inner: ClusterBackend, profile: FaultProfile,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.profile = profile
        self.rng = rng or random.Random(0)
        self.logger = get_logger(__name__)
        self.enabled = True
        self.fault_stats: Dict[str, int] = {
            "dropped_events": 0, "poisoned_events": 0,
            "transient_binds": 0, "transient_annotates": 0,
            "lease_renew_errors": 0, "lease_renew_conflicts": 0,
            "lease_acquire_errors": 0,
        }
        self._bind_faulted: set = set()
        self._annotate_faulted: set = set()
        # record/replay fault sink (obs/journal.py): when set, every
        # injected transient write fault reports (op, ns, pod) so replay
        # can re-inject it at the same call site (sim/replay.py). Watch
        # drops/poisons need no sink — the journal captures watch events
        # at controller receipt, i.e. post-filter, so they replay free.
        self.fault_sink = None

    def _roll(self, p: float) -> bool:
        return self.enabled and p > 0 and self.rng.random() < p

    def _fault(self, op: str, ns: str, pod: str) -> None:
        sink = self.fault_sink
        if sink is not None:
            sink(op, ns, pod)

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    # ---- node reads (pass-through) ----

    def get_nodes(self) -> List[str]:
        return self.inner.get_nodes()

    def is_node_active(self, node: str) -> bool:
        return self.inner.is_node_active(node)

    def get_node_labels(self, node: str) -> Dict[str, str]:
        return self.inner.get_node_labels(node)

    def get_node_addr(self, node: str) -> str:
        return self.inner.get_node_addr(node)

    def get_node_hugepage_resources(self, node: str) -> Tuple[int, int]:
        return self.inner.get_node_hugepage_resources(node)

    # ---- pod reads (pass-through) ----

    def pod_exists(self, pod: str, ns: str) -> bool:
        return self.inner.pod_exists(pod, ns)

    def get_pod_node(self, pod: str, ns: str) -> Optional[str]:
        return self.inner.get_pod_node(pod, ns)

    def get_pod_annotations(self, pod: str, ns: str) -> Optional[Dict[str, str]]:
        return self.inner.get_pod_annotations(pod, ns)

    def get_cfg_annotations(self, pod: str, ns: str) -> Optional[str]:
        return self.inner.get_cfg_annotations(pod, ns)

    def get_cfg_type(self, pod: str, ns: str) -> Optional[str]:
        return self.inner.get_cfg_type(pod, ns)

    def get_pod_node_groups(self, pod: str, ns: str) -> List[str]:
        return self.inner.get_pod_node_groups(pod, ns)

    # Concrete defaults on the ABC, so __getattr__ never fires for them:
    # without these delegations the SLO clock reads the stub (None/wall
    # time) in every faulted cell instead of the sim clock.
    def get_pod_created(self, pod: str, ns: str) -> Optional[float]:
        return self.inner.get_pod_created(pod, ns)

    def clock_now(self) -> float:
        return self.inner.clock_now()

    def get_requested_pod_resources(self, pod: str, ns: str) -> Dict[str, str]:
        return self.inner.get_requested_pod_resources(pod, ns)

    def get_scheduled_pods(self, scheduler: str):
        return self.inner.get_scheduled_pods(scheduler)

    def service_pods(self, scheduler: str):
        return self.inner.service_pods(scheduler)

    def get_cfg_map(self, pod: str, ns: str):
        return self.inner.get_cfg_map(pod, ns)

    # ---- writes (fault points; fencing epoch + lease pass through) ----

    def add_nad_to_pod(
        self, pod: str, ns: str, nad: str, *, epoch=None, fence_lease=None
    ) -> bool:
        return self.inner.add_nad_to_pod(
            pod, ns, nad, epoch=epoch, fence_lease=fence_lease
        )

    def annotate_pod_config(
        self, ns: str, pod: str, cfg: str, *, epoch=None, fence_lease=None
    ) -> bool:
        key = (ns, pod)
        if key not in self._annotate_faulted and self._roll(
            self.profile.transient_annotate
        ):
            self._annotate_faulted.add(key)
            self.fault_stats["transient_annotates"] += 1
            self._fault("annotate", ns, pod)
            raise TransientBackendError(
                f"injected transient annotate failure for {ns}/{pod}"
            )
        return self.inner.annotate_pod_config(
            ns, pod, cfg, epoch=epoch, fence_lease=fence_lease
        )

    def annotate_pod_gpu_map(
        self, ns: str, pod: str, gpu_map: Dict[str, int],
        *, epoch=None, fence_lease=None,
    ) -> bool:
        return self.inner.annotate_pod_gpu_map(
            ns, pod, gpu_map, epoch=epoch, fence_lease=fence_lease
        )

    def annotate_pod_meta(
        self, ns: str, pod: str, key: str, value: str,
        *, epoch=None, fence_lease=None,
    ) -> bool:
        fk = (ns, pod, "meta")
        if fk not in self._annotate_faulted and self._roll(
            self.profile.transient_annotate
        ):
            self._annotate_faulted.add(fk)
            self.fault_stats["transient_annotates"] += 1
            self._fault("meta", ns, pod)
            raise TransientBackendError(
                f"injected transient meta-annotate failure for {ns}/{pod}"
            )
        return self.inner.annotate_pod_meta(
            ns, pod, key, value, epoch=epoch, fence_lease=fence_lease
        )

    def claim_spillover_pod(
        self, ns: str, pod: str, claim_lease: str, claim_epoch: int,
        *, epoch=None, fence_lease=None,
    ) -> bool:
        fk = (ns, pod, "claim")
        if fk not in self._annotate_faulted and self._roll(
            self.profile.transient_annotate
        ):
            self._annotate_faulted.add(fk)
            self.fault_stats["transient_annotates"] += 1
            self._fault("claim", ns, pod)
            raise TransientBackendError(
                f"injected transient spillover-claim failure for {ns}/{pod}"
            )
        return self.inner.claim_spillover_pod(
            ns, pod, claim_lease, claim_epoch,
            epoch=epoch, fence_lease=fence_lease,
        )

    def bind_pod_to_node(
        self, pod: str, node: str, ns: str, *, epoch=None, fence_lease=None
    ) -> bool:
        key = (ns, pod)
        if key not in self._bind_faulted and self._roll(
            self.profile.transient_bind
        ):
            self._bind_faulted.add(key)
            self.fault_stats["transient_binds"] += 1
            self._fault("bind", ns, pod)
            raise TransientBackendError(
                f"injected transient bind failure for {ns}/{pod}"
            )
        return self.inner.bind_pod_to_node(
            pod, node, ns, epoch=epoch, fence_lease=fence_lease
        )

    def generate_pod_event(
        self, pod: str, ns: str, reason: str, event_type: EventType,
        message: str,
    ) -> None:
        self.inner.generate_pod_event(pod, ns, reason, event_type, message)

    # ---- watch plane (fault points) ----

    def poll_watch_events(self, timeout: float = 0.0) -> Iterable[WatchEvent]:
        return self.filter_watch_events(self.inner.poll_watch_events(timeout))

    def filter_watch_events(
        self, events: Iterable[WatchEvent]
    ) -> List[WatchEvent]:
        """The watch-plane fault surface, factored out of the poll so the
        federated chaos harness can fan one shared event stream out to N
        replicas and still give each replica its own seeded drop/poison
        faults (sim/chaos.py)."""
        out: List[WatchEvent] = []
        for ev in events:
            if ev.kind in ("pod_create", "pod_delete") and self._roll(
                self.profile.drop_watch_event
            ):
                # silently lost: only the resync/reconcile nets can repair
                self.fault_stats["dropped_events"] += 1
                continue
            out.append(ev)
        if self._roll(self.profile.poison_watch_event):
            # an additive malformed event (labels=None trips the node
            # translator) — never replaces real information, so recovery
            # is purely the controller's per-event isolation
            self.fault_stats["poisoned_events"] += 1
            out.insert(0, WatchEvent(
                kind="node_update", name="<poisoned>",
                labels=None, old_labels=None,          # type: ignore[arg-type]
                taints=None, old_taints=None,          # type: ignore[arg-type]
            ))
        return out

    # ---- coordination leases (fault points; k8s/lease.py) ----
    #
    # Renewal faults are NOT once-per-key like the bind/annotate ones:
    # leadership flapping is the behavior under test, and the elector's
    # grace/expiry logic (not a converged end state per pod) bounds it.

    def lease_try_acquire(self, name: str, holder: str, ttl: float) -> LeaseView:
        if self._roll(self.profile.lease_acquire_error):
            self.fault_stats["lease_acquire_errors"] += 1
            raise TransientBackendError(
                f"injected lease acquire failure for {holder}"
            )
        return self.inner.lease_try_acquire(name, holder, ttl)

    def lease_renew(self, name: str, holder: str, epoch: int, ttl: float) -> bool:
        if self._roll(self.profile.lease_renew_error):
            self.fault_stats["lease_renew_errors"] += 1
            raise TransientBackendError(
                f"injected lease renew failure for {holder}"
            )
        if self._roll(self.profile.lease_renew_conflict):
            # as if the CAS lost: the holder must step down immediately
            self.fault_stats["lease_renew_conflicts"] += 1
            return False
        return self.inner.lease_renew(name, holder, epoch, ttl)

    def lease_release(self, name: str, holder: str, epoch: int) -> bool:
        return self.inner.lease_release(name, holder, epoch)

    def lease_read(self, name: str):
        return self.inner.lease_read(name)

    def lease_live(self, name: str) -> str:
        return self.inner.lease_live(name)

    # ---- TriadSets (pass-through) ----

    def list_triadsets(self) -> List[dict]:
        return self.inner.list_triadsets()

    def list_pods_of_triadset(self, ts: dict) -> List[str]:
        return self.inner.list_pods_of_triadset(ts)

    def create_pod_for_triadset(self, ts: dict, ordinal: int) -> bool:
        return self.inner.create_pod_for_triadset(ts, ordinal)

    def update_triadset_status(self, ts: dict, replicas: int) -> bool:
        return self.inner.update_triadset_status(ts, replicas)
