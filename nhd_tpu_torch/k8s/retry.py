"""Unified retry/backoff policy for API-server calls.

The reference treats the API server as always-available: every K8SMgr call
is one-shot, and a transient 503 surfaces straight into the control loop
(SURVEY §5.3 — resilience rests on crash-only restarts, not on absorbing
faults). Gandiva/Gavel-style cluster schedulers instead treat the API
server as an unreliable dependency. This module is that defense layer:

* :func:`classify` — splits failures into *retryable* (429, 5xx, status-0
  network errors) and *terminal* (any other 4xx, plus the V1Binding
  ValueError quirk the bind path depends on);
* :class:`RetryPolicy` — exponential backoff with decorrelated jitter, a
  per-call deadline, Retry-After honoring, and a circuit breaker that
  trips after consecutive retryable failures and half-opens on a timer;
* :class:`RetryingApi` — wraps a CoreV1Api/CustomObjectsApi-shaped object
  so every non-watch method call runs under the policy (watch calls pass
  through: the watch plane has its own reconnect loop in k8s/kube.py);
* :data:`API_COUNTERS` — process-wide observability for the layer itself,
  exported through rpc/metrics.py.

Everything is injectable (clock, sleep, RNG) so the policy is unit-tested
without a single real sleep (tests/test_retry.py).
"""

from __future__ import annotations

import functools
import http.client as _httplib
import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from nhd_tpu_torch.obs import histo as _histo

# exceptions that mean "the network/transport failed" when no HTTP status
# is attached. Statusless exceptions OUTSIDE this set are client-side bugs
# (TypeError, KeyError, …) — retrying them burns backoff sleeps on a
# deterministic failure and can open the breaker against a healthy server.
_NETWORK_ERRORS: tuple = (OSError, _httplib.HTTPException)
try:  # the real kubernetes client surfaces transport faults as urllib3's
    import urllib3.exceptions as _u3

    _NETWORK_ERRORS = _NETWORK_ERRORS + (_u3.HTTPError,)
except Exception:  # nhdlint: ignore[NHD302]
    pass  # urllib3 absent (restclient fallback): stdlib set suffices

# circuit-breaker states (exported as the nhd_api_circuit_state gauge)
CIRCUIT_CLOSED = 0
CIRCUIT_OPEN = 1
CIRCUIT_HALF_OPEN = 2


class ApiCounters:
    """Thread-safe counter/gauge registry for the fault-tolerance layer.

    KNOWN is the single source of truth — name → (prometheus kind, help
    text) — iterated by rpc/metrics.py, so adding a counter here is all
    it takes to surface it on /metrics. Names are pre-seeded to 0 so
    every metric is visible from process start, not only after its first
    event.
    """

    KNOWN: Dict[str, Tuple[str, str]] = {
        "api_calls_total":
            ("counter", "API calls issued under the retry policy"),
        "api_retries_total":
            ("counter", "API call retries (backoff slept)"),
        "api_giveups_total":
            ("counter", "API calls abandoned after the retry budget"),
        "api_failures_total":
            ("counter", "Retryable API call failures observed"),
        "api_circuit_open_total":
            ("counter", "Circuit breaker open transitions"),
        "api_circuit_rejections_total":
            ("counter", "Calls rejected while the circuit was open"),
        "api_circuit_state":
            ("gauge", "Circuit state (0 closed, 1 open, 2 half-open)"),
        "watch_reconnects_total":
            ("counter", "Watch stream reconnects"),
        "watch_dedup_replays_total":
            ("counter", "Replayed watch ADDED events deduplicated"),
        "watch_malformed_lines_total":
            ("counter", "Malformed watch lines dropped"),
        "watch_read_timeouts_total":
            ("counter", "Watch streams ended by read timeout/error"),
        "resyncs_total":
            ("counter", "Full-relist resync passes"),
        "resync_synthetic_events_total":
            ("counter", "Synthetic events emitted by resync"),
        "controller_event_errors_total":
            ("counter", "Poisoned watch events isolated"),
        "controller_reconcile_errors_total":
            ("counter", "TriadSet reconcile passes failed"),
        "scheduler_loop_errors_total":
            ("counter",
             "Scheduler run-loop passes isolated (mirror rebuilt after)"),
        "bind_requeues_total":
            ("counter", "Pods requeued after a transient commit failure"),
        # incremental device-resident cluster state (solver/encode.py
        # ClusterDelta + solver/device_state.py row scatters,
        # docs/PERFORMANCE.md "Incremental device-resident state"). The
        # labeled complement nhd_device_state_rebuilds_total{reason=...}
        # is rendered from encode.rebuild_reasons_snapshot() in
        # rpc/metrics.py (bounded reason vocabulary, NHD603).
        "device_state_events_total":
            ("counter", "Watch/claim events folded into the incremental "
                        "cluster state as deltas"),
        "device_state_deltas_total":
            ("counter", "Row patches applied to the host-resident packed "
                        "cluster arrays"),
        "device_state_rows_uploaded_total":
            ("counter", "Node rows scattered/uploaded to the "
                        "device-resident arrays"),
        "device_state_full_rebuilds_total":
            ("counter", "Incremental-state fallbacks to a full "
                        "encode_cluster rebuild"),
        "device_state_resident_age_seconds":
            ("gauge", "Seconds since the resident cluster state was "
                      "last fully rebuilt"),
        # SPMD mesh plane (kernel.get_ranked_solver_mesh +
        # device_state._scatter_mesh, docs/PERFORMANCE.md "SPMD
        # megaround"): the sharded-solve posture and its upload economy
        "mesh_devices":
            ("gauge", "Devices in the scheduler's solve mesh "
                      "(0 = single-device posture)"),
        "mesh_shard_rows":
            ("gauge", "Padded node rows resident per mesh shard"),
        "mesh_solves_total":
            ("counter", "Fused ranked megarounds dispatched SPMD over "
                        "the mesh"),
        "mesh_rows_uploaded_total":
            ("counter", "Node rows scattered into mesh-sharded resident "
                        "arrays via per-shard delta scatters"),
        "mesh_wholesale_uploads_total":
            ("counter", "Mesh resident-state uploads that fell back to "
                        "a wholesale re-shard (storm-sized delta or "
                        "NHD_DEVICE_DELTA=0)"),
        # solver data-plane guard (solver/guard.py, docs/RESILIENCE.md
        # "Layer 8"): the detect -> degrade -> repair ladder's ledger.
        # guard_rung is the current degradation floor (0 = full
        # fidelity/mesh, 1 = single-device, 2 = host solve path).
        "guard_rung":
            ("gauge", "Solver guard degradation floor (0 mesh/full, "
                      "1 single-device, 2 host)"),
        "guard_faults_total":
            ("counter", "Device-plane faults the solver guard observed"),
        "guard_retries_total":
            ("counter", "Solver rounds re-dispatched after a transient "
                        "device-plane fault"),
        "guard_giveups_total":
            ("counter", "Device-plane faults surfaced past the guard "
                        "(terminal, or the rung ladder exhausted)"),
        "guard_degradations_total":
            ("counter", "Rung drops down the mesh -> single-device -> "
                        "host ladder"),
        "guard_promotions_total":
            ("counter", "Rung re-promotions after clean probe rounds"),
        "guard_audits_total":
            ("counter", "Resident-state audit passes run"),
        "guard_audit_rows_total":
            ("counter", "Device rows bit-exact spot-checked against the "
                        "host mirror"),
        "guard_corruptions_total":
            ("counter", "Resident-state corruptions detected (audit "
                        "mismatches + rank-tensor screen failures)"),
        "guard_repairs_total":
            ("counter", "Resident states rebuilt from host truth by the "
                        "guard"),
        "guard_quarantined_shapes":
            ("gauge", "Shape keys quarantined for repeated program "
                      "faults (AOT artifact retired, live re-trace)"),
        # scheduling-policy engine (nhd_tpu/policy/,
        # docs/SCHEDULING_POLICIES.md): heterogeneity scoring posture +
        # the bounded-preemption ledger. The labeled complement
        # nhd_policy_preemptions_total{tier=...} is rendered from
        # policy.preempt_tier_snapshot() in rpc/metrics.py (tier labels
        # clamp to a bounded vocabulary, NHD603 stance).
        "policy_preemptions_total":
            ("counter", "Pods evicted by bounded policy preemption"),
        "policy_preempt_budget_exhausted_total":
            ("counter", "Preemption plans refused by the round/tenant "
                        "budgets"),
        "policy_score_mode":
            ("gauge", "Heterogeneity scoring mode (0 off, 1 uniform, "
                      "2 matrix)"),
        # AOT export worker (solver/aot.py): background-thread failures
        # were invisible before this counter
        "aot_export_failures_total":
            ("counter", "AOT StableHLO background exports that failed "
                        "(serving unaffected; cache not written)"),
        # HA plane (k8s/lease.py, docs/RESILIENCE.md "HA & fencing").
        # Under the sharded federation the single-leader gauges
        # generalize: ha_is_leader means "holds at least one shard" and
        # ha_epoch reports the highest held shard token — the per-shard
        # truth lives on the nhd_shard_* families below.
        "ha_is_leader":
            ("gauge", "This replica holds the scheduler lease "
                      "(federation: at least one shard lease)"),
        "ha_epoch":
            ("gauge", "Fencing epoch of this replica's last leadership "
                      "(federation: highest held shard epoch)"),
        "ha_transitions_total":
            ("counter", "Leadership transitions (promotions + demotions)"),
        "ha_renewals_total":
            ("counter", "Successful lease renewals"),
        "ha_renewal_failures_total":
            ("counter", "Lease renewals that errored or lost the CAS"),
        "ha_promotions_total":
            ("counter", "Standby -> leader promotion replays completed"),
        "ha_stale_writes_rejected_total":
            ("counter", "Fenced writes rejected for a stale epoch"),
        "ha_watchdog_stalls_total":
            ("counter", "Stall-watchdog firings (lease released, exiting)"),
        "ha_watchdog_loop_age_seconds":
            ("gauge", "Age of the scheduling loop's last heartbeat"),
        # shard federation plane (k8s/lease.py ShardedElector +
        # scheduler/core.py spillover, docs/RESILIENCE.md "Federation");
        # the per-shard epoch gauge nhd_shard_epoch{shard=...} is
        # rendered from lease.shard_status_snapshot() in rpc/metrics.py
        "shard_owned_count":
            ("gauge", "Shard leases this replica currently holds"),
        "shard_acquisitions_total":
            ("counter", "Shard lease acquisitions (rendezvous-preferred "
                        "or patience-expired takeovers)"),
        "shard_handoffs_total":
            ("counter", "Shards voluntarily handed to a better-ranked "
                        "live member (bounded rebalance releases)"),
        "shard_spillover_claims_total":
            ("counter", "Cross-shard spillover pods claimed for a local "
                        "placement attempt"),
        "shard_spillover_spilled_total":
            ("counter", "Pods spilled to the untried shards after no "
                        "owned shard could place them"),
        "shard_spillover_exhausted_total":
            ("counter", "Spilled pods declared explicitly unschedulable "
                        "(every shard tried, or the record aged out)"),
        "shard_spillover_depth":
            ("gauge", "Pending pods carrying a live spillover record"),
        "shard_spillover_oldest_age_seconds":
            ("gauge", "Age of the oldest live spillover record"),
        "shard_spillover_orphan_age_max_seconds":
            ("gauge", "High-water mark of spillover record age (the "
                      "bounded-orphan-window observable)"),
        # ingress admission plane (nhd_tpu/ingress/admission.py,
        # docs/RESILIENCE.md "Layer 9 — Overload & admission")
        "admission_admitted_total":
            ("counter", "Pod creates admitted into a tenant lane"),
        "admission_deferred_total":
            ("counter", "Over-rate creates parked at the defer rung"),
        "admission_readmitted_total":
            ("counter", "Deferred creates re-admitted after recovery"),
        "admission_shed_total":
            ("counter", "Creates refused by the shed ladder (every one "
                        "gets a decision record + journal event)"),
        "admission_requeue_refusals_total":
            ("counter", "Scheduler requeues refused at the hard lane cap"),
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vals: Dict[str, float] = {name: 0 for name in self.KNOWN}

    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + by

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._vals[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._vals.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)

    def reset(self) -> None:
        """Back to all-zero (test isolation)."""
        with self._lock:
            self._vals = {name: 0 for name in self.KNOWN}


#: process-wide registry: the scheduler owns one API-server relationship,
#: so one counter set mirrors what an operator sees on the wire
API_COUNTERS = ApiCounters()


def classify(exc: BaseException) -> Tuple[bool, Optional[float]]:
    """(retryable?, Retry-After seconds or None) for an API-call failure.

    Retryable: HTTP 429 and 5xx, plus status-0/status-less failures (the
    restclient maps URLError to ApiException(status=0); the real client
    raises bare network exceptions with no status at all). Terminal: every
    other 4xx — a 404/409/410 will not improve with repetition — and
    ValueError, which the bind path REQUIRES to propagate untouched (the
    V1Binding deserialization quirk signals success, K8SMgr.py:487-491).
    """
    if isinstance(exc, ValueError):
        return (False, None)
    status = getattr(exc, "status", None)
    if status is None:
        # no HTTP status: retry only genuine transport failures — a
        # TypeError from a bad call is deterministic and must surface
        return (isinstance(exc, _NETWORK_ERRORS), None)
    try:
        status = int(status)
    except (TypeError, ValueError):
        return (isinstance(exc, _NETWORK_ERRORS), None)
    if status == 429 or status >= 500 or status == 0:
        return (status != 501, _retry_after(exc))  # 501 never improves
    return (False, None)


def _retry_after(exc: BaseException) -> Optional[float]:
    headers = getattr(exc, "headers", None)
    if headers is None:
        return None
    try:
        raw = headers.get("Retry-After")
        if raw is None:
            # plain-dict headers (restclient path) preserve wire casing,
            # and HTTP/2 hops lowercase header names — match insensitively
            for k in headers:
                if str(k).lower() == "retry-after":
                    raw = headers[k]
                    break
    except (AttributeError, TypeError):
        return None
    try:
        return float(raw) if raw is not None else None
    except (TypeError, ValueError):
        return None  # HTTP-date form: rare enough to fall back to jitter


def retryable(exc: BaseException) -> bool:
    """Would the policy have retried this failure? (Used by backends to
    translate an exhausted-retry error into TransientBackendError.)"""
    return classify(exc)[0]


class RetryPolicy:
    """Retry + backoff + circuit breaker for one API-server relationship.

    ``call(fn, *args, **kwargs)`` runs ``fn`` until success, a terminal
    failure, the attempt budget, or the per-call deadline — whichever
    comes first. Backoff is decorrelated jitter (AWS architecture-blog
    form): ``delay = min(cap, uniform(base, prev * 3))``, floored by a
    server-sent Retry-After when present.

    The breaker counts *consecutive* retryable failures across calls;
    at ``breaker_threshold`` it opens and rejects calls instantly (the
    scheduler keeps its loop latency instead of stacking timeouts), then
    half-opens after ``breaker_cooldown`` to let one probe through.
    """

    def __init__(
        self,
        *,
        attempts: int = 4,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        deadline: float = 15.0,
        breaker_threshold: int = 10,
        breaker_cooldown: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        exc_class: Optional[type] = None,
        counters: ApiCounters = API_COUNTERS,
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.deadline = deadline
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        # exceptions the breaker raises while open; kube.py passes the
        # active client's ApiException so existing handlers catch it
        self._exc_class = exc_class
        self._counters = counters
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._state = CIRCUIT_CLOSED
        self._open_until = 0.0
        self._half_open_since = 0.0

    # ------------------------------------------------------------------
    # circuit breaker
    # ------------------------------------------------------------------

    @property
    def circuit_state(self) -> int:
        with self._lock:
            return self._state

    def _set_state(self, state: int) -> None:
        # caller holds self._lock
        self._state = state
        self._counters.set("api_circuit_state", state)

    def _admit(self) -> bool:
        """May a call proceed right now? (False = breaker rejects it.)"""
        with self._lock:
            if self._state == CIRCUIT_CLOSED:
                return True
            if self._state == CIRCUIT_OPEN:
                if self._clock() < self._open_until:
                    return False
                # cooldown lapsed: half-open, admit exactly this probe
                self._set_state(CIRCUIT_HALF_OPEN)
                self._half_open_since = self._clock()
                return True
            # HALF_OPEN: one probe is already in flight; reject the rest
            # so a burst doesn't re-storm a recovering server. But the
            # probe may never report back (hung socket with no client
            # timeout, thread unwound by a BaseException) — after a full
            # cooldown of silence, assume it died and admit a new probe,
            # or the breaker would convert one stuck thread into a
            # permanent process-wide rejection
            if self._clock() - self._half_open_since >= self.breaker_cooldown:
                self._half_open_since = self._clock()
                return True
            return False

    def _record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != CIRCUIT_CLOSED:
                self._set_state(CIRCUIT_CLOSED)

    def _record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == CIRCUIT_HALF_OPEN or (
                self._state == CIRCUIT_CLOSED
                and self._consecutive_failures >= self.breaker_threshold
            ):
                self._set_state(CIRCUIT_OPEN)
                self._open_until = self._clock() + self.breaker_cooldown
                self._counters.inc("api_circuit_open_total")

    def _reject(self) -> BaseException:
        self._counters.inc("api_circuit_rejections_total")
        if self._exc_class is not None:
            return self._exc_class(
                status=0, reason="circuit breaker open (API server failing)"
            )
        return CircuitOpenError("circuit breaker open (API server failing)")

    # ------------------------------------------------------------------
    # the call loop
    # ------------------------------------------------------------------

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        if not self._admit():
            raise self._reject()  # rejected calls never hit the wire —
            #                       they stay out of the latency histogram
        t0 = time.perf_counter()
        try:
            return self._call_under_policy(fn, *args, **kwargs)
        finally:
            # whole-call latency incl. backoff sleeps — the figure a
            # caller (the scheduler's commit path) actually waited
            _histo.observe("api_call_seconds", time.perf_counter() - t0)

    def _call_under_policy(
        self, fn: Callable[..., Any], *args: Any, **kwargs: Any
    ) -> Any:
        self._counters.inc("api_calls_total")
        deadline_at = self._clock() + self.deadline
        prev_delay = self.base_delay
        attempt = 0
        while True:
            try:
                result = fn(*args, **kwargs)
            except ValueError:
                # the V1Binding quirk: a 2xx the client can't deserialize.
                # The call SUCCEEDED on the wire — callers depend on seeing
                # this exact exception (k8s/kube.py bind_pod_to_node)
                self._record_success()
                raise
            except Exception as exc:
                is_retryable, retry_after = classify(exc)
                if not is_retryable:
                    # terminal 4xx: a fact about the request, not about
                    # server health. The server RESPONDED, so this also
                    # counts as proof of health — without it a half-open
                    # probe answered 404 would wedge the breaker in
                    # HALF_OPEN and reject every later call forever
                    self._record_success()
                    raise
                self._counters.inc("api_failures_total")
                self._record_failure()
                attempt += 1
                delay = min(
                    self.max_delay,
                    self._rng.uniform(self.base_delay, prev_delay * 3),
                )
                if retry_after is not None:
                    # honor the server's directive up to the remaining
                    # deadline — capping it at max_delay would re-hit a
                    # throttling server well inside the window it asked
                    # us to stay away
                    remaining = max(0.0, deadline_at - self._clock())
                    delay = max(delay, min(retry_after, remaining))
                prev_delay = delay
                if (
                    attempt >= self.attempts
                    or not self._admit_retry()
                    or self._clock() + delay > deadline_at
                ):
                    self._counters.inc("api_giveups_total")
                    raise
                self._counters.inc("api_retries_total")
                self._sleep(delay)
                continue
            self._record_success()
            return result

    def _admit_retry(self) -> bool:
        """Retries stop immediately once the breaker opens mid-call."""
        with self._lock:
            return self._state != CIRCUIT_OPEN


class CircuitOpenError(Exception):
    """Raised for rejected calls when no client exception class is wired."""

    status = 0
    reason = "circuit breaker open"


class RetryingApi:
    """Proxy that runs every non-watch method of a kubernetes-client-shaped
    API object under a RetryPolicy.

    Watch establishment (``watch=True`` kwarg, as both the real client's
    ``Watch.stream`` and the restclient fallback issue it) passes through
    untouched: the watch plane's reconnect loop (k8s/kube.py) owns that
    backoff, and stacking the two would double-delay stream recovery.
    """

    def __init__(self, api: Any, policy: RetryPolicy):
        self._api = api
        self._policy = policy
        self._wrapped: Dict[str, Callable[..., Any]] = {}

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._api, name)
        if not callable(attr):
            return attr
        cached = self._wrapped.get(name)
        if cached is not None:
            return cached

        def wrapped(*args: Any, __attr=attr, **kwargs: Any) -> Any:
            if kwargs.get("watch"):
                return __attr(*args, **kwargs)
            return self._policy.call(__attr, *args, **kwargs)

        # full metadata, not just __name__: the real kubernetes client's
        # Watch.stream picks its deserialization return type by scanning
        # func.__doc__ for ':return:' — losing the docstring would leave
        # every watch event a raw dict and silently kill the watch plane
        functools.update_wrapper(wrapped, attr)
        self._wrapped[name] = wrapped
        return wrapped
