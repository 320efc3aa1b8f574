"""Per-tenant admission queue: bounded lanes, weighted fair dequeue, and
an explicit load-shed ladder (docs/RESILIENCE.md "Layer 9").

The watch-plane FIFO (scheduler/events.py WatchQueue) serves one tenant
perfectly and a hostile mix terribly: a single namespace creating pods at
10x everyone else's rate pushes every other tenant's time-to-bind out
behind its backlog, and overload is only ever expressed implicitly —
queues grow, p99 explodes, nothing is refused with a reason. This queue
replaces that FIFO at the front door:

* **Per-tenant bounded lanes.** TRIAD_POD_CREATE events are laned by
  namespace into bounded deques; everything else (node events, deletes —
  the mirror-consistency traffic) rides an unbounded control lane that is
  always drained first and never shed.
* **Weighted deficit-round-robin dequeue.** The scheduler drains creates
  in DRR order across tenants (weights via NHD_ADMIT_WEIGHTS), so one
  tenant's backlog cannot starve another's next pod, and folds up to
  NHD_ADMIT_BATCH creates into one batched solve.
* **An explicit, monotonic shed ladder.** Pressure — the fullest tenant
  lane's fill fraction, joined with the commit pipeline's occupancy via
  ``pressure_fn`` — moves the queue through ADMIT (0) → DEFER (1) →
  SHED (2). At DEFER, over-rate low-tier pods park in a deferred lane
  (re-admitted fairly when pressure drops); at SHED, over-rate pods are
  refused outright. Every refusal produces a shed record the scheduler
  thread turns into a decision record + pod event + /explain reason +
  journal entry — overload degrades explicitly, never silently.

``NHD_ADMIT=0`` keeps the queue as a pure pass-through FIFO (batched
dequeue, no fairness, no ladder) — the negative-control posture the
tenant-storm chaos cells use to demonstrate the starvation this layer
exists to prevent. All knobs are read at construction time (registered
in config/knobs.py), so harnesses can flip them per cell without
reimporting modules.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from nhd_tpu_torch.k8s.retry import API_COUNTERS, ApiCounters
from nhd_tpu_torch.scheduler.events import WatchItem, WatchType

#: the ladder's rungs, in degradation order (monotonic: every rung keeps
#: the restrictions of the rungs below it)
RUNG_ADMIT = 0
RUNG_DEFER = 1
RUNG_SHED = 2


# [the knob reads stay literal os.environ.get calls at the call sites —
# the contract extractor (analysis/contracts.py) and knobs_sync's
# registry↔read cross-reference both key on the literal]


def _parse_float(name: str, raw: str, default: float, *, minimum: float) -> float:
    try:
        val = float(raw) if raw else default
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")
    if val < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {val}")
    return val


def _parse_int(name: str, raw: str, default: int, *, minimum: int) -> int:
    try:
        val = int(raw) if raw else default
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")
    if val < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {val}")
    return val


def parse_weights(raw: str) -> Dict[str, float]:
    """``"tenant-a=2,default=0.5"`` → weight map. A typo'd entry fails
    loud at construction, not silently at the first contended dequeue."""
    out: Dict[str, float] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"NHD_ADMIT_WEIGHTS entry {part!r} is not tenant=weight"
            )
        try:
            w = float(val)
        except ValueError:
            raise ValueError(
                f"NHD_ADMIT_WEIGHTS weight for {name.strip()!r} is not "
                f"a number: {val!r}"
            )
        if w <= 0:
            raise ValueError(
                f"NHD_ADMIT_WEIGHTS weight for {name.strip()!r} must be "
                f"> 0, got {w}"
            )
        out[name.strip()] = w
    return out


class TokenBucket:
    """Per-tenant sustained-rate limiter (classic token bucket) on an
    injectable clock — chaos cells run it on the sim clock, so a failing
    seed replays exactly."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def take(self, n: float = 1.0) -> bool:
        """Consume *n* tokens if available; False = over-rate. A rate of
        0 disables the limiter (always in-rate)."""
        if self.rate <= 0:
            return True
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + max(now - self._t, 0.0) * self.rate
        )
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class _TenantLane:
    """One tenant's bounded admission state: the live deque, the parked
    deferred deque, its token bucket, and its DRR bookkeeping."""

    __slots__ = ("main", "deferred", "bucket", "weight", "deficit")

    def __init__(self, weight: float, bucket: TokenBucket):
        self.main: deque = deque()
        self.deferred: deque = deque()
        self.bucket = bucket
        self.weight = weight
        self.deficit = 0.0

    def depth(self) -> int:
        return len(self.main) + len(self.deferred)


class AdmissionQueue:
    """Drop-in WatchQueue replacement with per-tenant admission.

    The controller (and the scheduler's requeue paths) ``put``; the
    scheduler thread is the only consumer — ``get`` blocks like
    queue.Queue and raises queue.Empty, so the startup flush and the
    run loop work unchanged. The scheduler detects the richer interface
    by duck-typing (``get_creates``) and switches to batched dequeue +
    shed-verdict publishing; tests built on a plain WatchQueue keep the
    exact pre-admission behavior.
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float] = None,
        pressure_fn: Optional[Callable[[], float]] = None,
        counters: Optional[ApiCounters] = None,
    ):
        import time as _time

        self._clock = clock if clock is not None else _time.monotonic
        #: external backpressure (0..1): the scheduler wires the commit
        #: pipeline's occupancy here, coupling ingress admission to the
        #: bind pipeline's depth
        self.pressure_fn = pressure_fn
        self._counters = counters if counters is not None else API_COUNTERS
        env_admit = os.environ.get("NHD_ADMIT", "").lower()
        if env_admit in ("1", "true", "on", ""):
            self.enabled = True
        elif env_admit in ("0", "false", "off"):
            self.enabled = False
        else:
            # same word sets as NHD_ASYNC_COMMIT; a typo'd value must
            # fail loud, not silently disable the overload ladder
            raise ValueError(
                f"NHD_ADMIT must be 1/0/true/false/on/off, got {env_admit!r}"
            )
        self.batch_max = _parse_int(
            "NHD_ADMIT_BATCH", os.environ.get("NHD_ADMIT_BATCH", ""),
            8, minimum=1,
        )
        self.tenant_cap = _parse_int(
            "NHD_ADMIT_TENANT_CAP",
            os.environ.get("NHD_ADMIT_TENANT_CAP", ""), 256, minimum=1,
        )
        self.rate = _parse_float(
            "NHD_ADMIT_RATE", os.environ.get("NHD_ADMIT_RATE", ""),
            0.0, minimum=0.0,
        )
        self.burst = _parse_float(
            "NHD_ADMIT_BURST", os.environ.get("NHD_ADMIT_BURST", ""),
            max(self.rate, 1.0), minimum=1.0,
        )
        self.weights = parse_weights(os.environ.get("NHD_ADMIT_WEIGHTS", ""))
        self.defer_fill = _parse_float(
            "NHD_ADMIT_DEFER_FILL",
            os.environ.get("NHD_ADMIT_DEFER_FILL", ""), 0.5, minimum=0.0,
        )
        self.shed_fill = _parse_float(
            "NHD_ADMIT_SHED_FILL",
            os.environ.get("NHD_ADMIT_SHED_FILL", ""), 0.85, minimum=0.0,
        )
        if self.shed_fill < self.defer_fill:
            # the ladder must be monotonic: the shed rung sits above the
            # defer rung or "escalate" would mean "relax"
            raise ValueError(
                f"NHD_ADMIT_SHED_FILL ({self.shed_fill}) must be >= "
                f"NHD_ADMIT_DEFER_FILL ({self.defer_fill})"
            )
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        #: non-create traffic (node events, deletes, and — with the
        #: ladder off — everything): unbounded, drained first, never shed
        self._control: deque = deque()
        self._lanes: "OrderedDict[str, _TenantLane]" = OrderedDict()
        self._rr: List[str] = []       # DRR rotation (lane names)
        self._rr_idx = 0
        self._shed: deque = deque()    # refusal records awaiting verdicts
        self.stats: Dict[str, int] = {
            "admitted": 0, "deferred": 0, "readmitted": 0, "shed": 0,
            "requeue_refusals": 0,
        }

    # ------------------------------------------------------------------
    # producer side (controller thread + scheduler requeue paths)
    # ------------------------------------------------------------------

    def _lane(self, tenant: str) -> _TenantLane:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = _TenantLane(
                self.weights.get(tenant, 1.0),
                TokenBucket(self.rate, self.burst, self._clock),
            )
            self._lanes[tenant] = lane
            self._rr.append(tenant)
        return lane

    def _pressure(self) -> float:
        """Combined overload signal: the fullest tenant lane's fill
        fraction joined (max) with the external pressure_fn — a full
        commit pipeline escalates the ladder even while lanes are
        shallow, which is exactly the state where admitting more solves
        only grows the bind backlog."""
        fill = 0.0
        for lane in self._lanes.values():
            # LIVE depth only: deferred items are parked off the queue,
            # and counting them would hold the rung up forever — the
            # very backlog the defer rung created would block its own
            # recovery. The hard cap still counts total depth, so
            # parking is bounded per tenant either way.
            fill = max(fill, len(lane.main) / float(self.tenant_cap))
        if self.pressure_fn is not None:
            try:
                fill = max(fill, float(self.pressure_fn()))
            except Exception:  # nhdlint: ignore[NHD302]
                # deliberately silent: a broken pressure probe must not
                # take the front door with it (lane fill alone still
                # drives the ladder), and this runs on every put/get —
                # logging here would flood under exactly the overload
                # the ladder exists to manage
                pass
        return fill

    def rung(self) -> int:
        """Current ladder rung (0 ADMIT / 1 DEFER / 2 SHED)."""
        with self._lock:
            return self._rung_locked()

    def _rung_locked(self) -> int:
        if not self.enabled:
            return RUNG_ADMIT
        p = self._pressure()
        if p >= self.shed_fill:
            return RUNG_SHED
        if p >= self.defer_fill:
            return RUNG_DEFER
        return RUNG_ADMIT

    def put(self, item: WatchItem) -> None:
        self._put(item, requeued=False)

    def put_requeue(self, item: WatchItem) -> None:
        """Re-entry for pods the scheduler already admitted once
        (transient-bind requeue, preemptor/victim requeue): bypasses the
        rate bucket and the defer rung — the pod's earlier admission
        already paid them — but still respects the hard lane cap, so a
        requeue storm cannot reinflate the very backlog the ladder just
        shed. A refused requeue produces exactly one shed record; the
        periodic reconcile scan remains the pod's recovery path."""
        self._put(item, requeued=True)

    def put_batch(self, items: List[WatchItem]) -> None:
        """Controller batch seam: admit a whole decode pass under one
        lock acquisition, preserving arrival order."""
        with self._not_empty:
            for item in items:
                self._put_locked(item, requeued=False)
            self._not_empty.notify()

    def _put(self, item: WatchItem, *, requeued: bool) -> None:
        with self._not_empty:
            self._put_locked(item, requeued=requeued)
            self._not_empty.notify()

    def _put_locked(self, item: WatchItem, *, requeued: bool) -> None:
        if not self.enabled or item.type != WatchType.TRIAD_POD_CREATE:
            # ladder off → pure FIFO; control traffic is never laned:
            # deletes and node events are mirror-consistency input, and
            # shedding them would trade overload for state divergence
            self._control.append(item)
            return
        tenant = (item.pod or {}).get("ns", "default")
        lane = self._lane(tenant)
        if lane.depth() >= self.tenant_cap:
            self._refuse_locked(
                item, tenant,
                reason=(
                    f"tenant lane full ({self.tenant_cap} queued)"
                    + (" on requeue" if requeued else "")
                ),
                requeued=requeued,
            )
            return
        if requeued:
            lane.main.append(item)
            self.stats["admitted"] += 1
            self._counters.inc("admission_admitted_total")
            return
        rung = self._rung_locked()
        within_rate = lane.bucket.take()
        tier = self._item_tier(item)
        if rung >= RUNG_SHED and not within_rate:
            self._refuse_locked(
                item, tenant,
                reason=(
                    f"over tenant rate ({self.rate:g}/s) at shed rung "
                    f"(pressure >= {self.shed_fill:g})"
                ),
                requeued=False,
            )
            return
        if rung >= RUNG_DEFER and not within_rate and tier <= 0:
            # the middle rung: over-rate best-effort traffic parks
            # instead of shedding — re-admitted fairly when pressure
            # drops (the recovery half of the ladder)
            lane.deferred.append(item)
            self.stats["deferred"] += 1
            self._counters.inc("admission_deferred_total")
            return
        lane.main.append(item)
        self.stats["admitted"] += 1
        self._counters.inc("admission_admitted_total")

    @staticmethod
    def _item_tier(item: WatchItem) -> int:
        try:
            return int((item.pod or {}).get("tier") or 0)
        except (TypeError, ValueError):
            return 0

    def _refuse_locked(
        self, item: WatchItem, tenant: str, *, reason: str, requeued: bool
    ) -> None:
        pod = item.pod or {}
        # _locked suffix contract: every caller holds _lock already
        self._shed.append({  # nhdlint: ignore[NHD201]
            "ns": pod.get("ns", "default"),
            "pod": pod.get("name", "?"),
            "uid": pod.get("uid", ""),
            "corr": item.corr,
            "tenant": tenant,
            "reason": reason,
            "requeued": requeued,
            "t": self._clock(),
        })
        self.stats["shed"] += 1
        self._counters.inc("admission_shed_total")
        if requeued:
            self.stats["requeue_refusals"] += 1
            self._counters.inc("admission_requeue_refusals_total")

    # ------------------------------------------------------------------
    # consumer side (the scheduler thread only)
    # ------------------------------------------------------------------

    def get(
        self, block: bool = True, timeout: Optional[float] = None
    ) -> WatchItem:
        """One item, control lane first — the WatchQueue contract
        (blocking get with timeout, queue.Empty when nothing arrives)."""
        with self._not_empty:
            if block:
                self._not_empty.wait_for(self._ready_locked, timeout=timeout)
            item = self._pop_one_locked()
            if item is None:
                raise queue.Empty
            return item

    def get_creates(self, limit: int) -> List[WatchItem]:
        """Up to *limit* additional TRIAD_POD_CREATEs in DRR order,
        non-blocking — the scheduler calls this after a blocking get
        returned a create, folding the run into one batched solve.
        Control-lane traffic is never pulled: its items interleave with
        creates in arrival order only through get()."""
        out: List[WatchItem] = []
        if limit <= 0:
            return out
        with self._lock:
            self._recover_locked()
            while len(out) < limit:
                item = self._pop_create_locked()
                if item is None:
                    break
                out.append(item)
        return out

    def batch_limit(self) -> int:
        """How many creates one scheduling batch may fold right now:
        NHD_ADMIT_BATCH, halved at the defer rung and floored to 1 at
        the shed rung — the backpressure coupling between queue/commit
        depth and the scheduler's batch admission."""
        with self._lock:
            rung = self._rung_locked()
        if rung >= RUNG_SHED:
            return 1
        if rung >= RUNG_DEFER:
            return max(1, self.batch_max // 2)
        return self.batch_max

    def _any_locked(self) -> bool:
        if self._control:
            return True
        return any(lane.main for lane in self._lanes.values())

    def _ready_locked(self) -> bool:
        """The blocking get's wake predicate: live work, or parked work
        that is recoverable right now (rung back at ADMIT) — a consumer
        must not sleep out its timeout while re-admission is due."""
        if self._any_locked():
            return True
        if self._rung_locked() != RUNG_ADMIT:
            return False
        return any(lane.deferred for lane in self._lanes.values())

    def _pop_one_locked(self) -> Optional[WatchItem]:
        if self._control:
            return self._control.popleft()
        self._recover_locked()
        return self._pop_create_locked()

    def _pop_create_locked(self) -> Optional[WatchItem]:
        """One create in weighted deficit-round-robin order. The
        rotation and deficits persist across calls, so fairness holds at
        every granularity — single gets, batch folds, across batches."""
        n = len(self._rr)
        for _ in range(2 * n):   # two sweeps: one may only fund deficits
            if n == 0:
                return None
            self._rr_idx %= n
            name = self._rr[self._rr_idx]
            lane = self._lanes[name]
            if not lane.main:
                lane.deficit = 0.0
                self._rr_idx += 1
                continue
            if lane.deficit < 1.0:
                # fund at most once per visit, and only below one
                # credit — an idle lane cannot bank a burst
                lane.deficit += lane.weight
            if lane.deficit >= 1.0:
                lane.deficit -= 1.0
                if lane.deficit < 1.0:
                    # credit spent: the rotation MUST move on, or a
                    # deep lane would pop every call until empty and
                    # starve everyone behind it (weight > 1 lanes keep
                    # the slot while credit remains — that surplus IS
                    # the weight)
                    self._rr_idx += 1
                return lane.main.popleft()
            self._rr_idx += 1
        return None

    def _recover_locked(self) -> None:
        """The ladder's recovery half: once pressure drops below the
        defer rung, parked pods re-enter their tenant's live lane (in
        arrival order; DRR keeps re-admission fair across tenants)."""
        if self._rung_locked() != RUNG_ADMIT:
            return
        for lane in self._lanes.values():
            while lane.deferred:
                lane.main.append(lane.deferred.popleft())
                self.stats["readmitted"] += 1
                self._counters.inc("admission_readmitted_total")

    def drain_shed(self) -> List[dict]:
        """Pop every pending refusal record. The scheduler thread — the
        single writer — turns each into its decision record, pod event,
        /explain reason and journal entry exactly once."""
        with self._lock:
            out = list(self._shed)
            self._shed.clear()
        return out

    # ------------------------------------------------------------------
    # depth/metrics surface
    # ------------------------------------------------------------------

    def empty(self) -> bool:
        """True when a get() would find nothing to pop right now.
        Deferred items at a raised rung deliberately read as empty —
        they are parked, not drainable, and the drive loops that poll
        empty() must not spin on them (qsize/depths still count them:
        parked work IS backlog)."""
        with self._lock:
            return not self._ready_locked()

    def qsize(self) -> int:
        """TRUE ingress backlog: control + every tenant lane, deferred
        included — the nhd_event_queue_depth gauge under this layer."""
        with self._lock:
            return len(self._control) + sum(
                lane.depth() for lane in self._lanes.values()
            )

    def depths(self) -> Dict[str, object]:
        """Per-lane depth snapshot for /metrics and the fleet payload:
        summed total, per-tenant depths, the max tenant depth, deferred
        total and the current rung — one consistent read."""
        with self._lock:
            tenants = {
                name: lane.depth() for name, lane in self._lanes.items()
                if lane.depth()
            }
            return {
                "control": len(self._control),
                "tenants": tenants,
                "max_tenant": max(tenants.values(), default=0),
                "deferred": sum(
                    len(lane.deferred) for lane in self._lanes.values()
                ),
                "total": len(self._control) + sum(
                    lane.depth() for lane in self._lanes.values()
                ),
                "rung": self._rung_locked(),
            }
