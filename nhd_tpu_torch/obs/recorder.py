"""Flight recorder: correlation IDs, spans, and the bounded in-memory ring.

The reference's only observability is verbose logs plus the gRPC stats
plane (SURVEY §5.1/§5.5); counters say *how often* but never *where the
time went* for one pod. The flight recorder answers that: every watch
event mints a correlation ID that rides the pipeline (event queue → batch
admission → solve → select → assign → bind commit), and each stage
records a span into a bounded ring. Export is Chrome trace-viewer JSON
(chrome://tracing / https://ui.perfetto.dev) plus a queryable
"recent decisions" view (rpc/metrics.py, rpc/server.py).

Design constraints, in order:

* **off means off** — every producer call sites guard on
  ``get_recorder() is None``; a disabled recorder costs one module-global
  read on the batch path (bench.py's ≤2 % overhead acceptance);
* **thread-safe by construction** — spans arrive concurrently from the
  controller, scheduler, commit-pool, and RPC threads; the ring is a
  ``deque(maxlen=...)`` guarded by one lock, and a span is immutable
  after ``record`` returns (sole exception: ``realias_corr`` rewrites
  corr under the ring lock when cross-replica adoption lands late);
* **bounded** — the ring evicts oldest-first and counts what it dropped
  (the ``nhd_trace_ring_dropped_total`` metric), so tracing can stay on
  in production without growing the heap.

Work too frequent for the ring (a call made once per pod) adds to the
recorder's per-name tallies instead: a (count, seconds) pair, exported
beside the spans and cleared with them. While the process-global
recorder is on, a ``gc.callbacks`` hook records each collection as a
``gc`` span with its generation.

Correlation IDs are a process-wide monotonic counter, not random tokens:
deterministic runs produce deterministic traces (golden-file tests), and
the IDs only need to be unique within one process's ring lifetime.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

try:  # contextvars: per-thread in threads, carried across awaits in async
    from contextvars import ContextVar
except ImportError:  # pragma: no cover - py3.7+ always has it
    ContextVar = None  # type: ignore[assignment]

_corr_seq = itertools.count(1)
_CORR_VAR: "ContextVar[Optional[str]]" = ContextVar("nhd_corr", default=None)


def new_corr_id(scope: str = "") -> str:
    """Mint a fresh correlation ID (monotonic; unique within one
    process). ``scope`` — the minting replica's identity — makes the ID
    unique ACROSS processes too: every replica's counter restarts at 1,
    so two replicas' locally minted ``c000001`` would otherwise fuse
    unrelated pods into one journey when their dumps merge
    (chrome.merge_chrome_traces). Adopted corrs keep their origin's
    scope by construction (the annotation carries the full ID)."""
    n = next(_corr_seq)
    return f"{scope}/c{n:06d}" if scope else f"c{n:06d}"


def current_corr_id() -> Optional[str]:
    """The correlation ID bound to the calling context (or None)."""
    return _CORR_VAR.get()


@contextlib.contextmanager
def correlate(corr: Optional[str]) -> Iterator[None]:
    """Bind *corr* as the context correlation ID for the block — log
    records emitted inside (NHD_LOG_JSON=1) join against the trace."""
    token = _CORR_VAR.set(corr)
    try:
        yield
    finally:
        _CORR_VAR.reset(token)


class Span:
    """One recorded interval. Immutable after construction; __slots__
    because a gang-scale batch records tens of thousands of these.

    ``replica``/``shard``/``epoch`` are the federation coordinates
    (ISSUE 7): which replica produced the span, and — for spans on the
    fenced commit path — which shard lease and fencing epoch covered
    the work. ``replica`` is stamped by the recorder (every span a
    replica records is that replica's); shard/epoch only where the
    producer knows them, so a merged cross-replica journey shows which
    leadership each leg ran under."""

    __slots__ = (
        "name", "cat", "corr", "t0", "dur", "thread", "attrs",
        "replica", "shard", "epoch",
    )

    def __init__(
        self,
        name: str,
        t0: float,
        dur: float,
        *,
        cat: str = "span",
        corr: Optional[str] = None,
        thread: Optional[str] = None,
        attrs: Optional[dict] = None,
        replica: Optional[str] = None,
        shard: Optional[int] = None,
        epoch: Optional[int] = None,
    ):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.cat = cat
        self.corr = corr
        self.thread = thread or threading.current_thread().name
        self.attrs = attrs
        self.replica = replica
        self.shard = shard
        self.epoch = epoch

    def to_dict(self) -> dict:
        d = {
            "name": self.name, "cat": self.cat, "corr": self.corr,
            "t0": self.t0, "dur": self.dur, "thread": self.thread,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        for key in ("replica", "shard", "epoch"):
            v = getattr(self, key)
            if v is not None:
                d[key] = v
        return d


class FlightRecorder:
    """Bounded, thread-safe span ring + decision log.

    ``capacity`` bounds the span ring; ``decision_capacity`` bounds the
    independent per-pod decision log (a much smaller, higher-value record
    that must not be evicted by span churn from one big batch).
    """

    def __init__(
        self,
        capacity: int = 16384,
        decision_capacity: int = 256,
        *,
        identity: str = "",
    ):
        if capacity < 1 or decision_capacity < 1:
            raise ValueError(
                f"capacities must be >= 1, got {capacity}/{decision_capacity}"
            )
        self.capacity = capacity
        self.decision_capacity = decision_capacity
        # federation coordinates: which replica this ring belongs to
        # (stamped onto every span), and the monotonic→wall anchor the
        # cross-replica merge uses to put N processes' spans on one
        # timeline (chrome.merge_chrome_traces). Captured once — the
        # pair drifts together, which is exactly what re-basing needs.
        self.identity = identity
        self.epoch_offset = time.time() - time.monotonic()
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=capacity)
        self._decisions: "deque[dict]" = deque(maxlen=decision_capacity)
        self._dropped = 0
        # name -> [count, seconds] (tally)
        self._tallies: Dict[str, List[float]] = {}
        # the collector's spans (_on_gc): a collection may start at any
        # bytecode boundary, inside this recorder's own locked sections
        # too, so the hook only appends here (no lock) and the ring
        # takes them in at its next record or read (_absorb)
        self._pending: "deque[Span]" = deque()

    def _absorb(self) -> None:
        """Move the collector's pending spans into the ring (under the
        lock, so one caller at a time consumes ``_pending``)."""
        pending = self._pending
        if not pending:
            return
        with self._lock:
            while pending:
                span = pending.popleft()
                if len(self._spans) == self.capacity:
                    self._dropped += 1
                self._spans.append(span)

    # -- producers ------------------------------------------------------

    def record(
        self,
        name: str,
        t0: float,
        dur: float,
        *,
        cat: str = "span",
        corr: Optional[str] = None,
        thread: Optional[str] = None,
        attrs: Optional[dict] = None,
        shard: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> None:
        """Append one span (t0 on the time.monotonic() clock, seconds)."""
        span = Span(
            name, t0, dur, cat=cat,
            corr=corr if corr is not None else _CORR_VAR.get(),
            thread=thread, attrs=attrs,
            replica=self.identity or None, shard=shard, epoch=epoch,
        )
        self._absorb()
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(span)

    def tally(self, name: str, seconds: float, count: int = 1) -> None:
        """Add *count* calls and their *seconds* to *name*'s tally: the
        aggregate form of a span, for work too frequent for the ring."""
        with self._lock:
            t = self._tallies.get(name)
            if t is None:
                self._tallies[name] = [count, seconds]
            else:
                t[0] += count
                t[1] += seconds

    def realias_corr(self, old: str, new: str) -> int:
        """Rewrite ring spans recorded under *old* to carry *new* —
        see realias_corrs. Returns the number of spans re-aliased."""
        return self.realias_corrs({old: new})

    def realias_corrs(self, mapping: Dict[str, str]) -> int:
        """Rewrite ring spans whose corr is a key of *mapping* to carry
        the mapped ID, in ONE ring pass.

        The watch-receipt leg is recorded before the scheduler can read
        the pod's cluster-stamped corr (adoption happens at batch
        admission, _resolve_trace_corr); when adoption changes IDs,
        this re-joins those already-recorded legs to their journeys
        instead of orphaning them as one-span corrs. Batched because the
        pass holds the ring lock every producer thread records under —
        one O(capacity) scan per BATCH, not per pod. The sole sanctioned
        mutation of a recorded span: corr only, under the ring lock.
        Returns the number of spans re-aliased."""
        mapping = {o: n for o, n in mapping.items() if o != n}
        if not mapping:
            return 0
        n = 0
        with self._lock:
            for s in self._spans:
                new = mapping.get(s.corr)
                if new is not None:
                    s.corr = new
                    n += 1
        return n

    def record_decision(self, decision: dict) -> None:
        """Append one per-pod scheduling decision (see scheduler/core.py
        for the record shape: pod, ns, corr, outcome, node, phases...)."""
        with self._lock:
            self._decisions.append(decision)

    # -- consumers ------------------------------------------------------

    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first."""
        self._absorb()
        with self._lock:
            return list(self._spans)

    def tallies(self) -> Dict[str, Tuple[int, float]]:
        """Snapshot of the tallies: name -> (count, seconds)."""
        with self._lock:
            return {k: (int(v[0]), v[1]) for k, v in self._tallies.items()}

    def recent_decisions(self, n: int = 50) -> List[dict]:
        """The last *n* per-pod decisions, newest first."""
        with self._lock:
            out = list(self._decisions)
        out.reverse()
        return [dict(d) for d in out[: max(n, 0)]]

    def occupancy(self) -> int:
        self._absorb()
        with self._lock:
            return len(self._spans)

    def dropped(self) -> int:
        self._absorb()
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        global _DROPPED_BANKED
        with self._lock:
            # the process-global ring's drop count banks into the
            # monotonic total before it resets — dropped_total() is a
            # Prometheus counter and must never move backwards
            if _RECORDER is self:
                _DROPPED_BANKED += self._dropped
            self._pending.clear()
            self._spans.clear()
            self._decisions.clear()
            self._tallies.clear()
            self._dropped = 0


# ---------------------------------------------------------------------------
# process-global recorder (None = tracing off; the common case)
# ---------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None

# spans dropped by process-global rings that have since been replaced
# (enable), torn down (disable), or cleared — the live ring's count adds
# on top in dropped_total(). Without this bank the exported
# nhd_trace_ring_dropped_total reset on every enable()/clear(), which a
# Prometheus counter must never do (rate() reads a reset as a huge
# negative spike and drops the window).
_DROPPED_BANKED = 0


def get_recorder() -> Optional[FlightRecorder]:
    """The active recorder, or None when tracing is off. Producers must
    treat None as 'skip all span work' — this read is the entire
    recorder-off cost on the hot path."""
    return _RECORDER


def enable(
    capacity: int = 16384, decision_capacity: int = 256, *,
    identity: str = "",
) -> FlightRecorder:
    """Install (or replace) the process-global recorder and return it.
    ``identity`` names this replica in every span it records — set it
    under HA/federation so merged cross-replica journeys attribute each
    leg (chrome.merge_chrome_traces)."""
    global _RECORDER, _DROPPED_BANKED
    if _RECORDER is not None:
        _DROPPED_BANKED += _RECORDER.dropped()
    _RECORDER = FlightRecorder(
        capacity, decision_capacity, identity=identity
    )
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    return _RECORDER


def disable() -> None:
    global _RECORDER, _DROPPED_BANKED
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    if _RECORDER is not None:
        _DROPPED_BANKED += _RECORDER.dropped()
    _RECORDER = None


# the running collection's start (collections never nest)
_GC_T0: Optional[float] = None


def _on_gc(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` hook ``enable`` installs: each collection as
    a ``gc`` span (``attrs``: its generation and what it collected),
    bound to no correlation ID, handed to the ring through its pending
    queue (FlightRecorder._absorb)."""
    global _GC_T0
    if phase == "start":
        _GC_T0 = time.monotonic()
        return
    rec, t0 = _RECORDER, _GC_T0
    _GC_T0 = None
    if rec is not None and t0 is not None:
        rec._pending.append(Span(
            "gc", t0, time.monotonic() - t0, cat="gc",
            attrs={"generation": info.get("generation"),
                   "collected": info.get("collected")},
            replica=rec.identity or None,
        ))


def dropped_total() -> int:
    """Monotonic count of spans the process-global ring has EVER
    dropped, across enable()/disable()/clear() generations — the value
    nhd_trace_ring_dropped_total exports (a true counter, unlike the
    live ring's dropped() snapshot, which resets with the ring)."""
    rec = _RECORDER
    return _DROPPED_BANKED + (rec.dropped() if rec is not None else 0)


def decisions_view(n: int = 50) -> Dict[str, object]:
    """The recent-decisions payload both query planes serve (HTTP
    /decisions and gRPC GetRecentDecisions) — one definition, so the
    transports cannot drift."""
    rec = _RECORDER
    return {
        "enabled": rec is not None,
        "decisions": rec.recent_decisions(n) if rec is not None else [],
    }


@contextlib.contextmanager
def span(
    name: str,
    *,
    cat: str = "span",
    corr: Optional[str] = None,
    attrs: Optional[dict] = None,
) -> Iterator[None]:
    """Record the block as a span when tracing is on; free no-op when off."""
    rec = _RECORDER
    if rec is None:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        rec.record(
            name, t0, time.monotonic() - t0, cat=cat, corr=corr, attrs=attrs
        )
