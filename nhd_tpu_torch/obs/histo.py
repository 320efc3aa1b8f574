"""Prometheus histograms for the latency-shaped scheduler metrics.

The seed's ``last_*`` gauges were lossy by construction: a scrape sees
only the most recent batch, so any batch that lands between scrapes —
i.e. almost all of them — leaves no trace, and a p99 computed inside one
batch says nothing about the fleet over time. Histograms fix both:
cumulative buckets survive scrape gaps (counters never lose events) and
``histogram_quantile()`` gives real percentiles over any window.

Stdlib-only, like the rest of the metrics plane: a fixed ascending bucket
list, one lock per histogram (observes come from scheduler, commit-pool,
and API threads), and exact exposition rendering — bucket counts are
integers printed as integers, sums use ``repr`` (shortest round-trip), so
no ``:g`` precision loss on large counts (the same rule rpc/metrics.py
follows for counters).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Sequence, Tuple

# default latency buckets: 0.5 ms .. 30 s — covers the daemon fast path
# (sub-ms binds, docs/TPU_STATUS.md) through federation gang sweeps
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# API round trips are faster-grained: 1 ms .. 15 s (the retry deadline)
API_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 15.0,
)


def _fmt(v: float) -> str:
    """Exact, minimal float rendering for le labels and sums ('0.005',
    not '5e-03'; integers shed their trailing '.0')."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Histogram:
    """One cumulative-bucket histogram (thread-safe)."""

    def __init__(
        self, name: str, help_text: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"buckets must be a non-empty ascending sequence, "
                f"got {buckets!r}"
            )
        self.name = name
        self.help_text = help_text
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        # per-bucket (non-cumulative) counts; index len(buckets) = +Inf
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # Prometheus buckets are 'le': value exactly on an edge belongs
        # in that edge's bucket, hence bisect_left
        i = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            raw = list(self._counts)
            total_sum, total_count = self._sum, self._count
        cum: List[int] = []
        running = 0
        for c in raw:
            running += c
            cum.append(running)
        return cum, total_sum, total_count

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def render(self, prefix: str = "nhd_") -> List[str]:
        """Prometheus text exposition lines for this histogram."""
        cum, total_sum, total_count = self.snapshot()
        full = f"{prefix}{self.name}"
        lines = [
            f"# HELP {full} {self.help_text}",
            f"# TYPE {full} histogram",
        ]
        for edge, c in zip(self.buckets, cum):
            lines.append(f'{full}_bucket{{le="{_fmt(edge)}"}} {c}')
        lines.append(f'{full}_bucket{{le="+Inf"}} {cum[-1]}')
        lines.append(f"{full}_sum {_fmt(total_sum)}")
        lines.append(f"{full}_count {total_count}")
        return lines


class LabeledHistogram:
    """A histogram family with ONE label dimension (e.g. per solver
    round phase). Child histograms materialize on first observe; the
    label set must be bounded by construction at the call sites — phase
    names come from solver code, never from pod/corr identifiers
    (nhdlint NHD603 polices the unbounded-cardinality mistake)."""

    def __init__(
        self, name: str, label: str, help_text: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.label = label
        self.help_text = help_text
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._children: Dict[str, Histogram] = {}

    def observe(self, label_value: str, value: float) -> None:
        with self._lock:
            child = self._children.get(label_value)
            if child is None:
                child = Histogram(self.name, self.help_text, self.buckets)
                self._children[label_value] = child
        child.observe(value)

    def render(self, prefix: str = "nhd_") -> List[str]:
        full = f"{prefix}{self.name}"
        with self._lock:
            children = sorted(self._children.items())
        if not children:
            return []
        lines = [
            f"# HELP {full} {self.help_text}",
            f"# TYPE {full} histogram",
        ]
        for label_value, child in children:
            cum, total_sum, total_count = child.snapshot()
            sel = f'{self.label}="{label_value}"'
            for edge, c in zip(child.buckets, cum):
                lines.append(
                    f'{full}_bucket{{{sel},le="{_fmt(edge)}"}} {c}'
                )
            lines.append(f'{full}_bucket{{{sel},le="+Inf"}} {cum[-1]}')
            lines.append(f'{full}_sum{{{sel}}} {_fmt(total_sum)}')
            lines.append(f'{full}_count{{{sel}}} {total_count}')
        return lines

    def snapshot(self) -> Dict[str, Tuple[List[int], float, int]]:
        with self._lock:
            children = dict(self._children)
        return {k: child.snapshot() for k, child in children.items()}

    def reset(self) -> None:
        with self._lock:
            self._children.clear()


# ---------------------------------------------------------------------------
# registry: adding a histogram here is all it takes to surface it on
# /metrics (rpc/metrics.py renders the whole table, mirroring the
# ApiCounters.KNOWN convention)
# ---------------------------------------------------------------------------

HISTOGRAMS: Dict[str, Histogram] = {
    h.name: h
    for h in (
        Histogram(
            "bind_latency_seconds",
            "End-to-end per-pod bind latency: batch admission to bound",
        ),
        Histogram(
            "queue_wait_seconds",
            "Watch-event receipt to batch admission (event queue wait)",
        ),
        Histogram(
            "solve_phase_seconds",
            "Per-batch wall seconds in the batched feasibility solve",
        ),
        Histogram(
            "select_phase_seconds",
            "Per-batch wall seconds in candidate selection/packing",
        ),
        Histogram(
            "assign_phase_seconds",
            "Per-batch wall seconds in physical ID assignment",
        ),
        Histogram(
            "api_call_seconds",
            "Retry-layer API call latency (incl. backoff sleeps)",
            API_BUCKETS,
        ),
        Histogram(
            "time_to_bind_seconds",
            "True end-to-end pod creationTimestamp to bound (survives "
            "spillover hops, shard handoffs and replica restarts)",
            # SLO-shaped edges: the default latency ladder plus the
            # minutes range a spilled/orphaned pod can legitimately wait
            (*DEFAULT_BUCKETS, 60.0, 120.0, 300.0, 600.0),
        ),
    )
}

#: labeled families — one label dimension each (bounded label sets)
LABELED_HISTOGRAMS: Dict[str, LabeledHistogram] = {
    h.name: h
    for h in (
        LabeledHistogram(
            "round_phase_seconds", "phase",
            "Per-batch wall seconds by solver round phase (encode / "
            "materialize / upload / solve / select / readback ... — the "
            "fine-grained device-phase attribution, ISSUE 7)",
        ),
    )
}


def quantile_from_buckets(buckets, q: float) -> float:
    """Interpolated quantile from cumulative (edge, count) pairs — the
    PromQL ``histogram_quantile`` estimate, shared by every scrape-side
    percentile render (bench.py churn/daemon legs, obs/fleet.py).

    The old scrape-side p99 reported the raw upper EDGE of the covering
    bucket: any regression inside a bucket was invisible, and crossing
    an edge read as a cliff (a 251 ms p99 reported as 500 ms). Linear
    interpolation within the bucket fixes both. The lower edge of the
    first bucket is 0; a quantile landing in the +Inf bucket reports
    the last finite edge (there is no upper bound to interpolate to —
    PromQL's stance). Returns 0.0 with no observations.

    ``buckets``: iterable of (upper_edge, cumulative_count), ascending,
    +Inf edge last (``float('inf')`` accepted).
    """
    pairs = sorted(
        ((float(e), int(c)) for e, c in buckets), key=lambda p: p[0]
    )
    if not pairs or pairs[-1][1] <= 0:
        return 0.0
    total = pairs[-1][1]
    target = q * total
    prev_edge, prev_cum = 0.0, 0
    for edge, cum in pairs:
        if cum >= target:
            if edge == float("inf"):
                return prev_edge
            in_bucket = cum - prev_cum
            if in_bucket <= 0:
                return edge
            return prev_edge + (edge - prev_edge) * (
                (target - prev_cum) / in_bucket
            )
        prev_edge, prev_cum = edge, cum
    return prev_edge


def observe(name: str, value: float) -> None:
    """Observe into a registered histogram (KeyError on a typo'd name —
    misspelled instrumentation must fail tests, not vanish)."""
    HISTOGRAMS[name].observe(value)


def observe_labeled(name: str, label_value: str, value: float) -> None:
    """Observe into a registered labeled family (KeyError on a typo)."""
    LABELED_HISTOGRAMS[name].observe(label_value, value)


def render_all(prefix: str = "nhd_") -> List[str]:
    lines: List[str] = []
    for name in HISTOGRAMS:
        lines.extend(HISTOGRAMS[name].render(prefix))
    for name in LABELED_HISTOGRAMS:
        lines.extend(LABELED_HISTOGRAMS[name].render(prefix))
    return lines


def reset_all() -> None:
    """Back to all-zero (test isolation)."""
    from nhd_tpu_torch.obs.slo import SLO

    for h in HISTOGRAMS.values():
        h.reset()
    for lh in LABELED_HISTOGRAMS.values():
        lh.reset()
    # the global SLO tracker rides the same /metrics plane and must not
    # leak observations across reset_all-isolated tests
    SLO.reset()
