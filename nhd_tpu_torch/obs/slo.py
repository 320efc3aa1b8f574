"""SLO engine: true end-to-end time-to-bind + multi-window burn rates.

The latency story so far measures what one process saw: ``t_enqueue`` is
minted at watch receipt, so a pod that spilled across shards, rode a
handoff, or outlived a replica restart re-enters the clock at zero every
hop — the operator-facing "how long did this pod actually wait?" cannot
be answered from any one replica's histograms. This module measures from
the pod's **creationTimestamp** (``ClusterBackend.get_pod_created``),
which the cluster owns: the stamp survives every spill, handoff, and
crash, and every replica computes the same figure (ISSUE 7).

On top of the raw observations the tracker keeps **multi-window burn
rates** (the Google SRE workbook shape): with an objective of "fraction
``good_fraction`` of pods bind within ``target_sec``", the burn rate
over a window is ``breach_ratio / (1 - good_fraction)`` — 1.0 means the
error budget burns exactly at the sustainable rate, 14.4 over 1 h is the
classic page threshold. Exported as ``nhd_slo_*`` families
(rpc/metrics.py) and folded into the fleet artifact (obs/fleet.py).

Stdlib-only, one lock, bounded memory: observations aggregate into
fixed-width time buckets (720 per widest window), so coverage of the
full window is independent of bind rate — an event ring capped by COUNT
would silently truncate the 1 h window at anything past cap/3600
binds/s, under-reporting the burn exactly during the storm that should
page. ``clock`` is injectable so chaos runs drive the windows off the
sim's step clock.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nhd_tpu_torch.obs.histo import DEFAULT_BUCKETS, quantile_from_buckets

#: default objective: this fraction of pods bind within the target
SLO_BIND_TARGET_SEC = float(os.environ.get("NHD_SLO_BIND_SEC", "30"))
SLO_GOOD_FRACTION = float(os.environ.get("NHD_SLO_GOOD_FRACTION", "0.99"))

#: burn-rate windows, seconds (label, width) — the 5m/1h fast/slow pair
BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))

#: metric family names this module renders (without the nhd_ prefix) —
#: also the lint registration source for the NHD6xx metrics pack
METRIC_FAMILIES = (
    "slo_bind_target_seconds",
    "slo_bind_good_fraction",
    "slo_bind_observations_total",
    "slo_bind_breaches_total",
    "slo_bind_max_seconds",
    "slo_bind_burn_rate",
    "slo_tenant_observations_total",
    "slo_tenant_breaches_total",
    "slo_tenant_max_seconds",
    "slo_tenant_p99_seconds",
)

#: cap on distinct tenant labels (NHD603: label sets must be bounded by
#: construction — namespaces are operator-created but not bounded, so
#: past the cap new tenants aggregate under "other" instead of growing
#: the family per namespace)
TENANT_LABEL_MAX = 32
TENANT_OVERFLOW = "other"


class SloTracker:
    """Thread-safe time-to-bind SLO accounting for one replica."""

    def __init__(
        self,
        *,
        target_sec: float = SLO_BIND_TARGET_SEC,
        good_fraction: float = SLO_GOOD_FRACTION,
        windows: Sequence[Tuple[str, float]] = BURN_WINDOWS,
        clock: Callable[[], float] = time.time,
    ):
        if target_sec <= 0:
            raise ValueError(f"target_sec must be > 0, got {target_sec}")
        if not 0.0 < good_fraction < 1.0:
            raise ValueError(
                f"good_fraction must be in (0, 1), got {good_fraction}"
            )
        self.target_sec = target_sec
        self.good_fraction = good_fraction
        self.windows = tuple(windows)
        self._clock = clock
        self._lock = threading.Lock()
        # time-bucketed (total, breached) aggregates: 720 buckets span
        # the widest window, so window coverage never depends on bind
        # rate; memory stays O(buckets) forever via lazy eviction
        self._max_window = max((w for _, w in self.windows), default=3600.0)
        self._bucket_sec = self._max_window / 720.0
        self._buckets: Dict[int, List[int]] = {}
        self._total = 0
        self._breaches = 0
        self._max_seen = 0.0
        # per-tenant views (ISSUE 20): tenant → [count, breaches, max,
        # latency bucket counts] over the shared DEFAULT_BUCKETS edges —
        # p99 comes from the same interpolated-quantile estimate every
        # scrape-side percentile uses (obs/histo.quantile_from_buckets).
        # Bounded at TENANT_LABEL_MAX; overflow aggregates as "other".
        self._tenant_edges = DEFAULT_BUCKETS
        self._tenants: Dict[str, list] = {}

    # -- producers ------------------------------------------------------

    def observe(
        self,
        tt_bind: float,
        now: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> bool:
        """One bound pod's creation→bind seconds; returns whether it
        breached the target. ``tenant`` (the pod's namespace) feeds the
        per-tenant view the tenant-storm isolation invariant gates on."""
        now = self._clock() if now is None else now
        breached = tt_bind > self.target_sec
        with self._lock:
            self._total += 1
            if breached:
                self._breaches += 1
            self._max_seen = max(self._max_seen, tt_bind)
            key = int(now // self._bucket_sec)
            bucket = self._buckets.get(key)
            if bucket is None:
                self._buckets[key] = bucket = [0, 0]
            bucket[0] += 1
            if breached:
                bucket[1] += 1
            # lazy eviction: only when the map outgrows ~2 windows'
            # worth of buckets, drop everything already aged out
            if len(self._buckets) > 1444:
                floor_key = int((now - self._max_window) // self._bucket_sec)
                self._buckets = {
                    k: v for k, v in self._buckets.items() if k >= floor_key
                }
            if tenant is not None:
                self._observe_tenant_locked(tenant, tt_bind, breached)
        return breached

    def _observe_tenant_locked(
        self, tenant: str, tt_bind: float, breached: bool
    ) -> None:
        if tenant not in self._tenants and len(self._tenants) >= TENANT_LABEL_MAX:
            tenant = TENANT_OVERFLOW
        state = self._tenants.get(tenant)
        if state is None:
            state = [0, 0, 0.0, [0] * (len(self._tenant_edges) + 1)]
            # _locked suffix contract: observe() holds _lock here
            self._tenants[tenant] = state  # nhdlint: ignore[NHD201]
        state[0] += 1
        if breached:
            state[1] += 1
        state[2] = max(state[2], tt_bind)
        state[3][bisect_left(self._tenant_edges, tt_bind)] += 1

    # -- consumers ------------------------------------------------------

    def burn_rate(self, window_sec: float, now: Optional[float] = None) -> float:
        """breach_ratio within the window / the error budget. 0.0 when
        the window saw no binds (no traffic burns no budget). A bucket
        counts while any of its span is inside the window (resolution:
        max_window/720 — 5 s at the default 1 h)."""
        now = self._clock() if now is None else now
        cutoff = now - window_sec
        with self._lock:
            total = bad = 0
            for key, (n, breached) in self._buckets.items():
                if (key + 1) * self._bucket_sec > cutoff:
                    total += n
                    bad += breached
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - self.good_fraction)

    def tenant_p99(self, tenant: str) -> float:
        """Interpolated p99 time-to-bind for one tenant (0.0 when the
        tenant never bound a pod) — the tenant-storm isolation
        invariant's measured quantity."""
        with self._lock:
            state = self._tenants.get(tenant)
            if state is None:
                return 0.0
            counts = list(state[3])
        return self._p99_from_counts(counts)

    def _p99_from_counts(self, counts: List[int]) -> float:
        pairs = []
        running = 0
        for edge, c in zip(self._tenant_edges, counts):
            running += c
            pairs.append((edge, running))
        pairs.append((float("inf"), running + counts[-1]))
        return quantile_from_buckets(pairs, 0.99)

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            total, breaches = self._total, self._breaches
            max_seen = self._max_seen
            tenants = {
                name: {
                    "observations_total": st[0],
                    "breaches_total": st[1],
                    "max_seconds": st[2],
                    "counts": list(st[3]),
                }
                for name, st in self._tenants.items()
            }
        for view in tenants.values():
            view["p99_seconds"] = self._p99_from_counts(view.pop("counts"))
        return {
            "target_sec": self.target_sec,
            "good_fraction": self.good_fraction,
            "observations_total": total,
            "breaches_total": breaches,
            "max_seconds": max_seen,
            "burn_rates": {
                label: self.burn_rate(width, now)
                for label, width in self.windows
            },
            "tenants": tenants,
        }

    def render(self, prefix: str = "nhd_") -> List[str]:
        """Prometheus text exposition for the nhd_slo_* families."""
        snap = self.snapshot()
        lines = []
        for name, kind, help_text, value in (
            ("slo_bind_target_seconds", "gauge",
             "Time-to-bind SLO target (creation to bound)",
             snap["target_sec"]),
            ("slo_bind_good_fraction", "gauge",
             "Fraction of binds that must meet the target",
             snap["good_fraction"]),
            ("slo_bind_observations_total", "counter",
             "Binds measured against the SLO (creationTimestamp clock)",
             snap["observations_total"]),
            ("slo_bind_breaches_total", "counter",
             "Binds that exceeded the SLO target",
             snap["breaches_total"]),
            ("slo_bind_max_seconds", "gauge",
             "Largest creation-to-bind seconds observed",
             snap["max_seconds"]),
        ):
            lines += [
                f"# HELP {prefix}{name} {help_text}",
                f"# TYPE {prefix}{name} {kind}",
                f"{prefix}{name} {value}",
            ]
        lines += [
            f"# HELP {prefix}slo_bind_burn_rate Error-budget burn rate "
            "(1.0 = burning exactly the sustainable rate)",
            f"# TYPE {prefix}slo_bind_burn_rate gauge",
        ]
        for label, rate in sorted(snap["burn_rates"].items()):
            lines.append(
                f'{prefix}slo_bind_burn_rate{{window="{label}"}} {rate}'
            )
        if snap["tenants"]:
            for name, kind, help_text, field in (
                ("slo_tenant_observations_total", "counter",
                 "Binds measured per tenant (namespace, bounded set)",
                 "observations_total"),
                ("slo_tenant_breaches_total", "counter",
                 "Per-tenant binds that exceeded the SLO target",
                 "breaches_total"),
                ("slo_tenant_max_seconds", "gauge",
                 "Per-tenant largest creation-to-bind seconds",
                 "max_seconds"),
                ("slo_tenant_p99_seconds", "gauge",
                 "Per-tenant interpolated p99 creation-to-bind seconds",
                 "p99_seconds"),
            ):
                lines += [
                    f"# HELP {prefix}{name} {help_text}",
                    f"# TYPE {prefix}{name} {kind}",
                ]
                for tenant in sorted(snap["tenants"]):
                    lines.append(
                        f'{prefix}{name}{{tenant="{tenant}"}} '
                        f'{snap["tenants"][tenant][field]}'
                    )
        return lines

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._total = 0
            self._breaches = 0
            self._max_seen = 0.0
            self._tenants.clear()


#: process-global tracker (one replica per process in production; chaos
#: injects per-replica trackers through Scheduler(slo=...))
SLO = SloTracker()
