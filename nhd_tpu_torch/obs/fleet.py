"""Fleet aggregator: N replicas' observability → one federation view.

PR 6 made a pod's life span replicas (spillover hops, shard handoffs,
fenced rejections), so no single replica's /metrics or trace ring can
answer fleet questions — "which shard's binds are slow?", "how many pods
hopped?", "is the error budget burning?". This module merges N replicas'
views into one schema-versioned **fleet artifact**
(``artifacts/fleet/*.json``, envelope in obs/artifact.py):

* per-shard bind-latency histograms (from the replicas' ``bind`` spans,
  which carry their shard + fencing epoch — obs/recorder.py);
* spillover-hop counts and cross-replica journey tallies (the merged
  Chrome trace's per-corr view — obs/chrome.py pod_journeys);
* leadership timeline (per-shard epochs + ownerless-gap high-waters);
* fencing-rejection and spillover counters (k8s/retry.py ApiCounters);
* the SLO plane's burn-rate summary (obs/slo.py), worst-of across
  replicas per window — the page-worthy number.

Two producers feed the same payload builder: **in-process views**
(``replica_view`` — ChaosSim federation replicas, ``make fleet-demo``)
and **scraped views** (``scrape_replica`` — tools/fleet_top.py polling
live replicas' /metrics + /decisions). ChaosSim also calls
``write_fleet_artifact`` automatically around any invariant violation,
so a failed storm leaves the federation's full state on disk next to
the assertion message. Stdlib-only.
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import Dict, List, Optional, Tuple

from nhd_tpu_torch.obs.artifact import (
    make_envelope,
    validate_envelope,
    write_artifact,
)
from nhd_tpu_torch.obs.chrome import (
    chrome_trace,
    merge_chrome_traces,
    pod_journeys,
    scheduled_journeys,
)
from nhd_tpu_torch.obs.histo import DEFAULT_BUCKETS

FLEET_KIND = "fleet"
FLEET_SCHEMA_VERSION = 1

#: payload sections every fleet artifact carries (validate_fleet_artifact)
FLEET_SECTIONS = (
    "replicas", "per_shard", "spillover", "slo", "fencing",
    "leadership", "violations",
)

# exposition line: name{labels} value  (labels optional; no timestamps —
# our own exporter never emits them)
_SAMPLE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """Minimal text-exposition parser: family → [(labels, value)].
    Tolerant of anything it doesn't understand (a scrape target one
    version ahead must degrade, not crash the aggregator)."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            k: v.replace('\\"', '"')
            for k, v in _LABEL.findall(m.group("labels") or "")
        }
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


# ---------------------------------------------------------------------------
# view producers: one dict per replica, same shape from both paths
# ---------------------------------------------------------------------------


def replica_view(
    identity: str,
    *,
    recorder=None,
    slo=None,
    shards: Optional[Dict[int, int]] = None,
    decisions: Optional[List[dict]] = None,
) -> dict:
    """In-process view of one replica (chaos harness, fleet-demo):
    its trace dump, SLO snapshot, and held shards."""
    return {
        "replica": identity,
        "shards": {str(s): e for s, e in (shards or {}).items()},
        "slo": slo.snapshot() if slo is not None else None,
        "trace": chrome_trace(recorder) if recorder is not None else None,
        "decisions": list(decisions or []),
        "metrics": None,
    }


def scrape_replica(base_url: str, *, timeout: float = 5.0) -> dict:
    """Scraped view of one live replica: GET /metrics + /decisions on
    ``base_url`` (e.g. http://host:9464). The trace ring is NOT pulled —
    journeys come from dump files, not scrapes (a 16k-span ring per poll
    would swamp the replica)."""
    url = base_url.rstrip("/")
    with urllib.request.urlopen(f"{url}/metrics", timeout=timeout) as resp:
        metrics = parse_prometheus(resp.read().decode())
    decisions: List[dict] = []
    try:
        with urllib.request.urlopen(
            f"{url}/decisions?n=200", timeout=timeout
        ) as resp:
            payload = json.load(resp)
        if isinstance(payload, dict) and isinstance(
            payload.get("decisions"), list
        ):
            decisions = payload["decisions"]
    except (OSError, ValueError):
        # decisions are additive detail; metrics alone still merge —
        # a proxy's HTML error page (200, non-JSON) must not kill the
        # whole fleet view over one replica
        pass
    shards = {
        labels.get("shard", "?"): int(value)
        for labels, value in metrics.get("nhd_shard_epoch", [])
    }
    slo_snapshot = None
    if "nhd_slo_bind_observations_total" in metrics:
        burn = {
            labels.get("window", "?"): value
            for labels, value in metrics.get("nhd_slo_bind_burn_rate", [])
        }

        def _scalar(name: str) -> float:
            samples = metrics.get(name, [])
            return samples[0][1] if samples else 0.0

        # per-tenant views (obs/slo.py tenant families): the scraped
        # shape mirrors SloTracker.snapshot()["tenants"], so the payload
        # builder merges both producer paths identically
        tenants: Dict[str, dict] = {}
        for fam, field in (
            ("nhd_slo_tenant_observations_total", "observations_total"),
            ("nhd_slo_tenant_breaches_total", "breaches_total"),
            ("nhd_slo_tenant_max_seconds", "max_seconds"),
            ("nhd_slo_tenant_p99_seconds", "p99_seconds"),
        ):
            for labels, value in metrics.get(fam, []):
                tenants.setdefault(labels.get("tenant", "?"), {})[
                    field
                ] = value
        slo_snapshot = {
            "target_sec": _scalar("nhd_slo_bind_target_seconds"),
            "good_fraction": _scalar("nhd_slo_bind_good_fraction"),
            "observations_total": int(
                _scalar("nhd_slo_bind_observations_total")
            ),
            "breaches_total": int(_scalar("nhd_slo_bind_breaches_total")),
            "max_seconds": _scalar("nhd_slo_bind_max_seconds"),
            "burn_rates": burn,
            "tenants": tenants,
        }
    return {
        "replica": base_url,
        "shards": shards,
        "slo": slo_snapshot,
        "trace": None,
        "decisions": decisions,
        "metrics": metrics,
    }


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def _bucketize(durations: List[float]) -> dict:
    """One bind-latency histogram (exact cumulative counts over the
    standard latency ladder, obs/histo.py DEFAULT_BUCKETS) plus the
    interpolated p99 (quantile_from_buckets — raw bucket edges hid
    in-bucket regressions and read edge crossings as cliffs)."""
    from nhd_tpu_torch.obs.histo import quantile_from_buckets

    edges = tuple(DEFAULT_BUCKETS)
    # counts are cumulative by construction: each duration increments
    # EVERY edge it fits under, exactly the le= semantics
    cum = [0] * len(edges)
    for d in durations:
        for i, edge in enumerate(edges):
            if d <= edge:
                cum[i] += 1
    return {
        "count": len(durations),
        "sum_seconds": sum(durations),
        "max_seconds": max(durations, default=0.0),
        "buckets": {str(edge): c for edge, c in zip(edges, cum)},
        "p99_seconds": quantile_from_buckets(
            list(zip(edges, cum)) + [(float("inf"), len(durations))], 0.99
        ),
    }


def build_fleet_payload(
    views: List[dict],
    *,
    leadership: Optional[dict] = None,
    counters: Optional[dict] = None,
    violations: Optional[List[str]] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Merge N replica views (replica_view / scrape_replica shapes) into
    the fleet payload. ``leadership`` carries the producer's gap
    timeline (chaos knows it; scrapes only know current epochs),
    ``counters`` a process ApiCounters snapshot for the fencing /
    spillover totals, ``violations`` whatever invariant failures the
    producer observed."""
    traces = [v["trace"] for v in views if v.get("trace")]
    merged = merge_chrome_traces(traces) if traces else None
    journeys = pod_journeys(merged) if merged else {}

    # per-shard bind latency + spill hops from the merged spans: the
    # bind/spill spans carry their shard stamp (scheduler/core.py)
    bind_durs: Dict[str, List[float]] = {}
    spill_by_shard: Dict[str, int] = {}
    hops_by_corr: Dict[str, int] = {}
    for corr, events in journeys.items():
        for ev in events:
            args = ev.get("args") or {}
            shard = args.get("shard")
            if ev.get("name") == "bind" and ev.get("dur") is not None:
                key = str(shard) if shard is not None else "unsharded"
                bind_durs.setdefault(key, []).append(
                    float(ev["dur"]) / 1e6
                )
            elif ev.get("name") == "spill":
                key = str(shard) if shard is not None else "unsharded"
                spill_by_shard[key] = spill_by_shard.get(key, 0) + 1
                hops_by_corr[corr] = hops_by_corr.get(corr, 0) + 1

    cross_replica = 0
    for corr, events in journeys.items():
        reps = {
            (ev.get("args") or {}).get("replica")
            for ev in events
            if (ev.get("args") or {}).get("replica")
        }
        if len(reps) >= 2:
            cross_replica += 1

    # scrape path: per-replica bind histograms from the exposition (the
    # ring isn't scraped, so shard attribution isn't available there)
    per_replica_bind: Dict[str, dict] = {}
    for v in views:
        fams = v.get("metrics") or {}
        if "nhd_bind_latency_seconds_bucket" in fams:
            from nhd_tpu_torch.obs.histo import quantile_from_buckets

            raw = {
                labels.get("le", "?"): value
                for labels, value in
                fams["nhd_bind_latency_seconds_bucket"]
            }
            per_replica_bind[v["replica"]] = {
                "buckets": raw,
                # interpolated, not the raw covering edge (same fix as
                # the bench churn leg)
                "p99_seconds": quantile_from_buckets(
                    (
                        (float("inf") if le == "+Inf" else float(le), c)
                        for le, c in raw.items()
                        if le != "?"
                    ),
                    0.99,
                ),
            }

    # SLO: per-replica snapshots plus the fleet worst-of per window —
    # one replica's budget on fire IS the fleet's page
    slo_reps = {
        v["replica"]: v["slo"] for v in views if v.get("slo") is not None
    }
    worst_burn: Dict[str, float] = {}
    for snap in slo_reps.values():
        for window, rate in (snap.get("burn_rates") or {}).items():
            worst_burn[window] = max(worst_burn.get(window, 0.0), rate)
    # per-tenant fleet roll-up: totals sum, p99 is worst-of — one
    # tenant's p99 on fire on any replica is that tenant's fleet answer
    tenant_agg: Dict[str, dict] = {}
    for snap in slo_reps.values():
        for t, view in (snap.get("tenants") or {}).items():
            agg = tenant_agg.setdefault(t, {
                "observations_total": 0, "breaches_total": 0,
                "worst_p99_seconds": 0.0,
            })
            agg["observations_total"] += int(
                view.get("observations_total", 0)
            )
            agg["breaches_total"] += int(view.get("breaches_total", 0))
            agg["worst_p99_seconds"] = max(
                agg["worst_p99_seconds"], float(view.get("p99_seconds", 0.0))
            )
    slo_summary = {
        "replicas": slo_reps,
        "observations_total": sum(
            s.get("observations_total", 0) for s in slo_reps.values()
        ),
        "breaches_total": sum(
            s.get("breaches_total", 0) for s in slo_reps.values()
        ),
        "max_seconds": max(
            (s.get("max_seconds", 0.0) for s in slo_reps.values()),
            default=0.0,
        ),
        "worst_burn_rates": worst_burn,
        "tenants": tenant_agg,
    }

    counters = dict(counters or {})
    if not counters:
        # scrape path: no in-process ApiCounters snapshot — source the
        # fencing/spillover totals from each replica's parsed exposition
        # instead of silently reporting zeros (these families are
        # per-replica counters, so the fleet figure is their sum)
        for key in (
            "ha_stale_writes_rejected_total",
            "ha_renewal_failures_total",
            "shard_handoffs_total",
            "shard_spillover_claims_total",
            "shard_spillover_exhausted_total",
            "device_state_events_total",
            "device_state_deltas_total",
            "device_state_rows_uploaded_total",
            "device_state_full_rebuilds_total",
            "mesh_solves_total",
            "mesh_rows_uploaded_total",
            "mesh_wholesale_uploads_total",
            "guard_faults_total",
            "guard_retries_total",
            "guard_degradations_total",
            "guard_promotions_total",
            "guard_audits_total",
            "guard_corruptions_total",
            "guard_repairs_total",
            "policy_preemptions_total",
            "policy_preempt_budget_exhausted_total",
            "admission_admitted_total",
            "admission_deferred_total",
            "admission_readmitted_total",
            "admission_shed_total",
            "admission_requeue_refusals_total",
        ):
            total, seen = 0.0, False
            for v in views:
                fams = v.get("metrics") or {}
                for _labels, value in fams.get("nhd_" + key, []):
                    total += value
                    seen = True
            if seen:
                counters[key] = int(total)
    fencing = {
        "stale_writes_rejected_total": counters.get(
            "ha_stale_writes_rejected_total", 0
        ),
        "renewal_failures_total": counters.get(
            "ha_renewal_failures_total", 0
        ),
        "handoffs_total": counters.get("shard_handoffs_total", 0),
    }
    spillover = {
        "spill_events_total": sum(spill_by_shard.values()),
        "by_shard": spill_by_shard,
        "max_hops_per_pod": max(hops_by_corr.values(), default=0),
        "cross_replica_journeys": cross_replica,
        "claims_total": counters.get("shard_spillover_claims_total", 0),
        "exhausted_total": counters.get(
            "shard_spillover_exhausted_total", 0
        ),
    }

    # incremental device-resident cluster state: the fleet-wide delta
    # economy (how much host/upload work the event stream actually cost
    # vs how often state fell back to a full rebuild)
    device_state = {
        "events_total": counters.get("device_state_events_total", 0),
        "deltas_total": counters.get("device_state_deltas_total", 0),
        "rows_uploaded_total": counters.get(
            "device_state_rows_uploaded_total", 0
        ),
        "full_rebuilds_total": counters.get(
            "device_state_full_rebuilds_total", 0
        ),
        # SPMD mesh posture (ISSUE 11): sharded megarounds dispatched
        # and the per-shard upload economy, fleet-summed like the rest
        "mesh": {
            "solves_total": counters.get("mesh_solves_total", 0),
            "rows_uploaded_total": counters.get(
                "mesh_rows_uploaded_total", 0
            ),
            "wholesale_uploads_total": counters.get(
                "mesh_wholesale_uploads_total", 0
            ),
        },
        # solver data-plane guard (ISSUE 12, solver/guard.py): rung is
        # the in-process degradation floor (the scrape path cannot sum
        # a gauge across replicas, so it stays 0 there — the per-replica
        # nhd_guard_rung series carries it); the _total families sum
        # like every other fleet counter
        "guard": {
            "rung": int(counters.get("guard_rung", 0)),
            "faults_total": counters.get("guard_faults_total", 0),
            "retries_total": counters.get("guard_retries_total", 0),
            "degradations_total": counters.get(
                "guard_degradations_total", 0
            ),
            "promotions_total": counters.get("guard_promotions_total", 0),
            "audits_total": counters.get("guard_audits_total", 0),
            "corruptions_total": counters.get(
                "guard_corruptions_total", 0
            ),
            "repairs_total": counters.get("guard_repairs_total", 0),
        },
    }

    # scheduling-policy engine (nhd_tpu/policy/): the fleet-wide
    # preemption ledger. score_mode is an in-process gauge (the scrape
    # path carries it per replica as nhd_policy_score_mode; summing a
    # mode across replicas is meaningless, so it stays 0 there).
    policy = {
        "preemptions_total": counters.get("policy_preemptions_total", 0),
        "budget_exhausted_total": counters.get(
            "policy_preempt_budget_exhausted_total", 0
        ),
        "score_mode": int(counters.get("policy_score_mode", 0)),
    }

    # ingress admission (nhd_tpu/ingress/): the fleet-wide front-door
    # ledger plus per-replica queue-depth gauges sourced from the SAME
    # exposition families /metrics serves — one backlog number, both
    # surfaces (ISSUE 20 gauge-consistency satellite)
    queue_depth: Dict[str, int] = {}
    queue_depth_max_tenant: Dict[str, int] = {}
    for v in views:
        fams = v.get("metrics") or {}
        for _labels, value in fams.get("nhd_event_queue_depth", []):
            queue_depth[v["replica"]] = int(value)
        for _labels, value in fams.get(
            "nhd_event_queue_depth_max_tenant", []
        ):
            queue_depth_max_tenant[v["replica"]] = int(value)
    ingress = {
        "admitted_total": counters.get("admission_admitted_total", 0),
        "deferred_total": counters.get("admission_deferred_total", 0),
        "readmitted_total": counters.get("admission_readmitted_total", 0),
        "shed_total": counters.get("admission_shed_total", 0),
        "requeue_refusals_total": counters.get(
            "admission_requeue_refusals_total", 0
        ),
        "queue_depth": queue_depth,
        "queue_depth_max_tenant": queue_depth_max_tenant,
    }

    shard_epochs: Dict[str, int] = {}
    for v in views:
        for shard, epoch in (v.get("shards") or {}).items():
            shard_epochs[shard] = max(shard_epochs.get(shard, 0), int(epoch))
    lead = dict(leadership or {})
    lead.setdefault("shard_epochs", shard_epochs)

    payload = {
        "replicas": [
            {
                "replica": v["replica"],
                "shards": v.get("shards") or {},
                "spans": len((v.get("trace") or {}).get("traceEvents", [])),
                "decisions": len(v.get("decisions") or []),
            }
            for v in views
        ],
        "per_shard": {
            "bind_latency": {
                shard: _bucketize(durs)
                for shard, durs in sorted(bind_durs.items())
            },
            "bind_latency_per_replica": per_replica_bind,
        },
        "spillover": spillover,
        "slo": slo_summary,
        "fencing": fencing,
        "device_state": device_state,
        "policy": policy,
        "ingress": ingress,
        "leadership": lead,
        "violations": list(violations or []),
        "journeys": {
            # watch-receipt orphans excluded: standbys mint a corr per
            # event they see, only the scheduling replica's leg re-joins
            "pods_traced": len(scheduled_journeys(journeys)),
            "cross_replica": cross_replica,
        },
    }
    if extra:
        payload.update(extra)
    return payload


def build_fleet_artifact(
    views: List[dict], *, seed: Optional[int] = None, **kwargs
) -> dict:
    """Payload + envelope in one step (the common producer call)."""
    return make_envelope(
        FLEET_KIND, FLEET_SCHEMA_VERSION,
        build_fleet_payload(views, **kwargs), seed=seed,
    )


def validate_fleet_artifact(obj: object) -> List[str]:
    """Schema errors for a fleet artifact ([] = valid): the envelope
    contract plus every payload section the readers depend on."""
    errs = validate_envelope(
        obj, kind=FLEET_KIND, schema_version=FLEET_SCHEMA_VERSION
    )
    if errs:
        return errs
    payload = obj["payload"]  # type: ignore[index]
    for section in FLEET_SECTIONS:
        if section not in payload:
            errs.append(f"payload missing section {section!r}")
    if errs:
        return errs
    if not isinstance(payload["replicas"], list):
        errs.append("payload.replicas must be a list")
    for i, rep in enumerate(payload["replicas"]):
        if not isinstance(rep, dict) or "replica" not in rep:
            errs.append(f"payload.replicas[{i}] missing 'replica'")
    if not isinstance(payload["violations"], list):
        errs.append("payload.violations must be a list")
    slo = payload["slo"]
    if not isinstance(slo, dict) or "worst_burn_rates" not in slo:
        errs.append("payload.slo missing worst_burn_rates")
    for shard, hist in (
        payload["per_shard"].get("bind_latency", {}) or {}
    ).items():
        for field in ("count", "sum_seconds", "buckets"):
            if field not in hist:
                errs.append(
                    f"per_shard.bind_latency[{shard}] missing {field!r}"
                )
    return errs


def write_fleet_artifact(
    artifact: dict, out_dir: str = "artifacts/fleet",
    *, name: Optional[str] = None,
) -> str:
    """Validate + atomically write one fleet artifact; raises ValueError
    on schema errors (a producer must never publish a file the readers
    reject)."""
    errs = validate_fleet_artifact(artifact)
    if errs:
        raise ValueError("invalid fleet artifact: " + "; ".join(errs))
    if name is None:
        seed = artifact.get("seed")
        stamp = int(artifact.get("created_unix", 0))
        name = f"fleet-seed{seed if seed is not None else 'x'}-{stamp}.json"
    return write_artifact(artifact, out_dir, name)
