"""Perf-telemetry artifacts: the bench run as a schema-versioned file.

bench.py used to print one JSON line and scroll its per-config detail to
stderr — nothing a later run could be compared against. This module
gives the bench the same artifact discipline the fleet aggregator has
(obs/artifact.py envelope, obs/fleet.py): every run writes
``artifacts/bench/*.json`` carrying the schema version, git rev, seed,
per-config wall/placed/speedup, the per-phase breakdown the overhead war
tracks (encode / materialize / upload / solve / select / assign /
readback ...), and the per-(phase, shape-bucket) attribution table from
the process jit stats (obs/jitstats.py record_phase). tools/bench_diff.py
compares two such artifacts and fails on regression past a threshold —
the continuous-regression gate the bench trajectory needs.

``load_bench_artifact`` also reads the LEGACY driver records the repo
already carries (BENCH_r01–r05: ``{"n", "cmd", "rc", "tail",
"parsed"}``), upgrading them in memory to schema_version 0 with whatever
per-config detail their stderr tail still yields — so the gate can diff
a new run against history that predates the artifact writer.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from nhd_tpu_torch.obs.artifact import (
    make_envelope,
    validate_envelope,
    write_artifact,
)

BENCH_KIND = "bench"
BENCH_SCHEMA_VERSION = 1

#: payload sections every (v1) bench artifact carries
BENCH_SECTIONS = ("platform", "configs", "phase_attribution", "headline")

# legacy stderr tail, one line per config:
#   bench[cfg2:1kx256]: 1000 pods x 256 nodes -> placed 1000 in 0.042s
#   (23777 pods/s, rounds=5, solve=0.015s, select=0.003s, assign=0.012s,
#   p99 bind 25ms); ... speedup 301x
_LEGACY_LINE = re.compile(
    r"bench\[(?P<name>[^\]]+)\]:.*?placed (?P<placed>\d+) in "
    r"(?P<wall>[\d.]+)s \((?P<rate>[\d.]+) pods/s, "
    r"rounds=(?P<rounds>\d+), solve=(?P<solve>[\d.]+)s, "
    r"select=(?P<select>[\d.]+)s, assign=(?P<assign>[\d.]+)s"
    r"(?:, p99 bind (?P<p99>[\d.]+)ms)?"
)
_LEGACY_SPEEDUP = re.compile(
    r"bench\[(?P<name>[^\]]+)\]:.*speedup (?P<speedup>[\d.]+)x"
)


#: the coarse HOST round-loop phases — the figure the r14 vectorize+
#: pipeline work drives down, summed per config so the headline artifact
#: shows the solve-vs-host split directly. ``assign`` already contains
#: materialize+final_sync as sub-windows, which is exactly how the r14
#: acceptance metric is defined (the sum is a tracked comparable, not a
#: disjoint partition).
HOST_PHASE_KEYS = ("select", "assign", "materialize", "final_sync")

#: jit-stats attribution phases that are host-side work (the per-shape
#: rollup below; device-side time lives in the solve/select/assign
#: windows of the coarse trio and in the dispatch/readback entries)
HOST_ATTRIBUTION_PHASES = frozenset({
    "prepass", "encode", "fast_join", "native_assign", "materialize",
    "final_sync", "backfill", "spec_expand", "guard_audit",
})


def host_phase_rollup(phase_seconds: Dict[str, float]) -> Dict[str, float]:
    """Roll the jit-stats per-(phase, shape) attribution table up to a
    host-seconds total per shape bucket — keys are ``"phase:shape"``
    (obs/jitstats.py record_phase). The artifact's headline view of
    where the host round loop spends per cluster shape."""
    out: Dict[str, float] = {}
    for key, secs in phase_seconds.items():
        phase, _, shape = key.partition(":")
        if phase in HOST_ATTRIBUTION_PHASES and shape:
            out[shape] = out.get(shape, 0.0) + float(secs)
    return out


def config_record(
    *,
    wall_seconds: float,
    placed: int,
    speedup: float,
    rounds: int = 0,
    phases: Optional[Dict[str, float]] = None,
    p99_bind_ms: Optional[float] = None,
    extra: Optional[dict] = None,
) -> dict:
    """One config's result in the canonical shape (bench.py builds these;
    the legacy upgrader synthesizes the same shape from log lines).
    ``extra``: additional named sections (e.g. the sustained-churn leg's
    ``churn`` figures, gated by tools/bench_diff.py)."""
    phases = dict(phases or {})
    rec = {
        "wall_seconds": wall_seconds,
        "placed": placed,
        "pods_per_sec": (placed / wall_seconds) if wall_seconds > 0 else 0.0,
        "speedup_vs_serial": speedup,
        "rounds": rounds,
        "phases": phases,
        # the solve-vs-host split, precomputed per config (the r14
        # acceptance comparable): host = select+assign+materialize+
        # final_sync as recorded
        "host_phases_seconds": sum(
            float(phases.get(k, 0.0)) for k in HOST_PHASE_KEYS
        ),
        "p99_bind_ms": p99_bind_ms,
    }
    for key, value in (extra or {}).items():
        rec[key] = value
    return rec


def build_bench_artifact(
    configs: Dict[str, dict],
    *,
    headline: dict,
    platform: str,
    phase_attribution: Optional[dict] = None,
    micro: Optional[dict] = None,
    seed: Optional[int] = None,
    rev: Optional[str] = None,
    created: Optional[float] = None,
) -> dict:
    """Payload + envelope in one step (what bench.py writes).
    ``phase_attribution`` is the jit-stats per-(phase, shape) table
    (obs/jitstats.py snapshot: phase_seconds + phase_counts)."""
    attribution = dict(phase_attribution or {})
    if "phase_seconds" in attribution:
        # per-shape host total (host_phase_rollup): the solve-vs-host
        # split per shape bucket, on the artifact's front page
        attribution["host_seconds_by_shape"] = host_phase_rollup(
            attribution["phase_seconds"]
        )
    payload = {
        "platform": platform,
        "configs": {name: dict(rec) for name, rec in configs.items()},
        "phase_attribution": attribution,
        "headline": dict(headline),
    }
    if micro:
        payload["micro"] = dict(micro)
    return make_envelope(
        BENCH_KIND, BENCH_SCHEMA_VERSION, payload,
        seed=seed, rev=rev, created=created,
    )


def validate_bench_artifact(obj: object) -> List[str]:
    """Schema errors ([] = valid). schema_version 0 (upgraded legacy) is
    accepted with the same section contract — the upgrader guarantees
    it."""
    errs = validate_envelope(obj, kind=BENCH_KIND)
    if errs:
        return errs
    if obj["schema_version"] not in (0, BENCH_SCHEMA_VERSION):  # type: ignore[index]
        return [
            f"unsupported bench schema_version "
            f"{obj['schema_version']!r}"  # type: ignore[index]
        ]
    payload = obj["payload"]  # type: ignore[index]
    for section in BENCH_SECTIONS:
        if section not in payload:
            errs.append(f"payload missing section {section!r}")
    if errs:
        return errs
    if not isinstance(payload["configs"], dict):
        errs.append("payload.configs must be an object")
        return errs
    for name, rec in payload["configs"].items():
        for field in ("wall_seconds", "placed", "phases"):
            if field not in rec:
                errs.append(f"configs[{name!r}] missing {field!r}")
    return errs


def write_bench_artifact(
    artifact: dict, out_dir: str = "artifacts/bench",
    *, name: Optional[str] = None,
) -> str:
    """Validate + atomically write; raises ValueError on schema errors."""
    errs = validate_bench_artifact(artifact)
    if errs:
        raise ValueError("invalid bench artifact: " + "; ".join(errs))
    if name is None:
        stamp = int(artifact.get("created_unix", 0))
        name = f"bench-{artifact.get('git_rev', 'unknown')}-{stamp}.json"
    return write_artifact(artifact, out_dir, name)


def _upgrade_legacy(obj: dict, path: str) -> dict:
    """BENCH_rNN driver record → in-memory schema_version-0 artifact.
    Per-config detail is recovered from the stderr tail where its line
    format still parses; the headline JSON is always present."""
    parsed = obj.get("parsed")
    if not isinstance(parsed, dict):
        raise ValueError(f"{path}: legacy record has no 'parsed' headline")
    configs: Dict[str, dict] = {}
    tail = obj.get("tail", "") or ""
    speedups = {
        m.group("name"): float(m.group("speedup"))
        for m in _LEGACY_SPEEDUP.finditer(tail)
    }
    for m in _LEGACY_LINE.finditer(tail):
        name = m.group("name")
        phases = {
            "solve": float(m.group("solve")),
            "select": float(m.group("select")),
            "assign": float(m.group("assign")),
        }
        configs[name] = config_record(
            wall_seconds=float(m.group("wall")),
            placed=int(m.group("placed")),
            speedup=speedups.get(name, 0.0),
            rounds=int(m.group("rounds")),
            phases=phases,
            p99_bind_ms=float(m.group("p99")) if m.group("p99") else None,
        )
    return {
        "kind": BENCH_KIND,
        "schema_version": 0,
        "created_unix": 0.0,
        "git_rev": "unknown",
        "seed": None,
        "payload": {
            "platform": "unknown",
            "configs": configs,
            "phase_attribution": {},
            "headline": dict(parsed),
            "legacy": {"round": obj.get("n"), "rc": obj.get("rc")},
        },
    }


def load_bench_artifact(path: str) -> dict:
    """Read one bench artifact — new format or legacy BENCH_rNN driver
    record — validated; raises ValueError on anything else."""
    with open(path) as fh:
        obj = json.load(fh)
    if isinstance(obj, dict) and "kind" not in obj and "parsed" in obj:
        obj = _upgrade_legacy(obj, path)
    errs = validate_bench_artifact(obj)
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return obj
