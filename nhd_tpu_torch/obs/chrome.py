"""Chrome trace-viewer export for the flight recorder.

Emits the Trace Event Format's JSON-object form (the one chrome://tracing
and ui.perfetto.dev both load): a ``traceEvents`` list of complete ("X")
events with microsecond timestamps, plus thread-name metadata ("M")
events so the viewer labels rows by producing thread. The correlation ID
rides in ``args.corr``, so selecting any span of a pod surfaces the ID to
filter the rest of its pipeline.

The export is deterministic for deterministic input: events sort by
(ts, tid, name), timestamps are relative to the earliest span, and thread
IDs are assigned in first-seen-sorted order — golden-file tests diff the
serialized form directly.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List, Optional

from nhd_tpu_torch.obs.recorder import FlightRecorder, Span

_PID = 1


def chrome_trace(recorder: FlightRecorder) -> dict:
    """Render the recorder's current ring as a Chrome trace dict. The
    export carries an ``nhdMeta`` block (replica identity + the
    monotonic→wall anchor) so N replicas' dumps can be merged onto one
    timeline (merge_chrome_traces)."""
    return chrome_trace_of(
        recorder.spans(),
        meta={
            "replica": recorder.identity,
            "epochOffset": recorder.epoch_offset,
        },
    )


def chrome_trace_of(spans: List[Span], *, meta: Optional[dict] = None) -> dict:
    origin = min((s.t0 for s in spans), default=0.0)
    tids: Dict[str, int] = {}
    for name in sorted({s.thread for s in spans}):
        tids[name] = len(tids) + 1
    events: List[dict] = [
        {
            "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
            "args": {"name": tname},
        }
        for tname, tid in tids.items()
    ]
    body: List[dict] = []
    for s in spans:
        args: dict = {"corr": s.corr}
        if s.attrs:
            args.update(s.attrs)
        # federation coordinates, only where stamped: which replica
        # produced the span, and which (shard, fencing epoch) covered a
        # commit-path leg — a merged journey shows every leadership a
        # pod's life ran under
        for key in ("replica", "shard", "epoch"):
            v = getattr(s, key, None)
            if v is not None:
                args[key] = v
        body.append({
            "ph": "X",
            "name": s.name,
            "cat": s.cat,
            "pid": _PID,
            "tid": tids[s.thread],
            # microseconds, rounded so float noise can't perturb goldens
            "ts": round((s.t0 - origin) * 1e6, 3),
            "dur": round(s.dur * 1e6, 3),
            "args": args,
        })
    body.sort(key=lambda e: (e["ts"], e["tid"], e["name"]))
    events.extend(body)
    out = {"displayTimeUnit": "ms", "traceEvents": events}
    if meta is not None:
        out["nhdMeta"] = {**meta, "originMono": origin}
    return out


# ---------------------------------------------------------------------------
# cross-replica journey merge (ISSUE 7): N replicas' dumps → one timeline
# ---------------------------------------------------------------------------


def merge_chrome_traces(traces: List[dict]) -> dict:
    """Merge N replicas' trace dumps into ONE Chrome trace: each input
    becomes its own pid (process row) named by its replica identity, and
    timestamps are re-based onto a shared wall clock via each dump's
    ``nhdMeta`` anchor (originMono + epochOffset) — so a pod that spilled
    across shards reads as one journey whose legs line up in real time.

    Re-basing is all-or-none: dumps without an ``nhdMeta`` anchor
    (pre-federation exports) have no wall reference, and mixing one into
    an anchored set would put it ~epoch-seconds away from the rest in
    the viewer — so if ANY input lacks the anchor, every input merges on
    its raw relative timestamps (correct within one process, best effort
    across several). Deterministic for deterministic input: pids are
    assigned in (replica name, input order) order and events sort by
    (ts, pid, tid, name)."""
    keyed = sorted(
        enumerate(traces),
        key=lambda it: (
            str((it[1].get("nhdMeta") or {}).get("replica", "")), it[0]
        ),
    )
    # each dump's absolute wall time at ts=0, or None when unanchored
    wall0: List[Optional[float]] = []
    for _, t in keyed:
        m = t.get("nhdMeta") or {}
        if "originMono" in m:
            wall0.append(
                float(m["originMono"]) + float(m.get("epochOffset", 0.0))
            )
        else:
            wall0.append(None)
    if any(w is None for w in wall0):
        wall0 = [0.0] * len(wall0)
    base = min(wall0, default=0.0)
    events: List[dict] = []
    body: List[dict] = []
    replicas: List[str] = []
    for pid0, ((idx, trace), w0) in enumerate(zip(keyed, wall0), start=1):
        m = trace.get("nhdMeta") or {}
        name = str(m.get("replica") or f"replica-{idx}")
        replicas.append(name)
        events.append({
            "ph": "M", "name": "process_name", "pid": pid0, "tid": 0,
            "args": {"name": name},
        })
        shift = (w0 - base) * 1e6
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid0
            if ev.get("ph") == "X":
                ev["ts"] = round(float(ev.get("ts", 0.0)) + shift, 3)
                body.append(ev)
            else:
                events.append(ev)
    body.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    events.extend(body)
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events,
        "nhdMeta": {"merged": True, "replicas": replicas},
    }


def pod_journeys(trace: dict) -> Dict[str, List[dict]]:
    """corr ID → that pod's spans (X events), each journey sorted by
    timestamp. Works on single-replica exports and merged traces alike —
    the fleet aggregator and the federation tests both read journeys
    through this one definition."""
    out: Dict[str, List[dict]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        corr = (ev.get("args") or {}).get("corr")
        if not corr:
            continue
        out.setdefault(str(corr), []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: (e.get("ts", 0.0), e.get("name", "")))
    return out


def scheduled_journeys(journeys: Dict[str, List[dict]]) -> Dict[str, List[dict]]:
    """Journeys that progressed past watch receipt. EVERY replica
    records a watch_event under its own locally minted corr (standbys
    included), and only the replica that schedules the pod re-aliases
    its receipt leg into the adopted journey — counting the one-span
    receipt orphans as journeys inflates the pod tally roughly
    n_replicas-fold."""
    return {
        corr: evs for corr, evs in journeys.items()
        if any(ev.get("name") != "watch_event" for ev in evs)
    }


def journey_replicas(
    trace: dict, corr: str, journeys: Optional[Dict[str, List[dict]]] = None
) -> List[str]:
    """The distinct replica identities that produced spans for one corr
    ID — ≥2 proves a cross-replica journey (spillover hop, shard
    handoff, fenced rejection + retry on the new owner). Pass the
    precomputed ``pod_journeys(trace)`` dict when iterating many corrs —
    rebuilding the index per corr is quadratic."""
    if journeys is None:
        journeys = pod_journeys(trace)
    seen = []
    for ev in journeys.get(corr, []):
        rep = (ev.get("args") or {}).get("replica")
        if rep and rep not in seen:
            seen.append(rep)
    return seen


def journey_view(corr: str) -> Dict[str, object]:
    """The one-pod journey payload the HTTP ``/journey?corr=`` endpoint
    serves (one definition, like decisions_view, so transports cannot
    drift): the corr's spans from the live ring rendered as trace
    events, its decision records, and — when a journal is recording —
    the journal line seqs indexed for it, so an operator can jump from
    a live journey straight to the replayable evidence."""
    from nhd_tpu_torch.obs.journal import get_journal
    from nhd_tpu_torch.obs.recorder import get_recorder

    rec = get_recorder()
    out: Dict[str, object] = {
        "corr": corr,
        "enabled": rec is not None,
        "spans": [],
        "decisions": [],
        "journal": None,
    }
    if rec is not None:
        out["spans"] = pod_journeys(chrome_trace(rec)).get(corr, [])
        decisions = [
            d for d in rec.recent_decisions(rec.decision_capacity)
            if d.get("corr") == corr
        ]
        decisions.reverse()  # recent_decisions is newest-first
        out["decisions"] = decisions
    jnl = get_journal()
    if jnl is not None:
        out["journal"] = {
            "path": jnl.path, "seqs": jnl.corr_seqs(corr),
        }
    return out


def validate_chrome_trace(trace: object) -> List[str]:
    """Schema check for an exported trace; returns a list of problems
    (empty = valid). Shared by the test suite and ``make trace-demo`` so
    they cannot drift on what 'loads in the viewer' means."""
    errors: List[str] = []
    if not isinstance(trace, dict):
        return [f"top level must be an object, got {type(trace).__name__}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            errors.append(f"{where}: unsupported ph {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in ev:
                errors.append(f"{where}: missing {field!r}")
        if ph == "X":
            for field in ("ts", "dur"):
                v = ev.get(field)
                if not isinstance(v, (int, float)) or v < 0:
                    errors.append(f"{where}: {field} must be a number >= 0")
            if not isinstance(ev.get("args", {}), dict):
                errors.append(f"{where}: args must be an object")
        else:  # metadata
            if not isinstance(ev.get("args", {}).get("name"), str):
                errors.append(f"{where}: metadata event needs args.name")
    return errors


# itertools.count: atomic under the GIL, so concurrent dump triggers
# (ThreadingHTTPServer /trace?save=1 racing the CLI exit dump) can never
# draw the same sequence number and clobber each other's file
_dump_seq = itertools.count(1)


def dump_chrome_trace(
    recorder: FlightRecorder, out_dir: str, *, stem: Optional[str] = None
) -> str:
    """Write the current ring to ``out_dir`` as pretty-printed trace JSON;
    returns the written path. Filenames carry pid + a per-process sequence
    so repeated dump triggers never clobber each other."""
    os.makedirs(out_dir, exist_ok=True)
    name = stem or f"nhd-trace-{os.getpid()}-{next(_dump_seq):03d}"
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as fh:
        json.dump(chrome_trace(recorder), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path
