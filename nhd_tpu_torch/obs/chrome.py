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

``lay_on_profile`` puts the same spans on a ``torch.profiler`` trace's
own clock instead, beside the device's work: two ``clock_anchor`` marks,
as the profiled window opens and as it closes, tie the recorder's
``time.monotonic`` to the profiler's timestamps. torch is imported only
there, so this package stays importable without it.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

from nhd_tpu_torch.obs.recorder import FlightRecorder, Span

_PID = 1


def chrome_trace(recorder: FlightRecorder) -> dict:
    """Render the recorder's current ring as a Chrome trace dict. The
    export carries an ``nhdMeta`` block (replica identity + the
    monotonic→wall anchor) so N replicas' dumps can be merged onto one
    timeline (merge_chrome_traces)."""
    meta = {
        "replica": recorder.identity,
        "epochOffset": recorder.epoch_offset,
    }
    tallies = recorder.tallies()
    if tallies:
        meta["tallies"] = {
            name: {"count": n, "seconds": s}
            for name, (n, s) in sorted(tallies.items())
        }
    return chrome_trace_of(recorder.spans(), meta=meta)


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
# the recorder's spans on a torch.profiler trace's clock
# ---------------------------------------------------------------------------

#: the profiler event that marks one instant on both clocks, and the one
#: before it that takes the profiler's first-event cost off the anchor
CLOCK_ANCHOR = "nhd_clock_anchor"
CLOCK_WARM = "nhd_clock_warm"
#: the category of the recorder's spans once laid on a profiler trace
PROFILE_CAT = "nhd"


def clock_anchor() -> float:
    """Mark one instant on both clocks: a ``torch.profiler``
    ``record_function`` named CLOCK_ANCHOR with a ``time.monotonic()``
    read inside it, after a CLOCK_WARM one (a window's first recorded
    event takes a millisecond or more, most of it on one side of the
    read). Returns the read; take one as the profiled window opens and
    one as it closes, and hand both to ``lay_on_profile``."""
    from torch.profiler import record_function

    with record_function(CLOCK_WARM):
        pass
    with record_function(CLOCK_ANCHOR):
        return time.monotonic()


def lay_on_profile(
    trace: Union[dict, List[dict]], spans: Sequence[Span],
    anchors: Sequence[float],
) -> Dict[str, float]:
    """Append *spans* (the recorder's, on ``time.monotonic``) to *trace*,
    a ``torch.profiler`` Chrome export (the dict or its event list), as
    complete events of category PROFILE_CAT on the profiler's clock.

    *anchors* are the reads ``clock_anchor`` returned, in order; the
    trace holds one CLOCK_ANCHOR event for each. The instant of a read is
    its event's midpoint; the first and the last anchor fix the map
    ``ts = a + b * t`` (the profiler's clock need not tick at the host's
    rate, nor sit at a fixed offset from it). Each producing thread gets
    a row of its own in the anchors' process. Returns the spans laid,
    the slope (us a second) and the worst distance, in us, of a middle
    anchor from where the map puts its read (0 with two)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks = sorted((
        (float(e["ts"]) + float(e.get("dur", 0.0)) / 2.0, e)
        for e in events
        if e.get("ph") == "X" and e.get("name") == CLOCK_ANCHOR
    ), key=lambda m: m[0])
    if len(marks) != len(anchors) or len(marks) < 2:
        raise ValueError(
            f"{len(anchors)} anchor reads against {len(marks)} "
            f"{CLOCK_ANCHOR} events in the trace (need two or more, one each)"
        )
    (ts0, first), (ts1, _) = marks[0], marks[-1]
    t0, t1 = anchors[0], anchors[-1]
    if t1 <= t0:
        raise ValueError("the anchors' reads do not advance")
    slope = (ts1 - ts0) / (t1 - t0)
    residual = max(
        (abs(ts0 + slope * (t - t0) - ts) for (ts, _), t in
         zip(marks[1:-1], anchors[1:-1])),
        default=0.0,
    )
    pid = first.get("pid", _PID)
    used = [e.get("tid") for e in events if isinstance(e.get("tid"), int)]
    base = max(used, default=0) + 1
    tids: Dict[str, int] = {}
    for name in sorted({s.thread for s in spans}):
        tids[name] = base + len(tids)
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tids[name],
            "args": {"name": f"flight recorder: {name}"},
        })
    for s in spans:
        args: dict = {"corr": s.corr, "cat": s.cat}
        if s.attrs:
            args.update(s.attrs)
        events.append({
            "ph": "X", "name": s.name, "cat": PROFILE_CAT, "pid": pid,
            "tid": tids[s.thread], "ts": ts0 + slope * (s.t0 - t0),
            "dur": slope * s.dur, "args": args,
        })
    return {"spans": len(spans), "us_per_s": slope, "residual_us": residual}


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
