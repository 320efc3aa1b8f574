"""Record/replay journal: the lossless event log behind the flight recorder.

The span ring (recorder.py) is deliberately *bounded*: once a span is
evicted or the process exits, the traffic that produced a bug is gone.
The journal is the other half of the observability plane — a lossless,
append-only, schema-versioned event log that captures everything the
scheduler needs to re-drive a run (sim/replay.py):

* ``genesis``  — initial node inventory, knob snapshot, seed, git rev;
* ``watch``    — every watch event at controller receipt (full payload
  + digest + backend-clock timestamp + corr once minted);
* ``pod_spec`` — pod config text at prepare time (deduped), so replay
  can reconstruct configmaps recorded from a live cluster;
* ``cluster``  — scripted cluster mutations (node add/remove, pod
  create/delete, cordon, label updates) from a sim scenario source;
* ``fault``    — injected transient backend faults (sim/faults.py), so
  recorded fault timing replays exactly;
* ``decision`` — every per-pod scheduling decision record;
* ``commit``   — every commit outcome incl. fenced rejections/requeues.

File format: line 1 is the shared artifact envelope
(obs/artifact.py, ``kind="journal"``) whose payload declares the body
format; every following line is one JSON event object with a monotonic
``seq`` and a backend-clock ``t``. Writes stream to ``<path>.part``
(bounded memory — the buffer flushes every NHD_JOURNAL_FLUSH events) and
``finalize()`` atomically renames into place, so a reader never sees a
torn file and a crashed recording still leaves its flushed prefix.

Hot-path discipline mirrors the recorder: capture sites guard on
``get_journal() is None`` — journaling off costs one module-global read
(the bench_diff-gated ≤2 % budget, docs/bench/BENCH_DIFF_r18.md).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from nhd_tpu_torch.obs.artifact import make_envelope, validate_envelope

#: artifact-envelope coordinates of a journal file's header line
JOURNAL_KIND = "journal"
JOURNAL_SCHEMA_VERSION = 1
#: body-format marker the header payload must carry (bump with format)
BODY_FORMAT = "jsonl-events-v1"

#: every event kind a v1 journal may contain
EVENT_KINDS = (
    "genesis", "watch", "pod_spec", "cluster", "fault", "decision", "commit",
)

#: corrs kept in the corr→seq index for /journey journal refs
_CORR_INDEX_MAX = 4096


def payload_digest(obj: Any) -> str:
    """Short stable digest of any JSON-able payload — lets divergence
    tooling compare watch payloads without byte-diffing full objects."""
    data = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha1(data).hexdigest()[:12]


def knob_snapshot() -> Dict[str, Optional[str]]:
    """Environment value (or None) of every registered NHD_* knob —
    recorded at genesis so replay can name configuration drift (the
    NHD_POLICY-flip negative control). Reads are driven off the registry
    so a new knob is snapshotted the day it is registered."""
    from nhd_tpu_torch.config.knobs import KNOBS

    return {knob.name: os.environ.get(knob.name) for knob in KNOBS}


def genesis_nodes(backend) -> List[dict]:
    """Node inventory records for a genesis event, duck-typed off the
    backend's read API (works for FakeClusterBackend and any wrapper
    that delegates reads)."""
    nodes: List[dict] = []
    for name in sorted(backend.get_nodes()):
        cap_gb, _alloc_gb = backend.get_node_hugepage_resources(name)
        nodes.append({
            "name": name,
            "labels": dict(backend.get_node_labels(name) or {}),
            "hugepages_gb": int(cap_gb),
            "addr": backend.get_node_addr(name) or "",
        })
    return nodes


class JournalWriter:
    """Streaming JSONL journal writer. Thread-safe; every capture
    method is a no-op after ``finalize()`` so late producer threads
    cannot corrupt a sealed file."""

    def __init__(
        self,
        path: str,
        *,
        identity: str = "",
        seed: Optional[int] = None,
        flush_every: int = 64,
        clock=time.monotonic,
        rev: Optional[str] = None,
        created: Optional[float] = None,
    ):
        self.path = path
        self.identity = identity
        self.seed = seed
        self.flush_every = max(1, int(flush_every))
        #: timestamp source for event ``t`` — harnesses point this at
        #: the backend/sim clock so replay pacing follows the recorded
        #: domain, not the recorder host's wall clock
        self.clock = clock
        self._part = path + ".part"
        self._lock = threading.RLock()
        self._buf: List[dict] = []
        self._seq = 0
        self._finalized = False
        self._last_watch: Optional[dict] = None
        self._pod_spec_seen: set = set()
        self._corr_seqs: "OrderedDict[str, List[int]]" = OrderedDict()
        self.bytes_written = 0
        self.counts: Dict[str, int] = {k: 0 for k in EVENT_KINDS}
        header = make_envelope(
            JOURNAL_KIND, JOURNAL_SCHEMA_VERSION,
            {"identity": identity, "body": BODY_FORMAT},
            seed=seed, rev=rev, created=created,
        )
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self._part, "w")
        line = json.dumps(header, sort_keys=True)
        self._fh.write(line + "\n")
        self._fh.flush()
        self.bytes_written += len(line) + 1

    # -- plumbing -------------------------------------------------------

    def _event(self, kind: str, fields: dict, *, track_watch: bool = False):
        with self._lock:
            if self._finalized:
                return None
            self._seq += 1
            rec: dict = {"seq": self._seq, "t": float(self.clock()), "ev": kind}
            rec.update(fields)
            self._buf.append(rec)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if track_watch:
                self._last_watch = rec
            if len(self._buf) >= self.flush_every:
                self._flush_locked()
            return rec

    def _flush_locked(self) -> None:
        # callers hold the RLock already; re-entering is free and keeps
        # the buffer mutations visibly under the lock
        with self._lock:
            if not self._buf:
                return
            data = "\n".join(
                json.dumps(r, sort_keys=True, default=str)
                for r in self._buf
            ) + "\n"
            self._fh.write(data)
            # push through Python's IO buffer: the flushed prefix must
            # be readable (and crash-survivable) from the .part file
            self._fh.flush()
            self.bytes_written += len(data)
            self._buf.clear()
            # flushed events are on disk — the corr back-annotation
            # window is closed
            self._last_watch = None

    def _index_corr(self, corr: str, seq: int) -> None:
        seqs = self._corr_seqs.get(corr)
        if seqs is None:
            while len(self._corr_seqs) >= _CORR_INDEX_MAX:
                self._corr_seqs.popitem(last=False)
            seqs = self._corr_seqs[corr] = []
        seqs.append(seq)

    # -- capture API ----------------------------------------------------

    def genesis(
        self,
        nodes: Sequence[dict],
        *,
        knobs: Optional[Dict[str, Optional[str]]] = None,
        seed: Optional[int] = None,
        mode: str = "",
        respect_busy: bool = False,
    ) -> None:
        """Record the initial cluster: node inventory + knob snapshot.
        ``mode`` names the producing harness (``chaos``, ``cli``, ...).
        ``respect_busy`` pins the recording scheduler's busy-window
        setting so replay reconstructs the same placement spread."""
        self._event("genesis", {
            "nodes": [dict(n) for n in nodes],
            "knobs": dict(knob_snapshot() if knobs is None else knobs),
            "seed": self.seed if seed is None else seed,
            "mode": mode,
            "respect_busy": bool(respect_busy),
        })

    def watch_event(self, ev, *, corr: Optional[str] = None) -> None:
        """Record one watch event at receipt. ``ev`` is a
        k8s.interface.WatchEvent (or an equivalent dict) — the FULL
        payload is kept (replay re-drives from it); the digest rides
        along for cheap cross-journal comparison."""
        we = dataclasses.asdict(ev) if dataclasses.is_dataclass(ev) else dict(ev)
        rec = self._event(
            "watch",
            {"we": we, "digest": payload_digest(we), "corr": corr},
            track_watch=True,
        )
        if rec is not None and corr:
            with self._lock:
                self._index_corr(corr, rec["seq"])

    def note_corr(self, corr: str) -> None:
        """Back-annotate the most recent (still-buffered) watch event
        with the corr minted for it — the controller records the event
        before the corr exists. Best-effort: once the event has flushed
        to disk the annotation is dropped (decision/commit events carry
        the corr authoritatively)."""
        with self._lock:
            rec = self._last_watch
            if rec is not None and rec.get("corr") is None:
                rec["corr"] = corr
                self._index_corr(corr, rec["seq"])

    def pod_spec(
        self,
        ns: str,
        pod: str,
        cfg_text: Optional[str],
        *,
        groups: Iterable[str] = (),
        tier: int = 0,
    ) -> None:
        """Record a pod's config text at prepare time (deduped per
        (ns, pod, cfg digest)) — the capture point that makes journals
        recorded from a live cluster self-contained."""
        key = (ns, pod, payload_digest(cfg_text or ""))
        with self._lock:
            if key in self._pod_spec_seen:
                return
            self._pod_spec_seen.add(key)
        self._event("pod_spec", {
            "ns": ns, "pod": pod, "cfg_text": cfg_text,
            "groups": sorted(groups), "tier": int(tier),
        })

    def cluster_event(self, op: str, payload: Optional[dict] = None) -> None:
        """Record one scripted cluster mutation (FakeClusterBackend
        scenario_sink): op name + the mutation's kwargs."""
        self._event("cluster", {"op": op, "args": dict(payload or {})})

    def fault_event(self, op: str, ns: str, pod: str) -> None:
        """Record one injected transient fault (FaultyBackend
        fault_sink) so replay re-injects it at the same call site."""
        self._event("fault", {"op": op, "ns": ns, "pod": pod})

    def decision(self, decision: dict) -> None:
        """Record one per-pod scheduling decision (the recorder's
        record_decision shape) — the divergence diff's ground truth."""
        rec = self._event("decision", {"d": dict(decision)})
        corr = decision.get("corr")
        if rec is not None and corr:
            with self._lock:
                self._index_corr(corr, rec["seq"])

    def commit(
        self,
        pod: str,
        ns: str,
        corr: Optional[str],
        outcome: str,
        *,
        node: Optional[str] = None,
    ) -> None:
        """Record one commit outcome (OK / RETRY incl. fenced
        rejections / FAILED) from _finish_commit."""
        rec = self._event("commit", {
            "pod": pod, "ns": ns, "corr": corr,
            "outcome": outcome, "node": node,
        })
        if rec is not None and corr:
            with self._lock:
                self._index_corr(corr, rec["seq"])

    # -- introspection --------------------------------------------------

    def corr_seqs(self, corr: str) -> List[int]:
        """Journal line seqs indexed for *corr* (bounded; newest corrs
        win) — the /journey view's journal refs."""
        with self._lock:
            return list(self._corr_seqs.get(corr, ()))

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "path": self.path,
                "seq": self._seq,
                "counts": dict(self.counts),
                "bytes": self.bytes_written,
                "finalized": self._finalized,
            }

    # -- lifecycle ------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            if not self._finalized:
                self._flush_locked()
                self._fh.flush()

    def finalize(self) -> str:
        """Flush, seal, and atomically rename ``.part`` into place.
        Idempotent; returns the final path."""
        with self._lock:
            if self._finalized:
                return self.path
            self._flush_locked()
            self._fh.flush()
            self._fh.close()
            os.replace(self._part, self.path)
            self._finalized = True
        return self.path


# ---------------------------------------------------------------------------
# process-global journal (None = journaling off; the common case)
# ---------------------------------------------------------------------------

_JOURNAL: Optional[JournalWriter] = None


def get_journal() -> Optional[JournalWriter]:
    """The active journal, or None when journaling is off. Capture
    sites must treat None as 'skip all journal work' — this read is the
    entire journal-off cost on the hot path."""
    return _JOURNAL


def enable_journal(
    path: str,
    *,
    identity: str = "",
    seed: Optional[int] = None,
    flush_every: int = 64,
    clock=time.monotonic,
    rev: Optional[str] = None,
    created: Optional[float] = None,
) -> JournalWriter:
    """Install (or replace) the process-global journal writer. A
    replaced writer is finalized first so its flushed prefix survives.
    ``rev``/``created`` pin the envelope header for byte-stable golden
    fixtures (tools/trace_replay.py --regen-golden)."""
    global _JOURNAL
    if _JOURNAL is not None:
        _JOURNAL.finalize()
    _JOURNAL = JournalWriter(
        path, identity=identity, seed=seed,
        flush_every=flush_every, clock=clock, rev=rev, created=created,
    )
    return _JOURNAL


def disable_journal(*, finalize: bool = True) -> Optional[str]:
    """Tear down the process-global journal; returns the finalized path
    (or None when journaling was off)."""
    global _JOURNAL
    jnl, _JOURNAL = _JOURNAL, None
    if jnl is None:
        return None
    if finalize:
        return jnl.finalize()
    return jnl.path


def enable_journal_from_env(
    *, identity: str = "", seed: Optional[int] = None,
) -> Optional[JournalWriter]:
    """Honour NHD_JOURNAL / NHD_JOURNAL_DIR / NHD_JOURNAL_FLUSH: when
    NHD_JOURNAL=1, enable a journal at
    ``$NHD_JOURNAL_DIR/nhd-<identity|pid>.journal.jsonl``."""
    if os.environ.get("NHD_JOURNAL", "0") != "1":
        return None
    out_dir = os.environ.get("NHD_JOURNAL_DIR", "artifacts/journal")
    try:
        flush_every = int(os.environ.get("NHD_JOURNAL_FLUSH", "64"))
    except ValueError:
        flush_every = 64
    tag = identity or str(os.getpid())
    path = os.path.join(out_dir, f"nhd-{tag}.journal.jsonl")
    return enable_journal(
        path, identity=identity, seed=seed, flush_every=flush_every,
    )


def journal_view() -> Dict[str, object]:
    """The journal status payload the metrics plane renders (one
    definition, like decisions_view)."""
    jnl = _JOURNAL
    if jnl is None:
        return {"enabled": False}
    out: Dict[str, object] = {"enabled": True}
    out.update(jnl.stats())
    return out


# ---------------------------------------------------------------------------
# reading side: load / validate / merge
# ---------------------------------------------------------------------------

def validate_journal(header: object, events: Sequence[object]) -> List[str]:
    """Structural schema errors of one parsed journal ([] = valid):
    envelope coordinates, body-format marker, monotonic seqs, known
    event kinds, numeric timestamps, at most one genesis."""
    errs = validate_envelope(
        header, kind=JOURNAL_KIND, schema_version=JOURNAL_SCHEMA_VERSION,
    )
    if not errs and isinstance(header, dict):
        body = header["payload"].get("body")
        if body != BODY_FORMAT:
            errs.append(f"body format is {body!r}, expected {BODY_FORMAT!r}")
    last_seq = 0
    genesis_count = 0
    for i, ev in enumerate(events):
        where = f"event {i}"
        if not isinstance(ev, dict):
            errs.append(f"{where}: must be a JSON object")
            continue
        seq = ev.get("seq")
        if not isinstance(seq, int) or seq <= last_seq:
            errs.append(f"{where}: seq {seq!r} not monotonically increasing")
        else:
            last_seq = seq
        kind = ev.get("ev")
        if kind not in EVENT_KINDS:
            errs.append(f"{where}: unknown event kind {kind!r}")
        elif kind == "genesis":
            genesis_count += 1
        if not isinstance(ev.get("t"), (int, float)):
            errs.append(f"{where}: timestamp 't' must be a number")
    if genesis_count > 1:
        errs.append(f"{genesis_count} genesis events (at most one allowed)")
    return errs


def read_journal(path: str) -> Tuple[dict, List[dict]]:
    """Parse one journal file (``.part`` prefixes read too) into
    (header, events) without schema validation; raises ValueError on
    unparseable lines."""
    header: Optional[dict] = None
    events: List[dict] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                raise ValueError(f"{path}:{lineno}: unparseable JSON line")
            if header is None:
                header = obj
            else:
                events.append(obj)
    if header is None:
        raise ValueError(f"{path}: empty journal (no header line)")
    return header, events


def load_journal(path: str) -> Tuple[dict, List[dict]]:
    """Read + validate one journal; raises ValueError with the full
    error list on a malformed file (a truncated or foreign file must
    fail loud, not replay as an empty run)."""
    header, events = read_journal(path)
    errs = validate_journal(header, events)
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return header, events


def merge_journals(
    paths: Sequence[str],
) -> Tuple[List[dict], List[dict]]:
    """Load N fleet journals and merge their event streams onto one
    timeline, re-based like chrome.merge_chrome_traces: each journal's
    backend-clock ``t`` is anchored by its header's created_unix so
    concurrently recorded replicas interleave in wall order. Events gain
    an ``origin`` index into the returned header list."""
    loaded = [load_journal(p) for p in paths]
    if not loaded:
        raise ValueError("merge_journals: no journals given")
    anchor0 = min(h["created_unix"] for h, _ in loaded)
    merged: List[dict] = []
    for idx, (header, events) in enumerate(loaded):
        if not events:
            continue
        t0 = events[0]["t"]
        base = header["created_unix"] - anchor0
        for ev in events:
            rebased = dict(ev)
            rebased["t"] = base + (ev["t"] - t0)
            rebased["origin"] = idx
            merged.append(rebased)
    merged.sort(key=lambda e: (e["t"], e.get("origin", 0), e["seq"]))
    return [h for h, _ in loaded], merged
