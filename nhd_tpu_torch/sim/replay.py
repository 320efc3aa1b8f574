"""Deterministic journal replay: re-drive a recorded run, diff decisions.

A journal (obs/journal.py) captures everything a run's scheduling
behavior depended on: the genesis inventory + knob snapshot, the watch
stream at controller receipt (post fault-filter, so dropped events are
simply absent and poisoned ones replay their crash), every scripted
cluster mutation, every injected transient fault, and the decision /
commit ground truth. This module closes the loop: it reconstructs the
genesis cluster on a fresh FakeClusterBackend, re-drives the REAL
Controller/BatchScheduler code path with the recorded arrivals on a sim
clock (no wall-clock pacing — ``speed`` only scales the clock values the
stack observes), and diffs the replayed decision stream against the
recorded one.

Divergence semantics: decisions are aligned per pod as ordered
sequences — correlation IDs are minted from a process-global counter, so
a replay's corrs never equal the recording's; the (ns, pod) key and the
k-th-decision position are the stable join. Two decisions diverge when
their outcome, node, or victim set differ; phase wall times and the
``time`` stamp are advisory and never diffed. The first divergence (in
recorded order) is named by the RECORDED corr, which is what /journey
and the journal's own corr index resolve.

Perturbations (``drop_nodes``, or simply flipping a knob before
replaying) are the negative control: a replay under a perturbed genesis
must *report* a divergence, and knob drift between the recorded snapshot
and the replaying environment is named in the report so a silent
config flip cannot masquerade as a scheduler bug.
"""

from __future__ import annotations

import queue
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nhd_tpu_torch.device import DeviceLike
from nhd_tpu_torch.ingress import AdmissionQueue
from nhd_tpu_torch.k8s.fake import FakeClusterBackend
from nhd_tpu_torch.k8s.interface import TransientBackendError, WatchEvent
from nhd_tpu_torch.obs.artifact import make_envelope, write_artifact
from nhd_tpu_torch.obs.journal import knob_snapshot, load_journal, merge_journals
from nhd_tpu_torch.obs.recorder import FlightRecorder
from nhd_tpu_torch.scheduler.controller import Controller
from nhd_tpu_torch.scheduler.core import Scheduler
from nhd_tpu_torch.scheduler.events import WatchQueue
from nhd_tpu_torch.utils import get_logger

#: artifact-envelope coordinates of a divergence report
DIVERGENCE_KIND = "replay-divergence"
DIVERGENCE_SCHEMA_VERSION = 1

#: settle cadence after the last recorded event — mirrors the chaos
#: harness's quiesce (sim/chaos.py STEP_SEC / rounds), so a journal
#: recorded from a storm converges under the same drain budget
SETTLE_STEP_SEC = 10.0
SETTLE_ROUNDS = 12

#: events closer together than this replay in ONE scheduling window —
#: the scheduler's own batch-admission block time (core.py
#: Q_BLOCK_TIME_SEC): arrivals inside it were batched together by the
#: recording's scheduler, so replay must not split them across batches
BATCH_WINDOW_SEC = 0.5

#: divergence entries kept verbatim in the report payload (the count is
#: always exact; the list is capped so a totally-diverged replay does
#: not write an unbounded artifact)
_REPORT_DIVERGENCE_CAP = 100

#: knobs that configure the recording apparatus itself — they differ
#: between a recording run and its replay by construction, so they are
#: excluded from drift detection (everything else is fair game: a
#: flipped NHD_POLICY is exactly what drift must name)
_DRIFT_EXEMPT_PREFIX = "NHD_JOURNAL"

#: private-recorder ring size: big enough that no replayed decision is
#: ever evicted before the diff reads it back
_DECISION_CAPACITY = 1 << 20


def _decision_sig(d: dict) -> Tuple:
    """The diffed projection of one decision record: outcome, node,
    victim set. Everything else (phases, stamps, budget state) is
    advisory."""
    victims = tuple(sorted(
        v.get("pod", "") for v in (d.get("victims") or ())
    ))
    return (d.get("outcome"), d.get("node"), victims)


@dataclass
class ReplayResult:
    """Outcome of one replay: the two decision streams plus their diff."""

    recorded: List[dict]
    replayed: List[dict]
    divergences: List[dict]
    knob_drift: Dict[str, dict]
    dropped_nodes: List[str]
    speed: float
    paths: List[str]
    watch_dispatched: int = 0
    watch_poisoned: int = 0
    cluster_applied: int = 0
    faults_armed: int = 0

    @property
    def diverged(self) -> bool:
        return bool(self.divergences)

    @property
    def first_divergence(self) -> Optional[dict]:
        return self.divergences[0] if self.divergences else None

    def report_payload(self) -> dict:
        """JSON payload of the divergence report artifact."""
        return {
            "journals": list(self.paths),
            "speed": self.speed,
            "dropped_nodes": list(self.dropped_nodes),
            "knob_drift": dict(self.knob_drift),
            "decisions_recorded": len(self.recorded),
            "decisions_replayed": len(self.replayed),
            "watch_dispatched": self.watch_dispatched,
            "watch_poisoned": self.watch_poisoned,
            "cluster_applied": self.cluster_applied,
            "faults_armed": self.faults_armed,
            "divergence_count": len(self.divergences),
            "divergences": self.divergences[:_REPORT_DIVERGENCE_CAP],
            "first_divergence": self.first_divergence,
            "verdict": "diverged" if self.diverged else "match",
        }

    def write_report(
        self, out_dir: str, name: str = "replay_divergence.json"
    ) -> str:
        env = make_envelope(
            DIVERGENCE_KIND, DIVERGENCE_SCHEMA_VERSION,
            self.report_payload(),
        )
        return write_artifact(env, out_dir, name)


class _ScriptedFaultBackend:
    """Replays recorded transient faults against the real call sites.

    Mirrors FaultyBackend's once-per-key semantics (sim/faults.py): each
    recorded (op, ns, pod) fault fires exactly once, at the first
    matching call at-or-after its recorded time — the time gate keeps a
    fault recorded late in the run from firing on that pod's first bind.
    Reads and unlisted writes delegate to the inner backend untouched.
    """

    _OPS = ("annotate", "meta", "claim", "bind")

    def __init__(self, inner, faults: Sequence[dict], clock: Callable[[], float]):
        self.inner = inner
        self._clock = clock
        self._pending: Dict[Tuple[str, str, str], float] = {}
        for e in faults:
            key = (e.get("op", ""), e.get("ns", ""), e.get("pod", ""))
            # first recording wins, like the once-per-key sets it mirrors
            self._pending.setdefault(key, float(e.get("t", 0.0)))

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _fire(self, op: str, ns: str, pod: str) -> bool:
        key = (op, ns, pod)
        t = self._pending.get(key)
        if t is None or self._clock() < t - 1e-9:
            return False
        del self._pending[key]
        return True

    def remaining(self) -> int:
        return len(self._pending)

    def annotate_pod_config(
        self, ns, pod, cfg, *, epoch=None, fence_lease=None
    ):
        if self._fire("annotate", ns, pod):
            raise TransientBackendError(
                f"replayed transient annotate failure for {ns}/{pod}"
            )
        return self.inner.annotate_pod_config(
            ns, pod, cfg, epoch=epoch, fence_lease=fence_lease
        )

    def annotate_pod_meta(
        self, ns, pod, key, value, *, epoch=None, fence_lease=None
    ):
        if self._fire("meta", ns, pod):
            raise TransientBackendError(
                f"replayed transient meta-annotate failure for {ns}/{pod}"
            )
        return self.inner.annotate_pod_meta(
            ns, pod, key, value, epoch=epoch, fence_lease=fence_lease
        )

    def claim_spillover_pod(
        self, ns, pod, claim_lease, claim_epoch, *, epoch=None,
        fence_lease=None,
    ):
        if self._fire("claim", ns, pod):
            raise TransientBackendError(
                f"replayed transient spillover-claim failure for {ns}/{pod}"
            )
        return self.inner.claim_spillover_pod(
            ns, pod, claim_lease, claim_epoch,
            epoch=epoch, fence_lease=fence_lease,
        )

    def bind_pod_to_node(
        self, pod, node, ns, *, epoch=None, fence_lease=None
    ):
        if self._fire("bind", ns, pod):
            raise TransientBackendError(
                f"replayed transient bind failure for {ns}/{pod}"
            )
        return self.inner.bind_pod_to_node(
            pod, node, ns, epoch=epoch, fence_lease=fence_lease
        )


def recorded_folds(events: Sequence[dict]) -> List[List[Tuple[str, str]]]:
    """The batches a CLI recording's scheduler folded out of its
    admission queue, in the order it took them: each the (ns, pod) of
    the watched pod creates it solved together (one batch's decisions
    share their solve phase). Pods, not corrs: a watch line flushed
    before its corr was noted carries none. A pod decided again later
    stays in its first batch only."""
    pos: Dict[Tuple[str, str], int] = {}
    for e in events:
        we = e.get("we") or {}
        if e["ev"] == "watch" and we.get("kind") == "pod_create":
            pos.setdefault((we.get("namespace", ""), we.get("name", "")),
                           len(pos))
    batches: Dict[float, List[Tuple[str, str]]] = {}
    taken: set = set()
    for e in events:
        if e["ev"] != "decision":
            continue
        d = e["d"]
        solve = (d.get("phases") or {}).get("solve")
        key = (d.get("ns", ""), d.get("pod", ""))
        if solve is None or key not in pos or key in taken:
            continue
        taken.add(key)
        batches.setdefault(solve, []).append(key)
    return sorted(batches.values(), key=lambda b: min(pos[k] for k in b))


class _FoldQueue(AdmissionQueue):
    """The CLI's admission front door, folding each batch to the size
    the recording's scheduler folded (set by the engine before each;
    None folds as the queue's knobs say)."""

    fold: Optional[int] = None

    def batch_limit(self) -> int:
        return self.fold or super().batch_limit()


class ReplayEngine:
    """Loads one journal (or N fleet journals, merged onto one timeline
    like chrome.merge_chrome_traces) and re-drives the real scheduling
    stack from it."""

    def __init__(
        self,
        paths,
        *,
        speed: float = 1.0,
        drop_nodes: Sequence[str] = (),
        settle_rounds: int = SETTLE_ROUNDS,
        device: DeviceLike = "cuda",
    ):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("replay needs at least one journal path")
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        self.speed = float(speed)
        self.drop_nodes = list(drop_nodes)
        self.settle_rounds = int(settle_rounds)
        # the device every rebuilt Scheduler solves on (the port's
        # entry-point rule: cuda unless the caller asks for the CPU)
        self.device = device
        self.logger = get_logger(__name__)

        if len(self.paths) == 1:
            self.header, self.events = load_journal(self.paths[0])
            self.headers = [self.header]
        else:
            self.headers, self.events = merge_journals(self.paths)
            self.header = self.headers[0]

        self.genesis = next(
            (e for e in self.events if e["ev"] == "genesis"), None
        )
        if self.genesis is None:
            raise ValueError(
                f"{self.paths[0]}: journal has no genesis event; "
                "cannot reconstruct the cluster"
            )
        # a CLI recording took its pod creates through the admission
        # front door (cli.py build_threads): replay its folds as recorded
        # instead of solving each create alone once per window
        self._folds: Optional[List[List[Tuple[str, str]]]] = (
            recorded_folds(self.events)
            if self.genesis.get("mode") == "cli" else None
        )
        self._queued: set = set()
        # latest recorded spec per pod: the materialization source for
        # journals recorded from a live cluster (no scripted create_pod)
        self._specs: Dict[Tuple[str, str], dict] = {}
        for e in self.events:
            if e["ev"] == "pod_spec":
                self._specs[(e["ns"], e["pod"])] = e

        # recorded-time cursor (unscaled): fault gating and event
        # grouping live in this domain; the stack's clock observes the
        # speed-scaled value
        self._t0 = float(self.events[0]["t"])
        self._t_rec = self._t0
        self._now = 0.0

        self.base: Optional[FakeClusterBackend] = None
        self.backend: Optional[_ScriptedFaultBackend] = None
        self.sched: Optional[Scheduler] = None
        self.controller: Optional[Controller] = None
        self.recorder = FlightRecorder(
            decision_capacity=_DECISION_CAPACITY, identity="replay"
        )
        self._watch_dispatched = 0
        self._watch_poisoned = 0
        self._cluster_applied = 0

    # -- clocks ---------------------------------------------------------

    def _sim_clock(self) -> float:
        return self._now

    def _rec_clock(self) -> float:
        return self._t_rec

    def _advance(self, t_rec: float) -> None:
        self._t_rec = t_rec
        self._now = (t_rec - self._t0) / self.speed

    # -- setup ----------------------------------------------------------

    def _build(self) -> None:
        self.base = FakeClusterBackend()
        self.base.clock = self._sim_clock
        dropped = set(self.drop_nodes)
        for nd in self.genesis["nodes"]:
            if nd["name"] in dropped:
                continue
            self.base.add_node(
                nd["name"], dict(nd.get("labels") or {}),
                hugepages_gb=int(nd.get("hugepages_gb") or 64),
                addr=nd.get("addr", ""),
            )
        faults = [e for e in self.events if e["ev"] == "fault"]
        self.backend = _ScriptedFaultBackend(
            self.base, faults, self._rec_clock
        )
        self._faults_armed = len(faults)
        self._fresh_stack()

    def _fresh_stack(self) -> None:
        """(Re)build scheduler + controller — the same solo stack the
        chaos harness drives — sharing one oversized private recorder
        so replayed decisions accumulate without eviction, with global
        tracing untouched.

        ``respect_busy`` comes from the genesis event: a CLI recording
        spreads placements via the busy window while the chaos harness
        disables it, and replaying with the wrong setting packs (or
        spreads) pods the recording never did. Busy windows measure
        wall time, so recordings much longer than NHD_MIN_BUSY_SECS
        replay with uniformly-fresh busy stamps — a documented source
        of benign divergence for live recordings."""
        self.sched = Scheduler(
            self.backend,
            WatchQueue() if self._folds is None else _FoldQueue(),
            queue.Queue(),
            respect_busy=bool(self.genesis.get("respect_busy", False)),
            recorder=self.recorder, device=self.device,
        )
        self.controller = Controller(
            self.backend, self.sched.nqueue,
            isolate_events=True, recorder=self.recorder,
        )
        self.sched.build_initial_node_list()
        self.sched.load_deployed_configs()

    # -- drive ----------------------------------------------------------

    def _discard_emitted(self) -> None:
        """Drop backend-emitted watch events: cluster mutations above
        emit unconditionally, but replay drives the controller from the
        RECORDED stream only (the recording already reflects exactly
        which of those emissions survived the fault filter)."""
        for _ in self.base.poll_watch_events(0.0):
            pass

    def _apply_cluster(self, event: dict) -> None:
        op = event.get("op", "")
        p = event.get("args") or {}
        try:
            if op == "create_pod":
                self.base.create_pod(
                    p["name"], p.get("ns", "default"),
                    cfg_text=p.get("cfg_text"),
                    cfg_type=p.get("cfg_type", "triad"),
                    groups=p.get("groups"),
                    resources=p.get("resources") or None,
                    scheduler_name=p.get("scheduler_name", "nhd-scheduler"),
                    emit_watch=bool(p.get("emit_watch", True)),
                    tier=int(p.get("tier", 0)),
                )
            elif op == "delete_pod":
                self.base.delete_pod(
                    p["name"], p.get("ns", "default"),
                    emit_watch=bool(p.get("emit_watch", True)),
                )
            elif op == "add_node":
                self.base.add_node(
                    p["name"], dict(p.get("labels") or {}),
                    hugepages_gb=int(p.get("hugepages_gb") or 64),
                    addr=p.get("addr", ""),
                    emit_watch=bool(p.get("emit_watch", False)),
                )
            elif op == "remove_node":
                self.base.remove_node(
                    p["name"], emit_watch=bool(p.get("emit_watch", True)),
                )
            elif op == "cordon_node":
                self.base.cordon_node(p["name"], bool(p.get("cordon", True)))
            elif op == "update_node_labels":
                self.base.update_node_labels(
                    p["name"], dict(p.get("new_labels") or {})
                )
            elif op == "arm_bind_failure":
                self.base.fail_bind_for.add((p["ns"], p["pod"]))
            elif op == "sched_restart":
                self._fresh_stack()
            else:
                self.logger.warning(f"unknown cluster op {op!r}; skipped")
                return
        except KeyError as exc:
            self.logger.warning(f"cluster op {op!r} missing field {exc}")
            return
        self._cluster_applied += 1
        self._discard_emitted()

    def _materialize_for_watch(self, we: dict) -> None:
        """Keep the backend consistent with a recorded watch event that
        no scripted cluster op produced (journals recorded from a live
        cluster): pod_create needs the pod + configmap present before
        the scheduler reads its config; pod_delete must remove it or the
        reconcile scan would resurrect a pod the recording lost."""
        kind = we.get("kind")
        key = (we.get("namespace", ""), we.get("name", ""))
        if kind == "pod_create" and key not in self.base.pods:
            spec = self._specs.get(key)
            pod = self.base.create_pod(
                key[1], key[0] or "default",
                cfg_text=spec["cfg_text"] if spec else None,
                groups=",".join(spec.get("groups") or ()) if spec else None,
                scheduler_name=we.get("scheduler_name") or "nhd-scheduler",
                tier=int(spec.get("tier", 0)) if spec else 0,
                emit_watch=False,
            )
            if we.get("uid"):
                # the cluster's uid, as the recorded event carries it (a
                # pod under another uid reads as replaced to the scans);
                # nothing has seen the pod yet
                pod.uid = we["uid"]
        elif kind == "pod_delete" and key in self.base.pods:
            self.base.delete_pod(key[1], key[0] or "default",
                                 emit_watch=False)
            self._discard_emitted()

    def _dispatch_watch(self, event: dict) -> None:
        we = dict(event.get("we") or {})
        try:
            ev = WatchEvent(**we)
        except TypeError:
            # a journal from a newer schema may carry fields this build
            # doesn't know; keep the intersection
            known = {
                k: v for k, v in we.items()
                if k in WatchEvent.__dataclass_fields__
            }
            ev = WatchEvent(**known)
        self._materialize_for_watch(we)
        if self._folds is not None and ev.kind == "pod_create":
            self._queued.add((ev.namespace, ev.name))
        try:
            self.controller._dispatch(ev)
        except Exception as exc:
            # the recording's controller isolated this crash too (the
            # event was recorded at receipt, pre-translation)
            self._watch_poisoned += 1
            self.logger.debug(
                f"replay: poisoned watch event dropped "
                f"({ev.kind} {ev.namespace}/{ev.name}): {exc}"
            )
        self._watch_dispatched += 1

    def _drive_folds(self) -> None:
        """CLI mode: handle queued node and delete events as they come,
        and solve each recorded batch as soon as all its creates are
        queued, folded to its recorded size (the recording's scheduler
        solved it no earlier, and the batches before it first)."""
        q = self.sched.nqueue
        while q.depths()["control"]:
            self.sched.run_once()
        while self._folds and all(k in self._queued for k in self._folds[0]):
            fold = self._folds.pop(0)
            self._queued.difference_update(fold)
            q.fold = len(fold)
            self.sched.run_once()
        q.fold = None

    def _drive_sched(self, *, full_drain: bool = False) -> None:
        for _ in range(8):
            if self.sched.nqueue.empty():
                break
            self.sched.run_once()
        self.sched.check_pending_pods()
        if full_drain:
            while not self.sched.nqueue.empty():
                self.sched.run_once()
        # one-shot bind failures clear at group end, mirroring the
        # chaos harness's per-step clear
        self.base.fail_bind_for.clear()

    def run(self) -> ReplayResult:
        """Replay the journal end to end and return the divergence diff."""
        self._build()
        # window the input stream like the recording's scheduler saw it:
        # events closer together than the batch-admission block time
        # belong to one scheduling window (a chaos step's events share
        # one sim-clock stamp; a live recording's arrive micro-seconds
        # apart and were batched together) — the scheduler drives once
        # per window, so replayed batch composition matches recorded
        w_start: Optional[float] = None
        for e in self.events:
            if e["ev"] not in ("watch", "cluster"):
                continue
            t = float(e["t"])
            if self._folds is not None:
                # CLI mode: each recorded batch as soon as it is queued
                self._advance(t)
                if e["ev"] == "cluster":
                    self._apply_cluster(e)
                else:
                    self._dispatch_watch(e)
                self._drive_folds()
                continue
            if w_start is not None and t - w_start > BATCH_WINDOW_SEC:
                self._drive_sched()
                w_start = t
            elif w_start is None:
                w_start = t
            self._advance(t)
            if e["ev"] == "cluster":
                self._apply_cluster(e)
            else:
                self._dispatch_watch(e)
        if w_start is not None:
            self._drive_sched()
        # settle: let requeues/reconcile converge, advancing the sim
        # clock so time-gated retries fire (chaos quiesce cadence)
        for _ in range(self.settle_rounds):
            self._advance(self._t_rec + SETTLE_STEP_SEC * self.speed)
            self._drive_sched(full_drain=True)
        recorded = [
            dict(e["d"]) for e in self.events if e["ev"] == "decision"
        ]
        replayed = list(reversed(
            self.recorder.recent_decisions(_DECISION_CAPACITY)
        ))
        divergences = diff_decisions(recorded, replayed)
        return ReplayResult(
            recorded=recorded,
            replayed=replayed,
            divergences=divergences,
            knob_drift=knob_drift(self.genesis.get("knobs") or {}),
            dropped_nodes=list(self.drop_nodes),
            speed=self.speed,
            paths=list(self.paths),
            watch_dispatched=self._watch_dispatched,
            watch_poisoned=self._watch_poisoned,
            cluster_applied=self._cluster_applied,
            faults_armed=self._faults_armed,
        )


def knob_drift(recorded: Dict[str, Optional[str]]) -> Dict[str, dict]:
    """Registered knobs whose current environment value differs from the
    recorded genesis snapshot (journal-apparatus knobs exempt — they
    differ between a recording and its replay by construction)."""
    current = knob_snapshot()
    drift: Dict[str, dict] = {}
    for name in sorted(set(recorded) | set(current)):
        if name.startswith(_DRIFT_EXEMPT_PREFIX):
            continue
        rec_v = recorded.get(name)
        cur_v = current.get(name)
        if rec_v != cur_v:
            drift[name] = {"recorded": rec_v, "current": cur_v}
    return drift


def diff_decisions(
    recorded: Sequence[dict], replayed: Sequence[dict]
) -> List[dict]:
    """Align the two decision streams per pod and report every position
    where they differ, ordered by first appearance in the RECORDED
    stream (extra replayed-only decisions sort last). Each divergence
    names the recorded corr (when one exists) — the ID /journey and the
    journal's corr index resolve.

    Consecutive decisions with the SAME signature for a pod collapse to
    one before alignment: retry cadence is a timing artifact (a live
    scheduler and the replay's settle loop re-decide a pending pod at
    different rates), and a repeated identical verdict carries no
    placement information. Any change of verdict still diverges."""
    def by_pod(stream):
        out: "OrderedDict[Tuple[str, str], List[dict]]" = OrderedDict()
        for d in stream:
            key = (d.get("ns", ""), d.get("pod", ""))
            seq = out.setdefault(key, [])
            if seq and _decision_sig(seq[-1]) == _decision_sig(d):
                continue
            seq.append(d)
        return out

    rec_pods = by_pod(recorded)
    rep_pods = by_pod(replayed)
    # recorded-order rank of each collapsed (pod, k) position, for
    # sorting — mirrors the by_pod() collapse so indices line up
    rank: Dict[Tuple[Tuple[str, str], int], int] = {}
    seen_count: Dict[Tuple[str, str], int] = {}
    last_sig: Dict[Tuple[str, str], tuple] = {}
    for i, d in enumerate(recorded):
        key = (d.get("ns", ""), d.get("pod", ""))
        sig = _decision_sig(d)
        if last_sig.get(key) == sig:
            continue
        last_sig[key] = sig
        rank[(key, seen_count.get(key, 0))] = i
        seen_count[key] = seen_count.get(key, 0) + 1

    divergences: List[Tuple[int, dict]] = []
    for key in list(rec_pods) + [k for k in rep_pods if k not in rec_pods]:
        a = rec_pods.get(key, [])
        b = rep_pods.get(key, [])
        for k in range(max(len(a), len(b))):
            da = a[k] if k < len(a) else None
            db = b[k] if k < len(b) else None
            if da is not None and db is not None:
                if _decision_sig(da) == _decision_sig(db):
                    continue
                delta = {
                    "kind": "decision-mismatch",
                    "recorded": {
                        "outcome": da.get("outcome"), "node": da.get("node"),
                        "victims": _decision_sig(da)[2],
                    },
                    "replayed": {
                        "outcome": db.get("outcome"), "node": db.get("node"),
                        "victims": _decision_sig(db)[2],
                    },
                }
            elif db is None:
                delta = {
                    "kind": "missing-decision",
                    "recorded": {
                        "outcome": da.get("outcome"), "node": da.get("node"),
                        "victims": _decision_sig(da)[2],
                    },
                    "replayed": None,
                }
            else:
                delta = {
                    "kind": "extra-decision",
                    "recorded": None,
                    "replayed": {
                        "outcome": db.get("outcome"), "node": db.get("node"),
                        "victims": _decision_sig(db)[2],
                    },
                }
            order = rank.get((key, k), len(recorded) + len(divergences))
            divergences.append((order, {
                "ns": key[0], "pod": key[1], "index": k,
                "corr": (da or {}).get("corr") or (db or {}).get("corr"),
                **delta,
            }))
    divergences.sort(key=lambda pair: pair[0])
    return [d for _order, d in divergences]


def replay_journal(
    paths,
    *,
    speed: float = 1.0,
    drop_nodes: Sequence[str] = (),
    settle_rounds: int = SETTLE_ROUNDS,
    device: DeviceLike = "cuda",
) -> ReplayResult:
    """One-call convenience: load, replay, diff (on ``device``)."""
    return ReplayEngine(
        paths, speed=speed, drop_nodes=drop_nodes,
        settle_rounds=settle_rounds, device=device,
    ).run()
