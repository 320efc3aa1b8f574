"""Controller: watch-plane translation + TriadSet reconciliation.

The reference builds this on kopf (TriadController.py): node watches become
cordon/maintenance/group events, pod watches become create/delete events,
and a 3-second timer recreates missing TriadSet pods. This implementation
consumes the backend's WatchEvent stream directly — no operator framework —
and keeps the same translation rules. Unlike the reference's pure
crash-only stance (any controller exception kills the process,
TriadController.py:147-152), events are exception-isolated by default: one
poisoned event is logged and counted (nhd_controller_event_errors_total)
while the loop keeps draining — the resync and reconcile nets repair
whatever that event would have told us (docs/RESILIENCE.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from nhd_tpu_torch.k8s.interface import (
    CFG_ANNOTATION,
    CFG_TYPE_ANNOTATION,
    SCHEDULER_TAINT,
    TIER_ANNOTATION,
    ClusterBackend,
    WatchEvent,
)
from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.k8s.retry import API_COUNTERS
from nhd_tpu_torch.obs.journal import get_journal
from nhd_tpu_torch.obs.recorder import get_recorder, new_corr_id
from nhd_tpu_torch.scheduler.events import WatchItem, WatchQueue, WatchType
from nhd_tpu_torch.utils import get_logger

NHD_GROUP_LABEL = "NHD_GROUP"
TRIADSET_PERIOD_SEC = 3.0   # reference: TriadController.py:89


class Controller(threading.Thread):
    """Translates cluster changes into scheduler events and keeps TriadSets
    at their replica counts."""

    def __init__(
        self,
        backend: ClusterBackend,
        watch_queue: WatchQueue,
        *,
        sched_name: str = "nhd-scheduler",
        poll_interval: float = 0.1,
        isolate_events: bool = True,
        elector=None,
        recorder=None,
    ):
        super().__init__(name="nhd-controller", daemon=True)
        self.logger = get_logger(__name__)
        self.backend = backend
        self.queue = watch_queue
        self.sched_name = sched_name
        self.poll_interval = poll_interval
        # per-replica flight recorder (None → process-global): the chaos
        # harness runs N replicas in one process, each with its own ring
        self._recorder = recorder
        # HA standby mode (k8s/lease.py): watch translation always runs
        # (the scheduler's standby path keeps its node mirror warm from
        # it), but TriadSet reconciliation MUTATES the cluster (pod
        # creation, status patches) and is gated on holding the lease —
        # two replicas racing the same ordinal would double-create.
        # Under federation the same gate takes a ShardedElector, whose
        # ``is_leader`` reports the COORDINATOR shard (shard 0): TriadSet
        # pods are cluster-scoped, so exactly one federation member owns
        # their reconciliation regardless of how the node-group shards
        # are spread (docs/RESILIENCE.md "Federation").
        self.elector = elector
        # per-event exception isolation: one poisoned event (truncated
        # object off a cut stream, a shape the translators never met) is
        # logged and counted instead of killing the run loop. False
        # restores the reference's pure crash-only stance — kept only so
        # the chaos harness can demonstrate the failure mode
        # (tests/test_faults.py).
        self.isolate_events = isolate_events
        self._stop_event = threading.Event()
        self._last_triadset = 0.0
        self._last_status: Dict[tuple, int] = {}
        # batched-decode sink: while a decode_batch pass is active, the
        # translators' _emit calls accumulate here (then hand over as
        # ONE put_batch); None outside a pass, where _emit puts directly
        # — direct translator calls in tests keep their behavior
        self._batch_out: Optional[List[WatchItem]] = None

    # ------------------------------------------------------------------

    def _emit(self, item: WatchItem) -> None:
        """Single exit point for translated WatchItems: collected by the
        active decode pass, or enqueued immediately outside one."""
        if self._batch_out is not None:
            self._batch_out.append(item)
        else:
            self.queue.put(item)

    def handle_node_update(self, ev: WatchEvent) -> None:
        """Cordon/uncordon via taint or unschedulable flips, NHD group label
        diffs, maintenance label diffs (reference: TriadController.py:41-84)."""
        had_taint = SCHEDULER_TAINT in ev.old_taints
        has_taint = SCHEDULER_TAINT in ev.taints

        if (had_taint and not has_taint) or (
            not ev.was_unschedulable and ev.unschedulable
        ):
            self._emit(WatchItem(WatchType.NODE_CORDON, node=ev.name))
        elif (not had_taint and has_taint) or (
            ev.was_unschedulable and not ev.unschedulable and has_taint
        ):
            # uncordon-via-unschedulable only reactivates nodes that carry
            # the scheduler taint — never nodes NHD doesn't manage
            # (reference: TriadController.py:56-63)
            self._emit(WatchItem(WatchType.NODE_UNCORDON, node=ev.name))

        old_group = ev.old_labels.get(NHD_GROUP_LABEL)
        new_group = ev.labels.get(NHD_GROUP_LABEL)
        if new_group is None and old_group is not None:
            # label removed: back to the default pool (reference sends
            # 'default' explicitly on removal, TriadController.py:65-74)
            self._emit(
                WatchItem(WatchType.GROUP_UPDATE, node=ev.name, groups="default")
            )
        elif new_group is not None and new_group != old_group:
            self._emit(
                WatchItem(WatchType.GROUP_UPDATE, node=ev.name, groups=new_group)
            )

        was_maint = HostNode.maintenance_from_labels(ev.old_labels)
        is_maint = HostNode.maintenance_from_labels(ev.labels)
        if not was_maint and is_maint:
            self._emit(WatchItem(WatchType.NODE_MAINT_START, node=ev.name))
        elif was_maint and not is_maint:
            self._emit(WatchItem(WatchType.NODE_MAINT_END, node=ev.name))

    def handle_pod_event(self, ev: WatchEvent) -> None:
        """Only Triad pods that request THIS scheduler matter — both the
        cfg_type annotation and spec.schedulerName gate the event
        (reference: TriadController.py:123-144 'when' clauses)."""
        if ev.annotations.get(CFG_TYPE_ANNOTATION) != "triad":
            return
        if ev.scheduler_name != self.sched_name:
            return
        wt = (
            WatchType.TRIAD_POD_CREATE
            if ev.kind == "pod_create"
            else WatchType.TRIAD_POD_DELETE
        )
        # correlation ID minted at watch-event receipt: this is where one
        # pod's decision path enters the process, and every later span
        # (queue wait, solve, select, assign, bind) carries this ID —
        # scoped by replica identity so N processes' dumps merge cleanly
        rec = self._recorder if self._recorder is not None else get_recorder()
        corr = new_corr_id(rec.identity if rec is not None else "")
        jnl = get_journal()
        if jnl is not None:
            # the journal recorded this event at _dispatch entry; attach
            # the corr minted for it (best-effort back-annotation)
            jnl.note_corr(corr)
        t_recv = time.monotonic()
        if rec is not None:
            rec.record(
                "watch_event", t_recv, 0.0, cat="event", corr=corr,
                attrs={"kind": ev.kind, "pod": f"{ev.namespace}/{ev.name}"},
            )
        self._emit(
            WatchItem(
                wt,
                pod={
                    "ns": ev.namespace, "name": ev.name, "uid": ev.uid,
                    # deletes carry the last-seen solved config + node so the
                    # scheduler can release without re-reading a gone pod
                    "cfg": ev.annotations.get(CFG_ANNOTATION, ""),
                    "node": ev.node,
                    # the pod's priority tier rides to the front door:
                    # the admission ladder's defer rung spares
                    # higher-tier traffic (nhd_tpu/ingress/admission.py)
                    "tier": ev.annotations.get(TIER_ANNOTATION, "0"),
                },
                corr=corr,
                t_enqueue=t_recv,
            )
        )

    def _coordinator_write(self, fn, *args) -> bool:
        """THE coordinator-write chokepoint: every cluster-mutating call
        the controller issues routes through here (nhdlint NHD501 flags
        any that doesn't), re-checking coordinatorship AT the write —
        not just at the top of the reconcile pass. A replica deposed (or
        whose shard-0 lease handed off) mid-pass answers False for the
        rest of its writes instead of racing the new coordinator's
        reconciliation; the double-create that can still slip through
        the check-to-write window is absorbed by the create's 409
        idempotence, and status patches are last-writer-wins on a value
        both coordinators compute identically."""
        if self.elector is not None and not self.elector.is_leader:
            self.logger.warning(
                "coordinatorship lost mid-reconcile; dropping the write"
            )
            return False
        return bool(fn(*args))

    def reconcile_triadsets(self) -> None:
        """Create any missing '{service}-{ordinal}' pods
        (reference: TriadController.py:87-120)."""
        triadsets = self.backend.list_triadsets()
        live_keys = {(ts["ns"], ts["name"]) for ts in triadsets}
        # prune deleted TriadSets: a recreated same-name CR must get a
        # fresh status patch, and the cache must not grow unboundedly
        for key in list(self._last_status):
            if key not in live_keys:
                del self._last_status[key]
        for ts in triadsets:
            existing = set(self.backend.list_pods_of_triadset(ts))
            created = 0
            for ordinal in range(int(ts.get("replicas", 0))):
                name = f"{ts['service_name']}-{ordinal}"
                if name not in existing:
                    self.logger.info(f"TriadSet {ts['name']}: creating pod {name}")
                    if self._coordinator_write(
                        self.backend.create_pod_for_triadset, ts, ordinal
                    ):
                        created += 1
            # scale-subresource status: observed count incl. this pass's
            # creations; skip no-op patches (each would bump the object's
            # resourceVersion and wake every CRD watcher)
            observed = len(existing) + created
            key = (ts["ns"], ts["name"])
            if self._last_status.get(key) != observed:
                # cache only acknowledged writes so a transient API failure
                # retries next pass
                if self._coordinator_write(
                    self.backend.update_triadset_status, ts, observed
                ):
                    self._last_status[key] = observed

    # ------------------------------------------------------------------

    def _dispatch(self, ev: WatchEvent) -> None:
        # journal capture at receipt (obs/journal.py), BEFORE translation:
        # a poisoned event that crashes a translator below is still
        # recorded, so replay reproduces the crash-and-isolate behavior;
        # fault-dropped events never reach here, so replay re-drives the
        # post-drop stream exactly. One module-global read when off.
        jnl = get_journal()
        if jnl is not None:
            jnl.watch_event(ev)
        if ev.kind == "node_update":
            self.handle_node_update(ev)
        elif ev.kind in ("pod_create", "pod_delete"):
            self.handle_pod_event(ev)
        elif ev.kind == "node_add":
            self._emit(WatchItem(WatchType.NODE_ADD, node=ev.name))
        elif ev.kind == "node_delete":
            self._emit(WatchItem(WatchType.NODE_REMOVE, node=ev.name))

    def decode_batch(self, events: List[WatchEvent]) -> int:
        """Fold one wakeup's pending raw events into a single decode
        pass: translators emit into a local list, and the whole pass
        hands over as ONE put_batch — one queue-lock round-trip per
        wakeup instead of one per event (the per-event cost is pinned by
        the ingress micro-bench, bench[cfg9]). Per-event journal capture
        and exception isolation are unchanged: a poisoned event costs
        that event, and every item decoded before AND after it still
        lands, in arrival order. Returns the number of items emitted."""
        out: List[WatchItem] = []
        self._batch_out = out
        try:
            for ev in events:
                try:
                    self._dispatch(ev)
                except Exception:
                    if not self.isolate_events:
                        raise
                    # broad on purpose: the event is cluster-supplied
                    # data; a translator crash on one poisoned event must
                    # cost that event, not the control loop (the resync/
                    # reconcile nets repair whatever it carried)
                    API_COUNTERS.inc("controller_event_errors_total")
                    self.logger.exception(
                        f"poisoned watch event dropped ({ev.kind} {ev.name!r})"
                    )
        finally:
            # flush even when a crash-only (isolate_events=False) pass
            # re-raises: items decoded before the poison were enqueued
            # under per-event dispatch too, and must still be
            self._batch_out = None
            if out:
                put_batch = getattr(self.queue, "put_batch", None)
                if put_batch is not None:
                    put_batch(out)
                else:
                    for item in out:
                        self.queue.put(item)
        return len(out)

    def run_once(
        self, now: Optional[float] = None, timeout: float = 0.0
    ) -> None:
        events = list(self.backend.poll_watch_events(timeout))
        if events:
            self.decode_batch(events)
        if self.elector is not None and not self.elector.is_leader:
            # standby: watch, don't act. Single-lease mode: the leader
            # owns TriadSets; federation: the shard-0 coordinator does.
            return
        t = time.monotonic() if now is None else now
        if t - self._last_triadset >= TRIADSET_PERIOD_SEC:
            self._last_triadset = t
            try:
                self.reconcile_triadsets()
            except Exception:
                if not self.isolate_events:
                    raise
                # a failed reconcile pass retries next period; killing the
                # loop would also take the watch translation down with it.
                # Own counter: routine transient reconcile failures must
                # not pollute the poisoned-event alarm
                API_COUNTERS.inc("controller_reconcile_errors_total")
                self.logger.exception("TriadSet reconcile pass failed")

    def run(self) -> None:
        # BLOCKING poll with poll_interval as the timeout, not a sleep:
        # the loop wakes the moment the backend emits an event (both
        # backends support a blocking first get), so pod create→bind
        # pays solver time, not poll-cadence time — with the sleep the
        # daemon's bind latency was quantized at ~poll_interval
        # (measured r5, bench[daemon-mode])
        while not self._stop_event.is_set():
            self.run_once(timeout=self.poll_interval)

    def stop(self) -> None:
        self._stop_event.set()
