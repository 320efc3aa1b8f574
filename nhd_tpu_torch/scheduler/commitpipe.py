"""Bounded, in-order commit pipeline: overlap API-bound bind commits
with the next batch's admission and solve.

The commit path is >= 5 serial API round trips per pod, so on a real
cluster batch b's binds dominate its wall — and the solver sits idle
while they drain. With ``NHD_ASYNC_COMMIT`` on, the scheduler thread
submits each winner's commit closure here and moves straight on to
admitting batch b+1; ONE worker thread drains the queue strictly FIFO,
which preserves per-node commit order by construction (a total order
preserves every sub-order). Completed outcomes are handed back to the
single-writer scheduler thread at its drain points (top of every
run_once turn; a full barrier before any pass that re-reads cluster
state) — all mirror mutations (pod_state, unwind, requeue) stay on the
scheduler thread, exactly as in the synchronous path.

Safety properties, in terms of the existing machinery:

* **Fencing at drain** — the commit closure runs ``_commit_write``
  (scheduler/core.py) on the worker at drain time, so the fencing epoch
  is read when the write actually happens: a replica deposed while a
  commit sat queued is rejected by the backend, not landed stale.
* **Failure unwind** — a transient/terminal outcome flows through the
  same unwind+requeue paths (PR 2 / PR 5) when the scheduler thread
  processes it; the solve that ran in between saw the claim as applied,
  which is merely conservative (the node looked fuller than it was).
* **Watchdog liveness** — the worker advances the scheduler's
  heartbeat per drained commit, so a long queue draining against a slow
  API server reads as progress, while a wedged worker goes silent and
  trips the stall watchdog exactly like a wedged loop.
* **Bounded** — at most ``depth`` commits are in flight; ``submit``
  blocks the scheduler thread once the bound is hit (backpressure, not
  an unbounded queue against a down API server).

Locking discipline: the one condition guards only the deques and
counters; the commit closure always runs OUTSIDE it (nhdlint NHD2xx),
and NHD_SAN=1 instruments the condition like every other lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Set, Tuple

from nhd_tpu_torch.sanitizer.races import maybe_watch
from nhd_tpu_torch.utils import get_logger


class CommitUnit:
    """One queued commit: the closure to run plus the context the
    scheduler thread needs to process its outcome later. ``key`` is the
    pod's (ns, name) — drain barriers key on it."""

    __slots__ = ("key", "run", "ctx")

    def __init__(self, key: Tuple[str, str], run: Callable[[], Any], ctx: Any):
        self.key = key
        self.run = run
        self.ctx = ctx


class CommitPipeline:
    """FIFO commit pipeline: one worker, strict submission order,
    bounded in-flight depth."""

    def __init__(
        self,
        *,
        depth: int = 256,
        heartbeat: Optional[Callable[[], None]] = None,
        name: str = "nhd-commit-pipe",
    ):
        if depth < 1:
            raise ValueError(f"commit pipeline depth must be >= 1, got {depth}")
        self.logger = get_logger(__name__)
        self.depth = depth
        self._heartbeat = heartbeat
        self._cond = threading.Condition()
        self._queue: deque = deque()        # submitted, not yet run
        self._done: deque = deque()         # (unit, result), drain order
        self._inflight_keys: Set[Tuple[str, str]] = set()
        self._running = 0                   # units the worker holds
        self._stopped = False
        # dynamic race layer (NHD_RACE=1): _running/_stopped are written
        # by the scheduler thread and the worker, always under _cond —
        # registered before the worker starts so its writes are tracked
        maybe_watch(self, ("_running", "_stopped"))
        self._worker = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # scheduler-thread API
    # ------------------------------------------------------------------

    def submit(self, units: List[CommitUnit]) -> None:
        """Enqueue commits in order; blocks while the in-flight depth
        (queued + running) is at the bound — backpressure against an
        API server slower than the solver. Completed-but-undrained
        outcomes deliberately do NOT count: the submitter (the
        single-writer scheduler thread) is also the only drainer, and
        counting them would deadlock it inside submit with a full done
        queue nobody else may empty."""
        for unit in units:
            with self._cond:
                while (
                    not self._stopped
                    and self._inflight_depth() >= self.depth
                ):
                    self._cond.wait(timeout=1.0)
                if self._stopped:
                    raise RuntimeError("commit pipeline is stopped")
                self._queue.append(unit)
                self._inflight_keys.add(unit.key)
                self._cond.notify_all()

    def drain_ready(self) -> List[Tuple[CommitUnit, Any]]:
        """Completed (unit, result) pairs in submission order;
        non-blocking. The caller (single-writer thread) owns outcome
        processing."""
        with self._cond:
            out = list(self._done)
            self._done.clear()
            for unit, _ in out:
                self._inflight_keys.discard(unit.key)
            if out:
                self._cond.notify_all()
        return out

    def drain_all(self, timeout: Optional[float] = None) -> List[Tuple[CommitUnit, Any]]:
        """Barrier: wait until every submitted commit has completed,
        then return all undrained outcomes. Used before any pass that
        re-reads cluster state (periodic scan, mirror rebuild,
        promotion replay) — an in-flight bind must not race a fresh
        listing that still shows its pod Pending.

        ``timeout`` bounds the WHOLE wait (monotonic deadline, not
        per-wakeup — a steadily-completing queue notifies constantly
        and a per-wakeup budget would never expire); 0 is a
        non-blocking probe, None waits indefinitely."""
        with self._cond:
            deadline = (
                None if timeout is None
                else time.monotonic() + max(timeout, 0.0)
            )
            while self._queue or self._running:
                if deadline is None:
                    self._cond.wait(timeout=30.0)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
        return self.drain_ready()

    def inflight_keys(self) -> Set[Tuple[str, str]]:
        """Pod keys with a commit queued or running (undrained outcomes
        included) — watch handlers barrier on membership here."""
        with self._cond:
            return set(self._inflight_keys)

    def occupancy(self) -> float:
        """In-flight depth as a fraction of the bound (0..1) — the
        backpressure signal the ingress admission ladder joins with its
        own lane fill (nhd_tpu/ingress/admission.py): a commit pipeline
        running near its depth escalates shedding at the front door
        instead of letting submit() become the only brake."""
        with self._cond:
            return min(self._inflight_depth() / float(self.depth), 1.0)

    def stop(self, flush: bool = True) -> None:
        """Stop the worker; with ``flush`` (default) drain the queue
        first so no accepted commit is silently dropped."""
        if flush:
            self.drain_all()
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _inflight_depth(self) -> int:
        return len(self._queue) + self._running

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(timeout=1.0)
                if self._stopped and not self._queue:
                    return
                unit = self._queue.popleft()
                self._running += 1
            try:
                # the commit runs OUTSIDE the lock: it is seconds of API
                # round trips and must never serialize against submit
                # or drain
                result = unit.run()
            except BaseException as exc:
                # the closure (_commit_traced) never raises by contract;
                # a raise here is a bug, but eating the unit would hang
                # drain_all — surface it as the result instead
                self.logger.exception(
                    f"commit closure raised for {unit.key}"
                )
                result = exc
            with self._cond:
                self._running -= 1
                self._done.append((unit, result))
                self._cond.notify_all()
            if self._heartbeat is not None:
                # one drained commit = loop progress (stall watchdog)
                self._heartbeat()
