"""nhdsan — runtime deadlock sanitizer (the dynamic half of the lock
discipline story; ``nhd_tpu/analysis/lockgraph.py`` is the static half).

ThreadSanitizer-style witness machinery for what the AST cannot prove:
instrumented ``Lock``/``RLock``/``Condition`` wrappers record, per
thread, which locks are held (with acquisition stacks) and which lock is
being waited for. The union is a **wait-for graph**: thread T waits for
lock L, L is owned by thread U, U waits for M, ... — a cycle back to T
is a deadlock *in progress*. The waiter that discovers the cycle records
a witness and raises :class:`DeadlockError`, converting a silent hang
into a diagnosable failure (the streaming-mesh deadlock burned the whole
tier-1 budget precisely because nothing ever failed).

Detection is sound-at-detection-time: the wait-for graph is examined
under the registry lock while every edge in the cycle is current, so a
reported cycle was a real cycle at that instant (no false positives from
stale edges). Hold-while-blocking witnesses — a thread entering an
unbounded ``queue.get``/``Thread.join``/``Event.wait`` while holding an
instrumented lock — are recorded but not fatal: the static analog
(NHD211) flags the pattern; at runtime only the realized cycle kills.

Locks are keyed by their **construction site** (``file:line``), the same
key the static lock graph exports — a runtime witness therefore joins
against static facts by site (docs/OBSERVABILITY.md). Witnesses also
flow into the PR 3 flight recorder (``nhd_tpu/obs``) as ``nhdsan``
category spans when tracing is enabled, so a Chrome trace shows the
witness inline with the scheduling pipeline that produced it.

Opt-in: ``NHD_SAN=1`` makes the tests/conftest.py fixture call
:func:`nhd_tpu.sanitizer.install`, which monkeypatches
``threading.Lock``/``RLock``/``Condition`` (factories for everything
created afterwards) plus the blocking entry points above. Tests can also
instantiate a private :class:`Sanitizer` and build wrappers explicitly —
no global state touched.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import _thread

# originals, captured at import so wrappers can never nest even if this
# module loads after install() ran in another process/session
_ALLOCATE = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock


class DeadlockError(RuntimeError):
    """A wait-for-graph cycle: acquiring would deadlock. The message
    carries the full cycle with per-thread held-lock stacks."""


_SKIP_FILES = (
    os.path.dirname(__file__),
    getattr(threading, "__file__", "<none>"),
)


def _site() -> str:
    """file:line of the nearest stack frame outside this package and the
    stdlib threading/queue modules — the user-code construction (or
    blocking) site, matching the static lock graph's site keys."""
    import queue as _queue

    skip = _SKIP_FILES + (getattr(_queue, "__file__", "<none>"),)
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.startswith(skip):
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


class _LockInfo:
    __slots__ = ("uid", "site", "kind", "owner", "count", "acquired_at",
                 "n_acquisitions", "n_contended")

    def __init__(self, uid: int, site: str, kind: str):
        self.uid = uid
        self.site = site
        self.kind = kind
        self.owner: Optional[int] = None    # thread ident
        self.count = 0                      # re-entrancy depth (RLock)
        self.acquired_at: Optional[List[str]] = None  # stack summary
        self.n_acquisitions = 0
        self.n_contended = 0


class Sanitizer:
    """One witness registry. ``install()`` publishes a process-global
    instance; tests may build private ones."""

    def __init__(self, *, poll_interval: float = 0.05):
        self.poll_interval = poll_interval
        self._reg = _ALLOCATE()             # raw: never instrumented
        self._locks: Dict[int, _LockInfo] = {}
        self._wants: Dict[int, int] = {}    # thread ident -> lock uid
        self._held: Dict[int, List[int]] = {}  # thread ident -> [lock uid]
        self._witnesses: List[dict] = []
        # hold-while-blocking sites repeat (every queue drain under the
        # same lock): one witness per distinct site, with a count
        self._hwb_counts: Dict[Tuple, dict] = {}
        self._next_uid = 1
        self._t0 = time.monotonic()

    # -- wrapper factories ---------------------------------------------

    def Lock(self) -> "SanLock":
        return SanLock(self, reentrant=False, site=_site())

    def RLock(self) -> "SanLock":
        return SanLock(self, reentrant=True, site=_site())

    def Condition(self, lock=None) -> "threading.Condition":
        # a plain threading.Condition over an instrumented lock: every
        # acquire/release/wait flows through the wrapper, so the
        # wait-for graph sees the condition's lock like any other
        if lock is None:
            lock = self.RLock()
        return _SanCondition(lock)

    # -- registry -------------------------------------------------------

    def _register(self, info: _LockInfo) -> int:
        with self._reg:
            uid = self._next_uid
            self._next_uid += 1
            info.uid = uid
            self._locks[uid] = info
            return uid

    def _holder_stacks(self, idents: List[int]) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for ident in idents:
            held = []
            for uid in self._held.get(ident, ()):
                info = self._locks[uid]
                held.append(f"{info.kind}@{info.site}")
            out[str(ident)] = held
        return out

    def _detect_cycle(self, me: int) -> Optional[List[Tuple[int, int]]]:
        """Follow wants -> owner -> wants ... from *me*; a return to *me*
        is a deadlock. Caller holds the registry lock. Returns the cycle
        as [(thread ident, lock uid waited for), ...] or None."""
        path: List[Tuple[int, int]] = []
        seen = set()
        tid = me
        while True:
            uid = self._wants.get(tid)
            if uid is None:
                return None
            path.append((tid, uid))
            owner = self._locks[uid].owner
            if owner is None or owner == tid:
                return None
            if owner == me:
                return path
            if owner in seen:
                return None     # cycle not through me: its members report
            seen.add(owner)
            tid = owner

    # -- witness recording ---------------------------------------------

    def _record_witness(self, kind: str, detail: dict) -> dict:
        w = {
            "kind": kind,
            "t": time.monotonic() - self._t0,
            "thread": threading.current_thread().name,
            **detail,
        }
        self._witnesses.append(w)   # registry lock held by callers
        return w

    def _emit_span(self, w: dict) -> None:
        """Mirror the witness into the flight recorder (when tracing is
        on) so Chrome traces show it inline with the pipeline."""
        try:
            from nhd_tpu_torch.obs.recorder import get_recorder
            rec = get_recorder()
        except Exception:       # obs depends on nothing, but stay safe
            return
        if rec is None:
            return
        rec.record(
            f"nhdsan.{w['kind']}", time.monotonic(), 0.0, cat="nhdsan",
            attrs={k: v for k, v in w.items() if k not in ("kind",)},
        )

    # -- blocking-entry hook (queue.get / Thread.join / Event.wait) ----

    def note_blocking(self, desc: str) -> None:
        """Called by the installed blocking-entry patches before an
        unbounded wait: a thread holding instrumented locks here is the
        runtime NHD211. Not fatal — only a realized cycle kills."""
        me = threading.get_ident()
        with self._reg:
            held = self._held.get(me)
            if not held:
                return
            held_sites = tuple(
                f"{self._locks[u].kind}@{self._locks[u].site}" for u in held
            )
        at = _site()    # walks the stack: outside the registry lock
        w = None
        with self._reg:
            key = (desc, held_sites, at)
            prior = self._hwb_counts.get(key)
            if prior is not None:
                prior["count"] += 1
            else:
                w = self._record_witness("hold_while_blocking", {
                    "blocking": desc,
                    "held": list(held_sites),
                    "at": at,
                    "count": 1,
                })
                self._hwb_counts[key] = w
        if w is not None:
            self._emit_span(w)

    # -- race-sanitizer hook -------------------------------------------

    def held_snapshot(self, ident: Optional[int] = None) -> Tuple[Tuple[int, str], ...]:
        """(uid, 'kind@site') of every instrumented lock the thread
        holds right now — the per-access lockset the race layer
        (races.py) intersects, Eraser-style."""
        if ident is None:
            ident = threading.get_ident()
        with self._reg:
            return tuple(
                (u, f"{self._locks[u].kind}@{self._locks[u].site}")
                for u in self._held.get(ident, ())
            )

    # -- report ---------------------------------------------------------

    def witnesses(self, kind: Optional[str] = None) -> List[dict]:
        with self._reg:
            out = list(self._witnesses)
        return [w for w in out if kind is None or w["kind"] == kind]

    def report(self) -> dict:
        with self._reg:
            locks = [
                {
                    "site": i.site, "kind": i.kind,
                    "acquisitions": i.n_acquisitions,
                    "contended": i.n_contended,
                }
                for i in self._locks.values()
            ]
            witnesses = list(self._witnesses)
        return {
            "version": 1,
            "cycles": [w for w in witnesses if w["kind"] == "cycle"],
            "hold_while_blocking": [
                w for w in witnesses if w["kind"] == "hold_while_blocking"
            ],
            "locks": sorted(locks, key=lambda l: l["site"]),
        }

    def chrome_trace(self) -> dict:
        """Witnesses as a loadable Chrome trace (obs/chrome.py renders),
        usable even when the flight recorder was off."""
        from nhd_tpu_torch.obs.chrome import chrome_trace_of
        from nhd_tpu_torch.obs.recorder import Span

        spans = [
            Span(
                f"nhdsan.{w['kind']}", w["t"], 0.0, cat="nhdsan",
                thread=w.get("thread", "?"),
                attrs={k: v for k, v in w.items()
                       if k not in ("kind", "t", "thread")},
            )
            for w in self.witnesses()
        ]
        return chrome_trace_of(spans)


class SanLock:
    """Instrumented mutex; reentrant=True gives RLock semantics. Exposes
    the full lock protocol (incl. the ``_release_save`` trio) so
    ``threading.Condition`` composes with it."""

    def __init__(self, san: Sanitizer, *, reentrant: bool, site: str):
        self._san = san
        self._inner = _ALLOCATE()
        self.reentrant = reentrant
        self._info = _LockInfo(0, site, "RLock" if reentrant else "Lock")
        san._register(self._info)

    # -- bookkeeping (registry lock held) ------------------------------

    def _mark_acquired(self, me: int) -> None:
        info = self._info
        info.owner = me
        info.count += 1
        info.n_acquisitions += 1
        self._san._held.setdefault(me, []).append(info.uid)

    def _mark_released(self, me: int) -> None:
        info = self._info
        info.count -= 1
        if info.count == 0:
            info.owner = None
        held = self._san._held.get(me)
        if held and info.uid in held:
            held.reverse()
            held.remove(info.uid)   # innermost occurrence
            held.reverse()

    # -- lock protocol --------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        san = self._san
        me = threading.get_ident()
        bounded = timeout is not None and timeout >= 0
        self_deadlock = None
        with san._reg:
            if self.reentrant and self._info.owner == me:
                self._mark_acquired(me)
                return True
            if (not self.reentrant and self._info.owner == me
                    and blocking and not bounded):
                # one-edge self-cycle: re-acquiring a non-reentrant lock
                # this thread already owns can never succeed — the
                # callback-under-lock shape (static NHD212), caught here
                # before the wait-for walk because the thread never gets
                # to register a want against itself
                self_deadlock = san._record_witness("cycle", {
                    "cycle": [{
                        "thread": str(me),
                        "waits_for":
                            f"{self._info.kind}@{self._info.site}",
                        "owner": str(me),
                    }],
                    "held_by_thread": san._holder_stacks([me]),
                })
            elif self._inner.acquire(False):
                self._mark_acquired(me)
                return True
            elif not blocking:
                return False
            else:
                # contended: a bounded waiter cannot deadlock (it times
                # out), so it never enters the wants map — it still
                # appears as an OWNER of whatever it already holds,
                # which is what other threads' cycles need
                if not bounded:
                    san._wants[me] = self._info.uid
                self._info.n_contended += 1
        if self_deadlock is not None:
            # outside the registry lock: the recorder's lock may itself
            # be instrumented
            san._emit_span(self_deadlock)
            raise DeadlockError(
                "nhdsan: re-entrant acquisition of non-reentrant "
                f"{self._info.kind}@{self._info.site} — the owning "
                "thread is re-acquiring its own lock and would deadlock "
                "itself (use RLock or move the call outside the lock)"
            )
        deadline = time.monotonic() + timeout if bounded else None
        try:
            while True:
                w = None
                if not bounded:
                    with san._reg:
                        cycle = san._detect_cycle(me)
                        if cycle is not None:
                            w = san._record_witness("cycle", {
                                "cycle": [
                                    {
                                        "thread": str(tid),
                                        "waits_for":
                                            f"{san._locks[uid].kind}"
                                            f"@{san._locks[uid].site}",
                                        "owner": str(san._locks[uid].owner),
                                    }
                                    for tid, uid in cycle
                                ],
                                "held_by_thread": san._holder_stacks(
                                    [t for t, _ in cycle]
                                ),
                            })
                if w is not None:
                    # outside the registry lock: the recorder's own lock
                    # may itself be instrumented
                    san._emit_span(w)
                    raise DeadlockError(
                        "nhdsan: wait-for-graph cycle — acquiring "
                        f"{self._info.kind}@{self._info.site} would "
                        f"deadlock: {w['cycle']}"
                    )
                slice_ = san.poll_interval
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    slice_ = min(slice_, remaining)
                if self._inner.acquire(True, slice_):
                    with san._reg:
                        self._mark_acquired(me)
                    return True
        finally:
            if not bounded:
                with san._reg:
                    san._wants.pop(me, None)

    def release(self) -> None:
        me = threading.get_ident()
        san = self._san
        with san._reg:
            info = self._info
            if info.owner != me or info.count < 1:
                raise RuntimeError(
                    f"release of un-owned {info.kind}@{info.site}"
                )
            self._mark_released(me)
            if info.count == 0:
                self._inner.release()

    def locked(self) -> bool:
        return self._info.owner is not None

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol (lets cond.wait fully release an RLock)
    def _release_save(self):
        me = threading.get_ident()
        san = self._san
        with san._reg:
            info = self._info
            if info.owner != me:
                raise RuntimeError("cannot wait on un-acquired lock")
            count = info.count
            info.count = 0
            info.owner = None
            held = san._held.get(me)
            if held is not None:
                while info.uid in held:
                    held.remove(info.uid)
            self._inner.release()
        return count

    def _acquire_restore(self, count: int) -> None:
        self.acquire()
        if count > 1:
            me = threading.get_ident()
            with self._san._reg:
                for _ in range(count - 1):
                    self._mark_acquired(me)

    def _is_owned(self) -> bool:
        return self._info.owner == threading.get_ident()

    def _at_fork_reinit(self) -> None:
        # stdlib fork handlers (threading, concurrent.futures) reinit
        # locks in the child: fresh inner lock, ownership cleared — the
        # child has exactly one thread
        self._inner = _ALLOCATE()
        self._info.owner = None
        self._info.count = 0

    def __repr__(self) -> str:
        return (
            f"<SanLock {self._info.kind}@{self._info.site} "
            f"owner={self._info.owner}>"
        )


class _SanCondition(threading.Condition):
    """threading.Condition over an instrumented lock. A subclass (not a
    factory function) so ``threading.Condition`` stays a *type* after
    install() swaps the name — isinstance checks keep working."""

    def __init__(self, lock=None):
        if lock is None:
            san = _GLOBAL
            lock = san.RLock() if san is not None else _ORIG_RLOCK()
        super().__init__(lock)


# ---------------------------------------------------------------------------
# global install / uninstall (NHD_SAN=1 path)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Sanitizer] = None
_PATCHES: List[Tuple[object, str, object]] = []


def get_sanitizer() -> Optional[Sanitizer]:
    return _GLOBAL


def _patch(obj: object, name: str, new: object) -> None:
    _PATCHES.append((obj, name, getattr(obj, name)))
    setattr(obj, name, new)


def install(san: Optional[Sanitizer] = None) -> Sanitizer:
    """Publish *san* (or a fresh Sanitizer) globally and monkeypatch
    ``threading.Lock/RLock/Condition`` plus the unbounded blocking entry
    points. Locks created *before* install stay raw — deliberate for
    jax / interpreter internals, which is why tests/conftest.py installs
    at conftest IMPORT time (after the jax setup, before pytest
    collection imports nhd_tpu modules): module-level locks such as
    streaming's _CPU_MESH_SOLVE_LOCK are then created under
    instrumentation."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    san = san or Sanitizer()
    _GLOBAL = san

    import queue

    _patch(threading, "Lock", san.Lock)
    _patch(threading, "RLock", san.RLock)
    _patch(threading, "Condition", _SanCondition)

    orig_get = queue.Queue.get

    def san_get(self, block=True, timeout=None):
        if block and timeout is None:
            san.note_blocking("queue.Queue.get()")
        return orig_get(self, block, timeout)

    _patch(queue.Queue, "get", san_get)

    orig_join = threading.Thread.join

    def san_join(self, timeout=None):
        if timeout is None:
            san.note_blocking("threading.Thread.join()")
        return orig_join(self, timeout)

    _patch(threading.Thread, "join", san_join)

    orig_wait = threading.Event.wait

    def san_wait(self, timeout=None):
        if timeout is None:
            san.note_blocking("threading.Event.wait()")
        return orig_wait(self, timeout)

    _patch(threading.Event, "wait", san_wait)
    return san


def uninstall() -> Optional[Sanitizer]:
    """Restore every patched name; returns the sanitizer that was active
    (its witnesses stay readable after uninstall)."""
    global _GLOBAL
    for obj, name, orig in reversed(_PATCHES):
        setattr(obj, name, orig)
    _PATCHES.clear()
    san, _GLOBAL = _GLOBAL, None
    return san
