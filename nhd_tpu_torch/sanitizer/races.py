"""nhdrace runtime — Eraser-style dynamic race detection (the dynamic
half of NHD81x; ``nhd_tpu_torch/analysis/ownership.py`` is the static half).

Write-focused lockset intersection on *registered* shared objects:
product classes call :func:`maybe_watch` at the end of ``__init__``
(a no-op unless ``install_races()`` ran), after which every write to a
watched field flows through an instrumented class-level ``__setattr__``.
Per (object, field) the detector keeps the classic Eraser state
machine — *exclusive* while a single thread writes (no refinement: the
init/handoff pattern is legal), then on the first write from a second
thread the candidate lockset becomes the intersection of the previous
writer's held locks and the current holder's, refined on every
subsequent write. An empty candidate set in the shared state is a race
witness: two threads write the field and no common lock orders them.

Witness keys are ``"mod/label:Class.attr"`` — exactly the static pack's
shared-field registry keys (:func:`field_key` is the join), so a runtime
witness names its static finding and vice versa. Held locksets come
from nhdsan's registry (``Sanitizer.held_snapshot``), so the two
sanitizers agree on lock identity (construction site) too.

Reports ride the existing NHD_SAN surfaces: ``report()`` merges into
the conftest report dump, witnesses mirror into the flight recorder /
chrome trace as ``nhdsan.race`` spans.

Knobs (all registered in nhd_tpu_torch/config/knobs.py):

* ``NHD_RACE=1`` — conftest/chaos install the race layer (implies
  nhdsan install: locksets need the instrumented locks).
* ``NHD_RACE_INJECT=1`` — negative control: install_races() runs two
  deliberately unsynchronized incrementing threads on a watched dummy;
  the run must FAIL with a race report, proving the detector fires.
* ``NHD_RACE_ALLOW`` — comma-separated fnmatch globs of field keys to
  allowlist (witness recorded as suppressed, run stays green); the
  dynamic mirror of the static pack's written-justification inline
  suppressions.
"""

from __future__ import annotations

import inspect
import os
import threading
import weakref
from fnmatch import fnmatch
from typing import Dict, List, Optional, Set, Tuple

from nhd_tpu_torch.sanitizer.runtime import Sanitizer, _site, get_sanitizer, install

__all__ = [
    "RaceSanitizer", "field_key", "get_race_sanitizer", "install_races",
    "maybe_watch", "uninstall_races",
]


def field_key(cls: type, attr: str) -> str:
    """The shared-state identity: ``mod/label:Class.attr``, where the
    label is the class's defining file's last two path components — the
    same key the static ownership model derives from the AST."""
    from nhd_tpu_torch.analysis.lockgraph import _mod_label
    try:
        path = inspect.getfile(cls)
    except TypeError:           # builtins / C types
        path = cls.__module__.replace(".", "/") + ".py"
    return f"{_mod_label(path)}:{cls.__name__}.{attr}"


class _FieldState:
    __slots__ = ("owner", "lockset", "shared", "first_site")

    def __init__(self, owner: int, lockset: Tuple, site: str):
        self.owner = owner          # sole writer while exclusive
        self.lockset = lockset      # last held (exclusive) / candidates
        self.shared = False
        self.first_site = site


class RaceSanitizer:
    """One registry of watched objects + per-field Eraser states.
    ``install_races()`` publishes a process-global instance."""

    def __init__(self, san: Sanitizer, *, allow: str = ""):
        self._san = san
        # raw lock (never instrumented): same discipline as runtime.py
        import _thread
        self._reg = _thread.allocate_lock()
        self._watched: Dict[int, Set[str]] = {}     # id(obj) -> fields
        self._keys: Dict[int, Dict[str, str]] = {}  # id(obj) -> attr -> key
        self._states: Dict[Tuple[int, str], _FieldState] = {}
        self._patched: Dict[type, Tuple[object, bool]] = {}
        self._races: List[dict] = []
        self._suppressed: List[dict] = []
        self._reported: Set[str] = set()
        self._allow = tuple(
            g.strip() for g in allow.split(",") if g.strip()
        )

    # -- registration ---------------------------------------------------

    def watch(self, obj: object, fields: Tuple[str, ...]) -> None:
        cls = type(obj)
        oid = id(obj)
        with self._reg:
            if cls not in self._patched:
                self._patch_class(cls)
            self._watched.setdefault(oid, set()).update(fields)
            keys = self._keys.setdefault(oid, {})
            for f in fields:
                keys.setdefault(f, field_key(cls, f))
        try:
            weakref.finalize(obj, self._forget, oid)
        except TypeError:
            pass                # not weakref-able: entry lives on

    def _forget(self, oid: int) -> None:
        with self._reg:
            self._watched.pop(oid, None)
            self._keys.pop(oid, None)
            for k in [k for k in self._states if k[0] == oid]:
                del self._states[k]

    def _patch_class(self, cls: type) -> None:
        """Wrap cls.__setattr__ (registry lock held). The wrapper gates
        on the watched-instance registry, so unwatched instances pay one
        dict lookup and nothing else."""
        had_own = "__setattr__" in cls.__dict__
        orig = cls.__setattr__
        rs = self

        def race_setattr(obj, name, value):
            watched = rs._watched.get(id(obj))
            if watched is not None and name in watched:
                rs._on_write(obj, name)
            orig(obj, name, value)

        race_setattr._nhdrace_wrapped = True    # type: ignore[attr-defined]
        cls.__setattr__ = race_setattr          # type: ignore[assignment]
        self._patched[cls] = (orig, had_own)

    # -- the Eraser state machine --------------------------------------

    def _on_write(self, obj: object, name: str) -> None:
        me = threading.get_ident()
        held = self._san.held_snapshot(me)
        uids = frozenset(u for u, _ in held)
        sites = {u: s for u, s in held}
        oid = id(obj)
        race = None
        with self._reg:
            key = self._keys[oid][name]
            sk = (oid, name)
            st = self._states.get(sk)
            if st is None:
                self._states[sk] = _FieldState(me, uids, "<first>")
                st = self._states[sk]
            elif not st.shared:
                if st.owner == me:
                    st.lockset = uids   # still exclusive: refresh, don't
                    #                     refine (single writer is legal)
                else:
                    st.shared = True    # second writer: candidates start
                    st.lockset = frozenset(st.lockset) & uids
            else:
                st.lockset = frozenset(st.lockset) & uids
            if st.shared and not st.lockset and key not in self._reported:
                self._reported.add(key)
                race = {
                    "key": key,
                    "threads": sorted({str(st.owner), str(me)}),
                    "held_now": sorted(sites.values()),
                    "allowed": any(fnmatch(key, g) for g in self._allow),
                }
        if race is not None:
            at = _site()                # stack walk outside the registry
            race["at"] = at
            with self._san._reg:
                w = self._san._record_witness("race", dict(race))
            self._san._emit_span(w)
            with self._reg:
                (self._suppressed if race["allowed"]
                 else self._races).append(race)

    # -- report ---------------------------------------------------------

    def report(self) -> dict:
        with self._reg:
            return {
                "version": 1,
                "races": list(self._races),
                "suppressed": list(self._suppressed),
                "watched_objects": len(self._watched),
                "watched_fields": sorted(
                    {k for m in self._keys.values() for k in m.values()}
                ),
            }

    # -- teardown -------------------------------------------------------

    def unpatch_all(self) -> None:
        with self._reg:
            for cls, (orig, had_own) in self._patched.items():
                if had_own:
                    cls.__setattr__ = orig      # type: ignore[assignment]
                else:
                    try:
                        del cls.__setattr__
                    except AttributeError:
                        pass
            self._patched.clear()


# ---------------------------------------------------------------------------
# global install / uninstall (NHD_RACE=1 path)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[RaceSanitizer] = None


def get_race_sanitizer() -> Optional[RaceSanitizer]:
    return _GLOBAL


def maybe_watch(obj: object, fields: Tuple[str, ...]) -> None:
    """Product-code hook: register *obj*'s shared fields for dynamic
    race checking. No-op (one global read) unless install_races() ran —
    call it at the END of __init__ so construction writes stay exempt,
    mirroring the static pack's init exemption."""
    rs = _GLOBAL
    if rs is not None:
        rs.watch(obj, fields)


def install_races(san: Optional[Sanitizer] = None,
                  *, allow: Optional[str] = None) -> RaceSanitizer:
    """Publish a global RaceSanitizer (installing nhdsan first if
    needed — locksets come from its instrumented locks). When
    NHD_RACE_INJECT=1, immediately run the injected-race negative
    control so the surrounding harness MUST fail: proof the detector and
    the report plumbing fire end to end."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    base = san or get_sanitizer() or install()
    if allow is None:
        allow = os.environ.get("NHD_RACE_ALLOW", "")
    _GLOBAL = RaceSanitizer(base, allow=allow)
    if os.environ.get("NHD_RACE_INJECT", "0") == "1":
        inject_race(_GLOBAL)
    return _GLOBAL


def uninstall_races() -> Optional[RaceSanitizer]:
    """Restore every wrapped __setattr__; returns the sanitizer that was
    active (its report stays readable after uninstall)."""
    global _GLOBAL
    rs, _GLOBAL = _GLOBAL, None
    if rs is not None:
        rs.unpatch_all()
    return rs


# ---------------------------------------------------------------------------
# injected-race negative control
# ---------------------------------------------------------------------------

class _InjectedRace:
    """Two threads increment 'counter' with no common lock: the detector
    must produce a race witness for this, or the control fails."""

    def __init__(self):
        self.counter = 0


def inject_race(rs: Optional[RaceSanitizer] = None,
                rounds: int = 200) -> dict:
    """Run the deliberately racy workload on a watched dummy and return
    the race report. Used by NHD_RACE_INJECT=1 and by the tests."""
    rs = rs or _GLOBAL
    assert rs is not None, "install_races() first"
    dummy = _InjectedRace()
    rs.watch(dummy, ("counter",))
    # both threads must be alive at once: a short-lived thread that
    # exits before the second starts can hand its ident to the second
    # (pthread id reuse) and the two writers would look like one
    gate = threading.Barrier(2)

    def spin():
        gate.wait(timeout=10)
        for _ in range(rounds):
            dummy.counter += 1

    threads = [threading.Thread(target=spin, name=f"nhdrace-inject-{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return rs.report()
