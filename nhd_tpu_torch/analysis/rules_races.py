"""NHD81x — static data-race rules (project pack 'races').

Judges the shared-state model ``ownership.py`` builds: thread roots,
shared-field registry, per-access effective locksets (lexically held
plus must-hold-on-entry). Field keys are ``"mod/label:Class.attr"`` —
the same identity the runtime race sanitizer (``nhd_tpu_torch/sanitizer/
races.py``) reports, so a dynamic witness names its static finding.

* **NHD810** shared write with an empty consistent lockset: the field is
  written from one thread root and touched from another, and no single
  lock is held across every access. Reported at each unlocked write,
  naming a concurrent access site as the witness.
* **NHD811** write outside the declared owner: the ownership registry
  (``ownership.OWNERSHIP`` + in-module ``_NHD_RACE_OWNER``) declares the
  field single-writer; an unlocked write on a path from any *other* root
  breaks the discipline (readers tolerate staleness, a second writer
  corrupts).
* **NHD812** non-atomic read-modify-write: ``x += 1`` or
  check-then-set (``if self.x is None: self.x = ...``) on a shared field
  with no lock held — two threads interleave load and store and one
  update is lost (the classic dropped counter / double-initialized
  cache).
* **NHD813** mutable publish: a spawn site hands a mutable field
  (list/dict/set-valued) to the new thread raw — no ``copy``/``dict()``
  wrapper, no lock discipline — while the publisher keeps writing it.

A field whose every access shares one common lock is consistent and
skipped entirely; writes that do hold a lock are never reported even
when the overall intersection is empty (the unlocked *other* site is the
bug). Accesses in the owning class's ``__init__`` happen before the
object is published and are exempt. Main-thread-only code (reachable
from no root) neither creates sharing nor weakens locksets — a
documented under-approximation that keeps the pack quiet on
single-threaded modules.
"""

from __future__ import annotations

from fnmatch import fnmatch
from typing import List, Sequence, Set, Tuple

from nhd_tpu_torch.analysis.core import Finding, ModuleSource
from nhd_tpu_torch.analysis.ownership import (
    _WRITE_FLAVORS,
    Access,
    RaceModel,
    build_model,
)

_RMW_FLAVORS = ("rmw", "checkset")


def _fmt_roots(model: RaceModel, roots) -> str:
    return ", ".join(sorted(roots)) or "<main>"


def _witness(accesses: List[Access], mine: Access) -> str:
    """A concurrent access on a different root, for the diagnostic."""
    for a in accesses:
        if a.roots - mine.roots:
            return f"{a.path}:{a.line} ({a.flavor})"
    for a in accesses:
        if a is not mine:
            return f"{a.path}:{a.line} ({a.flavor})"
    return "same site, multiple concurrent instances"


def check_project(modules: Sequence[ModuleSource]) -> List[Finding]:
    model = build_model(modules)
    out: List[Finding] = []
    seen: Set[Tuple[str, str, int]] = set()

    def emit(rule: str, path: str, line: int, col: int, msg: str) -> None:
        k = (rule, path, line)
        if k not in seen:
            seen.add(k)
            out.append(Finding(rule, path, line, col, msg))

    shared = model.shared_fields()
    for key in sorted(shared):
        accesses = shared[key]
        consistent = frozenset.intersection(
            *[a.held for a in accesses]
        )
        if consistent:
            continue                # one lock covers every access: clean
        owner = model.owner_of(key)
        writes = [a for a in accesses if a.flavor in _WRITE_FLAVORS]
        for w in sorted(writes, key=lambda a: (a.path, a.line)):
            if w.held:
                continue            # the unlocked site is the finding
            if owner is not None:
                off_owner = [r for r in w.roots if not fnmatch(r, owner)]
                if off_owner:
                    emit(
                        "NHD811", w.path, w.line, w.col,
                        f"write to single-writer field '{key}' from "
                        f"non-owner thread root(s) "
                        f"{_fmt_roots(model, off_owner)} (declared owner "
                        f"'{owner}'): a second writer corrupts state "
                        "readers only ever expect the owner to advance — "
                        "route the update through the owner thread or "
                        "guard both writers with one lock",
                    )
                continue            # owner's own unlocked writes are the
                                    # single-writer discipline working
            if w.flavor in _RMW_FLAVORS:
                what = ("check-then-set" if w.flavor == "checkset"
                        else "read-modify-write")
                emit(
                    "NHD812", w.path, w.line, w.col,
                    f"non-atomic {what} on shared field '{key}' with no "
                    f"lock held (roots: "
                    f"{_fmt_roots(model, _roots_of(accesses))}): two "
                    "threads interleave the load and the store and one "
                    "update is lost — hold the field's lock across the "
                    "whole operation (or make it owner-thread-only via "
                    "_NHD_RACE_OWNER)",
                )
            else:
                emit(
                    "NHD810", w.path, w.line, w.col,
                    f"unsynchronized write to shared field '{key}' "
                    f"(concurrent access at {_witness(accesses, w)}; "
                    f"roots: {_fmt_roots(model, _roots_of(accesses))}): "
                    "no single lock is held across all accesses — guard "
                    "every access with one lock, or declare the owning "
                    "thread in the ownership registry if it is "
                    "single-writer by design",
                )

    # NHD813: mutable structures handed raw to a new thread
    for fn, ev, target_qual in model.spawns:
        if fn.module is None:
            continue
        _ref, publish, _multiple, kind = ev.target
        for scoped in publish:
            key = f"{fn.module.label}:{scoped}"
            if not model.is_mutable(key):
                continue
            live = [a for a in model.fields.get(key, []) if not a.init]
            writers = [a for a in live if a.flavor in _WRITE_FLAVORS]
            if not writers:
                continue            # effectively frozen after construction
            if all(a.held for a in writers) and ev.held:
                continue            # publisher and spawn share discipline
            emit(
                "NHD813", fn.path, ev.line, ev.col,
                f"mutable field '{key}' passed raw to a {kind} thread "
                f"target (spawned here, still written at "
                f"{writers[0].path}:{writers[0].line}): the new thread "
                "iterates/reads the live structure while the publisher "
                "mutates it — hand it a copy (dict(x)/list(x)/x.copy()) "
                "or guard both sides with one lock",
            )
    return out


def _roots_of(accesses: List[Access]):
    roots: Set[str] = set()
    for a in accesses:
        roots |= a.roots
    return roots
