"""nhdrace shared-state model — the static half of the two-layer race
detector (rules_races.py judges it; nhd_tpu_torch/sanitizer/races.py is the
runtime half, keyed on the same field identities).

Built on the lockgraph machinery (same module/function indexing, same
call-graph resolution, same ``with <lock>:`` held-set tracking) so the
two project packs never disagree about what a lock or a call edge is:

1. **thread-root inventory** — every entry point that runs off the main
   thread: ``Thread(target=...)`` / ``Timer(...)`` spawn sites resolved
   through the call-ref machinery, ``pool.submit(fn, ...)`` workers
   (multiplicity > 1 by construction), ``threading.Thread`` subclass
   ``run`` methods, HTTP handler ``do_*`` methods, plus the declared
   :data:`EXTRA_ROOTS` (the scheduler loop, gRPC handler methods) that
   no spawn expression in the analyzed set names;
2. **callable-attribute bindings** — ``CommitPipeline(heartbeat=
   self._beat)`` stores a bound method into ``self._heartbeat``; the
   binding is recovered from the constructor call plus the ``__init__``
   body, so ``self._heartbeat()`` on the worker thread resolves to
   ``Scheduler._beat`` and the heartbeat field is correctly shared;
3. **shared-field registry** — module globals and ``self.X`` attributes
   reachable from >= 2 roots (or from one root spawned with
   multiplicity), keyed ``"mod/label:Class.attr"`` — the exact key the
   lock registry and the runtime race sanitizer use, so a dynamic race
   witness names its static finding;
4. **per-access locksets** — locks held lexically at the access, plus
   the must-hold-on-entry set (intersection over every call path from a
   root, to the same fixed point lockgraph uses for may-acquire).

Ownership (single-writer state) is declared in two places: the central
:data:`OWNERSHIP` table below (live-tree architecture facts: every
``Scheduler`` mirror field is mutated on the scheduler loop only — HTTP
and gRPC views read through the ``ask_scheduler`` RPC queue), and
in-module ``_NHD_RACE_OWNER = {"field": "owner-glob"}`` declarations
(module- or class-level) for state whose owner is a local fact.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field as _dcfield
from fnmatch import fnmatch
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from nhd_tpu_torch.analysis.core import ModuleSource, _dotted
from nhd_tpu_torch.analysis.lockgraph import (
    LockGraphAnalysis,
    _Event,
    _Func,
    _FuncWalker,
    _self_attr,
)

# path scope: production packages only. tools/ and tests/ spawn threads
# freely around fixtures and harnesses; judging them would drown the
# pack in scaffolding noise (the races_out_of_scope fixture pins this).
_SCOPE_PARTS = ("nhd_tpu_torch",)


def in_scope(path: str) -> bool:
    return any(p in _SCOPE_PARTS for p in Path(path).with_suffix("").parts)


# single-writer ownership, field-key glob -> owner-root glob (matched
# against the owning root's entry-function qual). Architecture facts,
# not guesses: keep entries justified.
OWNERSHIP: Tuple[Tuple[str, str], ...] = (
    # every Scheduler mirror/bookkeeping field is mutated on the
    # scheduler loop thread; HTTP/gRPC views go through ask_scheduler
    # (RpcMsgType over mainq) and never touch the object directly
    ("scheduler/core:Scheduler.*", "*scheduler/core:Scheduler.run"),
    # the port's CLI entry thread installs the journal before it starts
    # the thread set and tears it down at exit; the other threads only
    # read the pointer, and a writer read just before the teardown drops
    # its events after finalize under its own lock
    ("obs/journal:_JOURNAL", "nhd_tpu_torch/cli:main"),
)

# roots no spawn expression in the analyzed set names: the scheduler
# loop is started by the CLI entry process, gRPC handler methods are
# dispatched by the grpc server's thread pool. The port adds its own:
# the CLI's entry thread, which starts the thread set and then serves
# signals and the exit (trace dump, launch counts) beside it, and the
# streaming tiler's tile workers (pool threads, one tile stage each),
# declared so a submit behind a helper still counts as a root.
EXTRA_ROOTS: Tuple[str, ...] = (
    "*scheduler/core:Scheduler.run",
    "*rpc/server:NHDControlHandler.Get*",
    "nhd_tpu_torch/cli:main",
    "*solver/streaming:StreamingScheduler._schedule_inner.<locals>.run_tile",
)

# http.server dispatches these on a per-connection handler thread
_HANDLER_METHODS = {
    "do_GET", "do_POST", "do_PUT", "do_PATCH", "do_DELETE", "do_HEAD",
}

# container methods that mutate the receiver in place
_MUTATORS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "remove", "discard", "clear", "setdefault", "appendleft", "popleft",
}

# wrapping a field in one of these hands the new thread a copy, not the
# shared structure (judged at spawn sites for NHD813)
_COPY_WRAPPERS = {
    "dict", "list", "set", "tuple", "sorted", "frozenset", "copy",
    "deepcopy",
}

_MUTABLE_CTORS = {
    "dict", "list", "set", "defaultdict", "deque", "OrderedDict",
    "Counter",
}

_INIT_METHODS = {"__init__", "__post_init__", "__new__"}

_WRITE_FLAVORS = ("write", "rmw", "checkset", "mutate")


def _is_mutable_expr(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d is not None and d.split(".")[-1] in _MUTABLE_CTORS:
            return True
    return False


# ---------------------------------------------------------------------------
# event extraction: lockgraph's walker + field accesses / spawns / bindings
# ---------------------------------------------------------------------------

class _AccessWalker(_FuncWalker):
    """Records, on top of acquire/call/block events (whose consumers
    dispatch on ev.kind and ignore the additions):

    * ``access`` events — target ``(scoped_field, flavor)`` with flavor
      read/write/rmw/checkset/mutate; scoped_field is ``"Cls.attr"`` for
      ``self.X`` or the bare name for a module global;
    * ``spawn`` events — target ``(entry_ref, publish_fields, multiple,
      kind)`` for thread/timer/pool-submit sites;
    * ``ctorbind`` events — target ``(ctor_ref, ((param, value_ref),
      ...))`` wherever a method/function reference is passed as a
      constructor/call argument (callable-attribute resolution).
    """

    def __init__(self, mod, func):
        super().__init__(mod, func)
        self._guards: List[Set[str]] = []   # fields read by enclosing ifs
        self._loop = 0

    # -- field identification ------------------------------------------

    def _field_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and self.func.cls is not None:
            return f"{self.func.cls}.{attr}"
        if isinstance(expr, ast.Name):
            if expr.id in getattr(self.mod, "race_globals", ()):
                return expr.id
        return None

    def _access(self, scoped: str, flavor: str, node: ast.AST,
                held: FrozenSet[str]) -> None:
        self.func.events.append(_Event(
            "access", (scoped, flavor), held, node.lineno, node.col_offset,
        ))

    # -- traversal ------------------------------------------------------

    def _visit(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.If):
            # check-then-set: a write in the body of an if whose test
            # read the same field is one non-atomic read-modify-write
            self._visit(node.test, held)
            self._guards.append(self._fields_in(node.test))
            try:
                for child in node.body:
                    self._visit(child, held)
            finally:
                self._guards.pop()
            for child in node.orelse:
                self._visit(child, held)
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            self._loop += 1
            try:
                super()._visit(node, held)
            finally:
                self._loop -= 1
            return
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._record_store(tgt, node, held)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._record_store(node.target, node, held)
        elif isinstance(node, ast.AugAssign):
            self._record_store(node.target, node, held, aug=True)
        elif isinstance(node, ast.Call):
            self._record_call_extras(node, held)
        elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            scoped = self._field_of(node)
            if scoped is not None:
                self._access(scoped, "read", node, held)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            scoped = self._field_of(node)
            if scoped is not None:
                self._access(scoped, "read", node, held)
        super()._visit(node, held)

    def _fields_in(self, expr: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(expr):
            scoped = self._field_of(node)
            if scoped is not None:
                out.add(scoped)
        return out

    def _record_store(self, tgt: ast.AST, stmt: ast.AST,
                      held: FrozenSet[str], aug: bool = False) -> None:
        flavor = "rmw" if aug else "write"
        while isinstance(tgt, ast.Subscript):
            # self.d[k] = v mutates the container self.d holds
            tgt = tgt.value
            if not aug:
                flavor = "mutate"
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._record_store(el, stmt, held, aug=aug)
            return
        scoped = self._field_of(tgt)
        if scoped is None:
            return
        if not aug and any(scoped in g for g in self._guards):
            flavor = "checkset"
        self._access(scoped, flavor, stmt, held)

    # -- spawns + callable bindings ------------------------------------

    def _value_ref(self, expr: ast.AST):
        """A call-ref for a bare callable expression (mirror of
        _callee_ref, which only looks at Call.func)."""
        attr = _self_attr(expr)
        if attr is not None and self.func.cls is not None:
            return ("method", self.func.cls, attr)
        if isinstance(expr, ast.Name):
            if expr.id in self.mod.import_funcs:
                return ("ext", *self.mod.import_funcs[expr.id])
            return ("local", expr.id)
        d = _dotted(expr)
        if d is not None and "." in d:
            head, _, _rest = d.partition(".")
            mod_part, _, fn_part = d.rpartition(".")
            if head in self.mod.import_mods:
                real = self.mod.import_mods[head]
                if mod_part == head:
                    mod_part = real
                return ("ext", mod_part, fn_part)
        return None

    def _publishes(self, exprs: List[ast.AST]) -> Tuple[str, ...]:
        """Fields handed to the new thread raw (no copy wrapper)."""
        out: List[str] = []
        stack = list(exprs)
        while stack:
            e = stack.pop()
            if isinstance(e, (ast.Tuple, ast.List)):
                stack.extend(e.elts)
                continue
            if isinstance(e, ast.Call):
                d = _dotted(e.func)
                tail = d.split(".")[-1] if d else (
                    e.func.attr if isinstance(e.func, ast.Attribute) else ""
                )
                if tail in _COPY_WRAPPERS or tail == "copy":
                    continue        # dict(self.x) / self.x.copy(): owned
                stack.extend(e.args)
                continue
            scoped = self._field_of(e)
            if scoped is not None:
                out.append(scoped)
        return tuple(sorted(set(out)))

    def _record_call_extras(self, node: ast.Call,
                            held: FrozenSet[str]) -> None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS):
            scoped = self._field_of(node.func.value)
            if scoped is not None:
                self._access(scoped, "mutate", node, held)
        d = _dotted(node.func)
        tail = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None
        )
        entry = None
        publish: List[ast.AST] = []
        kind = None
        if tail == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    entry = kw.value
                elif kw.arg in ("args", "kwargs"):
                    publish.append(kw.value)
            kind = "thread"
        elif tail == "Timer":
            if len(node.args) >= 2:
                entry = node.args[1]
                publish.extend(node.args[2:])
            for kw in node.keywords:
                if kw.arg == "function":
                    entry = kw.value
                elif kw.arg in ("args", "kwargs"):
                    publish.append(kw.value)
            kind = "timer"
        elif tail == "submit" and isinstance(node.func, ast.Attribute):
            if node.args:
                entry = node.args[0]
                publish.extend(node.args[1:])
                publish.extend(kw.value for kw in node.keywords)
            kind = "pool"
        elif tail == "start_new_thread":
            if node.args:
                entry = node.args[0]
                publish.extend(node.args[1:])
            kind = "thread"
        if kind is not None and entry is not None:
            ref = self._value_ref(entry)
            multiple = kind == "pool" or self._loop > 0
            self.func.events.append(_Event(
                "spawn", (ref, self._publishes(publish), multiple, kind),
                held, node.lineno, node.col_offset,
            ))
            return
        # callable-attribute bindings: Ctor(..., heartbeat=self._beat)
        bindings: List[Tuple[object, object]] = []
        for i, arg in enumerate(node.args):
            ref = self._method_ref(arg)
            if ref is not None:
                bindings.append((i, ref))
        for kw in node.keywords:
            if kw.arg is None:
                continue
            ref = self._method_ref(kw.value)
            if ref is not None:
                bindings.append((kw.arg, ref))
        if bindings:
            callee = self._callee_ref(node)
            if callee is not None:
                self.func.events.append(_Event(
                    "ctorbind", (callee, tuple(bindings)), held,
                    node.lineno, node.col_offset,
                ))

    def _method_ref(self, expr: ast.AST):
        """Only method/function references qualify as callable bindings
        (a bare Name that is not a known function is just data)."""
        attr = _self_attr(expr)
        if attr is not None and self.func.cls is not None:
            return ("method", self.func.cls, attr)
        if isinstance(expr, ast.Name) and expr.id in self.mod.import_funcs:
            return ("ext", *self.mod.import_funcs[expr.id])
        if isinstance(expr, ast.Name) and (
            expr.id in self.mod.funcs or expr.id in getattr(
                self.func, "nested", {}
            )
        ):
            return ("local", expr.id)
        return None


# ---------------------------------------------------------------------------
# per-class facts for binding + mutability + ownership declarations
# ---------------------------------------------------------------------------

@dataclass
class _ClassInfo:
    name: str
    mod_label: str
    init_params: Tuple[str, ...] = ()       # positional (for index lookup)
    all_params: FrozenSet[str] = frozenset()  # positional + keyword-only
    attr_of_param: Dict[str, str] = _dcfield(default_factory=dict)
    owner_decl: Dict[str, str] = _dcfield(default_factory=dict)
    mutable_attrs: Set[str] = _dcfield(default_factory=set)
    thread_subclass: bool = False


def _const_str_dict(expr: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if isinstance(expr, ast.Dict):
        for k, v in zip(expr.keys, expr.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out[k.value] = v.value
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Root:
    rid: str            # entry-function qual (the stable identity)
    kind: str           # thread | timer | pool | handler | run | declared
    site: str           # where it was inventoried
    multiple: bool      # > 1 concurrent instance possible


@dataclass(frozen=True)
class Access:
    key: str            # "mod/label:Cls.attr" or "mod/label:NAME"
    flavor: str         # read | write | rmw | checkset | mutate
    held: FrozenSet[str]
    path: str
    line: int
    col: int
    fn_qual: str
    roots: FrozenSet[str]
    init: bool          # constructor writing its own instance's field


class _OwnershipAnalysis(LockGraphAnalysis):
    walker_cls = _AccessWalker


class RaceModel:
    """Thread roots + shared-field registry + per-access locksets."""

    def __init__(self, modules: Sequence[ModuleSource]):
        self.analysis = _OwnershipAnalysis(modules)
        # pre-collect module globals so the walkers (which run inside
        # analysis.run) can classify bare-Name accesses
        for mod in self.analysis.modules:
            names: Set[str] = set()
            mutable: Set[str] = set()
            owner: Dict[str, str] = {}
            for node in mod.tree.body:
                tgts: List[ast.AST] = []
                value = None
                if isinstance(node, ast.Assign):
                    tgts, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    tgts, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    tgts = [node.target]
                for t in tgts:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                        if value is not None and _is_mutable_expr(value):
                            mutable.add(t.id)
                        if t.id == "_NHD_RACE_OWNER" and value is not None:
                            owner.update(_const_str_dict(value))
            names.discard("_NHD_RACE_OWNER")
            mod.race_globals = names            # type: ignore[attr-defined]
            mod.race_mutable = mutable          # type: ignore[attr-defined]
            mod.race_owner = owner              # type: ignore[attr-defined]
        self.classes: Dict[Tuple[str, str], _ClassInfo] = {}
        self.roots: Dict[str, Root] = {}
        self.roots_of: Dict[str, Set[str]] = {}
        self.entry_locks: Dict[str, Optional[FrozenSet[str]]] = {}
        self.callable_attrs: Dict[Tuple[str, str, str], Set[str]] = {}
        self.fields: Dict[str, List[Access]] = {}
        self.spawns: List[Tuple[_Func, _Event, Optional[str]]] = []
        self._built = False

    # -- construction ---------------------------------------------------

    def build(self) -> None:
        if self._built:
            return
        self._built = True
        self.analysis.run()
        self._collect_classes()
        self._collect_bindings()
        self._collect_roots()
        self._propagate_reachability()
        self._propagate_entry_locks()
        self._collect_fields()

    def _collect_classes(self) -> None:
        for mod in self.analysis.modules:
            for node in mod.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                info = _ClassInfo(node.name, mod.label)
                for base in node.bases:
                    d = _dotted(base)
                    if d is not None and d.split(".")[-1].endswith("Thread"):
                        info.thread_subclass = True
                for sub in node.body:
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            if (isinstance(t, ast.Name)
                                    and t.id == "_NHD_RACE_OWNER"):
                                info.owner_decl.update(
                                    _const_str_dict(sub.value)
                                )
                    if (isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))):
                        if sub.name == "__init__":
                            # positional index lookups use init_params;
                            # keyword bindings resolve by name, so
                            # keyword-only params count too
                            info.init_params = tuple(
                                a.arg for a in sub.args.args[1:]
                            )
                            info.all_params = frozenset(
                                info.init_params
                            ) | {a.arg for a in sub.args.kwonlyargs}
                        for st in ast.walk(sub):
                            if not isinstance(st, ast.Assign):
                                continue
                            for t in st.targets:
                                attr = _self_attr(t)
                                if attr is None:
                                    continue
                                if _is_mutable_expr(st.value):
                                    info.mutable_attrs.add(attr)
                                if (sub.name == "__init__"
                                        and isinstance(st.value, ast.Name)
                                        and st.value.id in info.all_params):
                                    info.attr_of_param[st.value.id] = attr
                self.classes[(mod.label, node.name)] = info

    def _class_of_ref(self, caller: _Func, ref) -> Optional[_ClassInfo]:
        if ref is None:
            return None
        mod = caller.module
        if ref[0] == "local":
            return self.classes.get((mod.label, ref[1]))
        if ref[0] == "ext":
            dotted, name = ref[1], ref[2]
            parts = dotted.split(".")
            for k in range(len(parts), 0, -1):
                cand = self.analysis._by_suffix.get(".".join(parts[-k:]))
                if cand is not None:
                    return self.classes.get((cand.label, name))
        return None

    def _collect_bindings(self) -> None:
        """Ctor(param=self._beat) + 'self.attr = param' in __init__ =>
        calls of self.attr() inside that class resolve to the bound
        method (union over every construction site)."""
        for fn in self.analysis.funcs.values():
            for ev in fn.events:
                if ev.kind != "ctorbind":
                    continue
                ctor_ref, bindings = ev.target
                info = self._class_of_ref(fn, ctor_ref)
                if info is None:
                    continue
                for param, value_ref in bindings:
                    if isinstance(param, int):
                        if param >= len(info.init_params):
                            continue
                        param = info.init_params[param]
                    attr = info.attr_of_param.get(param)
                    if attr is None:
                        continue
                    target = self.analysis._resolve(fn, value_ref)
                    if target is None:
                        continue
                    self.callable_attrs.setdefault(
                        (info.mod_label, info.name, attr), set()
                    ).add(target.qual)

    def _add_root(self, fn: _Func, kind: str, site: str,
                  multiple: bool) -> None:
        cur = self.roots.get(fn.qual)
        if cur is None:
            self.roots[fn.qual] = Root(fn.qual, kind, site, multiple)
        elif multiple and not cur.multiple:
            self.roots[fn.qual] = Root(cur.rid, cur.kind, cur.site, True)

    def _collect_roots(self) -> None:
        for fn in self.analysis.funcs.values():
            for ev in fn.events:
                if ev.kind != "spawn":
                    continue
                ref, _publish, multiple, kind = ev.target
                target = (self.analysis._resolve(fn, ref)
                          if ref is not None else None)
                self.spawns.append(
                    (fn, ev, target.qual if target else None)
                )
                if target is not None:
                    self._add_root(
                        target, kind, f"{fn.path}:{ev.line}", multiple
                    )
        for (mod_label, name), info in self.classes.items():
            if not info.thread_subclass:
                continue
            run = self.analysis.funcs.get(f"{mod_label}:{name}.run")
            if run is not None:
                self._add_root(run, "thread", run.path, False)
        for fn in self.analysis.funcs.values():
            tail = fn.qual.rsplit(".", 1)[-1]
            if tail in _HANDLER_METHODS:
                self._add_root(fn, "handler", fn.path, True)
            elif any(fnmatch(fn.qual, pat) for pat in EXTRA_ROOTS):
                self._add_root(fn, "declared", fn.path, False)

    def _call_targets(self, fn: _Func, ref) -> List[_Func]:
        hit = self.analysis._resolve(fn, ref)
        if hit is not None:
            return [hit]
        if ref is not None and ref[0] == "method" and fn.module is not None:
            quals = self.callable_attrs.get(
                (fn.module.label, ref[1], ref[2]), ()
            )
            return [self.analysis.funcs[q] for q in quals]
        return []

    def _propagate_reachability(self) -> None:
        for rid, root in self.roots.items():
            entry = self.analysis.funcs.get(rid)
            if entry is None:
                continue
            stack, seen = [entry], set()
            while stack:
                fn = stack.pop()
                if fn.qual in seen:
                    continue
                seen.add(fn.qual)
                self.roots_of.setdefault(fn.qual, set()).add(rid)
                for ev in fn.events:
                    if ev.kind == "call":
                        stack.extend(self._call_targets(fn, ev.target))

    def _propagate_entry_locks(self) -> None:
        """Must-hold-on-entry per function: TOP (unconstrained) meets,
        over every call edge, the caller's entry set union the locks
        held at the call site; roots and spawn targets enter with
        nothing held."""
        TOP = None
        entry: Dict[str, Optional[FrozenSet[str]]] = {
            q: TOP for q in self.analysis.funcs
        }

        def meet(qual: str, s: FrozenSet[str]) -> bool:
            cur = entry.get(qual, TOP)
            new = s if cur is TOP else cur & s
            if new != cur:
                entry[qual] = new
                return True
            return False

        for rid in self.roots:
            if rid in entry:
                entry[rid] = frozenset()
        changed, rounds = True, 0
        while changed and rounds < 50:
            changed, rounds = False, rounds + 1
            for fn in self.analysis.funcs.values():
                base = entry.get(fn.qual)
                if base is TOP:
                    continue
                for ev in fn.events:
                    if ev.kind == "call":
                        cs = base | ev.held
                        for callee in self._call_targets(fn, ev.target):
                            changed |= meet(callee.qual, cs)
                    elif ev.kind == "spawn":
                        ref = ev.target[0]
                        target = (self.analysis._resolve(fn, ref)
                                  if ref is not None else None)
                        if target is not None:
                            changed |= meet(target.qual, frozenset())
        self.entry_locks = entry

    def _field_key(self, mod_label: str, scoped: str) -> str:
        return f"{mod_label}:{scoped}"

    def _collect_fields(self) -> None:
        for fn in self.analysis.funcs.values():
            if fn.module is None:
                continue
            roots = frozenset(self.roots_of.get(fn.qual, ()))
            entry = self.entry_locks.get(fn.qual) or frozenset()
            for ev in fn.events:
                if ev.kind != "access":
                    continue
                scoped, flavor = ev.target
                key = self._field_key(fn.module.label, scoped)
                init = (
                    "." in scoped
                    and fn.qual.rsplit(".", 1)[-1] in _INIT_METHODS
                    and fn.cls is not None
                    and scoped.startswith(f"{fn.cls}.")
                )
                self.fields.setdefault(key, []).append(Access(
                    key, flavor, frozenset(ev.held | entry), fn.path,
                    ev.line, ev.col, fn.qual, roots, init,
                ))

    # -- queries --------------------------------------------------------

    def _instance_local(self, key: str, rid: str) -> bool:
        """http.server builds one handler *instance per connection*: a
        do_* root touching its own class's self.X state is thread-local
        by construction, not shared (per-request response flags, etc.)."""
        root = self.roots[rid]
        if root.kind != "handler":
            return False
        label, _, scoped = key.partition(":")
        if "." not in scoped:
            return False
        rlabel, _, rqual = rid.partition(":")
        return rlabel == label and rqual.split(".", 1)[0] == \
            scoped.split(".", 1)[0]

    def shared_fields(self) -> Dict[str, List[Access]]:
        """Fields accessed from >= 2 roots (or one multi-instance root)
        with at least one non-init write — the race candidate registry."""
        out: Dict[str, List[Access]] = {}
        for key, accesses in self.fields.items():
            live = [a for a in accesses if not a.init and a.roots]
            roots: Set[str] = set()
            for a in live:
                roots |= a.roots
            if not any(a.flavor in _WRITE_FLAVORS for a in live):
                continue
            roots = {r for r in roots if not self._instance_local(key, r)}
            multi = len(roots) >= 2 or any(
                self.roots[r].multiple for r in roots
            )
            if multi:
                out[key] = live
        return out

    def owner_of(self, key: str) -> Optional[str]:
        """The declared owner-root glob for a field key, if any."""
        label, _, scoped = key.partition(":")
        for mod in self.analysis.modules:
            if mod.label != label:
                continue
            decl = getattr(mod, "race_owner", {})
            if scoped in decl:
                return decl[scoped]
            if "." in scoped:
                cls, _, attr = scoped.partition(".")
                info = self.classes.get((label, cls))
                if info is not None and attr in info.owner_decl:
                    return info.owner_decl[attr]
        for pat, owner in OWNERSHIP:
            if fnmatch(key, pat):
                return owner
        return None

    def is_mutable(self, key: str) -> bool:
        label, _, scoped = key.partition(":")
        if "." in scoped:
            cls, _, attr = scoped.partition(".")
            info = self.classes.get((label, cls))
            return info is not None and attr in info.mutable_attrs
        for mod in self.analysis.modules:
            if mod.label == label:
                return scoped in getattr(mod, "race_mutable", ())
        return False


def build_model(modules: Sequence[ModuleSource]) -> RaceModel:
    model = RaceModel([m for m in modules if in_scope(m.path)])
    model.build()
    return model
