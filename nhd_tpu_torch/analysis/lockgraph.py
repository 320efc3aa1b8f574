"""NHD21x — interprocedural lock-graph analysis (project pack 'lockgraph').

PR 1's NHD2xx rules judge one function at a time; the deadlock that cost
the tier-1 budget was a *cross-module* blocking cycle (streaming tile
workers holding solver state while pjit collectives waited forever).
This pack analyzes the whole path set at once:

1. **lock registry** — every ``threading.Lock/RLock/Condition`` bound to
   a module-level name or a ``self.X``/class attribute, with its
   construction site and reentrancy kind (``Condition(self.X)`` aliases
   the lock it wraps, as in rules_locks);
2. **call graph** — module-local calls (``f()``, ``self.m()``,
   ``cls.m()``) plus cross-module edges resolved through ``import`` /
   ``from ... import`` (absolute and relative) against the analyzed set;
3. **per-function summaries** — which locks a function acquires, which
   calls and known-blocking operations it performs, and which locks are
   held at each of those program points (``with <lock>:`` nesting);
4. **transitive facts** — ``may_acquire(f)`` / ``may_block(f)``
   propagated over the call graph to a fixed point, each fact carrying a
   shortest witness chain for the diagnostic.

Rules emitted:

* **NHD210** lock-order inversion: the whole-program lock-order graph
  (edges L→M: M acquired, possibly through calls, while L is held)
  contains both L→M and M→L. Reported at both witness sites.
* **NHD211** blocking call while a lock is held: an unbounded
  ``.get()``/``.join()``/``.wait()``, a socket ``recv``/``accept``, or a
  solver/pjit entry point (``solve_bucket``/``solve_bucket_ranked_sharded``)
  executes — directly or through the call graph — under a held lock.
  ``Condition.wait`` releases *its own* lock, so that lock is subtracted
  before judging.
* **NHD212** re-entrant acquisition of a non-reentrant ``Lock``: a call
  path from a ``with self.X:`` body re-enters ``with self.X:`` (the
  callback-under-lock shape — the scheduler thread invoking a callback
  that takes the lock it already holds deadlocks itself).

Blocking-call heuristics lean on call-shape, not type inference: a
no-positional-arg ``.get()``/``.join()``/``.wait()`` cannot be
``dict.get``/``str.join`` (those require an argument), and a ``timeout=``
keyword (any value) marks the wait bounded, hence not a deadlock.

The same machinery exports the lock graph (``build_lock_graph`` →
JSON-ready dict, ``lock_graph_dot`` → Graphviz) so the runtime witnesses
nhdsan records (``nhd_tpu_torch/sanitizer/``) correlate with static facts by
lock construction site.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from nhd_tpu_torch.analysis.core import Finding, ModuleSource, _dotted

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
# names that dispatch a (potentially unbounded) sharded/pjit solve — the
# scheduler's own "collective rendezvous" entry points
_SOLVER_ENTRYPOINTS = {
    "solve_bucket", "solve_bucket_ranked", "solve_bucket_ranked_sharded",
}
_MAX_CHAIN = 4          # witness chains are truncated for readability


# ---------------------------------------------------------------------------
# small shared helpers
# ---------------------------------------------------------------------------

def _mod_label(path: str) -> str:
    """Stable per-module label: last two path components, extension
    dropped — agrees between the gate's absolute paths and the CLI's
    relative ones (same convention as Finding.fingerprint)."""
    parts = Path(path).with_suffix("").parts
    return "/".join(parts[-2:]) if len(parts) >= 2 else parts[0]


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id in ("self", "cls"):
            return node.attr
    return None


@dataclass(frozen=True)
class Lock:
    key: str            # "mod/label:Class.attr" or "mod/label:NAME"
    name: str           # display: "Class.attr" / "NAME"
    kind: str           # "Lock" | "RLock" | "Condition"
    path: str
    line: int

    @property
    def site(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def reentrant(self) -> bool:
        # Condition() owns an RLock; Condition(self.X) aliases X and is
        # resolved to X before this is consulted
        return self.kind in ("RLock", "Condition")


@dataclass
class _Event:
    """One program point inside a function: a lock acquisition, a call,
    or a known-blocking operation — with the locks held on entry."""

    kind: str                       # "acquire" | "call" | "block"
    target: object                  # lock key | callee ref | block desc
    held: FrozenSet[str]
    line: int
    col: int


@dataclass
class _Func:
    qual: str           # "mod/label:Class.method[.<locals>.inner]"
    path: str
    line: int
    cls: Optional[str]
    module: object = None           # owning _Module (set at index time)
    parent: Optional["_Func"] = None    # enclosing function, if nested
    nested: Dict[str, "_Func"] = field(default_factory=dict)
    events: List[_Event] = field(default_factory=list)


# callee references, resolved lazily against the project
# ("local", name) / ("method", cls, name) / ("ext", dotted_mod, name)
_CallRef = Tuple


def _direct_nested_defs(fn: ast.AST):
    """Function defs nested directly in *fn*'s body (not inside deeper
    defs or nested classes) — each becomes its own summarized function."""
    stack = list(fn.body)  # type: ignore[attr-defined]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
            continue
        if isinstance(node, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _Module:
    """Per-module facts: locks, aliases, functions, import bindings."""

    def __init__(self, source: ModuleSource):
        self.path = source.path
        self.tree = source.tree
        self.label = _mod_label(source.path)
        self.locks: Dict[str, Lock] = {}        # scoped name -> Lock
        self.alias: Dict[str, str] = {}         # cond key -> lock key
        self.funcs: Dict[str, _Func] = {}       # "func" / "Cls.meth" -> _Func
        self.import_funcs: Dict[str, Tuple[str, str]] = {}  # local -> (mod, name)
        self.import_mods: Dict[str, str] = {}   # local alias -> dotted module

    # -- lock + import discovery ---------------------------------------

    def _lock_ctor_kind(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        d = _dotted(node.func)
        if d is None:
            return None
        tail = d.split(".")[-1]
        return tail if tail in _LOCK_CTORS else None

    def _dotted_of_import(self, node: ast.ImportFrom) -> Optional[str]:
        """Absolute dotted target of an ImportFrom, resolving relative
        levels against this module's path tail."""
        if node.level == 0:
            return node.module
        parts = list(Path(self.path).parts[:-1])  # containing package dirs
        drop = node.level - 1
        if drop:
            parts = parts[:-drop] if drop <= len(parts) else []
        base = [p for p in parts if p not in (".", "/")]
        mod = list(node.module.split(".")) if node.module else []
        return ".".join(base[-3:] + mod) if (base or mod) else None

    def collect(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                kind = self._lock_ctor_kind(node.value)
                if kind:
                    cond_arg = None
                    if kind == "Condition" and node.value.args:  # type: ignore[union-attr]
                        arg = node.value.args[0]  # type: ignore[union-attr]
                        if isinstance(arg, ast.Name):
                            # COND = threading.Condition(LOCK) aliases
                            # LOCK, same as the class-level form
                            cond_arg = arg.id
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self._add_lock(tgt.id, kind, node, cond_arg)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    # 'import a.b.c' binds the name 'a' (dotted calls spell
                    # the full path themselves); 'import a.b.c as z' binds
                    # z directly to a.b.c
                    local = a.asname or a.name.split(".")[0]
                    self.import_mods[local] = a.name if a.asname else local
            elif isinstance(node, ast.ImportFrom):
                dotted = self._dotted_of_import(node)
                if dotted is None:
                    continue
                for a in node.names:
                    self.import_funcs[a.asname or a.name] = (dotted, a.name)
            elif isinstance(node, ast.ClassDef):
                self._collect_class_locks(node)
        # resolve Condition(self.X) aliases now that every lock is known
        for cond_key, lock_key in list(self.alias.items()):
            if lock_key not in self.locks and cond_key in self.alias:
                del self.alias[cond_key]

    def _add_lock(self, scoped: str, kind: str, node: ast.AST,
                  cond_arg: Optional[str] = None) -> None:
        key = f"{self.label}:{scoped}"
        if scoped not in self.locks:
            self.locks[scoped] = Lock(key, scoped, kind, self.path, node.lineno)
        if cond_arg is not None:
            self.alias[scoped] = cond_arg

    def _collect_class_locks(self, cls: ast.ClassDef) -> None:
        class_level = {id(n) for n in cls.body}
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            kind = self._lock_ctor_kind(node.value)
            if not kind:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if (attr is None and isinstance(tgt, ast.Name)
                        and id(node) in class_level):
                    # bare-name locks only at class level: a function
                    # LOCAL 'lock = threading.Lock()' has no cross-call
                    # identity the AST can track (that's nhdsan's job at
                    # runtime) and must not masquerade as a class lock
                    attr = tgt.id
                if attr is None:
                    continue
                cond_arg = None
                if kind == "Condition" and node.value.args:  # type: ignore[union-attr]
                    inner = _self_attr(node.value.args[0])   # type: ignore[union-attr]
                    if inner is not None:
                        cond_arg = f"{cls.name}.{inner}"
                self._add_lock(f"{cls.name}.{attr}", kind, node, cond_arg)

    # -- lock expression resolution ------------------------------------

    def lock_key_of(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        """Resolve a with-item / receiver expression to a canonical lock
        key (following Condition aliases), or None if untracked."""
        scoped: Optional[str] = None
        attr = _self_attr(expr)
        if attr is not None and cls is not None:
            scoped = f"{cls}.{attr}"
        elif isinstance(expr, ast.Name) and expr.id in self.locks:
            scoped = expr.id
        if scoped is None or scoped not in self.locks:
            return None
        scoped = self.alias.get(scoped, scoped)
        return self.locks[scoped].key if scoped in self.locks else None


# ---------------------------------------------------------------------------
# per-function event extraction
# ---------------------------------------------------------------------------

def _blocking_desc(call: ast.Call) -> Optional[str]:
    """A human description if *call* is a known potentially-unbounded
    blocking operation, else None."""
    kwnames = {k.arg for k in call.keywords}
    if isinstance(call.func, ast.Attribute):
        name = call.func.attr
        no_pos = not call.args
        bounded = "timeout" in kwnames
        if name == "get" and no_pos and not bounded:
            for k in call.keywords:
                if (k.arg == "block" and isinstance(k.value, ast.Constant)
                        and k.value.value is False):
                    return None
            return ".get() with no timeout"
        if name in ("join", "wait") and no_pos and not bounded:
            return f".{name}() with no timeout"
        if name in ("recv", "recv_into", "accept"):
            return f".{name}() on a socket/pipe"
        if name == "communicate" and not bounded:
            return ".communicate() with no timeout"
    d = _dotted(call.func)
    if d is not None and d.split(".")[-1] in _SOLVER_ENTRYPOINTS:
        return f"{d}() (sharded/pjit solve entry)"
    return None


class _FuncWalker:
    """Walk one function body tracking the set of held (tracked) locks;
    record acquire/call/block events in program order."""

    def __init__(self, mod: _Module, func: _Func):
        self.mod = mod
        self.func = func

    def walk(self, fn: ast.AST) -> None:
        for stmt in fn.body:  # type: ignore[attr-defined]
            self._visit(stmt, frozenset())

    def _visit(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.With):
            now = held
            for item in node.items:
                key = self.mod.lock_key_of(item.context_expr, self.func.cls)
                if key is not None:
                    self.func.events.append(_Event(
                        "acquire", key, now, item.context_expr.lineno,
                        item.context_expr.col_offset,
                    ))
                    now = now | {key}
            for child in node.body:
                self._visit(child, now)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, possibly unlocked: it gets its own
            # summary (_index_functions recurses into closures), and the
            # CALL to it — not its definition — inherits the held set
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _visit_call(self, node: ast.Call, held: FrozenSet[str]) -> None:
        # bare <lock>.acquire() is an ordering fact too (NHD202 already
        # flags the form itself)
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            key = self.mod.lock_key_of(func.value, self.func.cls)
            if key is not None:
                self.func.events.append(_Event(
                    "acquire", key, held, node.lineno, node.col_offset))
                return
        desc = _blocking_desc(node)
        if desc is not None:
            eff = held
            if isinstance(func, ast.Attribute) and func.attr == "wait":
                # Condition.wait releases its own lock while waiting: the
                # condition's (aliased) lock never counts as held across
                # the wait, and a wait on a *tracked* condition with no
                # other lock held is the canonical pattern — not recorded
                # at all, so callers holding the same condition's lock
                # don't inherit a phantom may_block fact
                key = self.mod.lock_key_of(func.value, self.func.cls)
                if key is not None:
                    eff = eff - {key}
                    if not eff:
                        desc = None
            if desc is not None:
                self.func.events.append(_Event(
                    "block", desc, eff, node.lineno, node.col_offset))
                return
        ref = self._callee_ref(node)
        if ref is not None:
            self.func.events.append(_Event(
                "call", ref, held, node.lineno, node.col_offset))

    def _callee_ref(self, node: ast.Call) -> Optional[_CallRef]:
        func = node.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.mod.import_funcs:
                return ("ext", *self.mod.import_funcs[name])
            return ("local", name)
        attr = _self_attr(func)
        if attr is not None and self.func.cls is not None:
            return ("method", self.func.cls, attr)
        d = _dotted(func)
        if d is not None and "." in d:
            head, _, rest = d.partition(".")
            mod_part, _, fn_part = d.rpartition(".")
            if head in self.mod.import_mods and rest:
                # import a.b as z; z.f() — or import a.b.c; a.b.c.f()
                real = self.mod.import_mods[head]
                if mod_part == head:
                    mod_part = real
                return ("ext", mod_part, fn_part)
            if head in self.mod.import_funcs and rest:
                # from pkg import mod; mod.f() — the "func" import was a
                # module object
                base, name = self.mod.import_funcs[head]
                if mod_part == head:
                    return ("ext", f"{base}.{name}", fn_part)
        return None


# ---------------------------------------------------------------------------
# the project analysis
# ---------------------------------------------------------------------------

class LockGraphAnalysis:
    # subclasses (ownership.py) swap in a richer walker that records
    # field accesses alongside the acquire/call/block events; every
    # consumer loop here dispatches on ev.kind, so extra kinds are inert
    walker_cls = _FuncWalker

    def __init__(self, modules: Sequence[ModuleSource]):
        self.modules = [_Module(m) for m in modules]
        self.locks: Dict[str, Lock] = {}
        self.funcs: Dict[str, _Func] = {}       # fid -> func
        self._by_suffix: Dict[str, Optional[_Module]] = {}
        # transitive facts: fid -> lock key -> (chain, site)
        self.may_acquire: Dict[str, Dict[str, Tuple[Tuple[str, ...], str]]] = {}
        # fid -> (desc, chain, site) of one reachable blocking op
        self.may_block: Dict[str, Optional[Tuple[str, Tuple[str, ...], str]]] = {}
        # (L, M) -> witness (path, line, col, via-chain, detail)
        self.order_edges: Dict[
            Tuple[str, str], Tuple[str, int, int, Tuple[str, ...]]
        ] = {}
        self._ran = False

    # -- construction ---------------------------------------------------

    def _register_suffixes(self, mod: _Module) -> None:
        parts = Path(mod.path).with_suffix("").parts
        for k in range(1, min(len(parts), 5) + 1):
            suffix = ".".join(parts[-k:])
            if suffix in self._by_suffix and self._by_suffix[suffix] is not mod:
                self._by_suffix[suffix] = None   # ambiguous: refuse to guess
            else:
                self._by_suffix[suffix] = mod

    def _index_functions(self, mod: _Module) -> None:
        def add(fn: ast.AST, cls: Optional[str], parent: Optional[_Func],
                scoped: str) -> None:
            func = _Func(
                qual=f"{mod.label}:{scoped}", path=mod.path,
                line=fn.lineno, cls=cls, module=mod, parent=parent,
            )
            if parent is None:
                mod.funcs.setdefault(scoped, func)
            else:
                parent.nested[fn.name] = func  # type: ignore[attr-defined]
            self.funcs[func.qual] = func
            self.walker_cls(mod, func).walk(fn)
            # closures: the streaming tile workers (the shape of the real
            # deadlock) are nested defs — they need their own summaries
            for sub in _direct_nested_defs(fn):
                add(sub, cls, func, f"{scoped}.<locals>.{sub.name}")

        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(node, None, None, node.name)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        add(sub, node.name, None, f"{node.name}.{sub.name}")

    def _resolve(self, caller: _Func, ref: _CallRef) -> Optional[_Func]:
        mod: _Module = caller.module  # type: ignore[assignment]
        kind = ref[0]
        if kind == "local":
            # lexical scope chain: own closures first, then siblings via
            # the enclosing function, then module level
            cur: Optional[_Func] = caller
            while cur is not None:
                hit = cur.nested.get(ref[1])
                if hit is not None:
                    return hit
                cur = cur.parent
            return mod.funcs.get(ref[1])
        if kind == "method":
            return mod.funcs.get(f"{ref[1]}.{ref[2]}")
        if kind == "ext":
            dotted, name = ref[1], ref[2]
            target = None
            # longest-suffix match of the dotted module against the set
            parts = dotted.split(".")
            for k in range(len(parts), 0, -1):
                cand = self._by_suffix.get(".".join(parts[-k:]))
                if cand is not None:
                    target = cand
                    break
            if target is None:
                return None
            return target.funcs.get(name)
        return None

    # -- fixed-point propagation ---------------------------------------

    def run(self) -> None:
        if self._ran:
            return
        self._ran = True
        for mod in self.modules:
            mod.collect()
            self._register_suffixes(mod)
            for lock in mod.locks.values():
                # aliased Conditions resolve through lock_key_of; only
                # canonical locks enter the global registry
                self.locks.setdefault(lock.key, lock)
        for mod in self.modules:
            self._index_functions(mod)

        for fid, fn in self.funcs.items():
            acq: Dict[str, Tuple[Tuple[str, ...], str]] = {}
            blk: Optional[Tuple[str, Tuple[str, ...], str]] = None
            for ev in fn.events:
                site = f"{fn.path}:{ev.line}"
                if ev.kind == "acquire" and ev.target not in acq:
                    acq[ev.target] = ((), site)          # type: ignore[index]
                elif ev.kind == "block" and blk is None:
                    blk = (ev.target, (), site)          # type: ignore[assignment]
            self.may_acquire[fid] = acq
            self.may_block[fid] = blk

        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for fid, fn in self.funcs.items():
                for ev in fn.events:
                    if ev.kind != "call":
                        continue
                    callee = self._resolve(fn, ev.target)
                    if callee is None:
                        continue
                    for lk, (chain, site) in self.may_acquire[
                        callee.qual
                    ].items():
                        new_chain = (callee.qual, *chain)[:_MAX_CHAIN]
                        cur = self.may_acquire[fid].get(lk)
                        if cur is None or len(new_chain) < len(cur[0]):
                            self.may_acquire[fid][lk] = (new_chain, site)
                            changed = True
                    cblk = self.may_block[callee.qual]
                    if cblk is not None and self.may_block[fid] is None:
                        desc, chain, site = cblk
                        self.may_block[fid] = (
                            desc, (callee.qual, *chain)[:_MAX_CHAIN], site
                        )
                        changed = True

        # lock-order edges L -> M (M acquired while L held)
        for fid, fn in self.funcs.items():
            for ev in fn.events:
                if ev.kind == "acquire":
                    for l in ev.held:
                        self._edge(l, ev.target, fn, ev, ())  # type: ignore[arg-type]
                elif ev.kind == "call" and ev.held:
                    callee = self._resolve(fn, ev.target)
                    if callee is None:
                        continue
                    for m, (chain, _site) in self.may_acquire[
                        callee.qual
                    ].items():
                        for l in ev.held:
                            self._edge(
                                l, m, fn, ev, (callee.qual, *chain)
                            )

    def _edge(self, l: str, m: str, fn: _Func, ev: _Event,
              via: Tuple[str, ...]) -> None:
        key = (l, m)
        cur = self.order_edges.get(key)
        if cur is None or len(via) < len(cur[3]):
            self.order_edges[key] = (fn.path, ev.line, ev.col, via[:_MAX_CHAIN])

    # -- findings -------------------------------------------------------

    def _name(self, key: str) -> str:
        lock = self.locks.get(key)
        return lock.name if lock else key

    def findings(self) -> List[Finding]:
        self.run()
        out: List[Finding] = []
        seen: Set[Tuple[str, str, int, str]] = set()

        def emit(rule: str, path: str, line: int, col: int, msg: str) -> None:
            k = (rule, path, line, msg)
            if k not in seen:
                seen.add(k)
                out.append(Finding(rule, path, line, col, msg))

        # NHD210: both directions present between two distinct locks
        for (l, m), (path, line, col, via) in sorted(self.order_edges.items()):
            if l >= m:
                continue
            rev = self.order_edges.get((m, l))
            if rev is None:
                continue
            for (a, b), (p, ln, c, chain), other in (
                ((l, m), (path, line, col, via), rev),
                ((m, l), rev, (path, line, col, via)),
            ):
                hop = f" via {' -> '.join(chain)}" if chain else ""
                emit(
                    "NHD210", p, ln, c,
                    f"lock-order inversion: acquires '{self._name(b)}' "
                    f"while holding '{self._name(a)}'{hop}, but "
                    f"{other[0]}:{other[1]} takes them in the opposite "
                    "order — two threads interleaving these paths "
                    "deadlock; pick one global order",
                )

        # NHD212: re-entrant acquisition of a non-reentrant Lock
        for (l, m), (path, line, col, via) in sorted(self.order_edges.items()):
            if l != m:
                continue
            lock = self.locks.get(l)
            if lock is None or lock.reentrant:
                continue
            hop = f" via {' -> '.join(via)}" if via else ""
            emit(
                "NHD212", path, line, col,
                f"re-entrant acquisition of non-reentrant lock "
                f"'{self._name(l)}'{hop}: a callback invoked while the "
                "lock is held re-acquires it and deadlocks the calling "
                "thread — use RLock or move the call outside the lock",
            )

        # NHD211: blocking op (direct or transitive) while a lock is held
        for fid, fn in sorted(self.funcs.items()):
            for ev in fn.events:
                if ev.kind == "block" and ev.held:
                    emit(
                        "NHD211", fn.path, ev.line, ev.col,
                        f"blocking {ev.target} while holding "
                        f"{self._held_names(ev.held)}: every thread "
                        "needing the lock stalls behind this wait (and a "
                        "cycle with the wait's producer deadlocks) — "
                        "release the lock first or bound the wait",
                    )
                elif ev.kind == "call" and ev.held:
                    callee = self._resolve(fn, ev.target)
                    if callee is None:
                        continue
                    blk = self.may_block[callee.qual]
                    if blk is None:
                        continue
                    desc, chain, site = blk
                    path_s = " -> ".join((callee.qual, *chain)[:_MAX_CHAIN])
                    emit(
                        "NHD211", fn.path, ev.line, ev.col,
                        f"call reaches blocking {desc} (at {site} via "
                        f"{path_s}) while holding "
                        f"{self._held_names(ev.held)} — release the lock "
                        "before the call or bound the wait",
                    )
        return out

    def _held_names(self, held: FrozenSet[str]) -> str:
        return ", ".join(f"'{self._name(h)}'" for h in sorted(held))

    # -- export ---------------------------------------------------------

    def graph(self) -> dict:
        """JSON-ready lock graph: nodes keyed like nhdsan keys its
        runtime locks (construction site), so static edges and runtime
        witnesses correlate (docs/OBSERVABILITY.md)."""
        self.run()
        inversions = sorted(
            [l, m] for (l, m) in self.order_edges
            if l < m and (m, l) in self.order_edges
        )
        return {
            "version": 1,
            "locks": [
                {
                    "key": lock.key, "name": lock.name, "kind": lock.kind,
                    "site": lock.site,
                }
                for _, lock in sorted(self.locks.items())
            ],
            "edges": [
                {
                    "from": l, "to": m, "path": path, "line": line,
                    "via": list(via),
                }
                for (l, m), (path, line, _col, via)
                in sorted(self.order_edges.items())
            ],
            "inversions": inversions,
        }


def check_project(modules: Sequence[ModuleSource]) -> List[Finding]:
    return LockGraphAnalysis(modules).findings()


def build_lock_graph(modules: Sequence[ModuleSource]) -> dict:
    return LockGraphAnalysis(modules).graph()


def lock_graph_dot(graph: dict) -> str:
    """Render a build_lock_graph() dict as Graphviz DOT. Inverted pairs
    are drawn red+bold so `dot -Tsvg` makes the deadlock jump out."""
    inverted = {tuple(pair) for pair in graph.get("inversions", [])}
    lines = [
        "digraph nhd_lock_order {",
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
    ]
    for lock in graph["locks"]:
        label = f"{lock['name']}\\n[{lock['kind']}] {lock['site']}"
        lines.append(f'  "{lock["key"]}" [label="{label}"];')
    for edge in graph["edges"]:
        l, m = edge["from"], edge["to"]
        hot = (l, m) in inverted or (m, l) in inverted
        style = ' [color=red, penwidth=2.0]' if hot else ""
        lines.append(f'  "{l}" -> "{m}"{style};')
    lines.append("}")
    return "\n".join(lines) + "\n"
