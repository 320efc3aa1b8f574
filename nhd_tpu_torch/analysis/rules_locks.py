"""NHD2xx — lock discipline for classes that own a threading lock.

The control plane mutates shared scheduler state from watch threads; the
repo's convention is "a class that owns a Lock/RLock guards its mutable
attributes with it". The pack infers the contract instead of requiring
annotations:

1. lock attributes: ``self.X = threading.Lock()/RLock()/Condition()``
   (or a class-level ``X = threading.Lock()``); a Condition built *on*
   a lock attribute is an alias for it;
2. guarded attributes: every attribute the class mutates anywhere inside
   a ``with self.X:`` block is declared lock-guarded;
3. violations: mutating that attribute outside any such block (except in
   ``__init__``, which runs before the object is published).

Mutation means attribute assignment, subscript store/delete, or calling
a known container mutator (append/pop/update/...). Read-only access is
never flagged — the single-writer pattern (scheduler/core.py) reads
snapshots without the lock by design.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from nhd_tpu_torch.analysis.core import Finding

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "sort", "reverse",
    "appendleft", "extendleft", "popleft",
}


def _terminal_attr(node: ast.AST) -> Optional[str]:
    return node.attr if isinstance(node, ast.Attribute) else None


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is self.X or cls.X, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id in ("self", "cls"):
            return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and _terminal_attr(node.func) in _LOCK_CTORS
    )


class _ClassAuditor:
    def __init__(self, cls: ast.ClassDef, path: str):
        self.cls = cls
        self.path = path
        self.lock_attrs: Set[str] = set()
        self.guarded: Set[str] = set()
        # line numbers of guarded-inference sites, for messages
        self.guard_sites: Dict[str, int] = {}

    # -- pass 1: find lock attributes -----------------------------------

    def find_locks(self) -> None:
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None and isinstance(tgt, ast.Name):
                    attr = tgt.id    # class-level: X = threading.Lock()
                if attr is None:
                    continue
                if _is_lock_ctor(node.value):
                    # Condition(self.X) aliases lock X; Condition() owns
                    # its own lock — either way the attr guards state
                    self.lock_attrs.add(attr)

    # -- pass 2/3: guarded inference, then violations -------------------

    def _walk_method(self, fn: ast.FunctionDef, *, collect: bool,
                     findings: Optional[List[Finding]] = None) -> None:
        in_init = fn.name == "__init__"

        def visit(node: ast.AST, held: bool) -> None:
            if isinstance(node, ast.With):
                now_held = held or any(
                    self._is_lock_expr(item.context_expr)
                    for item in node.items
                )
                for child in node.body:
                    visit(child, now_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def runs later, possibly unlocked: judge its
                # body as lock-not-held (conservative for inference too)
                for child in ast.iter_child_nodes(node):
                    visit(child, False)
                return
            self._judge(node, held, in_init, collect, findings)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, False)

    def _is_lock_expr(self, node: ast.AST) -> bool:
        attr = _self_attr(node)
        return attr is not None and attr in self.lock_attrs

    def _judge(self, node: ast.AST, held: bool, in_init: bool,
               collect: bool, findings: Optional[List[Finding]]) -> None:
        for attr, verb in self._mutations(node):
            if attr in self.lock_attrs:
                continue
            if collect:
                if held:
                    self.guarded.add(attr)
                    self.guard_sites.setdefault(attr, node.lineno)
            else:
                if not held and not in_init and attr in self.guarded:
                    assert findings is not None
                    lock = sorted(self.lock_attrs)[0]
                    findings.append(Finding(
                        "NHD201", self.path, node.lineno, node.col_offset,
                        f"'{verb}' mutates '{attr}' outside 'with "
                        f"{lock}:' — elsewhere (line "
                        f"{self.guard_sites.get(attr, '?')}) this class "
                        f"mutates it under the lock, so this write races "
                        "the guarded readers",
                    ))
        # NHD202: bare acquire()
        if not collect and isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "acquire"
                and self._is_lock_expr(func.value)
            ):
                assert findings is not None
                findings.append(Finding(
                    "NHD202", self.path, node.lineno, node.col_offset,
                    "bare .acquire(): an exception before release() "
                    "deadlocks every other thread — use 'with <lock>:'",
                ))

    def _mutations(self, node: ast.AST):
        """Yield (attr, description) for each self/cls-attribute mutation
        this single statement/expression performs."""
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                yield from self._target_mutation(tgt)
        elif isinstance(node, ast.AugAssign):
            yield from self._target_mutation(node.target)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:  # bare 'x: T' declares, not mutates
                yield from self._target_mutation(node.target)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                yield from self._target_mutation(tgt)
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
                attr = _self_attr(func.value)
                if attr is not None:
                    recv = func.value.value.id
                    yield attr, f"{recv}.{attr}.{func.attr}(...)"

    def _target_mutation(self, tgt: ast.AST):
        attr = _self_attr(tgt)
        if attr is not None:
            yield attr, f"{tgt.value.id}.{attr} = ..."
            return
        if isinstance(tgt, ast.Subscript):
            attr = _self_attr(tgt.value)
            if attr is not None:
                yield attr, f"{tgt.value.value.id}.{attr}[...] = ..."

    # -- driver ----------------------------------------------------------

    def audit(self) -> List[Finding]:
        self.find_locks()
        if not self.lock_attrs:
            return []
        methods = [
            n for n in self.cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for fn in methods:
            self._walk_method(fn, collect=True)
        findings: List[Finding] = []
        for fn in methods:
            self._walk_method(fn, collect=False, findings=findings)
        return findings


def check_module(tree: ast.Module, src: str, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_ClassAuditor(node, path).audit())
    return findings
