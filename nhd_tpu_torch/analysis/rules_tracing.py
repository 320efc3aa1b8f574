"""NHD1xx — capture, per-call build and host-sync hazards of the port.

The port's throughput rests on properties the interpreter will not
enforce for us:

* a CUDA graph replays the kernels it captured and nothing else — any
  host coercion of a tensor inside the capture (``int(x)``, ``x.item()``,
  ``if x:``, ``np.asarray(x)``) either fails (a sync is illegal while the
  stream captures) or bakes the capture-time value into every replay;
* a kernel library is opened once and a graph captured once — opening a
  library (``ctypes.CDLL``, ``build.load``) or constructing a
  ``torch.cuda.CUDAGraph()`` per call repays the build, the dlopen or
  the capture on every call;
* every device→host pull in the round loop stalls the launch queue, so
  the solver pulls at its one sanctioned flush (``HostPull``).

Scope is computed per module with no imports executed: a function is
*captured* if it is passed to ``torch.cuda.make_graphed_callables``,
called inside a ``with torch.cuda.graph(...)`` block, or reachable from
such a function through module-local calls; the statements of a
``with torch.cuda.graph(...)`` block are captured themselves.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from nhd_tpu_torch.analysis.core import Finding, _dotted

_COERCIONS = {"int", "float", "bool", "complex"}
#: tensor methods that return host values (a sync on a device tensor)
_HOST_METHODS = {"item", "tolist"}
# attribute reads that yield host values even on a captured tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
_CACHE_DECORATORS = {"lru_cache", "cache"}
# wall-clock reads inside a captured region run once, at CAPTURE time —
# a replay re-runs the kernels only, so the reading never changes
_CLOCK_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.thread_time", "time.perf_counter_ns",
    "time.monotonic_ns", "time.time_ns",
}


def _is_graph_ctx(node: ast.AST) -> bool:
    """``torch.cuda.graph(g)`` (or ``cuda.graph`` / ``graph`` imported
    from torch.cuda) as a with-item."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func) or ""
    return d in ("torch.cuda.graph", "cuda.graph")


def _is_graphed_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func) or ""
    return d.rsplit(".", 1)[-1] == "make_graphed_callables"


def _graphed_targets(call: ast.Call) -> List[str]:
    """Function names handed to make_graphed_callables: a name, or a
    tuple of names."""
    if not call.args:
        return []
    first = call.args[0]
    if isinstance(first, ast.Name):
        return [first.id]
    if isinstance(first, (ast.Tuple, ast.List)):
        return [e.id for e in first.elts if isinstance(e, ast.Name)]
    return []


class _FunctionIndex(ast.NodeVisitor):
    """All function defs (nested included), their call edges, every name
    handed to make_graphed_callables, every name called inside a
    graph-capture block, and the capture blocks themselves."""

    def __init__(self):
        self.functions: Dict[str, List[ast.FunctionDef]] = {}
        self.calls: Dict[int, Set[str]] = {}    # id(funcdef) -> callee names
        self.roots: Set[str] = set()            # captured entry functions
        self.blocks: List[ast.With] = []        # with torch.cuda.graph(...)
        self._stack: List[ast.FunctionDef] = []
        self._capture_depth = 0

    def _visit_func(self, node) -> None:
        self.functions.setdefault(node.name, []).append(node)
        self._stack.append(node)
        outer, self._capture_depth = self._capture_depth, 0
        self.generic_visit(node)
        self._capture_depth = outer
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        if any(_is_graph_ctx(item.context_expr) for item in node.items):
            self.blocks.append(node)
            self._capture_depth += 1
            self.generic_visit(node)
            self._capture_depth -= 1
        else:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name):
            if self._stack:
                self.calls.setdefault(
                    id(self._stack[-1]), set()
                ).add(node.func.id)
            if self._capture_depth:
                self.roots.add(node.func.id)
        if _is_graphed_call(node):
            self.roots.update(_graphed_targets(node))
        self.generic_visit(node)


class _CapturedChecker:
    """Per-captured-region dataflow: which local names carry tensors
    whose values exist only on the device (or only at capture time)."""

    def __init__(self, owner: ast.AST, name: str, traced: Set[str],
                 findings: List[Finding], path: str):
        self.owner = owner          # a FunctionDef or a With block
        self.name = name
        self.traced = set(traced)
        self.findings = findings
        self.path = path

    # -- taint judgement -------------------------------------------------

    def is_traced(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_traced(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_traced(node.value)
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            last = d.split(".")[-1]
            if d == "len" or last in _COERCIONS or last in (
                "size", "dim", "numel"
            ):
                return False  # a host value (the coercion is judged apart)
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _HOST_METHODS
            ):
                return False
            if isinstance(node.func, ast.Attribute) and self.is_traced(
                node.func.value
            ):
                return True   # method on a captured tensor (x.sum())
            if d.startswith("torch."):
                return True   # a torch op inside the capture
            return any(self.is_traced(a) for a in node.args) or any(
                self.is_traced(k.value) for k in node.keywords
            )
        if isinstance(node, ast.BinOp):
            return self.is_traced(node.left) or self.is_traced(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_traced(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_traced(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return self.is_traced(node.left) or any(
                self.is_traced(c) for c in node.comparators
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_traced(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_traced(node.body) or self.is_traced(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_traced(node.value)
        return False

    # -- propagation + checks -------------------------------------------

    def run(self) -> None:
        # two passes so names assigned late but used early (loops) settle
        for _ in range(2):
            for node in self._own_nodes():
                if isinstance(node, ast.Assign) and self.is_traced(node.value):
                    for tgt in node.targets:
                        self._taint_target(tgt)
                elif isinstance(node, ast.AugAssign) and (
                    self.is_traced(node.value) or self.is_traced(node.target)
                ):
                    self._taint_target(node.target)
        for node in self._own_nodes():
            self._check(node)

    def _own_nodes(self):
        """ast.walk minus nested function bodies: a nested def is judged
        by its own checker (it is captured through the call graph)."""
        if isinstance(self.owner, ast.With):
            stack = list(self.owner.body)
        else:
            stack = list(ast.iter_child_nodes(self.owner))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def _taint_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, ast.Name):
            self.traced.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._taint_target(e)

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule, self.path, node.lineno, node.col_offset, msg
        ))

    def _check(self, node: ast.AST) -> None:
        where = f"captured '{self.name}'"
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d in _CLOCK_CALLS:
                self._emit(
                    "NHD106", node,
                    f"{d}() inside {where} runs at capture time only — a "
                    "graph replay re-runs the kernels, not the host code, "
                    "so the reading never changes; time on the host "
                    "around graph.replay() (CUDA events)",
                )
            elif (
                d in _COERCIONS
                and node.args
                and self.is_traced(node.args[0])
            ):
                self._emit(
                    "NHD101", node,
                    f"{d}() coerces a device tensor inside {where}: a "
                    "sync is illegal while the stream captures, and the "
                    "capture-time value would be baked into every "
                    "replay — keep it a tensor or hoist it out",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_METHODS
                and self.is_traced(node.func.value)
            ):
                self._emit(
                    "NHD101", node,
                    f".{node.func.attr}() pulls a device tensor to the "
                    f"host inside {where}: a sync is illegal while the "
                    "stream captures — keep it a tensor or hoist it out",
                )
            elif d and (d.startswith("np.") or d.startswith("numpy.")) and (
                any(self.is_traced(a) for a in node.args)
            ):
                self._emit(
                    "NHD103", node,
                    f"{d}() applies host numpy to a device tensor inside "
                    f"{where}: the op would run once, at capture, on the "
                    "host — use torch ops so it stays in the graph",
                )
        elif isinstance(node, (ast.If, ast.While)) and self.is_traced(
            node.test
        ):
            kw = "if" if isinstance(node, ast.If) else "while"
            self._emit(
                "NHD102", node,
                f"Python '{kw}' on a device tensor inside {where}: the "
                "branch is decided once, at capture, and every replay "
                "takes it — use torch.where",
            )
        elif isinstance(node, ast.Assert) and self.is_traced(node.test):
            self._emit(
                "NHD102", node,
                f"assert on a device tensor inside {where}: it runs at "
                "capture only — validate on the host before capture",
            )


def _params(fn: ast.FunctionDef) -> Set[str]:
    args = fn.args
    params = [a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
    if args.vararg:
        params.append(args.vararg.arg)
    if args.kwarg:
        params.append(args.kwarg.arg)
    return set(params) - {"self", "cls"}


def _block_seeds(block: ast.With) -> Set[str]:
    """Names a capture block binds from an op or call: their values are
    the capture's (not yet computed) tensors."""
    out: Set[str] = set()
    for node in ast.walk(block):
        if isinstance(node, ast.Assign) and any(
            isinstance(n, (ast.Call, ast.BinOp, ast.Subscript))
            for n in ast.walk(node.value)
        ):
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out


# ---------------------------------------------------------------------------
# NHD104 / NHD105 — per-call builds and baked mutable defaults
# ---------------------------------------------------------------------------

def _build_kind(node: ast.Call) -> Optional[str]:
    """What *node* builds when it opens a kernel library or a graph."""
    d = _dotted(node.func) or ""
    last = d.rsplit(".", 1)[-1]
    if last in ("CDLL", "LoadLibrary"):
        return f"{d}() opens a kernel library"
    if d == "build.load" or d.endswith(".build.load"):
        return f"{d}() opens a kernel library"
    if d in ("torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph"):
        return f"{d}() constructs a CUDA graph"
    return None


def _module_globals(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _memoizes(fn: ast.FunctionDef, globals_: Set[str]) -> bool:
    """Whether *fn* stores into module state (a module-level dict
    subscript, or a name it declares global): the memo of a cache."""
    declared: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared.update(node.names)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id in globals_:
                return True
            if isinstance(t, ast.Name) and t.id in declared:
                return True
    return False


def _check_builds(
    tree: ast.Module, path: str,
    functions: Dict[str, List[ast.FunctionDef]],
) -> List[Finding]:
    """NHD104 (a library opened or a graph built per call) + NHD105
    (a mutable default baked into a graphed callable)."""
    findings: List[Finding] = []
    globals_ = _module_globals(tree)

    class V(ast.NodeVisitor):
        def __init__(self):
            self.fn_stack: List[ast.FunctionDef] = []
            self.loop_depth = 0

        def _cached(self, fn: ast.FunctionDef) -> bool:
            for dec in fn.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                d = _dotted(target) or ""
                if d.split(".")[-1] in _CACHE_DECORATORS:
                    return True
            return _memoizes(fn, globals_)

        def _visit_func(self, node) -> None:
            self.fn_stack.append(node)
            outer_loops, self.loop_depth = self.loop_depth, 0
            self.generic_visit(node)
            self.loop_depth = outer_loops
            self.fn_stack.pop()

        visit_FunctionDef = _visit_func
        visit_AsyncFunctionDef = _visit_func

        def visit_For(self, node) -> None:
            self._visit_loop(node)

        def visit_While(self, node) -> None:
            self._visit_loop(node)

        def _visit_loop(self, node) -> None:
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        def visit_Call(self, node: ast.Call) -> None:
            what = _build_kind(node)
            if what is not None:
                self._check_104(node, what)
            if _is_graphed_call(node):
                self._check_105(node)
            self.generic_visit(node)

        def _check_104(self, node: ast.Call, what: str) -> None:
            if self.loop_depth > 0:
                findings.append(Finding(
                    "NHD104", path, node.lineno, node.col_offset,
                    f"{what} inside a loop: every iteration repays the "
                    "open or the capture — hoist it out (one per kernel "
                    "or per bucket shape)",
                ))
            elif self.fn_stack and not any(
                self._cached(f) for f in self.fn_stack
            ):
                findings.append(Finding(
                    "NHD104", path, node.lineno, node.col_offset,
                    f"{what} per call of '{self.fn_stack[-1].name}': "
                    "the build, dlopen or capture repeats on every "
                    "invocation — keep it in a cache (functools."
                    "lru_cache, or a module-level memo) or at module "
                    "scope",
                ))

        def _check_105(self, node: ast.Call) -> None:
            for name in _graphed_targets(node):
                for fn in functions.get(name, []):
                    args = fn.args.posonlyargs + fn.args.args
                    defaults = list(fn.args.defaults)
                    pairs = list(zip(args[len(args) - len(defaults):],
                                     defaults))
                    pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs,
                                                     fn.args.kw_defaults)
                              if d is not None]
                    for a, default in pairs:
                        if _is_mutable_literal(default):
                            findings.append(Finding(
                                "NHD105", path, node.lineno,
                                node.col_offset,
                                f"parameter '{a.arg}' of graphed "
                                f"'{fn.name}' defaults to a mutable value: "
                                "the graph bakes its capture-time "
                                "contents, and later edits never reach a "
                                "replay — pass a tensor or an immutable "
                                "value",
                            ))

    V().visit(tree)
    return findings


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        d = _dotted(node.func) or ""
        return d.split(".")[-1] in ("list", "dict", "set", "bytearray")
    return False


# ---------------------------------------------------------------------------
# NHD107 — host-sync operations in solver hot-path modules
# ---------------------------------------------------------------------------
#
# Every device→host pull drains the launch queue: the host waits for
# every kernel queued before it, and the card idles while the host works
# on what came back. Inside nhd_tpu_torch/solver/ the contract is: copy
# into pinned memory without blocking and wait at ONE sanctioned flush
# per round (HostPull in device_state.py); any other sync flags, and the
# intentional sites carry inline suppressions with their reason.

import re as _re

_SOLVER_SCOPE_PARTS = ("solver",)
#: call names whose results are (or carry) device tensors — the taint
#: seeds for the scalar and array pull judgement
_DEVICE_RESULT = _re.compile(r"(solve|rank|megaround|speculat|fused)")
_SYNC_PULLS = {
    "np.asarray", "np.array", "np.copy",
    "numpy.asarray", "numpy.array", "numpy.copy",
}
#: torch calls that build a host tensor over host memory (no device value)
_HOST_TORCH = {"torch.from_numpy", "torch.frombuffer"}
#: torch factories that build on the CPU unless given a device
_FACTORIES = {
    "torch.empty", "torch.zeros", "torch.ones", "torch.full",
    "torch.arange", "torch.tensor", "torch.as_tensor", "torch.rand",
    "torch.randn", "torch.randint", "torch.linspace",
}
#: classes whose methods ARE the sanctioned flush
_SANCTIONED_FLUSH = {"HostPull"}


def _in_solver_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(p in parts for p in _SOLVER_SCOPE_PARTS)


def _is_cpu_target(node: ast.AST) -> bool:
    """'cpu', torch.device('cpu') or device='cpu' as a .to() argument."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith(
        "device"
    ):
        return bool(node.args) and _is_cpu_target(node.args[0])
    return False


class _HostSyncChecker:
    """Per-function device-taint dataflow: which local names hold (or
    contain) device tensors.

    Two tiers, as in the reference. STRONG taint flows through plain
    assignments whose value is (or derives from) a dispatch, a kernel or
    a torch op — these names hold tensors, so scalar and list pulls
    (``int()``, ``.item()``, ``.tolist()``, ``.numpy()``) flag on them.
    WEAK taint additionally flows through loop targets, where only the
    unmistakable array pulls (np.asarray/np.array/np.copy) flag. The
    unconditional syncs (``.cpu()``, ``.to("cpu")``, any
    ``.synchronize()``) flag wherever they appear."""

    def __init__(self, fn, findings: List[Finding], path: str):
        self.fn = fn
        self.findings = findings
        self.path = path
        self.dev: Set[str] = set()      # weak OR strong
        self.strong: Set[str] = set()

    def _own_nodes(self):
        stack = list(ast.iter_child_nodes(self.fn))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def _is_dispatch_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = _dotted(node.func) or ""
        if d in _HOST_TORCH or (d in _FACTORIES and not any(
            k.arg == "device" for k in node.keywords
        )):
            return False
        if d.startswith("torch.") or d.startswith("kernels."):
            return True
        if _DEVICE_RESULT.search(d.split(".")[-1]):
            return True
        return isinstance(node.func, ast.Attribute) and bool(
            _DEVICE_RESULT.search(node.func.attr)
        )

    def _tainted(self, node: ast.AST, names: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self._tainted(node.value, names)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._tainted(e, names) for e in node.elts)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in ("cpu", "numpy", "item", "tolist"):
                    return False    # a host value from here on
                if self._tainted(node.func.value, names):
                    return True     # a tensor method (t.sum(), t[0].to())
            return self._is_dispatch_call(node)
        return False

    def is_dev(self, node: ast.AST) -> bool:
        return self._tainted(node, self.dev)

    def is_strong(self, node: ast.AST) -> bool:
        return self._tainted(node, self.strong)

    def _taint(self, tgt: ast.AST, strong: bool) -> bool:
        changed = False
        if isinstance(tgt, ast.Name):
            if tgt.id not in self.dev:
                self.dev.add(tgt.id)
                changed = True
            if strong and tgt.id not in self.strong:
                self.strong.add(tgt.id)
                changed = True
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                changed |= self._taint(e, strong)
        elif isinstance(tgt, ast.Starred):
            changed = self._taint(tgt.value, strong)
        return changed

    def run(self) -> None:
        # fixed point: taint chains (dispatch -> name -> name -> loop
        # target) settle regardless of statement order
        for _ in range(8):
            changed = False
            for node in self._own_nodes():
                if isinstance(node, ast.Assign) and self.is_dev(node.value):
                    for tgt in node.targets:
                        changed |= self._taint(
                            tgt, self.is_strong(node.value)
                        )
                elif isinstance(node, ast.AnnAssign) and (
                    node.value is not None and self.is_dev(node.value)
                ):
                    changed |= self._taint(
                        node.target, self.is_strong(node.value)
                    )
                elif isinstance(node, ast.AugAssign) and (
                    self.is_dev(node.value) or self.is_dev(node.target)
                ):
                    changed |= self._taint(node.target, False)
                elif isinstance(node, (ast.For, ast.AsyncFor)) and self.is_dev(
                    node.iter
                ):
                    changed |= self._taint(node.target, False)
            if not changed:
                break
        for node in self._own_nodes():
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if d in ("torch.cuda.synchronize", "cuda.synchronize"):
                self._emit(node, "torch.cuda.synchronize() waits for every "
                                 "queued kernel")
            elif attr == "synchronize":
                self._emit(node, ".synchronize() blocks the host on the "
                                 "device")
            elif attr == "cpu":
                self._emit(node, ".cpu() is a synchronous device→host copy")
            elif attr == "to" and (
                any(_is_cpu_target(a) for a in node.args)
                or any(k.arg == "device" and _is_cpu_target(k.value)
                       for k in node.keywords)
            ):
                self._emit(node, ".to('cpu') is a synchronous device→host "
                                 "copy")
            elif attr in ("item", "tolist", "numpy") and self.is_strong(
                node.func.value
            ):
                self._emit(node, f".{attr}() on a device tensor is a "
                                 "synchronous host pull")
            elif (
                d in ("int", "float")
                and node.args
                and self.is_strong(node.args[0])
            ):
                self._emit(node, f"{d}() on a device tensor blocks on the "
                                 "queue to concretize the scalar")
            elif d in _SYNC_PULLS and node.args and self.is_dev(node.args[0]):
                self._emit(node, f"{d}() on a device tensor is a "
                                 "synchronous host pull")

    def _emit(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "NHD107", self.path, node.lineno, node.col_offset,
            f"host-sync in solver hot path '{self.fn.name}': {what} — "
            "each pull drains the launch queue; copy into pinned memory "
            "without blocking and wait at the round's ONE sanctioned "
            "flush (HostPull) (suppress intentional sync sites inline)",
        ))


def _check_host_sync(tree: ast.Module, path: str) -> List[Finding]:
    if not _in_solver_scope(path):
        return []
    sanctioned: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in _SANCTIONED_FLUSH:
            sanctioned.update(id(n) for n in ast.walk(node))
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) not in sanctioned:
            _HostSyncChecker(node, findings, path).run()
    return findings


# ---------------------------------------------------------------------------
# NHD108 — full cluster re-encode on a per-event / per-round hot path
# ---------------------------------------------------------------------------
#
# encode_cluster() re-projects EVERY node (O(N) host work); the
# incremental state layer (solver/encode.py ClusterDelta) exists so that
# per-event and per-round paths pay O(changed rows) instead — full
# rebuilds are fallback events that belong to the sanctioned chokepoints.
# Inside nhd_tpu_torch/solver/ and nhd_tpu_torch/scheduler/ any other call flags;
# deliberate one-shot batch sites carry inline suppressions (same
# contract shape as NHD107's sanctioned flush points).

_ENCODE_SCOPE_PARTS = ("solver", "scheduler")
#: enclosing functions allowed to issue the full re-encode: the delta
#: layer's rebuild chokepoint, its parity checker, and the one-shot
#: context builder. A `module:function` entry sanctions the function in
#: that module only — used for surfaces that are chokepoints by design
#: rather than by name (registering one here replaces an inline
#: suppression; the registry is reviewable, the scatter of ignores
#: was not).
_ENCODE_SANCTIONED = {
    "_rebuild", "rebuild", "make_context", "parity_errors",
    # the oracle-parity batch surface: one-shot snapshot evaluation, no
    # rounds and no events, so a delta would have nothing to reuse
    "matcher:find_nodes",
}


def _check_encode_calls(tree: ast.Module, path: str) -> List[Finding]:
    parts = path.replace("\\", "/").split("/")
    if not any(p in parts for p in _ENCODE_SCOPE_PARTS):
        return []
    if parts[-1] == "encode.py":
        return []  # the chokepoint module itself defines the rebuild
    modname = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    findings: List[Finding] = []

    class V(ast.NodeVisitor):
        def __init__(self):
            self._stack: List[str] = []

        def _visit_func(self, node) -> None:
            self._stack.append(node.name)
            self.generic_visit(node)
            self._stack.pop()

        visit_FunctionDef = _visit_func
        visit_AsyncFunctionDef = _visit_func

        def visit_Call(self, node: ast.Call) -> None:
            d = _dotted(node.func) or ""
            if d == "encode_cluster" or d.endswith(".encode_cluster"):
                fn = self._stack[-1] if self._stack else "<module>"
                if fn not in _ENCODE_SANCTIONED \
                        and f"{modname}:{fn}" not in _ENCODE_SANCTIONED:
                    findings.append(Finding(
                        "NHD108", path, node.lineno, node.col_offset,
                        f"full encode_cluster() in '{fn}' re-projects "
                        "every node (O(N) host work) on a per-event/"
                        "per-round path: get-or-apply row deltas through "
                        "the incremental state (solver/encode.py "
                        "ClusterDelta + refresh_context) instead — full "
                        "rebuilds belong to the sanctioned chokepoints; "
                        "suppress deliberate one-shot batch sites inline",
                    ))
            self.generic_visit(node)

    V().visit(tree)
    return findings


def check_module(tree: ast.Module, src: str, path: str) -> List[Finding]:
    index = _FunctionIndex()
    index.visit(tree)

    # propagate capture through module-local calls to a fixed point
    captured: Set[str] = set(index.roots) & set(index.functions)
    changed = True
    while changed:
        changed = False
        for name in list(captured):
            for fn in index.functions.get(name, []):
                for callee in index.calls.get(id(fn), ()):
                    if callee in index.functions and callee not in captured:
                        captured.add(callee)
                        changed = True

    findings: List[Finding] = []
    for name in sorted(captured):
        for fn in index.functions.get(name, []):
            _CapturedChecker(fn, fn.name, _params(fn), findings, path).run()
    for block in index.blocks:
        _CapturedChecker(block, "torch.cuda.graph block",
                         _block_seeds(block), findings, path).run()
    findings.extend(_check_builds(tree, path, index.functions))
    findings.extend(_check_host_sync(tree, path))
    findings.extend(_check_encode_calls(tree, path))
    return findings
