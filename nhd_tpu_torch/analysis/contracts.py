"""Cross-module model of the port's solve signature and kernel ABI
(NHD7xx pack).

The port's 25-tensor solve signature is a *convention* threaded through
many modules: ``kernel._ARG_ORDER``/``_POD_ARG_ORDER`` name the arrays,
``encode.DELTA_FIELDS`` mirrors them for the delta layer,
``_MUTABLE``/``_STATIC`` partition them for the in-place row updates,
``device_state`` and ``parallel/sharding`` cut the padded block
(``padded_args``) at ``len(_ARG_ORDER)``, the kernel-argument builders
read the tensors by name (``dict(zip(_ARG_ORDER, node))``), and each
kernel's pointer order is written once in ``kernels/abi.py``, again in
its ``.cu`` entry point and again in its plain version
(``kernels/reference.py``). ``aot`` hashes the defining modules into the
program fingerprint and ``build`` the ``.cu`` sources and ``abi.py``
into each library's. PRs that extend the signature or an entry point
must touch every one of those sites.

This module extracts the *facts* — tuple definitions, ``.index()`` and
by-name refs, block spans, the ABI rows, the plain
signatures, the kernel call sites, fingerprint sources, env-knob reads,
the knob registries — from a parsed project (``ModuleSource`` set) into
a :class:`ContractModel`. ``rules_contract.py`` judges the facts.

Everything here is stdlib-``ast`` only: the model is built from source
text, never by importing the modules it reads (the gate runs without
torch's CUDA or a compiler).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from nhd_tpu_torch.analysis.core import ModuleSource, _dotted

#: the contract tuple names the model tracks, wherever they are defined
CONTRACT_TUPLE_NAMES = (
    "_ARG_ORDER", "_POD_ARG_ORDER", "_MUTABLE", "_STATIC", "DELTA_FIELDS",
)

#: the builder of the padded block: node arrays in _ARG_ORDER, then pod
#: arrays in _POD_ARG_ORDER — a slice of its result is a block span
BLOCK_BUILDERS = ("padded_args",)

#: environment prefixes of the registered knobs: the reference's shared
#: ones and the port's own
KNOB_PREFIXES = ("NHD_", "NHDC_")

#: the module basename of the port's own knob registry (NHDC_* knobs)
PORT_REGISTRY = "port_knobs"

#: the module basename of the plain versions of the kernels
PLAIN_MODULE = "reference"


def module_basename(path: str) -> str:
    """'kernel' for 'nhd_tpu_torch/solver/kernel.py' — the unit fingerprint
    sources and tuple definitions are matched on."""
    name = path.rsplit("/", 1)[-1]
    return name[:-3] if name.endswith(".py") else name


@dataclass(frozen=True)
class TupleDef:
    """A module-level literal tuple/list-of-strings contract definition."""

    name: str
    path: str
    line: int
    col: int
    fields: Tuple[str, ...]


@dataclass(frozen=True)
class IndexRef:
    """``<tuple>.index("field")`` — a positional consumer of the contract."""

    path: str
    line: int
    col: int
    tuple_name: str
    field_name: str


@dataclass(frozen=True)
class FingerprintSite:
    """``for mod in (a, b): h.update(inspect.getsource(mod)...)`` or
    ``h.update((here / "kernel.py").read_bytes())`` inside a
    *fingerprint* function — a cache-key source list, resolved to module
    basenames through the import table. ``library``: the site keys a
    kernel library (its module reads the ABI table), and then
    ``sources`` says whether it hashes the kernel's ``.cu`` source."""

    path: str
    line: int
    col: int
    hashed: Tuple[str, ...]
    library: bool = False
    sources: bool = False


@dataclass(frozen=True)
class EnvRead:
    """One ``NHD_*`` environment read (os.environ.get / os.getenv /
    os.environ[...])."""

    path: str
    line: int
    col: int
    name: str


@dataclass(frozen=True)
class KnobRegistry:
    """A module-level ``KNOBS = (Knob(...), ...)`` registry."""

    path: str
    line: int
    names: Tuple[str, ...]

    @property
    def port(self) -> bool:
        """The port's own registry (NHDC_* knobs)."""
        return module_basename(self.path) == PORT_REGISTRY


@dataclass(frozen=True)
class KeyRef:
    """``d["field"]`` where ``d = dict(zip(<tuple>, ...))``: a by-name
    consumer of the contract."""

    path: str
    line: int
    col: int
    tuple_name: str
    field_name: str


@dataclass(frozen=True)
class BlockSpan:
    """``block[:X]`` / ``block[X:]`` of a ``padded_args`` result: the
    node/pod boundary, a literal int or ``len(<tuple>)``."""

    path: str
    line: int
    col: int
    count: Optional[int]
    sym: Optional[str]


@dataclass(frozen=True)
class AbiRow:
    """One kernel's row of the ABI table (``ABI = {name: KernelABI(...)}``):
    its pointer arguments (name, out, inplace) and its int sizes."""

    kernel: str
    entry: str
    path: str
    line: int
    col: int
    args: Tuple[Tuple[str, bool, bool], ...]
    sizes: Tuple[str, ...]

    @property
    def inputs(self) -> Tuple[str, ...]:
        return tuple(n for n, out, _ in self.args if not out)

    @property
    def inplace(self) -> Tuple[int, ...]:
        """Positions, among the inputs, of the tensors written in place."""
        ins = [(n, io) for n, out, io in self.args if not out]
        return tuple(i for i, (_, io) in enumerate(ins) if io)


@dataclass(frozen=True)
class HelperRow:
    """One C entry point of a source that holds no kernel
    (``HELPERS = {source: (HelperEntry(entry, ((name, kind), ...)), ...)}``
    in the ABI module): its parameters with their C kinds."""

    source: str
    entry: str
    path: str
    line: int
    col: int
    params: Tuple[Tuple[str, str], ...]


@dataclass(frozen=True)
class PlainSig:
    """A plain version's signature (a module-level def of the plain
    module named as a kernel): its positional params."""

    name: str
    path: str
    line: int
    col: int
    positional: Tuple[str, ...]


@dataclass(frozen=True)
class KernelCall:
    """``kernels.NAME(...)``: the positional arguments as descriptors —
    ``(tuple_name, field)`` for a by-name contract read, ``None`` for
    anything else — or, for ``kernels.NAME(*builder(...))``, the
    builder's name (its return tuple is described in ``builders``)."""

    path: str
    line: int
    col: int
    kernel: str
    args: Tuple[Optional[Tuple[str, str]], ...]
    builder: Optional[str]


@dataclass
class ContractModel:
    """Everything rules_contract.py judges, extracted in one pass."""

    tuple_defs: Dict[str, List[TupleDef]] = field(default_factory=dict)
    index_refs: List[IndexRef] = field(default_factory=list)
    fingerprint_sites: List[FingerprintSite] = field(default_factory=list)
    env_reads: List[EnvRead] = field(default_factory=list)
    registries: List[KnobRegistry] = field(default_factory=list)
    key_refs: List[KeyRef] = field(default_factory=list)
    block_spans: List[BlockSpan] = field(default_factory=list)
    abi_rows: Dict[str, AbiRow] = field(default_factory=dict)
    helper_rows: List[HelperRow] = field(default_factory=list)
    #: the ABI sizes passed as 64-bit ints (``WIDE`` in the ABI module)
    wide: Tuple[str, ...] = ()
    plain_sigs: Dict[str, PlainSig] = field(default_factory=dict)
    kernel_calls: List[KernelCall] = field(default_factory=list)
    #: builder function name -> its returned tuple's descriptors
    builders: Dict[str, Tuple[Optional[Tuple[str, str]], ...]] = field(
        default_factory=dict)
    #: basenames of modules defining ``get_tables`` (the combo tables —
    #: a required fingerprint source alongside the _ARG_ORDER module)
    table_modules: List[str] = field(default_factory=list)

    def first_def(self, name: str) -> Optional[TupleDef]:
        defs = self.tuple_defs.get(name)
        return defs[0] if defs else None


def _literal_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('a', 'b') for a Tuple/List of string constants, else None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out: List[str] = []
    for elt in node.elts:
        if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
            return None
        out.append(elt.value)
    return tuple(out)


def _import_table(tree: ast.Module) -> Dict[str, str]:
    """local name -> imported basename, for resolving fingerprint-source
    Names. Function-level imports count: aot imports kernel/combos inside
    program_fingerprint() to dodge an import cycle."""
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    # `import nhd_tpu_torch.solver.kernel as kernel` -> kernel
                    table[alias.asname] = alias.name.rsplit(".", 1)[-1]
                else:
                    # `import os` / `import a.b` binds the top name
                    top = alias.name.split(".")[0]
                    table[top] = top
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                table[alias.asname or alias.name] = alias.name
    return table


def _len_target(node: ast.AST, len_aliases: Dict[str, str]) -> Optional[str]:
    """NAME for ``len(NAME)`` or a local alias of it, else None."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "len"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Name)
    ):
        return node.args[0].id
    if isinstance(node, ast.Name):
        return len_aliases.get(node.id)
    return None


_ENV_GET_CALLS = {"os.environ.get", "environ.get", "os.getenv", "getenv"}
_ENV_SUBSCRIPTS = {"os.environ", "environ"}


def _is_knob_name(value: object) -> bool:
    return isinstance(value, str) and value.startswith(KNOB_PREFIXES)


def _own_nodes(func: ast.AST):
    """ast.walk of *func*'s body without nested defs (each is judged as
    a scope of its own)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _zip_dict_tuple(node: ast.AST) -> Optional[str]:
    """T for ``dict(zip(T, ...))`` with T a contract tuple name."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "dict"
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Call)
        and isinstance(node.args[0].func, ast.Name)
        and node.args[0].func.id == "zip"
        and node.args[0].args
        and isinstance(node.args[0].args[0], ast.Name)
        and node.args[0].args[0].id in CONTRACT_TUPLE_NAMES
    ):
        return node.args[0].args[0].id
    return None


def _abi_arg(node: ast.AST) -> Optional[Tuple[str, bool, bool]]:
    """(name, out, inplace) for one ``_a(...)``/``_io(...)``/``Arg(...)``
    entry of an ABI row."""
    if not (isinstance(node, ast.Call) and node.args):
        return None
    first = node.args[0]
    if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
        return None
    callee = (_dotted(node.func) or "").rsplit(".", 1)[-1]
    flags = dict(zip(("out", "inplace"), node.args[3:5]))
    flags.update((kw.arg, kw.value) for kw in node.keywords)

    def true(flag: str) -> bool:
        value = flags.get(flag)
        return isinstance(value, ast.Constant) and value.value is True

    return first.value, true("out"), callee == "_io" or true("inplace")


class _ModuleExtractor(ast.NodeVisitor):
    """One pass over one module, appending facts to the shared model."""

    def __init__(self, model: ContractModel, module: ModuleSource):
        self.model = model
        self.path = module.path
        self.imports = _import_table(module.tree)
        # NAME for every `x = len(NAME)` assignment in the module —
        # scoping is flat (module-wide) which is safe: a false alias can
        # only *record* a block span as symbolic, never invent a
        # literal mismatch
        self.len_aliases: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                target = _len_target(node.value, {})
                if target is not None:
                    self.len_aliases[node.targets[0].id] = target

    # -- contract tuple / registry definitions (module level only) ------

    def visit_Module(self, node: ast.Module) -> None:
        plain = module_basename(self.path) == PLAIN_MODULE
        for stmt in node.body:
            if plain and isinstance(stmt, ast.FunctionDef) \
                    and not stmt.name.startswith("_"):
                a = stmt.args
                self.model.plain_sigs[stmt.name] = PlainSig(
                    stmt.name, self.path, stmt.lineno, stmt.col_offset,
                    tuple(p.arg for p in a.posonlyargs + a.args),
                )
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if isinstance(target, ast.Name):
                    self._module_assign(target.id, stmt, stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                # `KNOBS: Tuple[Knob, ...] = (...)` — annotated form
                if isinstance(stmt.target, ast.Name):
                    self._module_assign(stmt.target.id, stmt, stmt.value)
        self.generic_visit(node)

    def _module_assign(self, name: str, stmt: ast.stmt,
                       value: ast.expr) -> None:
        if name in CONTRACT_TUPLE_NAMES:
            fields = _literal_str_tuple(value)
            if fields is not None:
                self.model.tuple_defs.setdefault(name, []).append(TupleDef(
                    name, self.path, stmt.lineno, stmt.col_offset, fields
                ))
        elif name == "ABI" and isinstance(value, ast.Dict):
            self._abi_table(value)
        elif name == "HELPERS" and isinstance(value, ast.Dict):
            self._helper_table(value)
        elif name == "WIDE":
            self.model.wide = _literal_str_tuple(value) or ()
        elif name == "KNOBS" and isinstance(value, (ast.Tuple, ast.List)):
            knobs = []
            for elt in value.elts:
                knob = self._knob_name(elt)
                if knob is None:
                    return  # not a Knob(...) registry after all
                knobs.append(knob)
            self.model.registries.append(
                KnobRegistry(self.path, stmt.lineno, tuple(knobs))
            )

    def _abi_table(self, value: ast.Dict) -> None:
        for key, row in zip(value.keys, value.values):
            if not (
                isinstance(key, ast.Constant) and isinstance(key.value, str)
                and isinstance(row, ast.Call) and len(row.args) >= 3
                and isinstance(row.args[0], ast.Constant)
                and isinstance(row.args[1], (ast.Tuple, ast.List))
            ):
                continue
            args = [_abi_arg(e) for e in row.args[1].elts]
            sizes = _literal_str_tuple(row.args[2])
            if any(a is None for a in args) or sizes is None:
                continue
            self.model.abi_rows[key.value] = AbiRow(
                key.value, str(row.args[0].value), self.path, row.lineno,
                row.col_offset, tuple(args), sizes,
            )

    def _helper_table(self, value: ast.Dict) -> None:
        for key, entries in zip(value.keys, value.values):
            if not (isinstance(key, ast.Constant) and isinstance(key.value, str)
                    and isinstance(entries, (ast.Tuple, ast.List))):
                continue
            for row in entries.elts:
                if not (isinstance(row, ast.Call) and len(row.args) >= 2
                        and isinstance(row.args[0], ast.Constant)
                        and isinstance(row.args[1], (ast.Tuple, ast.List))):
                    continue
                params = [_literal_str_tuple(p) for p in row.args[1].elts]
                if any(p is None or len(p) != 2 for p in params):
                    continue
                self.model.helper_rows.append(HelperRow(
                    key.value, str(row.args[0].value), self.path, row.lineno,
                    row.col_offset, tuple(params)))

    @staticmethod
    def _knob_name(node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        callee = _dotted(node.func) or ""
        if callee.rsplit(".", 1)[-1] != "Knob":
            return None
        for kw in node.keywords:
            if (
                kw.arg == "name"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
            ):
                return kw.value.value
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value
        return None

    # -- functions: fingerprint loops + get_tables definers -------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name == "get_tables":
            base = module_basename(self.path)
            if base not in self.model.table_modules:
                self.model.table_modules.append(base)
        if "fingerprint" in node.name:
            self._fingerprint_sites(node)
        self._scope_facts(node)
        self.generic_visit(node)

    def _scope_facts(self, func: ast.FunctionDef) -> None:
        """By-name reads of ``dict(zip(T, ...))`` locals, spans of
        ``padded_args`` blocks, kernel call sites and builder returns,
        within one function (nested defs are scopes of their own)."""
        aliases: Dict[str, str] = {}
        blocks = set()
        for node in _own_nodes(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tup = _zip_dict_tuple(node.value)
                if tup is not None:
                    aliases[node.targets[0].id] = tup
                if isinstance(node.value, ast.Call) and (
                    (_dotted(node.value.func) or "").rsplit(".", 1)[-1]
                    in BLOCK_BUILDERS
                ):
                    blocks.add(node.targets[0].id)

        def describe(arg: ast.AST) -> Optional[Tuple[str, str]]:
            if (
                isinstance(arg, ast.Subscript)
                and isinstance(arg.value, ast.Name)
                and arg.value.id in aliases
                and isinstance(arg.slice, ast.Constant)
                and isinstance(arg.slice.value, str)
            ):
                return aliases[arg.value.id], arg.slice.value
            return None

        for node in _own_nodes(func):
            if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ) and isinstance(node.value, ast.Name):
                ref = describe(node)
                if ref is not None:
                    self.model.key_refs.append(KeyRef(
                        self.path, node.lineno, node.col_offset, *ref
                    ))
                elif node.value.id in blocks and isinstance(
                    node.slice, ast.Slice
                ):
                    self._block_span(node)
            elif isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                head, _, kernel = d.rpartition(".")
                if head.rsplit(".", 1)[-1] == "kernels" and kernel:
                    builder = None
                    if node.args and isinstance(node.args[0], ast.Starred) \
                            and isinstance(node.args[0].value, ast.Call):
                        builder = _dotted(node.args[0].value.func)
                    self.model.kernel_calls.append(KernelCall(
                        self.path, node.lineno, node.col_offset, kernel,
                        tuple(describe(a) for a in node.args), builder,
                    ))
            elif isinstance(node, ast.Return) and isinstance(
                node.value, ast.Tuple
            ):
                self.model.builders[func.name] = tuple(
                    describe(e) for e in node.value.elts
                )

    def _block_span(self, node: ast.Subscript) -> None:
        sl = node.slice
        assert isinstance(sl, ast.Slice)
        bound = sl.upper if sl.lower is None else (
            sl.lower if sl.upper is None else None
        )
        if bound is None:
            return
        count = bound.value if isinstance(bound, ast.Constant) \
            and isinstance(bound.value, int) else None
        sym = _len_target(bound, self.len_aliases)
        if count is None and sym is None:
            return
        self.model.block_spans.append(BlockSpan(
            self.path, node.lineno, node.col_offset, count, sym
        ))

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _fingerprint_sites(self, func: ast.FunctionDef) -> None:
        for node in ast.walk(func):
            if not (
                isinstance(node, ast.For)
                and isinstance(node.iter, (ast.Tuple, ast.List))
            ):
                continue
            uses_getsource = any(
                isinstance(inner, ast.Call)
                and (_dotted(inner.func) or "").endswith("getsource")
                for body_stmt in node.body
                for inner in ast.walk(body_stmt)
            )
            if not uses_getsource:
                continue
            hashed = []
            for elt in node.iter.elts:
                if isinstance(elt, ast.Name):
                    hashed.append(self.imports.get(elt.id, elt.id))
                else:
                    dotted = _dotted(elt)
                    if dotted:
                        hashed.append(dotted.rsplit(".", 1)[-1])
            self.model.fingerprint_sites.append(FingerprintSite(
                self.path, node.lineno, node.col_offset, tuple(hashed)
            ))
        if any(s.path == self.path and s.line >= func.lineno
               and s.line <= (func.end_lineno or func.lineno)
               for s in self.model.fingerprint_sites):
            return
        self._file_hash_site(func)

    def _file_hash_site(self, func: ast.FunctionDef) -> None:
        """The port's form: ``h.update((here / "kernel.py").read_bytes())``,
        in a loop over literal file names or not, and
        ``source_path(name).read_bytes()`` for a kernel's ``.cu``."""
        loops: Dict[str, Tuple[ast.AST, ...]] = {}
        for node in ast.walk(func):
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                    and isinstance(node.iter, (ast.Tuple, ast.List)):
                loops[node.target.id] = tuple(node.iter.elts)
        hashed: List[str] = []
        sources = False
        reads = False

        def note(elt: ast.AST) -> None:
            nonlocal sources
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                if elt.value.endswith(".py"):
                    hashed.append(elt.value[:-3].rsplit("/", 1)[-1])
                elif elt.value.endswith(".cu"):
                    sources = True
            elif isinstance(elt, ast.Name):
                hashed.append(self.imports.get(elt.id, elt.id))

        for node in ast.walk(func):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("read_bytes", "read_text")):
                continue
            reads = True
            for inner in ast.walk(node.func.value):
                if isinstance(inner, ast.Constant):
                    note(inner)
                elif isinstance(inner, ast.Name) and inner.id in loops:
                    for elt in loops[inner.id]:
                        note(elt)
                elif isinstance(inner, ast.Call) and (
                    (_dotted(inner.func) or "").endswith("source_path")
                ):
                    sources = True
        if not reads:
            return
        self.model.fingerprint_sites.append(FingerprintSite(
            self.path, func.lineno, func.col_offset, tuple(hashed),
            library="ABI" in self.imports, sources=sources,
        ))

    # -- consumers: .index() refs and env reads -------------------------

    def _canonical(self, dotted: Optional[str]) -> str:
        """Resolve the leading component of a dotted path through the
        module's import aliases (`import os as _os` → `_os.environ.get`
        matches `os.environ.get`)."""
        if not dotted:
            return ""
        head, sep, rest = dotted.partition(".")
        return self.imports.get(head, head) + sep + rest

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "index"
            and isinstance(func.value, ast.Name)
            and func.value.id in CONTRACT_TUPLE_NAMES
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            self.model.index_refs.append(IndexRef(
                self.path, node.lineno, node.col_offset,
                func.value.id, node.args[0].value,
            ))
        dotted = self._canonical(_dotted(func))
        if dotted in _ENV_GET_CALLS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and _is_knob_name(arg.value):
                self.model.env_reads.append(EnvRead(
                    self.path, node.lineno, node.col_offset, arg.value
                ))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if (
            isinstance(node.ctx, ast.Load)
            and self._canonical(_dotted(node.value)) in _ENV_SUBSCRIPTS
            and isinstance(node.slice, ast.Constant)
            and _is_knob_name(node.slice.value)
        ):
            self.model.env_reads.append(EnvRead(
                self.path, node.lineno, node.col_offset, node.slice.value
            ))
        self.generic_visit(node)



def build_model(modules: Sequence[ModuleSource]) -> ContractModel:
    """Extract the contract model from every parsed module."""
    model = ContractModel()
    for module in modules:
        _ModuleExtractor(model, module).visit(module.tree)
    return model
