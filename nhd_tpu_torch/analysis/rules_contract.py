"""contract: NHD7xx — the port's solve signature and kernel ABI, across
layers.

NHD701  missing-consumer: a field present in one layer of the solve
        signature is absent (or a positional span disagrees) in another —
        DELTA_FIELDS vs _ARG_ORDER, the _MUTABLE/_STATIC partition,
        ``.index()`` and by-name (``dict(zip(_ARG_ORDER, ...))``) reads,
        the ``padded_args`` block spans; or a
        kernel's pointer or size list differs between its ``abi.py``
        row, its ``.cu`` entry point, its plain version
        (``kernels/reference.py``) and the argument builders that call it;
        or a size ``abi.py`` passes as 64-bit (``WIDE``) that the ``.cu``
        declares narrower, or the reverse; or a helper entry point
        (``HELPERS``: a source with no kernel) whose parameters or their
        C kinds differ from its ``.cu``.
NHD702  order-contract violation: same field *set* but a different order
        (positional consumers would read the wrong tensor) — in the
        signature tuples, or between an ABI row and its ``.cu`` entry,
        its plain version or a call site — duplicated fields,
        overlapping partition, or conflicting definitions.
NHD703  fingerprint-source omission: the program fingerprint
        (``solver/aot.py``) does not hash a module whose source defines
        the solve (the _ARG_ORDER module and the get_tables combo-table
        module), or a library fingerprint (``kernels/build.py``) does not
        hash the kernel's ``.cu`` source and the ABI table — a cached
        artifact would survive an edit that changes what it computes.
NHD710  host-alias hazard: a tensor that aliases a host mirror
        (``torch.from_numpy``, ``torch.as_tensor`` on the CPU, and the
        views that flow from them) reaches an argument a kernel writes
        in place (``inplace=True`` in ``abi.py``) or an ``index_copy_``
        target without an owning copy — the kernel (or its plain
        version on the CPU) would mutate the host mirror in place: the
        port's form of the reference's donation-alias hazard.
NHD720  unregistered env knob: an ``NHD_*`` environment read that is not
        in the shared registry (``nhd_tpu_torch/config/knobs.py``
        ``KNOBS``), or an ``NHDC_*`` read that is not in the port's own
        (``nhd_tpu_torch/config/port_knobs.py``) — an unregistered knob
        is an undocumented knob.

Checks fire only when both sides of a contract are visible in the
analyzed project — analyzing one file alone stays silent unless that
file carries both the definition and the violating consumer, which is
exactly how the fixtures exercise each rule. ``test_*``/``conftest.py``
modules are never part of the contract model.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nhd_tpu_torch.analysis.core import Finding, ModuleSource, _dotted

from nhd_tpu_torch.analysis.contracts import (
    ContractModel,
    TupleDef,
    build_model,
    module_basename,
)


def _is_test_module(path: str) -> bool:
    name = path.rsplit("/", 1)[-1]
    return name.startswith("test_") or name == "conftest.py"


def check_project(modules: Sequence[ModuleSource]) -> List[Finding]:
    modules = [m for m in modules if not _is_test_module(m.path)]
    model = build_model(modules)
    out: List[Finding] = []
    out.extend(_check_signature(model))
    out.extend(_check_abi(model))
    out.extend(_check_fingerprints(model))
    out.extend(_check_knobs(model))
    out.extend(_check_host_alias(modules, model))
    return out


# ---------------------------------------------------------------------------
# NHD701 / NHD702: the signature itself
# ---------------------------------------------------------------------------

def _finding(rule: str, site, message: str) -> Finding:
    return Finding(rule, site.path, site.line, site.col, message)


def _resolve_def(
    model: ContractModel, name: str, out: List[Finding]
) -> Optional[TupleDef]:
    """The project's definition of one contract tuple; conflicting
    re-definitions are themselves an NHD702 (every consumer would pick
    whichever import it happens to see)."""
    defs = model.tuple_defs.get(name, [])
    if not defs:
        return None
    first = defs[0]
    for other in defs[1:]:
        if other.fields != first.fields:
            out.append(_finding(
                "NHD702", other,
                f"conflicting definition of {name}: differs from "
                f"{first.path}:{first.line}",
            ))
    return first


def _check_signature(model: ContractModel) -> List[Finding]:
    out: List[Finding] = []
    arg = _resolve_def(model, "_ARG_ORDER", out)
    pod = _resolve_def(model, "_POD_ARG_ORDER", out)
    mutable = _resolve_def(model, "_MUTABLE", out)
    static = _resolve_def(model, "_STATIC", out)
    delta = _resolve_def(model, "DELTA_FIELDS", out)

    # duplicated fields inside any one tuple break every positional use
    for tdef in (arg, pod, mutable, static, delta):
        if tdef is None:
            continue
        seen: Set[str] = set()
        for f in tdef.fields:
            if f in seen:
                out.append(_finding(
                    "NHD702", tdef,
                    f"{tdef.name} lists '{f}' more than once",
                ))
            seen.add(f)

    # encode's delta layer must mirror the kernel signature exactly:
    # same set (NHD701, the missing consumer is named) and same order
    # (NHD702 — ClusterDelta scatters rows by position)
    if arg is not None and delta is not None:
        for f in arg.fields:
            if f not in delta.fields:
                out.append(_finding(
                    "NHD701", delta,
                    f"'{f}' is in {arg.path.rsplit('/', 1)[-1]} _ARG_ORDER "
                    f"but missing from DELTA_FIELDS — the delta layer "
                    f"(encode.ClusterDelta) would never upload it",
                ))
        for f in delta.fields:
            if f not in arg.fields:
                out.append(_finding(
                    "NHD701", delta,
                    f"DELTA_FIELDS lists '{f}' which is not in _ARG_ORDER "
                    f"— no solver consumer exists for it",
                ))
        if set(arg.fields) == set(delta.fields) and arg.fields != delta.fields:
            i = next(
                i for i, (a, d) in enumerate(zip(arg.fields, delta.fields))
                if a != d
            )
            out.append(_finding(
                "NHD702", delta,
                f"DELTA_FIELDS order diverges from _ARG_ORDER at position "
                f"{i} ('{delta.fields[i]}' vs '{arg.fields[i]}') — "
                f"positional consumers would read the wrong array",
            ))

    # the in-place update partition must tile _ARG_ORDER exactly
    if arg is not None and mutable is not None and static is not None:
        part = set(mutable.fields) | set(static.fields)
        for f in arg.fields:
            if f not in part:
                out.append(_finding(
                    "NHD701", arg,
                    f"'{f}' is in _ARG_ORDER but neither _MUTABLE nor "
                    f"_STATIC — the in-place row updates (device_state "
                    f"scatter, the megaround's claims) would drop it",
                ))
        for tdef in (mutable, static):
            for f in tdef.fields:
                if f not in arg.fields:
                    out.append(_finding(
                        "NHD701", tdef,
                        f"{tdef.name} lists '{f}' which is not in "
                        f"_ARG_ORDER",
                    ))
        overlap = set(mutable.fields) & set(static.fields)
        for f in sorted(overlap):
            out.append(_finding(
                "NHD702", static,
                f"'{f}' is in both _MUTABLE and _STATIC — the partition "
                f"must be disjoint",
            ))

    # positional .index() consumers
    for ref in model.index_refs:
        tdef = model.first_def(ref.tuple_name)
        if tdef is not None and ref.field_name not in tdef.fields:
            out.append(_finding(
                "NHD701", ref,
                f"{ref.tuple_name}.index('{ref.field_name}'): no such "
                f"field in {tdef.path}:{tdef.line} — this raises "
                f"ValueError at first call",
            ))

    # by-name consumers: d = dict(zip(T, ...)); d["field"]
    for ref in model.key_refs:
        tdef = model.first_def(ref.tuple_name)
        if tdef is not None and ref.field_name not in tdef.fields:
            out.append(_finding(
                "NHD701", ref,
                f"dict(zip({ref.tuple_name}, ...))['{ref.field_name}']: "
                f"no such field in {tdef.path}:{tdef.line} — this raises "
                f"KeyError at first call",
            ))

    # padded_args block: node arrays first, so the node/pod boundary is
    # len(_ARG_ORDER), literally or symbolically
    if arg is not None:
        for span in model.block_spans:
            if span.count is not None and span.count != len(arg.fields):
                out.append(_finding(
                    "NHD701", span,
                    f"padded_args block cut at a literal {span.count} but "
                    f"len(_ARG_ORDER) == {len(arg.fields)} — the node "
                    f"tensors and the pod tensors would be mixed",
                ))
            elif span.sym is not None and span.sym != "_ARG_ORDER" \
                    and span.sym in model.tuple_defs:
                out.append(_finding(
                    "NHD701", span,
                    f"padded_args block cut at len({span.sym}); the node "
                    f"block spans _ARG_ORDER",
                ))

    return out


# ---------------------------------------------------------------------------
# NHD701 / NHD702: the kernel ABI across its four layers
# ---------------------------------------------------------------------------

#: ``extern "C" int nhd_x(<params>)`` — a kernel's C entry point
_CU_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _cu_params(abi_path: str) -> Dict[str, Tuple[str, int, List[Tuple[str, str]]]]:
    """entry -> (file, line, [(C type, name), ...]) of every ``extern "C"``
    entry point in the ``.cu`` files beside the ABI table, every
    parameter kept."""
    out: Dict[str, Tuple[str, int, List[Tuple[str, str]]]] = {}
    here = Path(abi_path).parent
    if not here.is_dir():
        return out
    for cu in sorted(here.glob("*.cu")):
        text = cu.read_text()
        for m in _CU_ENTRY.finditer(text):
            params = []
            for p in (p.strip() for p in m.group(2).split(",")):
                if p:
                    name = re.split(r"[\s*]+", p)[-1]
                    params.append((p[: len(p) - len(name)].strip(), name))
            out[m.group(1)] = (cu.name, text.count("\n", 0, m.start()) + 1, params)
    return out


def _c_kind(ctype: str) -> str:
    """The ``abi.HELPERS`` kind of a C parameter type."""
    wide = "long long" in ctype or "uint64_t" in ctype or "Handle" in ctype
    if "*" in ctype:
        return "u64ptr" if wide else "ptr"
    return "u64" if wide else "int"


def _cu_entries(abi_path: str) -> Dict[str, Tuple[str, int, List[str], List[str]]]:
    """entry -> (file, line, pointer params, int params) of every ``.cu``
    beside the ABI table. The trailing ``int device, void* stream`` are
    the launch context, not part of the row."""
    out: Dict[str, Tuple[str, int, List[str], List[str]]] = {}
    here = Path(abi_path).parent
    if not here.is_dir():
        return out
    for cu in sorted(here.glob("*.cu")):
        text = cu.read_text()
        for m in _CU_ENTRY.finditer(text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            params = [p for p in params if p.split()[-1].lstrip("*")
                      not in ("device", "stream")]
            ptrs, ints = [], []
            for p in params:
                name = re.split(r"[\s*]+", p)[-1]
                (ptrs if "*" in p else ints).append(name)
            line = text.count("\n", 0, m.start()) + 1
            out[m.group(1)] = (cu.name, line, ptrs, ints)
    return out


def _compare(rule_site, what: str, want: Sequence[str], got: Sequence[str],
             layer: str) -> List[Finding]:
    """NHD701 for names in one list but not the other, NHD702 for the
    same names in another order."""
    out: List[Finding] = []
    missing = [n for n in want if n not in got]
    extra = [n for n in got if n not in want]
    for n in missing:
        out.append(_finding(
            "NHD701", rule_site,
            f"{what}: '{n}' is in the abi.py row but missing from "
            f"{layer}",
        ))
    for n in extra:
        out.append(_finding(
            "NHD701", rule_site,
            f"{what}: {layer} has '{n}', which the abi.py row lacks",
        ))
    if not missing and not extra and list(want) != list(got):
        i = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        out.append(_finding(
            "NHD702", rule_site,
            f"{what}: {layer} diverges from the abi.py row at position "
            f"{i} ('{got[i]}' vs '{want[i]}') — the kernel would read the "
            f"wrong tensor",
        ))
    return out


def _check_abi(model: ContractModel) -> List[Finding]:
    out: List[Finding] = []
    if not model.abi_rows:
        return out
    entries = _cu_entries(next(iter(model.abi_rows.values())).path)
    fields = {
        name: set(t.fields) for name, t in (
            (n, model.first_def(n)) for n in ("_ARG_ORDER", "_POD_ARG_ORDER")
        ) if t is not None
    }
    for kernel, row in sorted(model.abi_rows.items()):
        # the .cu entry point: pointers then sizes, by parameter name
        if entries:
            if row.entry not in entries:
                out.append(_finding(
                    "NHD701", row,
                    f"{kernel}: no extern \"C\" entry {row.entry} in any "
                    f".cu beside {row.path}",
                ))
            else:
                cu, line, ptrs, ints = entries[row.entry]
                layer = f"{cu}:{line}"
                out.extend(_compare(row, f"{kernel} pointers",
                                    [a[0] for a in row.args], ptrs, layer))
                out.extend(_compare(row, f"{kernel} sizes", row.sizes, ints,
                                    layer))
        # the plain version: the inputs, positionally (its keywords are
        # the wrapper's, from which kernels.sizes_for derives the sizes)
        sig = model.plain_sigs.get(kernel)
        if sig is not None:
            out.extend(_compare(sig, f"{kernel} inputs", row.inputs,
                                sig.positional, f"the plain version "
                                f"{sig.path}:{sig.line}"))
    out.extend(_check_widths(model, entries))
    # call sites: what the caller passes, position by position
    for call in model.kernel_calls:
        row = model.abi_rows.get(call.kernel)
        if row is None:
            continue
        args = call.args
        if call.builder is not None:
            built = model.builders.get(call.builder.rsplit(".", 1)[-1])
            if built is None:
                continue
            args = built + args[1:]
        elif any(a is None for a in args) and len(args) != len(row.inputs):
            continue   # starred or keyword-assembled: not judged
        if len(args) != len(row.inputs):
            out.append(_finding(
                "NHD701", call,
                f"kernels.{call.kernel} gets {len(args)} tensors but its "
                f"abi.py row takes {len(row.inputs)} inputs "
                f"({row.path}:{row.line})",
            ))
            continue
        for i, (desc, want) in enumerate(zip(args, row.inputs)):
            if desc is None:
                continue
            tup, name = desc
            known = fields.get(tup, ())
            if name != want and want in known and name in known:
                out.append(_finding(
                    "NHD702", call,
                    f"kernels.{call.kernel} position {i}: passes {tup} "
                    f"'{name}' where the abi.py row takes '{want}' — the "
                    f"kernel would read the wrong tensor",
                ))
                break  # one finding per call site
    return out


def _check_widths(model: ContractModel, entries) -> List[Finding]:
    """The 64-bit sizes (``WIDE``) against the ``.cu`` types, and the
    helper entry points against their ``.cu``: ctypes passes an int
    where a 64-bit handle is declared, and cuts a handle bound as int."""
    out: List[Finding] = []
    if not entries:
        return out
    typed = _cu_params(next(iter(model.abi_rows.values())).path)
    for kernel, row in sorted(model.abi_rows.items()):
        if row.entry not in typed:
            continue
        cu, line, params = typed[row.entry]
        for ctype, name in params:
            if name not in row.sizes:
                continue
            wide = _c_kind(ctype) == "u64"
            if wide != (name in model.wide):
                out.append(_finding(
                    "NHD701", row,
                    f"{kernel} size '{name}': {cu}:{line} declares it "
                    f"'{ctype}', but abi.py binds it as "
                    f"{'a 64-bit int (WIDE)' if name in model.wide else 'an int'}",
                ))
    for h in model.helper_rows:
        what = f"helper {h.source} {h.entry}"
        if h.entry not in typed:
            out.append(_finding(
                "NHD701", h,
                f"{what}: no extern \"C\" entry {h.entry} in any .cu beside "
                f"{h.path}",
            ))
            continue
        cu, line, params = typed[h.entry]
        found = _compare(h, f"{what} parameters", [n for n, _ in h.params],
                         [n for _, n in params], f"{cu}:{line}")
        out.extend(found)
        if found:
            continue
        for (name, kind), (ctype, _) in zip(h.params, params):
            if _c_kind(ctype) != kind:
                out.append(_finding(
                    "NHD701", h,
                    f"{what}: '{name}' is '{ctype}' in {cu}:{line}, but "
                    f"abi.py binds it as {kind}",
                ))
    return out


# ---------------------------------------------------------------------------
# NHD703: fingerprint sources
# ---------------------------------------------------------------------------

def _check_fingerprints(model: ContractModel) -> List[Finding]:
    out: List[Finding] = []
    if not model.fingerprint_sites:
        return out
    required: Dict[str, str] = {}
    for tdef in model.tuple_defs.get("_ARG_ORDER", []):
        required[module_basename(tdef.path)] = "defines _ARG_ORDER"
    for base in model.table_modules:
        required.setdefault(base, "defines get_tables")
    abi_mods = sorted({module_basename(r.path)
                       for r in model.abi_rows.values()}) or ["abi"]
    for site in model.fingerprint_sites:
        hashed = set(site.hashed)
        if site.library:
            for base in abi_mods:
                if base not in hashed:
                    out.append(_finding(
                        "NHD703", site,
                        f"library fingerprint does not hash module "
                        f"'{base}' (the ABI table) — a cached library "
                        f"would survive an edit of its pointer order",
                    ))
            if not site.sources:
                out.append(_finding(
                    "NHD703", site,
                    "library fingerprint does not hash the kernel's .cu "
                    "source — a cached library would survive an edit of "
                    "its kernel",
                ))
            continue
        for base, why in sorted(required.items()):
            if base not in hashed:
                out.append(_finding(
                    "NHD703", site,
                    f"program fingerprint does not hash module '{base}' "
                    f"({why}) — a cached artifact would survive an "
                    f"edit that changes placement semantics",
                ))
    return out


# ---------------------------------------------------------------------------
# NHD720: env-knob registries
# ---------------------------------------------------------------------------

def _check_knobs(model: ContractModel) -> List[Finding]:
    """NHD_* reads against the shared registry, NHDC_* reads against the
    port's own; a prefix whose registry is not in the project is out of
    scope."""
    out: List[Finding] = []
    for port, prefix in ((False, "NHD_"), (True, "NHDC_")):
        regs = [r for r in model.registries if r.port == port]
        if not regs:
            continue
        registered: Set[str] = set()
        for reg in regs:
            registered.update(reg.names)
        reg_path = regs[0].path
        for read in model.env_reads:
            if read.name.startswith(prefix) and read.name not in registered:
                out.append(_finding(
                    "NHD720", read,
                    f"env knob '{read.name}' is read here but not "
                    f"registered in {reg_path} KNOBS — an unregistered "
                    f"knob is an undocumented knob",
                ))
    return out


# ---------------------------------------------------------------------------
# NHD710: host-alias dataflow
# ---------------------------------------------------------------------------
#
# Model:
#
# * taint SEEDS are the zero-copy host wrappers: ``torch.from_numpy``,
#   ``torch.frombuffer`` and ``torch.as_tensor`` without a device (or on
#   the CPU) — each shares the host array's memory.
# * taint PROPAGATES through: plain assignment, tuple/list/dict displays
#   and comprehensions, subscripts and slices (views), conditional
#   expressions, starred args, the view-returning tensor methods
#   (``.view``, ``.reshape``, ``.contiguous``, ``.to`` without
#   ``copy=True`` — on the CPU each may hand back the same memory), user
#   functions classified ALIASING (some return is a bare parameter) or
#   TRANSPARENT (returns a zero-copy wrapper of a parameter), and
#   instance attributes any method of the class assigns a tainted value
#   into (class-wide fixed point).
# * taint is CUT by any other call — ``.clone()``, ``.to(..., copy=True)``,
#   ``np.ascontiguousarray`` and every function not classified produce
#   owned values.
# * SINKS are the positions of ``kernels.NAME(...)`` whose abi.py input
#   is ``inplace`` and the receiver of ``.index_copy_`` /
#   ``.index_copy``'s in-place form.

_ZERO_COPY = {"torch.from_numpy", "torch.frombuffer"}
_MAYBE_COPY = {"torch.as_tensor", "torch.asarray"}
#: tensor methods that may return the receiver's memory
_VIEW_METHODS = {
    "view", "reshape", "contiguous", "to", "expand", "permute", "t",
    "flatten", "squeeze", "unsqueeze", "view_as", "narrow", "select",
    "detach", "as_strided", "transpose", "movedim", "unflatten",
}


def _is_cpu_or_absent(call: ast.Call) -> bool:
    """torch.as_tensor aliases host memory unless it is given a device
    other than the CPU."""
    for kw in call.keywords:
        if kw.arg == "device":
            return isinstance(kw.value, ast.Constant) and kw.value.value == "cpu"
    return len(call.args) < 3


def _is_alias_source(call: ast.Call) -> bool:
    d = _dotted(call.func) or ""
    if d in _ZERO_COPY:
        return True
    return d in _MAYBE_COPY and _is_cpu_or_absent(call)


def _is_view_call(call: ast.Call) -> bool:
    """A view-returning method call: ``.to(...)`` only without
    ``copy=True``."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr not in _VIEW_METHODS:
        return False
    if call.func.attr == "to":
        return not any(
            kw.arg == "copy" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in call.keywords
        )
    return True


def _classify_functions(modules: Sequence[ModuleSource]) -> Dict[str, str]:
    """name -> 'aliasing' | 'transparent' for every function in the
    project whose returns can pass a parameter through. Names are
    unqualified: the callable travels between modules by from-import."""
    classes: Dict[str, str] = {}
    for module in modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in node.args.args
                      + node.args.posonlyargs + node.args.kwonlyargs}
            params.discard("self")
            kind = _return_kind(node, params)
            if kind is not None:
                # aliasing dominates transparent if both appear
                if classes.get(node.name) != "aliasing":
                    classes[node.name] = kind
    return classes


def _own_walk(func: ast.AST):
    """ast.walk that does not descend into nested defs/classes — their
    bodies are judged as functions of their own."""
    stack: List[ast.AST] = [func]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            stack.append(child)


def _return_kind(
    func: ast.AST, params: Set[str]
) -> Optional[str]:
    kind: Optional[str] = None
    for node in _own_walk(func):
        if not (isinstance(node, ast.Return) and node.value is not None):
            continue
        if _expr_aliases_param(node.value, params):
            return "aliasing"
        if _is_zero_copy_of_param(node.value, params):
            kind = "transparent"
    return kind


def _expr_aliases_param(node: ast.AST, params: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in params
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_expr_aliases_param(e, params) for e in node.elts)
    if isinstance(node, ast.Dict):
        return any(
            v is not None and _expr_aliases_param(v, params)
            for v in node.values
        )
    if isinstance(node, ast.IfExp):
        return (
            _expr_aliases_param(node.body, params)
            or _expr_aliases_param(node.orelse, params)
        )
    if isinstance(node, ast.Subscript):
        # a slice of a parameter is a view of it
        return _expr_aliases_param(node.value, params)
    if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        return _expr_aliases_param(node.elt, params)
    if isinstance(node, ast.Call) and _is_view_call(node):
        return _expr_aliases_param(node.func.value, params)
    return False


def _is_zero_copy_of_param(node: ast.AST, params: Set[str]) -> bool:
    return (
        isinstance(node, ast.Call)
        and _is_alias_source(node)
        and bool(node.args)
        and _expr_aliases_param(node.args[0], params)
    )


def _local_alias_table(tree: ast.Module) -> Dict[str, str]:
    """from-import aliases: local name -> original function name."""
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.asname:
                    table[alias.asname] = alias.name
    return table


class _Taint:
    """Per-function taint evaluation against shared project facts."""

    def __init__(
        self,
        fn_class: Dict[str, str],
        aliases: Dict[str, str],
        attr_taint: Set[str],
    ):
        self.fn_class = fn_class
        self.aliases = aliases
        self.attr_taint = attr_taint
        self.locals: Set[str] = set()

    def _callee_kind(self, call: ast.Call) -> Optional[str]:
        dotted = _dotted(call.func) or ""
        name = dotted.rsplit(".", 1)[-1]
        name = self.aliases.get(name, name)
        return self.fn_class.get(name)

    def tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            if _is_alias_source(node):
                return True
            if _is_view_call(node):
                return self.tainted(node.func.value)
            kind = self._callee_kind(node)
            if kind == "transparent":
                return bool(node.args) and self.tainted(node.args[0])
            if kind == "aliasing":
                return any(self.tainted(a) for a in node.args)
            return False  # any other call produces an owned value
        if isinstance(node, ast.Name):
            return node.id in self.locals
        if isinstance(node, ast.Attribute):
            return (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in self.attr_taint
            )
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(
                v is not None and self.tainted(v) for v in node.values
            )
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.tainted(node.elt) or any(
                self.tainted(gen.iter) for gen in node.generators
            )
        if isinstance(node, ast.DictComp):
            return self.tainted(node.value) or any(
                self.tainted(gen.iter) for gen in node.generators
            )
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.tainted(node.value)
        return False


def _function_nodes(tree: ast.Module):
    """(func, owning-class-name-or-None) for every def in the module."""
    out = []

    def walk(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, cls))
                walk(child, cls)
            else:
                walk(child, cls)

    walk(tree, None)
    return out


def _check_host_alias(modules: Sequence[ModuleSource],
                      model: ContractModel) -> List[Finding]:
    fn_class = _classify_functions(modules)
    inplace = {k: r.inplace for k, r in model.abi_rows.items() if r.inplace}
    out: List[Finding] = []
    for module in modules:
        aliases = _local_alias_table(module.tree)
        funcs = _function_nodes(module.tree)
        # class-wide attribute taint, to a fixed point: self.X = tainted
        # in any method taints reads of self.X in every method
        attr_taint: Dict[Optional[str], Set[str]] = {}
        for _ in range(4):
            changed = False
            for func, cls in funcs:
                taints = attr_taint.setdefault(cls, set())
                eng = _run_function(
                    func, fn_class, aliases, taints, inplace, None
                )
                for attr in eng:
                    if attr not in taints:
                        taints.add(attr)
                        changed = True
            if not changed:
                break
        for func, cls in funcs:
            _run_function(
                func, fn_class, aliases, attr_taint.get(cls, set()),
                inplace, out, path=module.path,
            )
    return out


def _taint_targets(t: ast.AST) -> List[str]:
    """Names a tainted assignment taints: plain locals, every name of a
    tuple target, the *base* of a subscript store (``d[k] = tainted``
    taints ``d``; ``self._dev[k] = tainted`` taints the attr), and
    ``self.X`` attribute stores (returned as ``self.X``)."""
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        return [n for e in t.elts for n in _taint_targets(e)]
    if isinstance(t, ast.Starred):
        return _taint_targets(t.value)
    if isinstance(t, ast.Subscript):
        return _taint_targets(t.value)
    if (
        isinstance(t, ast.Attribute)
        and isinstance(t.value, ast.Name)
        and t.value.id == "self"
    ):
        return [f"self.{t.attr}"]
    return []


def _run_function(
    func: ast.AST,
    fn_class: Dict[str, str],
    aliases: Dict[str, str],
    attr_taint: Set[str],
    inplace: Dict[str, Tuple[int, ...]],
    findings: Optional[List[Finding]],
    path: str = "",
) -> Set[str]:
    """One pass over a function body: propagate local taint to a fixed
    point, then (when *findings* is given) flag tainted values that a
    kernel or an ``index_copy_`` writes in place. Returns the attr names
    this function writes tainted values into (for the class fixed
    point)."""
    eng = _Taint(fn_class, aliases, attr_taint)
    stmts = [
        n for n in _own_walk(func)
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
    ]
    stmts.sort(key=lambda n: (n.lineno, n.col_offset))
    attr_writes: Set[str] = set()
    for _ in range(8):
        changed = False
        for stmt in stmts:
            value = stmt.value
            if value is None or not eng.tainted(value):
                continue
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            for t in targets:
                for name in _taint_targets(t):
                    if name.startswith("self."):
                        attr = name[5:]
                        if attr not in attr_writes:
                            attr_writes.add(attr)
                            changed = True
                    elif name not in eng.locals:
                        eng.locals.add(name)
                        changed = True
        if not changed:
            break
    if findings is None:
        return attr_writes
    for node in _own_walk(func):
        if not isinstance(node, ast.Call):
            continue
        func_attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if func_attr == "index_copy_" and eng.tainted(node.func.value):
            findings.append(Finding(
                "NHD710", path, node.lineno, node.col_offset,
                "index_copy_ writes in place into a tensor that may alias "
                "a live host array (torch.from_numpy / torch.as_tensor on "
                "the CPU) — the row update would rewrite the host mirror; "
                "own it first (.clone() / .to(device, copy=True))",
            ))
            continue
        d = _dotted(node.func) or ""
        head, _, kernel = d.rpartition(".")
        if head.rsplit(".", 1)[-1] != "kernels" or kernel not in inplace:
            continue
        for p in inplace[kernel]:
            arg: Optional[ast.AST] = None
            if any(isinstance(a, ast.Starred) for a in node.args):
                arg = next(a for a in node.args if isinstance(a, ast.Starred))
            elif p < len(node.args):
                arg = node.args[p]
            if arg is not None and eng.tainted(arg):
                findings.append(Finding(
                    "NHD710", path, node.lineno, node.col_offset,
                    f"kernels.{kernel} writes argument {p} in place, and "
                    f"the value may alias a live host array (torch."
                    f"from_numpy / torch.as_tensor on the CPU) without an "
                    f"owning copy — the kernel would mutate the host "
                    f"mirror; own it first (.clone() / .to(device, "
                    f"copy=True))",
                ))
                break  # one finding per call site
    return attr_writes
