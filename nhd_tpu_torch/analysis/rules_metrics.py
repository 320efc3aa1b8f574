"""NHD6xx — metrics discipline for the Prometheus exposition surface.

The repo's /metrics plane is hand-rendered text exposition
(rpc/metrics.py, obs/histo.py, obs/slo.py), which is exactly where
metric-name typos, unregistered families, and cardinality bombs slip in:
a scraper silently drops a malformed name, a family emitted without a
``# TYPE`` declaration breaks PromQL functions, and one ``corr=`` or
``pod=`` label turns a bounded time series into one-per-pod-ever.

This is a PROJECT pack (like lockgraph): registrations are collected
across every analyzed module first, then each module's exposition
strings are judged against the whole-project registry — histo.py's
constructor table legitimately registers what metrics.py renders.

What counts as a **registration** (any module):

* a ``# TYPE <name> <kind>`` / ``# HELP <name> ...`` string literal with
  a static name;
* a ``Histogram("x", ...)`` / ``LabeledHistogram("x", ...)``
  constructor first argument (family ``nhd_x`` plus its
  ``_bucket``/``_sum``/``_count`` children);
* a tuple literal ``("x", "counter"|"gauge"|..., ...)`` — the
  name/kind/help row idiom rpc/metrics.py and obs/slo.py render from;
* a dict literal ``{"x": ("counter", ...)}`` — the ApiCounters.KNOWN
  idiom;
* a ``*FAMILIES*`` assignment of a tuple/list of plain strings
  (obs/slo.py METRIC_FAMILIES).

What counts as a **sample line**: a string whose static head is a full
metric name followed by ``{`` (labels) or by a value (numeric literal,
or an immediately following f-string interpolation). Dynamic names
(``f"nhd_{name} ..."``) are skipped — those render from a registration
table by construction, which is the sanctioned pattern.

* NHD601 — an exposition name that does not match ``nhd_[a-z0-9_]+``
  (wrong prefix, uppercase, dashes): scrapers and recording rules key on
  the prefix, and invalid chars break the exposition format outright.
* NHD602 — a sample line for a family no analyzed module registers: it
  will scrape TYPE-less (breaking counter semantics) and no registry
  table documents it.
* NHD603 — an unbounded-cardinality label (``corr``/``uid``/``pod``/…)
  on a sample line or as a LabeledHistogram label key: per-pod/per-corr
  series grow without bound and take the scrape DB down; identities
  belong in the flight recorder (/decisions), not in label values.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from nhd_tpu_torch.analysis.core import Finding, ModuleSource

NAME_RE = re.compile(r"^nhd_[a-z0-9_]+$")
# a TYPE declaration is self-identifying (the kind keyword follows); a
# HELP line only counts when the family is nhd-ish — "# HELP me ..."
# prose in a docstring must never register as an exposition line
_TYPE_DECL = re.compile(
    r"#\s*TYPE\s+([A-Za-z_:][A-Za-z0-9_:.\-]*)\s+"
    r"(?:counter|gauge|histogram|summary)\b"
)
_HELP_DECL = re.compile(
    r"#\s*HELP\s+([Nn][Hh][Dd][A-Za-z0-9_:.\-]*)(?=\s|$)"
)
_NAME_HEAD = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)")
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"')
_NUMBERISH = re.compile(r"^(?:[0-9.]|\+Inf)")

EXPOSITION_KINDS = frozenset({"counter", "gauge", "histogram", "summary"})

#: label keys whose value space grows with the pod population — one of
#: these on a metric family is a time-series-per-pod-ever cardinality bomb
UNBOUNDED_LABELS = frozenset({
    "corr", "corr_id", "uid", "pod_uid", "pod", "pod_name", "namespace",
})

#: histogram child suffixes resolve to their parent family registration
_HISTO_SUFFIXES = ("_bucket", "_sum", "_count")


def _static_text(node: ast.AST) -> Optional[str]:
    """The full text of a string literal with every interpolation
    replaced by \\x00 (so label scans see the static skeleton), or None
    for non-strings."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("\x00")
        return "".join(parts)
    return None


def _sample_name(text: str) -> Optional[str]:
    """The metric family a string emits as a sample line, or None.

    Requires an nhd-prefixed, complete static name followed by labels
    (``{``) or a value (numeric, or a \\x00 interpolation placeholder) —
    so prose like ``"nhd_tpu_torch scheduler"``, paths like ``"nhd_tpu_torch/rpc"``
    and bare family references in asserts never register as emissions.
    The prefix gate is case-insensitive so ``NHD_Foo{...}`` still lands
    in NHD601 instead of escaping detection entirely."""
    m = _NAME_HEAD.match(text)
    if not m or not text[len(m.group(1)):]:
        return None  # bare name (a reference, not an emission) or no name
    name, rest = m.group(1), text[len(m.group(1)):]
    if not name.lower().startswith("nhd"):
        return None
    if rest.startswith("{"):
        return name
    if rest.startswith(" "):
        value = rest[1:].lstrip()
        if value.startswith("\x00") or _NUMBERISH.match(value):
            return name
    return None


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _registrations(tree: ast.Module) -> Set[str]:
    """Every family this module registers (full names, nhd_-prefixed
    where the idiom stores the unprefixed name)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        text = _static_text(node) if isinstance(
            node, (ast.Constant, ast.JoinedStr)
        ) else None
        if text is not None:
            for rx in (_TYPE_DECL, _HELP_DECL):
                for m in rx.finditer(text):
                    if "\x00" not in m.group(1):
                        out.add(m.group(1))
        if isinstance(node, ast.Call):
            cname = _call_name(node)
            if cname and cname.endswith("Histogram") and node.args:
                s = _str_const(node.args[0])
                if s:
                    out.add(f"nhd_{s}")
        if isinstance(node, (ast.Tuple, ast.List)) and len(node.elts) >= 2:
            first = _str_const(node.elts[0])
            second = _str_const(node.elts[1])
            if first and second in EXPOSITION_KINDS:
                out.add(f"nhd_{first}")
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                key = _str_const(k) if k is not None else None
                if (
                    key
                    and isinstance(v, ast.Tuple)
                    and v.elts
                    and _str_const(v.elts[0]) in EXPOSITION_KINDS
                ):
                    out.add(f"nhd_{key}")
        if isinstance(node, ast.Assign):
            names = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if any("FAMILIES" in n for n in names) and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                for elt in node.value.elts:
                    s = _str_const(elt)
                    if s:
                        out.add(f"nhd_{s}")
    return out


def _registered(name: str, registry: Set[str]) -> bool:
    if name in registry:
        return True
    for suffix in _HISTO_SUFFIXES:
        if name.endswith(suffix) and name[: -len(suffix)] in registry:
            return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, registry: Set[str]):
        self.path = path
        self.registry = registry
        self.findings: List[Finding] = []

    def _check_name(self, name: str, node: ast.AST) -> bool:
        """NHD601; returns whether the name was well-formed (a malformed
        name is not additionally reported unregistered)."""
        if NAME_RE.match(name):
            return True
        self.findings.append(Finding(
            "NHD601", self.path, node.lineno, node.col_offset,
            f"exported metric name {name!r} must match nhd_[a-z0-9_]+ — "
            "scrapers and recording rules key on the prefix, and invalid "
            "characters break the text exposition format",
        ))
        return False

    def _visit_string(self, node: ast.AST) -> None:
        text = _static_text(node)
        if text is None:
            return
        for line in text.split("\n"):
            line = line.strip()
            for rx in (_TYPE_DECL, _HELP_DECL):
                for m in rx.finditer(line):
                    if "\x00" not in m.group(1):
                        self._check_name(m.group(1), node)
            name = _sample_name(line)
            if name is None or "\x00" in name:
                continue
            if self._check_name(name, node) and not _registered(
                name, self.registry
            ):
                self.findings.append(Finding(
                    "NHD602", self.path, node.lineno, node.col_offset,
                    f"metric family {name!r} is emitted but registered "
                    "nowhere (no # TYPE declaration, histogram registry "
                    "entry, name/kind table row, or *FAMILIES* list in "
                    "any analyzed module): it scrapes TYPE-less and no "
                    "registry documents it",
                ))
            for lm in _LABEL.finditer(line):
                if lm.group(1) in UNBOUNDED_LABELS:
                    self.findings.append(Finding(
                        "NHD603", self.path, node.lineno, node.col_offset,
                        f"label {lm.group(1)!r} on metric family "
                        f"{name!r} has unbounded cardinality (one time "
                        "series per pod/correlation ever seen): put "
                        "identities in the flight recorder's /decisions "
                        "view, not in label values",
                    ))

    def visit_Constant(self, node: ast.Constant) -> None:
        self._visit_string(node)

    def visit_JoinedStr(self, node: ast.JoinedStr) -> None:
        self._visit_string(node)
        # don't generic_visit: the inner Constants are fragments of THIS
        # string and must not be re-judged out of context

    def visit_Call(self, node: ast.Call) -> None:
        cname = _call_name(node)
        if cname == "LabeledHistogram":
            # the label key arrives positionally (arg 1) or as label=
            label_node = node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "label"),
                None,
            )
            label = _str_const(label_node) if label_node is not None else None
            if label in UNBOUNDED_LABELS:
                self.findings.append(Finding(
                    "NHD603", self.path, node.lineno, node.col_offset,
                    f"LabeledHistogram label key {label!r} has unbounded "
                    "cardinality (one child histogram per pod/correlation "
                    "ever seen): label sets must be bounded by "
                    "construction",
                ))
        self.generic_visit(node)


def check_project(modules: Sequence[ModuleSource]) -> List[Finding]:
    registry: Set[str] = set()
    for module in modules:
        registry |= _registrations(module.tree)
    findings: List[Finding] = []
    for module in modules:
        visitor = _Visitor(module.path, registry)
        visitor.visit(module.tree)
        findings.extend(visitor.findings)
    return findings
