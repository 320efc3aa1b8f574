"""nhdlint engine: findings, suppressions, baseline, file walking.

Per-file rule packs live in sibling ``rules_*`` modules; each exposes
``check_module(tree, src, path) -> List[Finding]``. *Project* packs
(``PROJECT_PACKS``) see every parsed module at once and emit
whole-program findings — the interprocedural lock-graph rules
(``lockgraph.py``) need the cross-module call graph, which no
one-file-at-a-time visitor can build. This module owns everything
rule-independent so a pack is just one visitor (or project function)
plus a rule table entry.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import re
import tokenize
from dataclasses import asdict, dataclass, field
from fnmatch import fnmatch
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # e.g. "NHD201"
    path: str          # path as given to the analyzer (posix separators)
    line: int          # 1-based line of the offending node
    col: int           # 0-based column
    message: str
    snippet: str = ""  # stripped source line, for output and fingerprints

    def fingerprint(self) -> str:
        """Line-number-independent identity used by the baseline: moving
        a grandfathered finding up or down a file must not resurrect it,
        while editing the offending line (or renaming/moving the file)
        must. Keyed on the last two path components rather than the full
        path so the gate test (absolute paths) and the CLI (relative
        paths) agree on the same entries, while same-named files in
        different directories still get distinct slots."""
        tail = "/".join(self.path.rsplit("/", 2)[-2:])
        raw = f"{self.rule}:{tail}:{self.snippet}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


@dataclass
class FileReport:
    """Per-file outcome: surviving findings plus suppression accounting."""

    path: str
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    skipped: bool = False          # whole file opted out via skip-file
    unused_ignores: List[int] = field(default_factory=list)  # line numbers


@dataclass
class ModuleSource:
    """One successfully parsed module, as handed to project packs."""

    path: str                      # display path (posix separators)
    src: str
    tree: ast.Module


# ---------------------------------------------------------------------------
# rule registry (packs register lazily to keep import order trivial)
# ---------------------------------------------------------------------------

def _pack_tracing(tree, src, path):
    from nhd_tpu_torch.analysis.rules_tracing import check_module
    return check_module(tree, src, path)


def _pack_locks(tree, src, path):
    from nhd_tpu_torch.analysis.rules_locks import check_module
    return check_module(tree, src, path)


def _pack_excepts(tree, src, path):
    from nhd_tpu_torch.analysis.rules_excepts import check_module
    return check_module(tree, src, path)


def _pack_determinism(tree, src, path):
    from nhd_tpu_torch.analysis.rules_determinism import check_module
    return check_module(tree, src, path)


def _pack_fencing(tree, src, path):
    from nhd_tpu_torch.analysis.rules_fencing import check_module
    return check_module(tree, src, path)


PACKS: Dict[str, Callable] = {
    "tracing": _pack_tracing,
    "locks": _pack_locks,
    "excepts": _pack_excepts,
    "determinism": _pack_determinism,
    "fencing": _pack_fencing,
}


def _pack_lockgraph(modules):
    from nhd_tpu_torch.analysis.lockgraph import check_project
    return check_project(modules)


def _pack_metrics(modules):
    from nhd_tpu_torch.analysis.rules_metrics import check_project
    return check_project(modules)


def _pack_contract(modules):
    from nhd_tpu_torch.analysis.rules_contract import check_project
    return check_project(modules)


def _pack_races(modules):
    from nhd_tpu_torch.analysis.rules_races import check_project
    return check_project(modules)


# project packs: check_project(modules: Sequence[ModuleSource]) -> findings.
# They run over the whole analyzed path set at once (analyze_file hands
# them a one-module project, so EXPECT fixtures keep working unchanged).
PROJECT_PACKS: Dict[str, Callable] = {
    "lockgraph": _pack_lockgraph,
    "metrics": _pack_metrics,
    "contract": _pack_contract,
    "races": _pack_races,
}

ALL_PACK_NAMES: Tuple[str, ...] = (*PACKS, *PROJECT_PACKS)


def _split_packs(
    packs: Optional[Sequence[str]],
) -> Tuple[List[str], List[str]]:
    """(file packs, project packs) in registry order; None = all. Unknown
    names raise KeyError — the CLI validates first, library callers get
    the loud failure."""
    if packs is None:
        return list(PACKS), list(PROJECT_PACKS)
    unknown = [p for p in packs if p not in PACKS and p not in PROJECT_PACKS]
    if unknown:
        raise KeyError(f"unknown pack(s): {', '.join(unknown)}")
    return (
        [p for p in PACKS if p in packs],
        [p for p in PROJECT_PACKS if p in packs],
    )

# rule id -> (pack, one-line description); the single source docs and
# --list-rules render from
RULES: Dict[str, Tuple[str, str]] = {
    "NHD101": ("tracing",
               "int()/float()/bool()/.item()/.tolist() coercion of a "
               "device tensor inside a CUDA-graph capture (illegal sync "
               "while capturing, or a capture-time value baked in)"),
    "NHD102": ("tracing",
               "Python control flow (if/while/assert) on a device tensor "
               "inside a CUDA-graph capture (decided once, at capture)"),
    "NHD103": ("tracing",
               "numpy host op on a device tensor inside a CUDA-graph "
               "capture (runs once, on the host, at capture)"),
    "NHD104": ("tracing",
               "kernel library opened (ctypes.CDLL, build.load) or CUDA "
               "graph constructed (torch.cuda.CUDAGraph) per call, not at "
               "module scope or in a cache: the build, dlopen or capture "
               "repeats on every call"),
    "NHD105": ("tracing",
               "graphed callable (make_graphed_callables) with a mutable "
               "default parameter: the graph bakes its capture-time "
               "contents, later edits never reach a replay"),
    "NHD106": ("tracing",
               "raw time.time()/perf_counter() timing inside a CUDA-graph "
               "capture: clock reads run at capture only — time on the "
               "host around graph.replay() (CUDA events)"),
    "NHD107": ("tracing",
               "host-sync operation (.cpu(), .to('cpu'), .item()/.tolist()"
               "/.numpy() on a device tensor, torch.cuda.synchronize(), "
               "Event.synchronize()) in a solver hot-path module: each "
               "pull drains the launch queue — copy into pinned memory "
               "and wait at the round's one sanctioned flush (HostPull) "
               "(intentional sites suppressed inline)"),
    "NHD108": ("tracing",
               "full encode_cluster() call on a per-event/per-round hot "
               "path in solver/scheduler code outside the sanctioned "
               "rebuild chokepoint (ClusterDelta._rebuild/make_context): "
               "steady paths must get-or-apply row deltas through the "
               "incremental cluster state"),
    "NHD201": ("locks",
               "write to lock-guarded attribute outside 'with <lock>:' in a "
               "class that owns a threading.Lock/RLock"),
    "NHD202": ("locks",
               "bare <lock>.acquire() call: an exception before release() "
               "deadlocks every other thread; use 'with <lock>:'"),
    "NHD210": ("lockgraph",
               "lock-order inversion: one call path acquires A then B, "
               "another B then A — two threads interleaving them deadlock"),
    "NHD211": ("lockgraph",
               "blocking call (unbounded queue get/join/wait, socket "
               "recv/accept, subprocess wait, sharded solve entry) "
               "reached while a lock is "
               "held — directly or through the call graph"),
    "NHD212": ("lockgraph",
               "re-entrant acquisition of a non-reentrant Lock through a "
               "call path (callback invoked under the lock it takes)"),
    "NHD301": ("excepts",
               "bare 'except:' catches SystemExit/KeyboardInterrupt and "
               "hides programming errors"),
    "NHD302": ("excepts",
               "broad 'except Exception:' that neither logs, re-raises, nor "
               "returns — watch-loop and RPC errors vanish silently"),
    "NHD401": ("determinism",
               "unseeded global RNG (random.*/np.random.*) in a solver/encode "
               "path: placement must be a pure function of cluster state"),
    "NHD402": ("determinism",
               "wall-clock read (time.time/datetime.now) in a solver/encode "
               "path: use the caller-passed 'now' or time.monotonic"),
    "NHD501": ("fencing",
               "mutating ClusterBackend call in nhd_tpu_torch/scheduler/ outside "
               "its chokepoint: commit-path mutators (bind/annotate/NAD/"
               "spillover) belong in Scheduler._commit_write (the write "
               "must carry the owning shard's fencing epoch), TriadSet "
               "mutators in Controller._coordinator_write (coordinatorship "
               "re-checked at the write, not the pass)"),
    "NHD601": ("metrics",
               "exported metric name does not match nhd_[a-z0-9_]+: "
               "scrapers key on the prefix, and invalid characters break "
               "the text exposition format"),
    "NHD602": ("metrics",
               "metric family emitted but registered nowhere (# TYPE "
               "declaration, histogram registry, name/kind table row or "
               "*FAMILIES* list): it scrapes TYPE-less and undocumented"),
    "NHD603": ("metrics",
               "unbounded-cardinality label (corr/uid/pod/...) on a "
               "metric family: one time series per pod ever seen — "
               "identities belong in /decisions, not label values"),
    "NHD701": ("contract",
               "solve-signature or kernel-ABI consumer out of step: a "
               "field present in one layer (_ARG_ORDER/_POD_ARG_ORDER, "
               "an abi.py row) is missing from another (DELTA_FIELDS, "
               "_MUTABLE/_STATIC partition, by-name or .index() read, "
               "padded_args block span, .cu entry point, plain version, "
               "argument builder) — the missing consumer layer is named"),
    "NHD702": ("contract",
               "solve-signature or kernel-ABI order violation: same field "
               "set but different order, duplicated fields, overlapping "
               "_MUTABLE/_STATIC partition, or conflicting definitions — "
               "positional consumers would read the wrong tensor"),
    "NHD703": ("contract",
               "fingerprint-source omission: the program fingerprint does "
               "not hash a module that defines the solve (the _ARG_ORDER "
               "module / the get_tables combo tables), or a library "
               "fingerprint does not hash its .cu source and the ABI "
               "table — cached artifacts would survive semantic edits"),
    "NHD710": ("contract",
               "host-alias hazard: a tensor that aliases a host mirror "
               "(torch.from_numpy, torch.as_tensor on the CPU, and their "
               "views) reaches an argument a kernel writes in place "
               "(inplace in abi.py) or an index_copy_ target without an "
               "owning copy — the kernel may mutate the host mirror"),
    "NHD720": ("contract",
               "unregistered env knob: an NHD_* environment read absent "
               "from the nhd_tpu_torch/config/knobs.py KNOBS registry, or "
               "an NHDC_* read absent from config/port_knobs.py — the "
               "knob is undocumented"),
    "NHD810": ("races",
               "unsynchronized write to a field shared between thread "
               "roots: no single lock is held across every access — "
               "guard all accesses with one lock or declare the owning "
               "thread in the ownership registry"),
    "NHD811": ("races",
               "write to declared single-writer state from a non-owner "
               "thread root: readers tolerate staleness, a second writer "
               "corrupts — route the update through the owner thread"),
    "NHD812": ("races",
               "non-atomic read-modify-write (x += 1, check-then-set) on "
               "a shared field with no lock held: interleaved load/store "
               "drops an update (lost counter, double-initialized cache)"),
    "NHD813": ("races",
               "mutable structure handed raw to a new thread "
               "(Thread/Timer/submit) while the publisher keeps writing "
               "it — pass a copy or guard both sides with one lock"),
}


# ---------------------------------------------------------------------------
# suppression syntax
# ---------------------------------------------------------------------------

# directive forms, all comment-only: "nhdlint:" followed by either
# "ignore[RULE1,RULE2]", a bare "ignore" (all rules), or "skip-file"
_DIRECTIVE = re.compile(
    r"#\s*nhdlint:\s*(?P<kind>ignore|skip-file)"
    r"(?:\[(?P<rules>[A-Z0-9,\s]+)\])?"
)


def _comment_tokens(src: str) -> Dict[int, str]:
    """line -> comment text, via tokenize so directive-looking text inside
    string literals and docstrings can never register as a directive."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unterminated construct etc. — fall back to raw lines so a file
        # the parser also rejects (reported as NHD000) still honors its
        # directives. Only comment-shaped lines count: a directive inside
        # a string literal must not survive the fallback either.
        for lineno, line in enumerate(src.splitlines(), start=1):
            if line.lstrip().startswith("#"):
                out[lineno] = line
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for a nested Attribute/Name chain, else None.
    Shared by the rule packs so they can never disagree on what counts
    as a dotted call."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def parse_suppressions(
    src: str, tree: Optional[ast.Module] = None
) -> Tuple[bool, Dict[int, Optional[frozenset]]]:
    """Scan source *comments* for nhdlint directives.

    Returns (skip_file, {line -> rules-or-None}) where None means "ignore
    every rule on this line". skip-file is honored only above the first
    statement (module docstring/comment block), so it cannot hide inside
    a function body. Pass the already-parsed ``tree`` to avoid a second
    parse; None means the source failed to parse.
    """
    ignores: Dict[int, Optional[frozenset]] = {}
    skip_file = False
    first_code_line = None
    if tree is not None:
        body = [n for n in tree.body
                if not (isinstance(n, ast.Expr)
                        and isinstance(n.value, ast.Constant))]
        if body:
            first_code_line = body[0].lineno
    for lineno, comment in sorted(_comment_tokens(src).items()):
        m = _DIRECTIVE.search(comment)
        if not m:
            continue
        if m.group("kind") == "skip-file":
            if first_code_line is None or lineno <= first_code_line:
                skip_file = True
            continue
        rules = m.group("rules")
        if rules:
            ignores[lineno] = frozenset(
                r.strip() for r in rules.split(",") if r.strip()
            )
        else:
            ignores[lineno] = None
    return skip_file, ignores


# ---------------------------------------------------------------------------
# analysis driver
# ---------------------------------------------------------------------------

def _load_module(
    path: str | Path, src: Optional[str] = None
) -> Tuple[FileReport, Optional[ModuleSource], Dict[int, Optional[frozenset]]]:
    """Read + parse one file. The report comes back terminal (NHD000 /
    skipped) when the module is None; otherwise findings are still to be
    collected and applied via _apply_findings."""
    p = Path(path)
    display = p.as_posix()
    report = FileReport(path=display)
    if src is None:
        try:
            src = p.read_text()
        except (OSError, UnicodeDecodeError) as exc:
            report.findings.append(Finding(
                "NHD000", display, 1, 0, f"unreadable file: {exc}"
            ))
            return report, None, {}
    try:
        tree: Optional[ast.Module] = ast.parse(src, filename=display)
    except SyntaxError as exc:
        tree = None
        syntax_error: Optional[SyntaxError] = exc
    else:
        syntax_error = None
    skip_file, ignores = parse_suppressions(src, tree)
    if skip_file:
        report.skipped = True
        return report, None, {}
    if tree is None:
        assert syntax_error is not None
        report.findings.append(Finding(
            "NHD000", display, syntax_error.lineno or 1, 0,
            f"syntax error: {syntax_error.msg}",
        ))
        return report, None, {}
    return report, ModuleSource(display, src, tree), ignores


def _apply_findings(
    report: FileReport,
    module: ModuleSource,
    ignores: Dict[int, Optional[frozenset]],
    raw: List[Finding],
    ran: set,
) -> None:
    """Attach snippets, apply inline suppressions, account unused
    directives; mutates *report* in place."""
    lines = module.src.splitlines()
    used_ignore_lines = set()
    for f in raw:
        snippet = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        f = Finding(f.rule, f.path, f.line, f.col, f.message, snippet)
        rules = ignores.get(f.line, "missing")
        if rules != "missing" and (rules is None or f.rule in rules):
            report.suppressed += 1
            used_ignore_lines.add(f.line)
        else:
            report.findings.append(f)
    # a directive is "unused" only when every rule it could suppress was
    # actually checked this run — a --packs subset must not tell people
    # to delete suppressions that are load-bearing for the full run
    ran_rules = {rid for rid, (pack, _) in RULES.items() if pack in ran}
    for line, rules in ignores.items():
        if line in used_ignore_lines:
            continue
        judged = (
            ran == set(ALL_PACK_NAMES) if rules is None else rules <= ran_rules
        )
        if judged:
            report.unused_ignores.append(line)
    report.unused_ignores.sort()
    report.findings.sort(key=lambda f: (f.line, f.col, f.rule))


def analyze_file(
    path: str | Path,
    packs: Optional[Sequence[str]] = None,
    *,
    src: Optional[str] = None,
) -> FileReport:
    """Run the selected packs over one file, applying inline suppressions.
    Project packs see a one-module project — fixture files exercise the
    interprocedural rules within a single module this way."""
    file_packs, proj_packs = _split_packs(packs)
    report, module, ignores = _load_module(path, src)
    if module is None:
        return report
    raw: List[Finding] = []
    for name in file_packs:
        raw.extend(PACKS[name](module.tree, module.src, module.path))
    for name in proj_packs:
        raw.extend(PROJECT_PACKS[name]([module]))
    _apply_findings(report, module, ignores, raw, set(file_packs + proj_packs))
    return report


def _excluded(p: Path, patterns: Sequence[str]) -> bool:
    """fnmatch against the posix path, anchored loosely: a pattern
    matches the whole path, a path suffix, or any directory segment run
    (so ``tests/fixtures`` excludes the fixture tree wherever the repo
    root sits)."""
    s = p.as_posix()
    for pat in patterns:
        if (
            fnmatch(s, pat)
            or fnmatch(s, f"*/{pat}")
            or fnmatch(s, f"{pat}/*")
            or fnmatch(s, f"*/{pat}/*")
        ):
            return True
    return False


def iter_py_files(
    paths: Iterable[str | Path], *, exclude: Sequence[str] = ()
) -> List[Path]:
    """Expand files/directories into a sorted, de-duplicated .py list."""
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    seen, uniq = set(), []
    for p in out:
        if p not in seen and not _excluded(p, exclude):
            seen.add(p)
            uniq.append(p)
    return uniq


def analyze_paths(
    paths: Iterable[str | Path],
    packs: Optional[Sequence[str]] = None,
    *,
    exclude: Sequence[str] = (),
    modules_out: Optional[List[ModuleSource]] = None,
) -> List[FileReport]:
    """Run the selected packs over a path set. Per-file packs run file by
    file; project packs run once over every successfully parsed module,
    their findings distributed back to the owning file's report (so
    inline suppressions and the baseline apply uniformly). Pass a list as
    ``modules_out`` to receive the parsed ModuleSource set — the CLI's
    lock-graph export reuses it instead of re-parsing every file."""
    file_packs, proj_packs = _split_packs(packs)
    ran = set(file_packs + proj_packs)
    loaded = [
        _load_module(p) for p in iter_py_files(paths, exclude=exclude)
    ]
    raw_by_path: Dict[str, List[Finding]] = {}
    modules = [m for _, m, _ in loaded if m is not None]
    if modules_out is not None:
        modules_out.extend(modules)
    for module in modules:
        raw = raw_by_path.setdefault(module.path, [])
        for name in file_packs:
            raw.extend(PACKS[name](module.tree, module.src, module.path))
    for name in proj_packs:
        for f in PROJECT_PACKS[name](modules):
            # a project finding always lands in an analyzed module; guard
            # anyway so a pack bug can't KeyError the whole run
            if f.path in raw_by_path:
                raw_by_path[f.path].append(f)
    reports: List[FileReport] = []
    for report, module, ignores in loaded:
        if module is not None:
            _apply_findings(
                report, module, ignores, raw_by_path[module.path], ran
            )
        reports.append(report)
    return reports


# ---------------------------------------------------------------------------
# baseline: grandfathered findings, matched by fingerprint with multiplicity
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: str | Path) -> Dict[str, int]:
    """fingerprint -> allowed count. Missing file = empty baseline."""
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {p}: unsupported version {data.get('version')!r}"
        )
    counts: Dict[str, int] = {}
    for entry in data.get("entries", []):
        counts[entry["fingerprint"]] = (
            counts.get(entry["fingerprint"], 0) + int(entry.get("count", 1))
        )
    return counts


def subtract_baseline(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], int]:
    """Drop findings covered by the baseline; returns (new, baselined)."""
    budget = dict(baseline)
    new: List[Finding] = []
    baselined = 0
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            baselined += 1
        else:
            new.append(f)
    return new, baselined


def write_baseline(findings: Sequence[Finding], path: str | Path) -> None:
    """Serialize current findings as the new grandfather set (sorted and
    aggregated so the file diffs cleanly in review)."""
    agg: Dict[Tuple[str, str, str, str], int] = {}
    for f in findings:
        key = (f.rule, f.path, f.snippet, f.fingerprint())
        agg[key] = agg.get(key, 0) + 1
    entries = [
        {"rule": rule, "path": p, "snippet": snip,
         "fingerprint": fp, "count": n}
        for (rule, p, snip, fp), n in sorted(agg.items())
    ]
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "entries": entries}, indent=2
    ) + "\n")
