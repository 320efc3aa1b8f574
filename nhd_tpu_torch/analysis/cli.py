"""``python -m nhd_tpu_torch.analysis`` — the nhdlint command line.

Exit codes: 0 = clean (or everything baselined/suppressed), 1 = new
findings, 2 = usage error. Output formats: human (default, one line per
finding, grep-friendly) and ``--format json`` (stable schema for CI
annotation tooling).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from nhd_tpu_torch.analysis.core import (
    ALL_PACK_NAMES,
    Finding,
    RULES,
    analyze_paths,
    load_baseline,
    subtract_baseline,
    write_baseline,
)

DEFAULT_BASELINE = ".nhdlint-baseline.json"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nhdlint",
        description="AST-based static analysis of the PyTorch/CUDA port: "
                    "capture and host-sync hazards, lock discipline, "
                    "exception hygiene, scheduler determinism, the kernel "
                    "ABI contract and data races.",
    )
    p.add_argument("paths", nargs="*", default=["nhd_tpu_torch"],
                   help="files or directories to analyze (default: nhd_tpu_torch)")
    p.add_argument("--packs", default=",".join(ALL_PACK_NAMES),
                   help=f"comma-separated packs to run (default: all of "
                        f"{','.join(ALL_PACK_NAMES)})")
    p.add_argument("--exclude", action="append", default=[],
                   metavar="PATTERN",
                   help="fnmatch pattern of paths to skip (repeatable; "
                        "matches whole paths, suffixes, or directory "
                        "segments — e.g. tests/fixtures)")
    p.add_argument("--lock-graph-json", metavar="FILE", default=None,
                   help="write the interprocedural lock graph (locks, "
                        "order edges, inversions) as JSON")
    p.add_argument("--lock-graph-dot", metavar="FILE", default=None,
                   help="write the lock graph as Graphviz DOT (inverted "
                        "pairs highlighted)")
    p.add_argument("-f", "--format", dest="fmt", choices=("human", "json"),
                   default="human")
    p.add_argument("--baseline", default=None,
                   help=f"baseline JSON of grandfathered findings "
                        f"(default: ./{DEFAULT_BASELINE} if present)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline file and "
                        "exit 0 (grandfather everything now visible)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file (report all findings)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    p.add_argument("--diff-base", metavar="REV", default=None,
                   help="differential mode: only findings on lines "
                        "changed since REV (git diff) affect the exit "
                        "code; off-diff findings are reported as "
                        "advisory. The baseline still applies first.")
    p.add_argument("--sarif", metavar="FILE", default=None,
                   help="also write findings as SARIF 2.1.0 (all "
                        "post-baseline findings, independent of "
                        "--diff-base gating)")
    return p


def _changed_lines(rev: str) -> Optional[dict]:
    """{repo-relative path: set of changed line numbers} from
    ``git diff -U0 REV``, or None if git fails (treated as a usage
    error by the caller — a bad REV must not read as 'clean')."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "diff", "--no-color", "--unified=0", rev, "--", "*.py"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    changed: dict = {}
    path = None
    for raw in proc.stdout.splitlines():
        if raw.startswith("+++ b/"):
            path = raw[6:].strip()
        elif raw.startswith("+++"):
            path = None  # /dev/null (deletion) or unusual prefix
        elif raw.startswith("@@") and path is not None:
            # @@ -a[,b] +c[,d] @@ — new-file side span is c..c+d-1
            try:
                new_span = raw.split("+", 1)[1].split(" ", 1)[0]
            except IndexError:
                continue
            start, _, count = new_span.partition(",")
            first = int(start)
            n = int(count) if count else 1
            if n > 0:
                changed.setdefault(path, set()).update(
                    range(first, first + n)
                )
    return changed


def _write_sarif(findings: List[Finding], out: Path) -> None:
    """SARIF 2.1.0 — one run, rule metadata from the catalogue, stable
    partialFingerprints so CI viewers track findings across pushes."""
    seen_rules = sorted({f.rule for f in findings})
    doc = {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "nhdlint",
                "informationUri": "docs/STATIC_ANALYSIS.md",
                "rules": [
                    {
                        "id": rule,
                        "shortDescription": {"text": RULES[rule][1]},
                        "properties": {"pack": RULES[rule][0]},
                    }
                    for rule in seen_rules if rule in RULES
                ],
            }},
            "results": [
                {
                    "ruleId": f.rule,
                    "level": "error",
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": f.line,
                                "startColumn": f.col + 1,
                            },
                        },
                    }],
                    "partialFingerprints": {
                        "nhdlintFingerprint/v1": f.fingerprint(),
                    },
                }
                for f in findings
            ],
        }],
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")


def _resolve_packs(arg: str) -> Optional[List[str]]:
    packs = [x.strip() for x in arg.split(",") if x.strip()]
    if not packs:
        # an empty selection (e.g. --packs "$UNSET_VAR") must not read
        # as "clean" with zero rules run — same reasoning as the
        # no-files-found guard below
        print("nhdlint: --packs selected no packs "
              f"(have: {', '.join(ALL_PACK_NAMES)})", file=sys.stderr)
        return None
    unknown = [x for x in packs if x not in ALL_PACK_NAMES]
    if unknown:
        print(f"nhdlint: unknown pack(s): {', '.join(unknown)} "
              f"(have: {', '.join(ALL_PACK_NAMES)})", file=sys.stderr)
        return None
    return packs


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for rule, (pack, desc) in sorted(RULES.items()):
            print(f"{rule}  [{pack:<11}] {desc}")
        return 0

    packs = _resolve_packs(args.packs)
    if packs is None:
        return 2

    modules: List = []
    reports = analyze_paths(
        args.paths, packs, exclude=args.exclude, modules_out=modules
    )
    if not reports:
        # a path typo must not read as "clean" — that would silently
        # disable the whole lint tier in make lint / CI
        print(f"nhdlint: no Python files found under: "
              f"{', '.join(args.paths)}", file=sys.stderr)
        return 2

    if args.lock_graph_json or args.lock_graph_dot:
        from nhd_tpu_torch.analysis.lockgraph import build_lock_graph, lock_graph_dot

        graph = build_lock_graph(modules)
        if args.lock_graph_json:
            Path(args.lock_graph_json).write_text(
                json.dumps(graph, indent=2) + "\n"
            )
            print(f"nhdlint: lock graph -> {args.lock_graph_json}",
                  file=sys.stderr)
        if args.lock_graph_dot:
            Path(args.lock_graph_dot).write_text(lock_graph_dot(graph))
            print(f"nhdlint: lock graph DOT -> {args.lock_graph_dot}",
                  file=sys.stderr)

    findings: List[Finding] = [f for r in reports for f in r.findings]
    suppressed = sum(r.suppressed for r in reports)
    unused_ignores = [
        (r.path, line) for r in reports for line in r.unused_ignores
    ]

    baseline_path = Path(args.baseline or DEFAULT_BASELINE)
    if args.write_baseline:
        if set(packs) != set(ALL_PACK_NAMES):
            # a subset write would silently drop every other pack's
            # grandfathered entries from the file
            print("nhdlint: --write-baseline requires all packs "
                  "(drop --packs)", file=sys.stderr)
            return 2
        write_baseline(findings, baseline_path)
        print(f"nhdlint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baselined = 0
    if not args.no_baseline and (args.baseline or baseline_path.exists()):
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as exc:
            print(f"nhdlint: bad baseline {baseline_path}: {exc}",
                  file=sys.stderr)
            return 2
        findings, baselined = subtract_baseline(findings, baseline)

    if args.sarif:
        _write_sarif(findings, Path(args.sarif))
        print(f"nhdlint: SARIF -> {args.sarif}", file=sys.stderr)

    advisory: List[Finding] = []
    if args.diff_base is not None:
        changed = _changed_lines(args.diff_base)
        if changed is None:
            print(f"nhdlint: git diff against {args.diff_base!r} failed",
                  file=sys.stderr)
            return 2
        on_diff = []
        for f in findings:
            (on_diff if f.line in changed.get(f.path, ()) else advisory) \
                .append(f)
        findings = on_diff

    if args.fmt == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "files": len(reports),
            "suppressed": suppressed,
            "baselined": baselined,
            "unused_ignores": [
                {"path": p, "line": line} for p, line in unused_ignores
            ],
            "packs": packs,
            "advisory": [f.to_dict() for f in advisory],
        }, indent=2))
    else:
        for f in findings:
            print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
            if f.snippet:
                print(f"    {f.snippet}")
        for p, line in unused_ignores:
            # advisory, not an exit-code failure: a stale directive can
            # mask a future finding on its line, so keep them visible
            print(f"{p}:{line}: warning: unused 'nhdlint: ignore' directive")
        for f in advisory:
            # off-diff in --diff-base mode: visible, never exit-affecting
            print(f"{f.path}:{f.line}:{f.col + 1}: advisory: "
                  f"{f.rule} {f.message}")
        tail = (f"{len(findings)} finding(s) in {len(reports)} file(s)"
                f" ({suppressed} suppressed, {baselined} baselined, "
                f"{len(unused_ignores)} unused ignore(s))")
        if args.diff_base is not None:
            tail += f"; {len(advisory)} off-diff advisory"
        print(f"nhdlint: {tail}" if findings else f"nhdlint: clean — {tail}")

    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
