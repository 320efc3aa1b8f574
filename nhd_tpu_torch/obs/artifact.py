"""Schema-versioned observability artifacts: one envelope, many kinds.

Every JSON artifact the observability plane writes — fleet snapshots
(obs/fleet.py), bench telemetry (obs/perf.py, bench.py) — shares ONE
envelope so downstream tooling (tools/bench_diff.py, tools/fleet_top.py,
CI) can route and validate files without per-kind sniffing:

    {
      "kind":            "fleet" | "bench" | ...,
      "schema_version":  int        (per kind; bump on breaking change),
      "created_unix":    float      (wall clock at write),
      "git_rev":         str        ("unknown" outside a work tree),
      "seed":            int|None   (whatever made the run reproducible),
      "payload":         {...}      (the kind-specific body)
    }

Stdlib-only; writes are atomic (tmp + rename) so a reader polling the
artifact directory never sees a torn file. The per-kind payload
validators live with their producers — this module owns exactly the
envelope contract.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import List, Optional

#: envelope fields every artifact must carry
ENVELOPE_FIELDS = (
    "kind", "schema_version", "created_unix", "git_rev", "seed", "payload"
)


def git_rev(cwd: Optional[str] = None) -> str:
    """Short git revision of *cwd* (or CWD), 'unknown' when unavailable
    — artifacts must still be writable from an installed wheel or a
    tarball checkout with no .git."""
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=cwd,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    if proc.returncode != 0:
        return "unknown"
    return proc.stdout.strip() or "unknown"


def make_envelope(
    kind: str,
    schema_version: int,
    payload: dict,
    *,
    seed: Optional[int] = None,
    rev: Optional[str] = None,
    created: Optional[float] = None,
) -> dict:
    """Wrap *payload* in the shared envelope. ``rev``/``created`` are
    injectable so tests produce byte-stable artifacts."""
    return {
        "kind": kind,
        "schema_version": int(schema_version),
        "created_unix": time.time() if created is None else float(created),
        "git_rev": git_rev() if rev is None else rev,
        "seed": seed,
        "payload": payload,
    }


def validate_envelope(
    obj: object, *, kind: Optional[str] = None,
    schema_version: Optional[int] = None,
) -> List[str]:
    """Envelope-level schema errors ([] = valid). Pass ``kind`` /
    ``schema_version`` to additionally pin what the caller expects —
    a reader that can only handle fleet v1 should say so here rather
    than KeyError deep inside its payload walk."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"artifact must be a JSON object, got {type(obj).__name__}"]
    for field in ENVELOPE_FIELDS:
        if field not in obj:
            errs.append(f"missing envelope field {field!r}")
    if errs:
        return errs
    if not isinstance(obj["kind"], str) or not obj["kind"]:
        errs.append("kind must be a non-empty string")
    if not isinstance(obj["schema_version"], int):
        errs.append("schema_version must be an int")
    if not isinstance(obj["created_unix"], (int, float)):
        errs.append("created_unix must be a number")
    if not isinstance(obj["git_rev"], str):
        errs.append("git_rev must be a string")
    if obj["seed"] is not None and not isinstance(obj["seed"], int):
        errs.append("seed must be an int or null")
    if not isinstance(obj["payload"], dict):
        errs.append("payload must be an object")
    if kind is not None and obj.get("kind") != kind:
        errs.append(f"kind is {obj.get('kind')!r}, expected {kind!r}")
    if (
        schema_version is not None
        and obj.get("schema_version") != schema_version
    ):
        errs.append(
            f"schema_version is {obj.get('schema_version')!r}, "
            f"expected {schema_version}"
        )
    return errs


def write_artifact(obj: dict, out_dir: str, name: str) -> str:
    """Atomically write *obj* as ``out_dir/name`` (mkdir -p'd); returns
    the written path. ``name`` should carry enough context to never
    collide (callers stamp pid/seed/step — this function deliberately
    does not invent entropy, so artifact names stay predictable for the
    Make targets that read them back)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_artifact(path: str) -> dict:
    """Read + envelope-validate one artifact; raises ValueError with the
    full error list on a malformed file (a truncated or foreign JSON
    must fail loud, not produce an empty diff)."""
    with open(path) as fh:
        obj = json.load(fh)
    errs = validate_envelope(obj)
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return obj
