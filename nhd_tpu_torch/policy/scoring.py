"""Heterogeneity-aware scoring: the throughput matrix → score rows.

Gavel's core observation (PAPERS.md): on mixed hardware, placement
QUALITY is a per-(workload, accelerator-generation) throughput matrix,
not a boolean. This module owns that matrix and projects it into the
dense form the fused megaround consumes: one int32 row of
:data:`~nhd_tpu.policy.classes.MAX_CLASSES` quantized scores per pod
TYPE (``PodTypeArrays.class_score``), gathered against each node row's
class index (``ClusterArrays.node_class``) inside the jitted program —
the batch-scheduler-architecture stance (PAPERS.md): the policy layer
is vectorized terms inside the existing solve, never a host-side
re-rank.

Matrix source: ``NHD_POLICY_TPUT`` — inline JSON, or ``@/path`` to a
JSON file (the TriadSet/operator config hook) — shaped::

    {"gpu": {"gen-a": 1.0, "gen-b": 0.55}, "cpu": {"gen-a": 1.0}}

Outer keys are workload kinds (:func:`workload_kind`), inner keys node
classes; missing entries default to 1.0 (uniform). Scores quantize to
0..SCORE_QUANT relative to the kind's best class, so a uniform matrix
yields a CONSTANT row per type — a per-type constant shift of the
ranking value cannot reorder nodes, making "uniform" placement-neutral
by construction. With ``NHD_POLICY=0`` the rows are all-zero and the
ranking value is bit-identical to the pre-policy formula (the pinned
control).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

import numpy as np

from nhd_tpu_torch.policy import enabled
from nhd_tpu_torch.policy.classes import CLASSES, DEFAULT_CLASS, MAX_CLASSES

#: score quantization ceiling. The ranking value packs
#: (score * 3 + pref) * (Np + 1) into int32 (kernel._rank_body consumers)
#: — at 255 the node axis may reach ~2.7M rows before overflow, far past
#: the streaming tiler's per-solve tile bound.
SCORE_QUANT = 255

# score-mode constants (the nhd_policy_score_mode gauge)
MODE_OFF = 0
MODE_UNIFORM = 1
MODE_MATRIX = 2

_LOCK = threading.Lock()
#: the live matrix ({} = uniform); None = not loaded yet (env consulted)
_MATRIX: Optional[Dict[str, Dict[str, float]]] = None
#: the raw NHD_POLICY_TPUT string the cached matrix was parsed from —
#: a changed env re-parses at the next lookup (operators flip matrices
#: without a restart; /metrics' score_mode gauge would otherwise report
#: the first-seen posture forever). None = matrix came from set_matrix.
_MATRIX_RAW: Optional[str] = None
_MATRIX_GEN = 0
_ROW_CACHE: Dict[tuple, np.ndarray] = {}


def _load_env_matrix() -> Dict[str, Dict[str, float]]:
    raw = os.environ.get("NHD_POLICY_TPUT", "").strip()
    if not raw:
        return {}
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as fh:
                data = json.load(fh)
        else:
            data = json.loads(raw)
        if not isinstance(data, dict):
            raise ValueError("matrix must be a JSON object")
        return {
            str(kind): {str(c): float(v) for c, v in (classes or {}).items()}
            for kind, classes in data.items()
        }
    except (OSError, ValueError) as exc:
        from nhd_tpu_torch.utils import get_logger

        # a malformed matrix degrades to uniform scoring (feasibility
        # first — a config typo must never unschedule the fleet)
        get_logger(__name__).error(
            f"NHD_POLICY_TPUT unreadable ({exc}); using the uniform matrix"
        )
        return {}


def _matrix() -> Dict[str, Dict[str, float]]:
    global _MATRIX, _MATRIX_RAW, _MATRIX_GEN
    raw = os.environ.get("NHD_POLICY_TPUT", "").strip()
    with _LOCK:
        if _MATRIX is None or (
            _MATRIX_RAW is not None and raw != _MATRIX_RAW
        ):
            _MATRIX = _load_env_matrix()
            _MATRIX_RAW = raw
            _MATRIX_GEN += 1
            _ROW_CACHE.clear()
        return _MATRIX


def set_matrix(matrix: Optional[Dict[str, Dict[str, float]]]) -> None:
    """Install a throughput matrix programmatically (bench, chaos,
    tests) — a programmatic matrix pins itself (env changes ignored
    until re-armed). ``None`` re-arms the env load; ``{}`` forces
    uniform."""
    global _MATRIX, _MATRIX_RAW, _MATRIX_GEN
    with _LOCK:
        _MATRIX = matrix
        _MATRIX_RAW = None
        _MATRIX_GEN += 1
        _ROW_CACHE.clear()


def score_mode() -> int:
    """0 off / 1 uniform / 2 matrix — the nhd_policy_score_mode gauge."""
    if not enabled():
        return MODE_OFF
    return MODE_MATRIX if _matrix() else MODE_UNIFORM


def scoring_active() -> bool:
    """True when scoring can actually REORDER placements (a non-uniform
    matrix under NHD_POLICY=1). Gates the paths that cannot honor score
    terms — the speculative megaround falls back to classic rounds so
    round-0 claims never bypass the policy ranking."""
    return score_mode() == MODE_MATRIX


def workload_kind(req) -> str:
    """A PodRequest's throughput-matrix row key. Deliberately coarse
    (GPU-driven vs CPU-only — the axis generations actually differ on);
    finer keys can join later without touching the solver: the kind is
    host-side, the device only ever sees the projected row."""
    return "gpu" if req.needs_gpu else "cpu"


def _quantize(vals: Dict[str, float]) -> Dict[str, int]:
    """Relative quantization: the kind's best class scores SCORE_QUANT,
    the rest proportionally; missing classes score the default 1.0
    relative to that best."""
    best = max(list(vals.values()) + [1.0])
    return {
        c: max(0, min(SCORE_QUANT, round(v / best * SCORE_QUANT)))
        for c, v in vals.items()
    }


def score_row(req) -> np.ndarray:
    """The [MAX_CLASSES] int32 score row for one pod type (encode-time
    hook: solver/encode.py encode_pods calls this per DISTINCT type).
    All-zero with the policy off (the bit-exactness control); one cached
    row per (kind, matrix generation, interner generation) otherwise."""
    if not enabled():
        return np.zeros(MAX_CLASSES, np.int32)
    kind = workload_kind(req)
    key = (kind, _MATRIX_GEN, CLASSES.generation)
    with _LOCK:
        row = _ROW_CACHE.get(key)
        if row is not None:
            return row
    m = _matrix().get(kind, {})
    q = _quantize(m)
    default_q = q.get(DEFAULT_CLASS)
    if default_q is None:
        best = max(list(m.values()) + [1.0])
        default_q = max(0, min(SCORE_QUANT, round(1.0 / best * SCORE_QUANT)))
    row = np.full(MAX_CLASSES, default_q, np.int32)
    for i, name in enumerate(CLASSES.names()[:MAX_CLASSES]):
        row[i] = q.get(name, default_q)
    with _LOCK:
        if len(_ROW_CACHE) > 4096:
            _ROW_CACHE.clear()
        _ROW_CACHE[key] = row
    return row


def throughput(req_kind: str, class_name: str) -> float:
    """Raw (unquantized) matrix lookup — the bench's ground-truth
    aggregate-placed-throughput figure reads this."""
    return _matrix().get(req_kind, {}).get(class_name, 1.0)
