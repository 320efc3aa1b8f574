"""NHD4xx — determinism in solver and encode paths.

Two schedulers replaying the same watch stream must produce the same
placements: multihost ranks solve disjoint shards of one cluster and any
rank-local entropy desynchronizes them, and the chaos-soak / oracle-vs-
batch equivalence tests only mean something when a solve is a pure
function of cluster state. So inside ``nhd_tpu_torch/solver/`` (which includes
the encode path):

* NHD401 — global-RNG calls (``random.*``, ``np.random.*``). Simulation
  code (``nhd_tpu_torch/sim/``) seeds its generators explicitly and is out of
  scope; the solver must not roll dice at all.
* NHD402 — wall-clock reads (``time.time``, ``datetime.now``). Busy-decay
  and stats use the caller-passed ``now`` / ``time.monotonic`` /
  ``time.perf_counter``, which stay allowed; calendar time in a solve
  makes placement depend on when you run it.
"""

from __future__ import annotations

import ast
from typing import List

from nhd_tpu_torch.analysis.core import Finding, _dotted

# module-path gate: the pack judges only solver/encode code
_SCOPE_PARTS = ("solver",)

_RANDOM_FUNCS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "getrandbits",
    "rand", "randn", "permutation", "normal", "standard_normal", "bytes",
}
_WALLCLOCK = {
    "time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
    "datetime.today", "date.today",
}


def _in_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(p in parts for p in _SCOPE_PARTS)


def check_module(tree: ast.Module, src: str, path: str) -> List[Finding]:
    if not _in_scope(path):
        return []

    # global-RNG names imported from the random modules: `from random
    # import shuffle`. Only names in _RANDOM_FUNCS count — seeded
    # constructors (Random, default_rng, Generator) are the rule's own
    # recommended remedy and must never be flagged.
    from_random: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
            "random", "numpy.random"
        ):
            for alias in node.names:
                if alias.name in _RANDOM_FUNCS:
                    from_random.add(alias.asname or alias.name)

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None:
            continue
        head, _, tail = d.rpartition(".")
        if (
            (head in ("random", "np.random", "numpy.random")
             and tail in _RANDOM_FUNCS)
            or (not head and tail in from_random)
        ):
            findings.append(Finding(
                "NHD401", path, node.lineno, node.col_offset,
                f"{d}() draws from a global unseeded RNG inside the "
                "solver path: placement must be a pure function of "
                "cluster state — thread an explicit seeded generator (or "
                "jax.random key) through the caller",
            ))
        elif d in _WALLCLOCK or (
            tail in ("now", "utcnow") and head.endswith("datetime")
        ):
            findings.append(Finding(
                "NHD402", path, node.lineno, node.col_offset,
                f"{d}() reads the wall clock inside the solver path: "
                "placement would depend on when the solve runs — use the "
                "caller-passed 'now' or time.monotonic/perf_counter",
            ))
    return findings
