"""nhdlint for the port — AST-based static analysis of nhd_tpu_torch.

The port's performance story rests on kernels built and opened once,
launches that queue without host waits, and a control plane that
mutates shared state from watch threads and tile workers. The bug
classes that hurt most at production scale — per-call library opens,
host-sync stalls in the hot batch loop, off-lock state mutation,
nondeterministic placement, a kernel ABI out of step across its layers —
are exactly the ones best caught statically.
Per-file rule packs, each a visitor over stdlib ``ast`` (no third-party
dependency, so the gate runs everywhere the tests run):

  tracing      NHD1xx  CUDA-graph capture / per-call build / host-sync hazards
  locks        NHD2xx  lock discipline for classes that own a Lock/RLock
  excepts      NHD3xx  exception hygiene (silently swallowed errors)
  determinism  NHD4xx  unseeded randomness / wall-clock in solver paths
  fencing      NHD5xx  commit-fencing discipline in the control plane
  metrics      NHD6xx  observability-surface hygiene

plus *project* packs that see every module at once:

  lockgraph    NHD21x  interprocedural lock-order inversions, blocking
                       calls under locks, re-entrant Lock acquisition —
                       with DOT/JSON export of the whole-program lock
                       graph (--lock-graph-dot / --lock-graph-json)
  contract     NHD7xx  cross-layer solve-signature and kernel-ABI contract
                       analysis (_ARG_ORDER vs DELTA_FIELDS vs block spans
                       vs abi.py vs .cu entry points vs plain versions vs
                       fingerprints), host-alias taint tracking into
                       in-place kernel arguments, and the env-knob
                       registries (config/knobs.py, config/port_knobs.py)

Run ``python -m nhd_tpu_torch.analysis nhd_tpu_torch`` (``--list-rules``
for the catalogue); the suppression syntax, the baseline workflow and
the CI modes (``--diff-base REV``, ``--sarif``) are the reference's
(docs/STATIC_ANALYSIS.md).
"""

from nhd_tpu_torch.analysis.core import (
    ALL_PACK_NAMES,
    Finding,
    ModuleSource,
    PACKS,
    PROJECT_PACKS,
    RULES,
    analyze_file,
    analyze_paths,
    iter_py_files,
    load_baseline,
    subtract_baseline,
    write_baseline,
)

__all__ = [
    "ALL_PACK_NAMES",
    "Finding",
    "ModuleSource",
    "PACKS",
    "PROJECT_PACKS",
    "RULES",
    "analyze_file",
    "analyze_paths",
    "iter_py_files",
    "load_baseline",
    "subtract_baseline",
    "write_baseline",
]
