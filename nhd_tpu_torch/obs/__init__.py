"""Observability the solver path reaches: jit-style program accounting
(jitstats.py), the flight recorder (recorder.py) and the counters the
encode and device-state layers bump (counters.py). Copies of the
reference's modules of the same names; counters.py keeps only the
registry object those layers read."""

from nhd_tpu_torch.obs.counters import API_COUNTERS
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.obs.recorder import get_recorder

__all__ = ["API_COUNTERS", "JIT_STATS", "get_recorder"]
