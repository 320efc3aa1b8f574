"""Matchers and batch scheduling on PyTorch.

``find_node`` here is the serial oracle, as in the reference package;
the batched matcher is ``nhd_tpu_torch.solver.matcher`` (``find_nodes``)
and the round loop ``BatchScheduler``.
"""

from nhd_tpu_torch.solver.batch import (
    BatchAssignment,
    BatchItem,
    BatchScheduler,
    BatchStats,
    ScheduleContext,
)
from nhd_tpu_torch.solver.matcher import find_nodes
from nhd_tpu_torch.solver.oracle import MatchResult, OracleMatcher, find_node

__all__ = [
    "BatchAssignment",
    "BatchItem",
    "BatchScheduler",
    "BatchStats",
    "MatchResult",
    "OracleMatcher",
    "ScheduleContext",
    "find_node",
    "find_nodes",
]
