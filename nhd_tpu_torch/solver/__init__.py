"""Matchers and batch scheduling on PyTorch.

``find_node`` here is the serial oracle, as in the reference package;
the batched matcher is ``nhd_tpu_torch.solver.matcher`` (``find_nodes``),
the round loop ``BatchScheduler`` and the node-axis tiler
``StreamingScheduler``.
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
from nhd_tpu_torch.solver.streaming import StreamingScheduler

__all__ = [
    "BatchAssignment",
    "BatchItem",
    "BatchScheduler",
    "BatchStats",
    "MatchResult",
    "OracleMatcher",
    "ScheduleContext",
    "StreamingScheduler",
    "find_node",
    "find_nodes",
]
