"""Typed event bus between controller and scheduler.

Equivalent of the reference's NHDWatchQueue (NHDWatchQueue.py:6-40): the
controller thread translates cluster watches into typed events; the
scheduler thread is the only consumer. A plain queue.Queue suffices — the
reference's multiprocessing.Queue choice (NHDWatchQueue.py:25) bought
nothing across threads.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from enum import Enum, auto
from typing import Dict, List, Optional


class WatchType(Enum):
    """Reference: NHDWatchTypes (NHDWatchQueue.py:6-15)."""

    TRIAD_POD_CREATE = auto()
    TRIAD_POD_DELETE = auto()
    TRIAD_POD_UPDATE = auto()
    NODE_CORDON = auto()
    NODE_UNCORDON = auto()
    NODE_MAINT_START = auto()
    NODE_MAINT_END = auto()
    GROUP_UPDATE = auto()
    TRIADSET_UPDATE = auto()
    # structural node inventory changes (rebuild addition: the reference
    # only rebuilds its node list at restart). The scheduler folds these
    # into its mirror — and into the incremental cluster state
    # (solver/encode.py ClusterDelta) as padded-slot adds / in-place
    # tombstones — without a restart.
    NODE_ADD = auto()
    NODE_REMOVE = auto()


@dataclass
class WatchItem:
    type: WatchType
    pod: Optional[Dict[str, str]] = None   # {'ns', 'name', 'uid'}
    node: Optional[str] = None
    groups: Optional[str] = None
    # flight-recorder plumbing (obs/): the correlation ID minted at
    # watch-event receipt and the enqueue stamp (time.monotonic) — the
    # scheduler turns their difference into the queue-wait span/histogram
    corr: Optional[str] = None
    t_enqueue: float = 0.0


class WatchQueue:
    """Thin typed wrapper over queue.Queue (NHDWatchQueue.py:18-36)."""

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue[WatchItem]" = queue.Queue(maxsize)

    def put(self, item: WatchItem) -> None:
        self._q.put(item)

    def put_batch(self, items: List[WatchItem]) -> None:
        """Batched enqueue seam shared with ingress.AdmissionQueue: the
        controller hands one decode pass's items over in arrival order."""
        for item in items:
            self._q.put(item)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> WatchItem:
        return self._q.get(block=block, timeout=timeout)

    def empty(self) -> bool:
        return self._q.empty()

    def qsize(self) -> int:
        """Approximate depth (the nhd_event_queue_depth gauge)."""
        return self._q.qsize()
