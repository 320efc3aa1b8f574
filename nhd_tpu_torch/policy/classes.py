"""Node classes: fleet hardware generations as interned small ints.

A real fleet mixes node generations (ROADMAP heterogeneity item); the
solver's packed cluster arrays carry each node's class as one int32 per
row (``ClusterArrays.node_class``) so the fused megaround can gather
per-(pod-type, class) throughput scores without any host re-rank.

Class names come off node labels at encode time (core/node.py stores
``HostNode.node_class`` at label parse: the explicit ``NHD_NODE_CLASS``
label when present, else a GPU-model-derived default, else ``cpu``) and
intern here — the same move as the node-group bitmask interner
(solver/encode.py GroupInterner), except class indices are meaningful
per NAME, not per position, so interning order never matters for
correctness and a new class mid-stream is a plain row patch, not a
delta-layer rebuild trigger.

The interner is process-global: node encodes and pod score rows
(policy/scoring.py) must agree on indices, and several live contexts
(streaming tiles, chaos replicas) share one process. The index space is
bounded at :data:`MAX_CLASSES` — the ``class_score`` tensor's fixed row
width, so the fused program shapes never re-specialize on fleet
diversity; classes past the bound fold into index 0 (scored as the
default class) with one warning.
"""

from __future__ import annotations

import threading
from typing import Dict, List

#: fixed width of the per-type score row (PodTypeArrays.class_score):
#: a compile-time constant so class diversity never re-traces programs
MAX_CLASSES = 16

#: index 0 is the default class — unlabeled nodes, and the overflow
#: bucket when a fleet exceeds MAX_CLASSES distinct classes
DEFAULT_CLASS = "default"


class ClassInterner:
    """Class name → stable small int (0 = the default class)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idx: Dict[str, int] = {DEFAULT_CLASS: 0}
        self._names: List[str] = [DEFAULT_CLASS]
        #: bumps when a new name interns — scoring row caches key on it
        self.generation = 0
        self._warned_overflow = False

    def index(self, name: str) -> int:
        """The class's row index, interning on first sight. Past
        MAX_CLASSES distinct names, folds to 0 (default scoring)."""
        if not name:
            return 0
        with self._lock:
            i = self._idx.get(name)
            if i is not None:
                return i
            if len(self._names) >= MAX_CLASSES:
                if not self._warned_overflow:
                    self._warned_overflow = True
                    from nhd_tpu_torch.utils import get_logger

                    get_logger(__name__).warning(
                        f"more than {MAX_CLASSES} distinct node classes; "
                        f"folding {name!r} (and any further classes) into "
                        "the default class for scoring"
                    )
                return 0
            i = len(self._names)
            self._idx[name] = i
            self._names.append(name)
            self.generation += 1
            return i

    def names(self) -> List[str]:
        with self._lock:
            return list(self._names)

    def name_of(self, i: int) -> str:
        with self._lock:
            return self._names[i] if 0 <= i < len(self._names) else DEFAULT_CLASS

    @property
    def n_classes(self) -> int:
        with self._lock:
            return len(self._names)


#: the process-global interner every encode and score row shares
CLASSES = ClassInterner()


def node_class_index(node) -> int:
    """The packed-row class index of one HostNode (encode-time hook:
    solver/encode.py calls this per row)."""
    return CLASSES.index(getattr(node, "node_class", DEFAULT_CLASS))
