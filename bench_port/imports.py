"""What the run must not load: JAX and the JAX package. Compared by the
whole top-level name of each module, the part before the first dot, so
that ``nhd_tpu_torch`` (the port) passes and ``nhd_tpu`` fails."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nhd_tpu"})


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among *modules*, sorted."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
