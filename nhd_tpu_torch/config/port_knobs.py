"""Registry of the port's own environment knobs (``NHDC_*``).

The port reads the reference's registered ``NHD_*`` knobs where their
meaning is the same (``config/knobs.py``, a verbatim copy, so one
setting drives both sides of a parity test). A knob only the port has
takes the ``NHDC_`` prefix and is registered here: nhdlint's NHD720
(``nhd_tpu_torch/analysis/rules_contract.py``) fails any ``NHDC_*``
environment read that this table lacks.
"""

from __future__ import annotations

from typing import FrozenSet, Tuple

from nhd_tpu_torch.config.knobs import Knob

KNOBS: Tuple[Knob, ...] = (
    Knob("NHDC_AOT_DIR", "`nhd_tpu_torch/_build`",
         "the port's kernel cache: the CUDA kernel libraries with their "
         "toolchain metas, and the manifest of shape keys that "
         "`--prewarm` warms (solver/aot.py, kernels/build.py)"),
)


def registered_names() -> FrozenSet[str]:
    """Every registered ``NHDC_*`` name."""
    return frozenset(k.name for k in KNOBS)
