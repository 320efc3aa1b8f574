"""Config parser plugin seam.

The reference declares an abstract CfgParser (CfgParser.py:9-33) and a
scheduler-side factory that today always returns the Triad parser
(NHDScheduler.py:228-233 — noted there as a missing plugin registry).
Here the seam is an actual registry keyed by the pod's ``cfg_type``
annotation value, so new workload formats plug in without touching the
scheduler.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional

from nhd_tpu_torch.core.topology import PodTopology


class CfgParser(ABC):
    """A workload config format: text ⇄ PodTopology (reference: CfgParser.py:9-33)."""

    @abstractmethod
    def to_topology(self, parse_net: bool) -> Optional[PodTopology]:
        """Parse the config into a PodTopology; ``parse_net`` additionally
        reloads already-assigned NIC state from a deployed config
        (reference: CfgParser.py:21-24, TriadCfgParser.py:337-380)."""

    @abstractmethod
    def to_config(self) -> str:
        """Write the solved topology back into config text
        (reference: CfgParser.py:13-16, TriadCfgParser.py:413-459)."""

    @abstractmethod
    def to_gpu_map(self) -> Dict[str, int]:
        """Produce the pod GPU-device annotation map
        (reference: CfgParser.py:29-33, TriadCfgParser.py:397-410)."""


_REGISTRY: Dict[str, Callable[[str], CfgParser]] = {}
_DEFAULT_TYPE = "triad"


def register_cfg_parser(cfg_type: str, factory: Callable[[str], CfgParser]) -> None:
    _REGISTRY[cfg_type] = factory


def get_cfg_parser(cfg_type: Optional[str], cfg_text: str) -> CfgParser:
    """Build a parser for ``cfg_type``, defaulting to the Triad format like
    the reference factory does (NHDScheduler.py:228-233)."""
    factory = _REGISTRY.get(cfg_type or _DEFAULT_TYPE) or _REGISTRY[_DEFAULT_TYPE]
    return factory(cfg_text)


def registered_cfg_types() -> list:
    """The cfg_type values currently registered (CLI validation)."""
    return sorted(_REGISTRY)
