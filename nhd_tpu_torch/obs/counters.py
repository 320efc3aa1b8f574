"""The one counter registry of the port.

Re-exports ``API_COUNTERS`` and ``ApiCounters`` from the port's copy of
the reference's k8s/retry.py, so the encode and device-state layers,
the solver guard, the retry layer and the daemon all bump one object.
Every name this module used to seed (the ``device_state_*`` counters) is
in ``ApiCounters.KNOWN`` there, with the guard's names beside them.
"""

from __future__ import annotations

from nhd_tpu_torch.k8s.retry import API_COUNTERS, ApiCounters

__all__ = ["API_COUNTERS", "ApiCounters"]
