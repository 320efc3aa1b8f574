"""The counter registry the encode and device-state layers bump.

A cut-down copy of ``ApiCounters`` from the reference's k8s/retry.py:
only the registry object and the device-state counter names the solver
path touches, without the API retry layer around it.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class ApiCounters:
    """Thread-safe counter/gauge registry, pre-seeded from KNOWN."""

    KNOWN: Dict[str, Tuple[str, str]] = {
        "device_state_events_total":
            ("counter", "Watch/claim events folded into the incremental "
                        "cluster state as deltas"),
        "device_state_deltas_total":
            ("counter", "Row patches applied to the host-resident packed "
                        "cluster arrays"),
        "device_state_rows_uploaded_total":
            ("counter", "Node rows scattered/uploaded to the "
                        "device-resident arrays"),
        "device_state_full_rebuilds_total":
            ("counter", "Incremental-state fallbacks to a full "
                        "encode_cluster rebuild"),
        "device_state_resident_age_seconds":
            ("gauge", "Seconds since the resident cluster state was "
                      "last fully rebuilt"),
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vals: Dict[str, float] = {name: 0 for name in self.KNOWN}

    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0) + by

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._vals[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._vals.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._vals)

    def reset(self) -> None:
        with self._lock:
            self._vals = {name: 0 for name in self.KNOWN}


#: process-wide registry
API_COUNTERS = ApiCounters()
