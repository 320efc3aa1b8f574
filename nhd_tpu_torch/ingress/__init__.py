"""Overload-robust front door: per-tenant admission between the
controller's watch decode and the scheduler's batch machinery
(docs/RESILIENCE.md "Layer 9 — Overload & admission")."""

from nhd_tpu_torch.ingress.admission import (
    RUNG_ADMIT,
    RUNG_DEFER,
    RUNG_SHED,
    AdmissionQueue,
    TokenBucket,
)

__all__ = [
    "AdmissionQueue",
    "TokenBucket",
    "RUNG_ADMIT",
    "RUNG_DEFER",
    "RUNG_SHED",
]
