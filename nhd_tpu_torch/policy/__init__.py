"""Scheduling-policy engine: heterogeneity-aware scoring, priority
tiers, and bounded preemption (ROADMAP "Heterogeneity-aware scoring and
preemption as new workloads"; Gavel, PAPERS.md "Heterogeneity-Aware
Cluster Scheduling Policies for Deep Learning Workloads").

The feasibility solver PRs 1-14 built answers "where CAN this pod run";
this package answers "where SHOULD it run, and who yields when it
can't":

* **Node classes** (:mod:`nhd_tpu.policy.classes`) — fleet hardware
  generations, derived from node labels at encode time and interned to
  small ints exactly like node groups. Every node row carries its class
  index in the packed cluster arrays (``ClusterArrays.node_class``).
* **Throughput scoring** (:mod:`nhd_tpu.policy.scoring`) — a
  per-(workload-kind, node-class) throughput matrix projected into
  per-pod-type score rows (``PodTypeArrays.class_score``) that ride the
  fused solve+rank megaround as extra vmapped score terms: the ranking
  key becomes (score, gpuless-preference, low-node-index). With
  ``NHD_POLICY=0`` the rows are all-zero and placements are bit-exact
  with the pre-policy scheduler; a uniform matrix is placement-neutral
  by construction (a constant per-type shift cannot reorder nodes).
* **Bounded preemption** (:mod:`nhd_tpu.policy.preempt`) — pods carry a
  priority tier; when a higher-tier pod is unplaceable the planner
  picks a minimal victim set (lowest tier first, finish-time-fairness
  tiebreak) under per-round and per-tenant budgets. Execution lives in
  scheduler/core.py and rides the existing unwind+requeue path through
  the fenced ``_commit_write`` chokepoint — never an unfenced eviction.

Everything here is dormant until ``NHD_POLICY=1`` (read per call, so
tests and chaos cells toggle it without rebuilding schedulers);
docs/SCHEDULING_POLICIES.md is the operator story.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple


def enabled() -> bool:
    """The policy master switch (``NHD_POLICY``, default off). Read at
    call time — the pinned bit-exactness contract is that everything in
    this package is inert when it reads false."""
    return os.environ.get("NHD_POLICY", "0") == "1"


def preemption_enabled() -> bool:
    """Preemption rides the master switch; ``NHD_POLICY_PREEMPT=0``
    keeps scoring while disabling eviction (scoring-only posture)."""
    return enabled() and os.environ.get("NHD_POLICY_PREEMPT", "1") == "1"


# ---------------------------------------------------------------------------
# policy counters — the labeled complement of the scalar
# nhd_policy_* families in k8s/retry.py ApiCounters (rendered as
# nhd_policy_preemptions_total{tier=...} by rpc/metrics.py)
# ---------------------------------------------------------------------------

#: tier label vocabulary bound (NHD603 stance: metric label sets must be
#: finite) — tiers at or past the bound fold into the top bucket
MAX_TIER_LABEL = 7

_LOCK = threading.Lock()
_PREEMPT_BY_TIER: Dict[int, int] = {}
#: (preemptor_tier, victim_tier) pairs — the chaos harness's
#: tier-inversion invariant reads these (every victim must be strictly
#: lower-tier than its preemptor)
_PREEMPT_PAIRS: List[Tuple[int, int]] = []


def note_preemption(preemptor_tier: int, victim_tier: int) -> None:
    """Record one executed eviction (called by the scheduler AFTER the
    fenced evict landed, never for planned-but-fenced-off ones)."""
    t = max(0, min(int(victim_tier), MAX_TIER_LABEL))
    with _LOCK:
        _PREEMPT_BY_TIER[t] = _PREEMPT_BY_TIER.get(t, 0) + 1
        if len(_PREEMPT_PAIRS) < 65536:  # bounded witness ring
            _PREEMPT_PAIRS.append((int(preemptor_tier), int(victim_tier)))


def preempt_tier_snapshot() -> Dict[int, int]:
    """{victim tier: evictions} this process executed."""
    with _LOCK:
        return dict(_PREEMPT_BY_TIER)


def preempt_pairs() -> List[Tuple[int, int]]:
    """(preemptor tier, victim tier) witness list (bounded)."""
    with _LOCK:
        return list(_PREEMPT_PAIRS)


def reset_policy_metrics() -> None:
    """Test/chaos-cell isolation: zero the policy registries."""
    with _LOCK:
        _PREEMPT_BY_TIER.clear()
        _PREEMPT_PAIRS.clear()
