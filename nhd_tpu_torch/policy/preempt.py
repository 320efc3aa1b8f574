"""Bounded preemption: minimal victim sets under explicit budgets.

When a higher-tier pod has no candidate node, the planner asks the only
question the feasibility solver can't: *who should yield?* The answer is
deliberately conservative (Gavel's policy stance, PAPERS.md):

* victims must be STRICTLY lower tier than the preemptor;
* lowest tier evicts first; within a tier the finish-time-fairness
  tiebreak prefers the most recently bound pod (least progress lost —
  the cheapest work to redo);
* the victim set is minimal per node (victims release one at a time and
  the single-node oracle re-judges feasibility after each — the first
  feasible prefix wins), and the chosen node is the one needing the
  fewest victims (ties: lowest victim-tier sum, then node order);
* per-round and per-tenant budgets bound every step of a storm: a
  planner that would exceed either returns "budget-exhausted" instead
  of a plan.

Planning is PURE with respect to cluster state: victims release on the
live mirror node only long enough to ask the oracle, then re-claim —
the scheduler thread owns the mirror, so the probe is invisible to
every other consumer. Execution (the fenced evict + unwind + requeue)
lives in scheduler/core.py; this module never touches a backend.

Determinism: given the same mirror, pod-state and budgets, the plan is
a pure function — node iteration order is the mirror's dict order,
victim order is (tier, -bound_at, name) — pinned by the property test
in tests/test_policy.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: candidate-node scan bound: preemption is an exceptional-path operator
#: action, not a hot path, but a federation-scale mirror must not pay an
#: O(nodes × victims) oracle walk per unplaceable pod — the first
#: PLAN_SCAN_MAX nodes holding eligible victims are considered
PLAN_SCAN_MAX = 64


def round_budget() -> int:
    """Max evictions one scheduling batch may execute
    (``NHD_POLICY_PREEMPT_ROUND_BUDGET``)."""
    return int(os.environ.get("NHD_POLICY_PREEMPT_ROUND_BUDGET", "4"))


def tenant_budget() -> int:
    """Max evictions one batch may charge a single tenant (namespace)
    (``NHD_POLICY_PREEMPT_TENANT_BUDGET``)."""
    return int(os.environ.get("NHD_POLICY_PREEMPT_TENANT_BUDGET", "2"))


def max_attempts() -> int:
    """Preemption attempts per pod before it takes the plain
    unschedulable verdict (``NHD_POLICY_PREEMPT_ATTEMPTS``) — the
    livelock bound: a pod that preempts and still can't place (races,
    fragmentation) stops burning victims."""
    return int(os.environ.get("NHD_POLICY_PREEMPT_ATTEMPTS", "2"))


@dataclass
class PreemptBudget:
    """One scheduling batch's remaining eviction allowance."""

    round_left: int
    tenant_cap: int
    tenant_used: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def fresh(cls) -> "PreemptBudget":
        return cls(round_left=round_budget(), tenant_cap=tenant_budget())

    def admits(self, victims: List[Tuple[str, str, int]]) -> bool:
        """Whether this victim list fits the remaining allowance."""
        if len(victims) > self.round_left:
            return False
        per_ns: Dict[str, int] = {}
        for ns, _pod, _tier in victims:
            per_ns[ns] = per_ns.get(ns, 0) + 1
        return all(
            self.tenant_used.get(ns, 0) + n <= self.tenant_cap
            for ns, n in per_ns.items()
        )

    def charge(self, victims: List[Tuple[str, str, int]]) -> None:
        self.round_left -= len(victims)
        for ns, _pod, _tier in victims:
            self.tenant_used[ns] = self.tenant_used.get(ns, 0) + 1

    def state(self) -> dict:
        """The budget snapshot decision records carry."""
        return {
            "round_left": self.round_left,
            "tenant_cap": self.tenant_cap,
            "tenant_used": dict(self.tenant_used),
        }


@dataclass
class PreemptionPlan:
    """A minimal victim set on one node, within budget."""

    node: str
    #: (ns, pod, tier) in eviction order
    victims: List[Tuple[str, str, int]]

    @property
    def tier_sum(self) -> int:
        return sum(t for _ns, _pod, t in self.victims)


def _eligible_victims(
    node, tier: int, pod_tiers: Dict[Tuple[str, str], Tuple[int, float]],
) -> List[Tuple[str, str, int]]:
    """Strictly-lower-tier pods on *node*, in eviction preference order:
    lowest tier first, then most recently bound (finish-time fairness —
    least progress lost), then name (the determinism pin)."""
    out = []
    for (pod, ns) in node.pod_info:
        vt, bound_at = pod_tiers.get((ns, pod), (0, 0.0))
        if vt < tier:
            out.append((vt, -bound_at, ns, pod))
    out.sort()
    return [(ns, pod, vt) for vt, _mb, ns, pod in out]


def _probe_node(
    node, name: str, req, victims: List[Tuple[str, str, int]],
    budget: PreemptBudget, *, now, respect_busy,
) -> Optional[List[Tuple[str, str, int]]]:
    """The minimal feasible victim PREFIX on one node, or None.

    Victims release on the live node one at a time; after each release
    the single-node oracle re-judges the preemptor. Whatever happens,
    every released topology re-claims before return — the probe must be
    invisible (the scheduler thread owns the mirror, so nothing can
    observe the window)."""
    from nhd_tpu_torch.solver.oracle import find_node

    released: List[Tuple[Tuple[str, str], object]] = []
    single = {name: node}
    try:
        for i, (ns, pod, vt) in enumerate(victims):
            top = node.pod_info.get((pod, ns))
            if top is None:
                continue
            node.release_from_topology(top)
            released.append(((ns, pod), top))
            prefix = victims[: i + 1]
            if not budget.admits(prefix):
                return None
            if find_node(
                single, req, now=now, respect_busy=respect_busy
            ) is not None:
                return list(prefix)
        return None
    finally:
        # exact inverse, reverse order: claim_from_topology re-claims
        # the same physical IDs release_from_topology freed
        for (_key, top) in reversed(released):
            if not node.claim_from_topology(top):
                from nhd_tpu_torch.utils import get_logger

                # should be unreachable (same IDs, same node); if the
                # mirror really can't re-claim, say so loudly — the
                # reconcile net repairs from the cluster
                get_logger(__name__).error(
                    f"preemption probe could not restore a claim on "
                    f"{name}; mirror may need a reconcile pass"
                )


def plan_preemption(
    nodes: Dict[str, "object"],
    req,
    tier: int,
    pod_tiers: Dict[Tuple[str, str], Tuple[int, float]],
    budget: PreemptBudget,
    *,
    now: Optional[float] = None,
    respect_busy: bool = True,
) -> Tuple[Optional[PreemptionPlan], str]:
    """The minimal-victim plan for one unplaceable pod, or (None, why).

    ``pod_tiers`` maps (ns, pod) → (tier, bound_at) for bound pods (the
    scheduler's pod_state projection). ``why`` is "ok", "no-plan"
    (no victim set makes the pod feasible) or "budget-exhausted" (a
    feasible set exists but the round/tenant budgets refuse it — the
    nhd_policy_preempt_budget_exhausted_total signal)."""
    if tier <= 0:
        return None, "no-plan"
    best: Optional[PreemptionPlan] = None
    saw_budget_refusal = False
    scanned = 0
    for name, node in nodes.items():
        if not node.active or node.maintenance:
            continue
        if not (req.node_groups & set(node.groups)):
            continue
        victims = _eligible_victims(node, tier, pod_tiers)
        if not victims:
            continue
        scanned += 1
        if scanned > PLAN_SCAN_MAX:
            break
        # budget-blind probe first: distinguishes "no plan exists" from
        # "a plan exists but the budget refuses it" (different verdicts,
        # different metrics)
        blind = PreemptBudget(round_left=len(victims), tenant_cap=len(victims))
        prefix = _probe_node(
            node, name, req, victims, blind,
            now=now, respect_busy=respect_busy,
        )
        if prefix is None:
            continue
        if not budget.admits(prefix):
            saw_budget_refusal = True
            continue
        plan = PreemptionPlan(node=name, victims=prefix)
        if (
            best is None
            or len(plan.victims) < len(best.victims)
            or (
                len(plan.victims) == len(best.victims)
                and plan.tier_sum < best.tier_sum
            )
        ):
            best = plan
            if len(best.victims) == 1 and best.tier_sum == 0:
                break  # cannot do better than one tier-0 victim
    if best is not None:
        return best, "ok"
    return None, ("budget-exhausted" if saw_budget_refusal else "no-plan")
