"""Structured unschedulability diagnosis ("why won't this pod place?").

The reference's only debugging story is grepping the matcher's verbose
logs for the node that rejected a pod (reference README.md:161-171 shows
the documented workflow). This module answers the same question as data:
for one pod against the current node mirror, report each node's FIRST
failing predicate — in the exact order the matcher applies them
(Matcher.py:65-391 / solver/oracle.py) — plus a cluster-wide summary.

Serial per-node evaluation via the oracle stages (exact semantics, no
tensor blow-up): explaining is a one-pod operator query, not a hot path.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode, PodTopology
from nhd_tpu_torch.solver.oracle import OracleMatcher

# predicate order mirrors the matcher pipeline (oracle.find_node)
R_INACTIVE = "node-inactive"            # cordoned / missing scheduler taint
R_MAINTENANCE = "maintenance"
R_HUGEPAGES = "insufficient-hugepages"
R_GROUPS = "node-group-mismatch"
R_BUSY = "busy-backoff"                 # GPU pod within MIN_BUSY_SECS window
R_GPU = "gpu-numa-fit"
R_CPU = "cpu-numa-fit"
R_NIC = "nic-bandwidth-fit"
R_PCI = "pci-switch-pairing"
R_INTERSECT = "cross-resource-numa-intersection"
R_INVALID_MODE = "invalid-map-mode"     # matcher rejects unconditionally
R_OK = "schedulable"


@dataclass
class NodeVerdict:
    node: str
    reason: str
    detail: str = ""


@dataclass
class ExplainReport:
    pod_summary: str
    verdicts: List[NodeVerdict] = field(default_factory=list)
    schedulable_nodes: List[str] = field(default_factory=list)
    # policy verdict (nhd_tpu/policy/, present only with NHD_POLICY=1):
    # the pod's tier, the scoring mode, and the score-term breakdown per
    # schedulable node — (class, quantized score); the highest-scoring
    # schedulable node is what the fused megaround's ranking picks first
    policy: Optional[dict] = None

    @property
    def summary(self) -> Dict[str, int]:
        return dict(Counter(v.reason for v in self.verdicts))

    def render(self) -> str:
        """Human-readable report (CLI output)."""
        lines = [f"pod: {self.pod_summary}"]
        counts = self.summary
        lines.append(
            "summary: "
            + ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
        )
        if self.schedulable_nodes:
            lines.append(
                f"schedulable on {len(self.schedulable_nodes)} node(s): "
                + ", ".join(self.schedulable_nodes[:8])
                + ("..." if len(self.schedulable_nodes) > 8 else "")
            )
        else:
            lines.append("UNSCHEDULABLE on every node")
        if self.policy is not None and self.policy.get("scores"):
            ranked = sorted(
                self.policy["scores"].items(),
                key=lambda kv: -kv[1]["score"],
            )
            lines.append(
                f"policy: tier={self.policy['tier']} "
                f"mode={self.policy['score_mode']} "
                + ", ".join(
                    f"{n}={s['class']}:{s['score']}" for n, s in ranked[:8]
                )
            )
        for v in self.verdicts:
            if v.reason != R_OK:
                lines.append(
                    f"  {v.node}: {v.reason}"
                    + (f" ({v.detail})" if v.detail else "")
                )
        return "\n".join(lines)


def explain(
    nodes: Dict[str, HostNode],
    req: Union[PodRequest, PodTopology],
    *,
    now: Optional[float] = None,
    respect_busy: bool = True,
) -> ExplainReport:
    """Per-node first-failing-predicate report for one pod."""
    if isinstance(req, PodTopology):
        req = PodRequest.from_topology(req)
    matcher = OracleMatcher()

    gpus = sum(req.gpu_counts())
    bw = req.nic_bw()
    report = ExplainReport(
        pod_summary=(
            f"{req.n_groups} group(s), {gpus} GPU(s), "
            f"{sum(rx + tx for rx, tx in bw):.0f} Gbps NIC, "
            f"{req.hugepages_gb} GiB hugepages, map={req.map_mode.name}, "
            f"groups={sorted(req.node_groups)}"
        )
    )

    if req.map_mode not in (MapMode.NUMA, MapMode.PCI):
        # the matcher refuses these outright (oracle.find_node) — report
        # that, not per-node feasibility
        report.verdicts = [
            NodeVerdict(name, R_INVALID_MODE,
                        f"map mode {req.map_mode.name} is not schedulable")
            for name in nodes
        ]
        return report

    for name, node in nodes.items():
        report.verdicts.append(_explain_node(matcher, name, node, req,
                                             now=now,
                                             respect_busy=respect_busy))
    report.schedulable_nodes = [
        v.node for v in report.verdicts if v.reason == R_OK
    ]
    _attach_policy(report, nodes, req)
    return report


def _attach_policy(report: ExplainReport, nodes, req) -> None:
    """Score-term breakdown for the schedulable nodes (policy engine):
    answers "the pod CAN run on 12 nodes — why did it land THERE" as
    data. Off (None) unless NHD_POLICY=1."""
    from nhd_tpu_torch import policy as _policy

    if not _policy.enabled():
        return
    from nhd_tpu_torch.policy.classes import CLASSES, node_class_index
    from nhd_tpu_torch.policy.scoring import score_mode, score_row

    row = score_row(req)
    scores = {}
    for name in report.schedulable_nodes:
        idx = node_class_index(nodes[name])
        scores[name] = {
            "class": CLASSES.name_of(idx),
            "score": int(row[min(idx, len(row) - 1)]),
        }
    report.policy = {
        "tier": getattr(req, "tier", 0),
        "score_mode": score_mode(),
        "scores": scores,
    }


def _explain_node(
    matcher: OracleMatcher,
    name: str,
    node: HostNode,
    req: PodRequest,
    *,
    now: Optional[float],
    respect_busy: bool,
) -> NodeVerdict:
    # stage 1: pod-level filters, split into individual reasons
    if not node.active:
        return NodeVerdict(name, R_INACTIVE)
    if node.maintenance:
        return NodeVerdict(name, R_MAINTENANCE)
    if req.hugepages_gb > node.mem.free_hugepages_gb:
        return NodeVerdict(
            name, R_HUGEPAGES,
            f"need {req.hugepages_gb} GiB, free {node.mem.free_hugepages_gb}",
        )
    if not (req.node_groups & set(node.groups)):
        return NodeVerdict(
            name, R_GROUPS,
            f"node groups {sorted(node.groups)}",
        )
    if sum(req.gpu_counts()) > 0 and respect_busy and node.is_busy(now):
        return NodeVerdict(name, R_BUSY)

    # stage 2: per-resource NUMA feasibility, in matcher order
    gpu_combos = matcher._numa_combos(
        req.gpu_counts(), node.free_gpus_per_numa(), node.numa_nodes
    )
    if not gpu_combos:
        return NodeVerdict(
            name, R_GPU,
            f"need {list(req.gpu_counts())}, "
            f"free/numa {node.free_gpus_per_numa()}",
        )
    cpu_combos = matcher._numa_combos(
        req.cpu_slot_counts(node.smt_enabled),
        node.free_cpu_cores_per_numa(), node.numa_nodes,
    )
    if not cpu_combos:
        return NodeVerdict(
            name, R_CPU,
            f"need {list(req.cpu_slot_counts(node.smt_enabled))} phys, "
            f"free/numa {node.free_cpu_cores_per_numa()}",
        )
    nic_combos = matcher._nic_combos(node, req.nic_bw())
    if not nic_combos:
        free = node.free_nic_bw_per_numa()
        return NodeVerdict(
            name, R_NIC,
            f"need {[f'{rx:.0f}/{tx:.0f}' for rx, tx in req.nic_bw()]} "
            f"rx/tx Gbps, headroom/numa "
            f"{[[f'{r:.0f}/{t:.0f}' for r, t in numa] for numa in free]}",
        )

    # stage 3: PCI switch pairing, then cross-type intersection
    if req.map_mode == MapMode.PCI:
        nic_combos = matcher.prune_pci_nic_combos(node, nic_combos)
        if not nic_combos:
            return NodeVerdict(
                name, R_PCI,
                f"free GPUs per switch {node.free_gpus_per_pciesw()}",
            )

    gpu_prefixes = set(gpu_combos)
    cpu_prefixes = {c[:-1] for c in cpu_combos}
    nic_prefixes = {tuple(n for n, _ in c) for c in nic_combos}
    if not (gpu_prefixes & cpu_prefixes & nic_prefixes):
        return NodeVerdict(
            name, R_INTERSECT,
            "per-resource NUMA assignments never coincide",
        )
    return NodeVerdict(name, R_OK)
