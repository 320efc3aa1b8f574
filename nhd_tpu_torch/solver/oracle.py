"""Serial oracle matcher: exact reference semantics, deterministic order.

A clean-room reimplementation of the reference's filter→intersect→select
solver (Matcher.py:27-452), used for two things:

1. the correctness oracle the batched JAX solver is property-tested against;
2. the serial baseline the benchmark compares against (BASELINE.md north
   star: ≥100× this loop).

Semantics notes (each is a load-bearing reference quirk, kept):
* NUMA combinations are enumerated per resource type, then intersected on
  the per-group prefix; CPU combos carry one extra trailing slot for the
  top-level misc cores (Matcher.py:345,442-444).
* SMT ceil-division for SMT-tolerant requests (Matcher.py:179-201) lives in
  CpuRequest.physical_cores.
* GPU-requesting pods skip nodes placed on within MIN_BUSY_SECS
  (Matcher.py:103-111).
* PCI map mode additionally requires each NIC choice to have enough free
  GPUs on its PCIe switch (Matcher.py:295-335).
* Node selection: CPU-only pods prefer GPU-less nodes, else first candidate
  in iteration order (Matcher.py:404-421); the final combo maximizes GPU
  packing skew (Matcher.py:423-452).

Deliberate deviations from the reference (all documented, all pinned by
tests — the JAX solver is property-tested against THIS oracle):

* Combination order: the reference stores combos in Python sets, so its
  tie-breaking order is CPython-hash order (Matcher.py:129,141). Here
  combinations stay in itertools.product order, making every tie-break
  deterministic. Feasible *sets* are identical.
* Top-level misc-core SMT: the reference gates the ceil-halving on a plain
  Enum member (`req_cpus['misc'][1]`, Matcher.py:198) which is truthy even
  for SMT_DISABLED — so the reference *always* ceil-halves misc cores on
  SMT nodes. Four lines earlier it correctly uses `.value` for group cores
  (Matcher.py:182-190). This oracle honors the flag as intended: SMT-OFF
  misc cores cost one physical core each.
* Group/active filtering lives here (see filter_pod_resources) rather than
  in the scheduler wrapper.

Reference quirk kept (and worth knowing): PCI-mode intersection requires
free GPUs per PCIe switch ≥ the number of *NICs chosen* on that switch
(Matcher.py:313-322) — not ≥ the GPUs actually requested. A multi-GPU
group can therefore match a node whose switch holds only one free GPU and
then fail at physical assignment; the scheduler handles that by failing
the pod, exactly as the reference does (NHDScheduler.py:296-299).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Dict, List, Optional, Sequence, Tuple, Union

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode, PodTopology
from nhd_tpu_torch.utils import get_logger

NumaCombo = Tuple[int, ...]
NicCombo = Tuple[Tuple[int, int], ...]  # per group: (numa, nic ordinal)


@dataclass
class MatchResult:
    """A chosen node plus the NUMA/NIC mapping to realize on it."""

    node: str
    mapping: Dict[str, tuple]  # {'gpu': NumaCombo, 'cpu': NumaCombo+misc, 'nic': NicCombo}


@dataclass
class FeasibleSets:
    """Per-node feasible combination lists (the reference's `filts[0]`)."""

    gpu: Dict[str, List[NumaCombo]]
    cpu: Dict[str, List[NumaCombo]]
    nic: Dict[str, List[NicCombo]]
    candidates: List[str]


class OracleMatcher:
    """Schedules one pod at a time against the host-side node mirror."""

    def __init__(self) -> None:
        self.logger = get_logger(__name__)

    # ------------------------------------------------------------------

    def find_node(
        self,
        nodes: Dict[str, HostNode],
        req: Union[PodRequest, PodTopology],
        *,
        now: Optional[float] = None,
        respect_busy: bool = True,
    ) -> Optional[MatchResult]:
        """Find the best node + mapping for one pod (reference: Matcher.py:27-63)."""
        if isinstance(req, PodTopology):
            req = PodRequest.from_topology(req)

        if req.map_mode not in (MapMode.NUMA, MapMode.PCI):
            self.logger.error(f"invalid map mode {req.map_mode}")
            return None

        nodes = self.filter_pod_resources(nodes, req)
        filts = self.filter_numa_topology(nodes, req, now=now, respect_busy=respect_busy)
        if not filts.candidates:
            return None

        self.intersect_resources(nodes, filts, req.map_mode)

        node = self.select_node(filts, req, nodes)
        if node is None:
            return None

        mapping = self.choose_mapping(node, nodes[node].numa_nodes, filts)
        return MatchResult(node, mapping)

    # ------------------------------------------------------------------
    # stage 1: pod-level resource filter
    # ------------------------------------------------------------------

    def filter_pod_resources(
        self, nodes: Dict[str, HostNode], req: PodRequest
    ) -> Dict[str, HostNode]:
        """Maintenance + hugepages (reference: Matcher.py:65-84), plus the
        node-group ∩ pod-groups and active checks the reference performs
        scheduler-side before calling the matcher (NHDScheduler.py:235-247)
        — folded in here so direct matcher users get full semantics and the
        JAX solver's group/active predicates have an oracle to test against."""
        return {
            name: node
            for name, node in nodes.items()
            if node.active
            and not node.maintenance
            and req.hugepages_gb <= node.mem.free_hugepages_gb
            and req.node_groups & set(node.groups)
        }

    # ------------------------------------------------------------------
    # stage 2: per-resource NUMA feasibility
    # ------------------------------------------------------------------

    @staticmethod
    def _numa_combos(
        demands: Sequence[float], free: Sequence[float], numa_nodes: int
    ) -> List[NumaCombo]:
        """All assignments of demand slots onto NUMA nodes whose per-node
        sums fit the free vector (reference: Matcher.py:118-129,203-212)."""
        out: List[NumaCombo] = []
        for combo in product(range(numa_nodes), repeat=len(demands)):
            totals = [0.0] * numa_nodes
            for slot, numa in enumerate(combo):
                totals[numa] += demands[slot]
            if all(totals[i] <= free[i] for i in range(numa_nodes)):
                out.append(combo)
        return out

    def filter_numa_topology(
        self,
        nodes: Dict[str, HostNode],
        req: PodRequest,
        *,
        now: Optional[float] = None,
        respect_busy: bool = True,
    ) -> FeasibleSets:
        """Per-node combination enumeration for GPU, CPU, NIC
        (reference: Matcher.py:86-280)."""
        filts = FeasibleSets(gpu={}, cpu={}, nic={}, candidates=list(nodes.keys()))
        req_gpus = req.gpu_counts()

        # --- GPUs (reference: Matcher.py:97-149) ---
        for name, node in nodes.items():
            if sum(req_gpus) > 0 and respect_busy and node.is_busy(now):
                filts.candidates.remove(name)
                continue
            combos = self._numa_combos(
                req_gpus, node.free_gpus_per_numa(), node.numa_nodes
            )
            if not combos:
                filts.candidates.remove(name)
            filts.gpu[name] = combos
        if not filts.candidates:
            return FeasibleSets(gpu={}, cpu={}, nic={}, candidates=[])

        # --- CPUs (reference: Matcher.py:152-222) ---
        for name, node in nodes.items():
            if name not in filts.candidates:
                continue
            slots = req.cpu_slot_counts(node.smt_enabled)
            combos = self._numa_combos(
                slots, node.free_cpu_cores_per_numa(), node.numa_nodes
            )
            if not combos:
                filts.candidates.remove(name)
            filts.cpu[name] = combos

        # --- NICs (reference: Matcher.py:224-276) ---
        bw = req.nic_bw()
        for name, node in nodes.items():
            if name not in filts.candidates:
                continue
            combos = self._nic_combos(node, bw)
            if not combos:
                filts.candidates.remove(name)
            filts.nic[name] = combos

        return filts

    @staticmethod
    def _nic_combos(node: HostNode, bw: List[Tuple[float, float]]) -> List[NicCombo]:
        """All (numa, nic ordinal) assignments per group whose summed rx/tx
        demands fit every chosen NIC's headroom. Groups may share a NIC; the
        subtraction is joint (reference: Matcher.py:242-268, without the
        per-combination deepcopy).
        """
        free = node.free_nic_bw_per_numa()
        out: List[NicCombo] = []
        n_groups = len(bw)
        for numa_combo in product(range(node.numa_nodes), repeat=n_groups):
            # each group picks one NIC ordinal within its assigned NUMA node
            per_group_choices = [range(len(free[numa])) for numa in numa_combo]
            for picks in product(*per_group_choices):
                usage: Dict[Tuple[int, int], List[float]] = {}
                ok = True
                for g in range(n_groups):
                    key = (numa_combo[g], picks[g])
                    acc = usage.setdefault(key, [0.0, 0.0])
                    acc[0] += bw[g][0]
                    acc[1] += bw[g][1]
                for (numa, idx), (rx, tx) in usage.items():
                    if rx > free[numa][idx][0] or tx > free[numa][idx][1]:
                        ok = False
                        break
                if ok:
                    out.append(tuple(zip(numa_combo, picks)))
        return out

    # ------------------------------------------------------------------
    # stage 3: cross-resource intersection
    # ------------------------------------------------------------------

    @staticmethod
    def prune_pci_nic_combos(
        node: HostNode, nic_combos: List[NicCombo]
    ) -> List[NicCombo]:
        """PCI map mode: keep NIC combos whose PCIe switches hold at least
        as many free GPUs as NICs chosen on them — the kept reference
        quirk (Matcher.py:295-335; see module docstring). Shared with the
        explainer (solver/explain.py) so both report identical verdicts
        by construction."""
        gpu_per_sw = node.free_gpus_per_pciesw()
        nic_sw = node.nic_pciesw_per_numa()
        kept: List[NicCombo] = []
        for combo in nic_combos:
            switch_counts: Dict[int, int] = {}
            for numa, idx in combo:
                sw = nic_sw[numa][idx]
                switch_counts[sw] = switch_counts.get(sw, 0) + 1
            if all(
                gpu_per_sw.get(sw, 0) >= count
                for sw, count in switch_counts.items()
            ):
                kept.append(combo)
        return kept

    def intersect_resources(
        self, nodes: Dict[str, HostNode], filts: FeasibleSets, map_mode: MapMode
    ) -> None:
        """Keep only combinations whose per-group NUMA prefix is feasible for
        all three resource types; PCI mode first prunes NIC combos without
        enough free GPUs on their switches (reference: Matcher.py:283-391).
        Mutates ``filts`` in place.
        """
        if map_mode == MapMode.PCI:
            for name in list(filts.candidates):
                filts.nic[name] = self.prune_pci_nic_combos(
                    nodes[name], filts.nic[name]
                )

        for name in list(filts.candidates):
            gpu_prefixes = set(filts.gpu[name])
            cpu_prefixes = {c[:-1] for c in filts.cpu[name]}
            nic_prefixes = {tuple(numa for numa, _ in c) for c in filts.nic[name]}
            common = gpu_prefixes & cpu_prefixes & nic_prefixes
            if not common:
                filts.candidates.remove(name)
                continue
            filts.gpu[name] = [c for c in filts.gpu[name] if c in common]
            filts.cpu[name] = [c for c in filts.cpu[name] if c[:-1] in common]
            filts.nic[name] = [
                c for c in filts.nic[name]
                if tuple(numa for numa, _ in c) in common
            ]

    # ------------------------------------------------------------------
    # stage 4: node selection + mapping choice
    # ------------------------------------------------------------------

    def select_node(
        self, filts: FeasibleSets, req: PodRequest, nodes: Dict[str, HostNode]
    ) -> Optional[str]:
        """CPU-only pods prefer the first GPU-less node; otherwise the first
        candidate in iteration order (reference: Matcher.py:393-421)."""
        if not filts.candidates:
            return None
        if not req.needs_gpu:
            for name in filts.candidates:
                if nodes[name].total_gpus() == 0:
                    return name
        return filts.candidates[0]

    def choose_mapping(
        self, node: str, numa_nodes: int, filts: FeasibleSets
    ) -> Dict[str, tuple]:
        """Pick the GPU combo maximizing packing skew (max-min of per-NUMA
        group counts), then the first CPU/NIC combos sharing its prefix
        (reference: Matcher.py:423-452). First maximal combo wins."""

        def skew(combo: NumaCombo) -> int:
            counts = [combo.count(n) for n in range(numa_nodes)]
            return max(counts) - min(counts)

        gpu_list = filts.gpu[node]
        best = max(range(len(gpu_list)), key=lambda i: (skew(gpu_list[i]), -i))
        gpu_combo = gpu_list[best]

        cpu_combo = next(c for c in filts.cpu[node] if c[:-1] == gpu_combo)
        nic_combo = next(
            c for c in filts.nic[node]
            if tuple(numa for numa, _ in c) == gpu_combo
        )
        return {"gpu": gpu_combo, "cpu": cpu_combo, "nic": nic_combo}


_default = OracleMatcher()


def find_node(
    nodes: Dict[str, HostNode],
    req: Union[PodRequest, PodTopology],
    *,
    now: Optional[float] = None,
    respect_busy: bool = True,
) -> Optional[MatchResult]:
    """Module-level convenience wrapper over OracleMatcher.find_node."""
    return _default.find_node(nodes, req, now=now, respect_busy=respect_busy)
