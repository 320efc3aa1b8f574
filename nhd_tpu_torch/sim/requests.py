"""Synthesize PodTopology objects from bare PodRequests.

Benchmarks and batch tests often start from numeric PodRequests; physical
assignment (HostNode.assign_physical_ids) and config write-back need a full
PodTopology object graph. This builds a minimal one whose derived
PodRequest round-trips exactly.
"""

from __future__ import annotations

from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import (
    Core,
    Gpu,
    NicDir,
    NicPair,
    NumaHint,
    PodTopology,
    ProcGroup,
    VlanInfo,
)


def request_to_topology(req: PodRequest) -> PodTopology:
    top = PodTopology(
        misc_cores_smt=req.misc.smt,
        map_mode=req.map_mode,
        hugepages_gb=req.hugepages_gb,
        ctrl_vlan=VlanInfo("KniVlan", 0),
    )
    for i in range(req.misc.count):
        top.misc_cores.append(Core(f"CtrlCores[{i}]"))

    for gi, g in enumerate(req.groups):
        if g.needs_nic and g.proc.count < 2:
            raise ValueError(
                "a group with NIC bandwidth needs >= 2 proc cores (rx+tx pair)"
            )
        pg = ProcGroup(proc_smt=g.proc.smt, helper_smt=g.misc.smt,
                       vlan=VlanInfo(f"mods[{gi}].vlan", 0))
        base = f"mods[{gi}].dp[0]"
        remaining = g.proc.count

        # one rx/tx NIC pair carries the whole group's bandwidth when any
        # bandwidth is requested (two proc cores)
        if g.needs_nic and remaining >= 2:
            rx = Core(f"{base}.rx_cores[0]", g.nic_rx_gbps, NicDir.RX, NumaHint.GROUP)
            tx = Core(f"{base}.tx_cores[0]", g.nic_tx_gbps, NicDir.TX, NumaHint.GROUP)
            pg.proc_cores.extend([rx, tx])
            top.nic_pairs.append(NicPair(rx, tx))
            remaining -= 2

        # GPUs take one feeder core each while cores remain
        feeders_total = min(g.gpus, remaining) if g.gpus else 0
        for j in range(g.gpus):
            cores = []
            if j < feeders_total:
                cores.append(
                    Core(f"{base}.gpu_map[{j}][0]", 0, NicDir.NONE, NumaHint.GROUP)
                )
                remaining -= 1
            pg.gpus.append(Gpu(cores, [f"{base}.gpu_map[{j}][1]"]))

        for j in range(remaining):
            pg.proc_cores.append(
                Core(f"{base}.cpu_workers[{j}]", 0, NicDir.NONE, NumaHint.GROUP)
            )
        for j in range(g.misc.count):
            pg.misc_cores.append(
                Core(f"mods[{gi}].helpers[{j}]", 0, NicDir.NONE, NumaHint.GROUP)
            )
        top.proc_groups.append(pg)
    return top
