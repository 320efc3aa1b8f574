"""The fleet a configuration states, as the program and the reference
each receive it.

The program gets NFD node labels, which the daemon parses into its node
mirror (``HostNode.parse_labels``, then ``set_hugepages``). The label
format follows ``nhd_tpu_torch/sim/synth.py`` ``make_node_labels``,
copied here so that the benchmark owns its inputs. The reference gets
the same hardware as plain numbers (``Hardware``), worked out from the
same specification. Nothing here imports the program.

The PCIe switch layout is stated by two optional keys of the fleet,
``gpus_per_switch`` and ``nics_per_switch`` (both 1 where absent): GPU
``j`` of NUMA node ``u`` sits on switch ``u * SW_STRIDE + j //
gpus_per_switch``, NIC ``k`` of NUMA node ``u`` on switch ``u *
SW_STRIDE + k // nics_per_switch``. With both at 1, GPU ``j`` and NIC
``j`` of a NUMA node share a switch and each switch holds one of each;
a GPUDirect server with two GPUs and two NICs behind each switch states
both as 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

#: the PCIe switch ids of NUMA node *u* start at ``u * SW_STRIDE``
SW_STRIDE = 16


def switch_id(numa: int, slot: int, per_switch: int) -> int:
    """The PCIe switch of a NUMA node's GPU or NIC *slot*, *per_switch*
    of them to a switch."""
    return numa * SW_STRIDE + slot // per_switch


def node_name(fleet: dict, i: int) -> str:
    return f"{fleet['name_prefix']}{i:05d}"


def node_group(fleet: dict, i: int) -> str:
    """Node *i*'s node group: the configuration's groups in turn."""
    groups = fleet["groups"]
    return groups[i % len(groups)]


def node_class(fleet: dict, i: int) -> str:
    """Node *i*'s hardware-generation class: ``classes`` lists runs of
    ``[class, count]`` in node order; none gives no class label."""
    at = 0
    for cls, count in fleet.get("classes", []):
        at += count
        if i < at:
            return cls
    return ""


def raw_mac(k: int, numa: int, slot: int) -> str:
    return f"0c42a1{k:02x}{numa:02x}{slot:02x}"


def mac(k: int, numa: int, slot: int) -> str:
    """NIC *k*'s MAC as the node mirror reports it (colon form, upper)."""
    raw = raw_mac(k, numa, slot)
    return ":".join(raw[j:j + 2] for j in range(0, 12, 2)).upper()


def _ranges(ints: List[int]) -> str:
    spans: List[str] = []
    start = prev = ints[0]
    for v in ints[1:] + [None]:
        if v is not None and v == prev + 1:
            prev = v
            continue
        spans.append(f"{start}-{prev}" if start != prev else f"{start}")
        if v is not None:
            start = prev = v
    return "_".join(spans)


def node_labels(fleet: dict, i: int) -> Dict[str, str]:
    """Node *i*'s NFD label dict."""
    pfx = "feature.node.kubernetes.io/nfd-extras-"
    phys = fleet["phys_cores"]
    labels = {
        f"{pfx}cpu.num_cores": str(phys),
        f"{pfx}cpu.numSockets": str(fleet["sockets"]),
    }
    if fleet["smt"]:
        labels["feature.node.kubernetes.io/cpu-hardware_multithreading"] = "true"
    n_logical = phys * (2 if fleet["smt"] else 1)
    isolated = [c for c in range(n_logical)
                if c % phys >= fleet["reserved_cores"]]
    if isolated:
        labels[f"{pfx}cpu.isolcpus"] = _ranges(isolated)
    k = 0
    for numa in range(fleet["sockets"]):
        for slot in range(fleet["nics_per_numa"]):
            sw = switch_id(numa, slot, fleet.get("nics_per_switch", 1))
            labels[
                f"{pfx}nic.eth{k}.mlx5.{raw_mac(k, numa, slot)}"
                f".{fleet['nic_speed_mbps']}Mbs.{numa}.{sw:x}.{slot:x}.0"
            ] = "true"
            k += 1
    g = 0
    for numa in range(fleet["sockets"]):
        for slot in range(fleet["gpus_per_numa"]):
            sw = switch_id(numa, slot, fleet.get("gpus_per_switch", 1))
            labels[f"{pfx}gpu.{g}.{fleet['gpu_model']}.{numa}.{sw:x}"] = "true"
            g += 1
    labels["NHD_GROUP"] = node_group(fleet, i)
    cls = node_class(fleet, i)
    if cls:
        labels["NHD_NODE_CLASS"] = cls
    labels["DATA_PLANE_VLAN"] = str(fleet["data_vlan"])
    labels["DATA_DEFAULT_GW"] = fleet["gw"]
    return labels


@dataclass
class Hardware:
    """The fleet's hardware as plain arrays, the reference's node model.

    Logical core ``c`` sits on physical core ``c % P``; physical cores
    ``[u * P/U, (u+1) * P/U)`` are NUMA node ``u``'s. GPU ``j`` and NIC
    ``k`` are numbered NUMA node by NUMA node, as the labels list them;
    ``gps`` GPUs and ``nps`` NICs share a PCIe switch (the fleet's
    ``gpus_per_switch`` and ``nics_per_switch``)."""

    N: int
    U: int
    P: int
    smt: bool
    reserved: int
    gpn: int
    npn: int
    nic_cap: float
    hugepages: int
    node_groups: List[str]
    group_names: List[str]
    gps: int = 1
    nps: int = 1

    @classmethod
    def of(cls, fleet: dict, nic_bw_avail: float) -> "Hardware":
        N = fleet["nodes"]
        return cls(
            N=N, U=fleet["sockets"], P=fleet["phys_cores"], smt=fleet["smt"],
            reserved=fleet["reserved_cores"], gpn=fleet["gpus_per_numa"],
            npn=fleet["nics_per_numa"],
            nic_cap=fleet["nic_speed_mbps"] / 1e3 * nic_bw_avail,
            hugepages=fleet["hugepages_gb"],
            node_groups=[node_group(fleet, i) for i in range(N)],
            group_names=list(fleet["groups"]),
            gps=fleet.get("gpus_per_switch", 1),
            nps=fleet.get("nics_per_switch", 1),
        )

    @property
    def L(self) -> int:
        """Logical cores a node."""
        return self.P * (2 if self.smt else 1)

    @property
    def phys_numa(self) -> np.ndarray:
        return np.arange(self.P) // (self.P // self.U)

    @property
    def gpu_numa(self) -> np.ndarray:
        return np.arange(self.U * self.gpn) // self.gpn

    @property
    def nic_numa(self) -> np.ndarray:
        return np.arange(self.U * self.npn) // self.npn

    def _raw_gpu_switch(self) -> List[int]:
        return [switch_id(u, s, self.gps) for u in range(self.U) for s in range(self.gpn)]

    def _raw_nic_switch(self) -> List[int]:
        return [switch_id(u, s, self.nps) for u in range(self.U) for s in range(self.npn)]

    def switches(self) -> List[int]:
        """The node's PCIe switch ids, sorted (dense id = position)."""
        return sorted(set(self._raw_gpu_switch()) | set(self._raw_nic_switch()))

    def gpu_switch(self) -> np.ndarray:
        """Dense switch id of each GPU."""
        dense = {s: j for j, s in enumerate(self.switches())}
        return np.array([dense[s] for s in self._raw_gpu_switch()], np.int64)

    def nic_switch(self) -> np.ndarray:
        """Dense switch id of each NIC."""
        dense = {s: j for j, s in enumerate(self.switches())}
        return np.array([dense[s] for s in self._raw_nic_switch()], np.int64)

    def mac_index(self) -> Dict[str, int]:
        """MAC → NIC number, the same on every node of the fleet."""
        return {mac(u * self.npn + s, u, s): u * self.npn + s
                for u in range(self.U) for s in range(self.npn)}
