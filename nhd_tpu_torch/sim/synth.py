"""Synthetic clusters and workload configs.

The reference has no way to exercise the scheduler without a live Viasat
cluster (SURVEY.md §4); this module provides the missing seam: generate
reference-format NFD label dicts (Node.py:327-454) and Triad config text
(TriadCfgParser.py format) deterministically, so every layer — parser, node
mirror, oracle, JAX solver, scheduler, bench — runs hermetically.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from nhd_tpu_torch.core.node import HostNode


@dataclass
class SynthNodeSpec:
    """Knobs for one synthetic node."""

    name: str = "node0"
    sockets: int = 2
    phys_cores: int = 24          # total physical cores across sockets
    smt: bool = True
    reserved_cores: int = 2       # OS cores (not isolated) per node, from core 0
    nics_per_numa: int = 2
    nic_speed_mbps: int = 100000
    gpus_per_numa: int = 2
    gpu_model: str = "V100"
    # PCIe switch of each (numa, slot): by default NIC i and GPU i on a NUMA
    # node share switch  numa*16+i  so PCI mode has pairings to find.
    hugepages_gb: int = 64
    reserved_hugepages_gb: int = 0
    groups: str = "default"
    # hardware-generation class label (policy engine heterogeneity
    # scoring, NHD_NODE_CLASS); "" = let the node derive its class from
    # the GPU inventory
    node_class: str = ""
    data_vlan: int = 100
    gw: str = "10.1.0.1/32"
    sriov_pfs: int = 0            # extra PF NICs that must be excluded
    slow_nics: int = 0            # extra below-threshold NICs (excluded)


def make_node_labels(spec: SynthNodeSpec) -> Dict[str, str]:
    """Reference-format NFD label dict for a synthetic node."""
    labels: Dict[str, str] = {}
    labels["feature.node.kubernetes.io/nfd-extras-cpu.num_cores"] = str(spec.phys_cores)
    labels["feature.node.kubernetes.io/nfd-extras-cpu.numSockets"] = str(spec.sockets)
    if spec.smt:
        labels["feature.node.kubernetes.io/cpu-hardware_multithreading"] = "true"

    # isolcpus: everything except the first `reserved_cores` physical cores
    # (and their siblings): those stay for the OS (Node.py:352-370).
    n_logical = spec.phys_cores * (2 if spec.smt else 1)
    isolated: List[int] = []
    for c in range(n_logical):
        phys = c % spec.phys_cores
        if phys >= spec.reserved_cores:
            isolated.append(c)
    if isolated:
        labels["feature.node.kubernetes.io/nfd-extras-cpu.isolcpus"] = _ranges(isolated)

    nic_i = 0
    for numa in range(spec.sockets):
        for slot in range(spec.nics_per_numa):
            mac = f"0c42a1{nic_i:02x}{numa:02x}{slot:02x}"
            pciesw = numa * 16 + slot
            labels[
                f"feature.node.kubernetes.io/nfd-extras-nic.eth{nic_i}.mlx5"
                f".{mac}.{spec.nic_speed_mbps}Mbs.{numa}.{pciesw:x}.{slot:x}.0"
            ] = "true"
            nic_i += 1
    for s in range(spec.slow_nics):
        labels[
            f"feature.node.kubernetes.io/nfd-extras-nic.slow{s}.intel"
            f".aabbcc0000{s:02x}.1000Mbs.0.0.0.0"
        ] = "true"
    for s in range(spec.sriov_pfs):
        pf = f"pf{s}"
        labels[f"feature.node.kubernetes.io/nfd-extras-sriov.8.{pf}"] = "true"
        labels[
            f"feature.node.kubernetes.io/nfd-extras-nic.{pf}.mlx5"
            f".aabbccdd00{s:02x}.{spec.nic_speed_mbps}Mbs.0.0.0.0"
        ] = "true"

    gpu_i = 0
    for numa in range(spec.sockets):
        for slot in range(spec.gpus_per_numa):
            pciesw = numa * 16 + slot
            labels[
                f"feature.node.kubernetes.io/nfd-extras-gpu.{gpu_i}"
                f".{spec.gpu_model}.{numa}.{pciesw:x}"
            ] = "true"
            gpu_i += 1

    labels["NHD_GROUP"] = spec.groups
    if spec.node_class:
        labels["NHD_NODE_CLASS"] = spec.node_class
    labels["DATA_PLANE_VLAN"] = str(spec.data_vlan)
    labels["DATA_DEFAULT_GW"] = spec.gw
    if spec.reserved_hugepages_gb:
        labels["RES_HUGEPAGES_GB"] = str(spec.reserved_hugepages_gb)
    return labels


def _ranges(sorted_ints: List[int]) -> str:
    """Render a sorted int list as cpuset ranges joined by '_'
    (the reference's multi-range label convention, Node.py:356)."""
    spans: List[str] = []
    start = prev = sorted_ints[0]
    for v in sorted_ints[1:] + [None]:  # type: ignore[list-item]
        if v is not None and v == prev + 1:
            prev = v
            continue
        spans.append(f"{start}-{prev}" if start != prev else f"{start}")
        if v is not None:
            start = prev = v
    return "_".join(spans)


def make_node(spec: SynthNodeSpec, hugepage_free: Optional[int] = None) -> HostNode:
    """Build a ready-to-schedule HostNode from a spec."""
    node = HostNode(spec.name)
    if not node.parse_labels(make_node_labels(spec)):
        raise RuntimeError(f"label parse failed for synthetic node {spec.name}")
    free = spec.hugepages_gb if hugepage_free is None else hugepage_free
    node.set_hugepages(spec.hugepages_gb, free)
    return node


def make_cluster(
    n_nodes: int,
    spec: Optional[SynthNodeSpec] = None,
    *,
    groups: Optional[List[str]] = None,
    gpu_free_fraction: float = 1.0,
    seed: int = 0,
) -> Dict[str, HostNode]:
    """A dict of identical-spec nodes (optionally spread over node groups,
    optionally with some GPUs pre-claimed to create packing pressure)."""
    base = spec or SynthNodeSpec()
    rng = random.Random(seed)
    nodes: Dict[str, HostNode] = {}
    for i in range(n_nodes):
        s = SynthNodeSpec(**{**base.__dict__, "name": f"node{i:05d}"})
        if groups:
            s.groups = groups[i % len(groups)]
        node = make_node(s)
        if gpu_free_fraction < 1.0:
            for gpu in node.gpus:
                if rng.random() > gpu_free_fraction:
                    gpu.used = True
        nodes[node.name] = node
    return nodes


def make_triad_config(
    *,
    n_groups: int = 1,
    nic_pairs_per_group: int = 1,
    rx_gbps: float = 10.0,
    tx_gbps: float = 5.0,
    cpu_workers: int = 2,
    gpus_per_group: int = 0,
    feeders_per_gpu: int = 1,
    helpers_per_group: int = 1,
    ext_cores: int = 1,
    hugepages_gb: int = 4,
    map_type: str = "NUMA",
    proc_smt: bool = True,
    helper_smt: bool = True,
    ext_smt: bool = True,
    gpu_type: str = "ANY",
) -> str:
    """Produce Triad-format config text for a synthetic workload.

    The shape matches what the reference parser consumes
    (TriadCfgParser.py:134-309): one module type ``mods`` with ``n_groups``
    instances, each with helper cores, a data-path group holding NIC core
    pairs + speeds, optional cpu_workers, and a gpu_map.
    """
    mods = []
    for g in range(n_groups):
        helpers = ", ".join(["-1"] * helpers_per_group) if helpers_per_group else ""
        rx_cores = ", ".join(["-1"] * nic_pairs_per_group)
        tx_cores = ", ".join(["-1"] * nic_pairs_per_group)
        rx_speeds = ", ".join([f"{rx_gbps:.1f}"] * nic_pairs_per_group)
        tx_speeds = ", ".join([f"{tx_gbps:.1f}"] * nic_pairs_per_group)
        workers = ", ".join(["-1"] * cpu_workers) if cpu_workers else ""
        gpu_entries = []
        for gi in range(gpus_per_group):
            for _ in range(feeders_per_gpu):
                gpu_entries.append(f"(-1, {gi})")
        gpu_map = ", ".join(gpu_entries)
        mods.append(
            f"""    {{
      module = "inst{g}";
      vlan = 0;
      helpers = [ {helpers} ];
      dp = ( {{
        rx_cores = [ {rx_cores} ];
        rx_speeds = [ {rx_speeds} ];
        tx_cores = [ {tx_cores} ];
        tx_speeds = [ {tx_speeds} ];
        cpu_workers = [ {workers} ];
        gpu_map = ( {gpu_map} );
      }} );
    }}"""
        )
    mods_text = ",\n".join(mods)
    ext = ", ".join(["-1"] * ext_cores)
    # ext_cores entries are config *paths to scalar fields* (the reference
    # int()s each resolved value, TriadCfgParser.py:126).
    ext_paths = ", ".join(f'"CtrlCores[{i}]"' for i in range(ext_cores))
    gpu_type_line = f'gpu_type = "{gpu_type}";' if gpu_type else ""
    return f"""
TopologyCfg : {{
  cpu_arch = "ANY";
  ext_cores = [ {ext_paths} ];
  ext_cores_smt = {str(ext_smt).lower()};
  kni_vlan = "KniVlan";
  map_type = "{map_type}";
  mod_defs = ( {{
    module = "mods";
    helper_cores = [ "helpers" ];
    helper_cores_smt = {str(helper_smt).lower()};
    data_vlan = "vlan";
    dp_group = {{
      name = "dp";
      proc_cores_smt = {str(proc_smt).lower()};
      {gpu_type_line}
    }};
  }} );
}};
mods = (
{mods_text}
);
CtrlCores = [ {ext} ];
KniVlan = 0;
Hugepages_GB = {hugepages_gb};
"""
