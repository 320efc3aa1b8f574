"""Workload topology IR: the config-format-agnostic pod requirement model.

Plays the role of the reference's nhd/CfgTopology.py (CfgTopology.py:126-242):
a parser-independent description of what a pod needs — processing groups of
CPU cores, GPUs, and NIC rx/tx cores with bandwidth, plus top-level
miscellaneous cores and hugepages — which the matcher consumes and the
scheduler fills back in with concrete physical IDs.

Differences from the reference are deliberate and TPU-motivated:

* Everything needed by the matcher is derivable as a fixed-shape numeric
  "request vector" (see nhd_tpu/core/request.py) so a batch of pods can be
  packed into dense device arrays without touching this object graph.
* Enums are IntEnums so they can be embedded in arrays directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional


class GpuKind(IntEnum):
    """GPU model classes (reference: CfgTopology.py:8-16)."""

    ANY = 0
    V100 = 1
    GTX_1080 = 2
    GTX_1080TI = 3
    GTX_2080 = 4
    GTX_2080TI = 5
    A100 = 6
    UNSUPPORTED = 7

    @staticmethod
    def from_config_name(name: str) -> Optional["GpuKind"]:
        """Config-file spelling → kind (reference: CfgTopology.py:112-123)."""
        return _GPU_CONFIG_NAMES.get(name)

    @staticmethod
    def from_model_string(model: str) -> "GpuKind":
        """NFD label model substring → kind (reference: Node.py:85-97).

        Order matters: '1080Ti' must be probed before '1080'.
        """
        for probe, kind in _GPU_MODEL_PROBES:
            if probe in model:
                return kind
        return GpuKind.UNSUPPORTED


_GPU_CONFIG_NAMES = {
    "ANY": GpuKind.ANY,
    "V100": GpuKind.V100,
    "1080": GpuKind.GTX_1080,
    "1080Ti": GpuKind.GTX_1080TI,
    "2080": GpuKind.GTX_2080,
    "2080Ti": GpuKind.GTX_2080TI,
}

_GPU_MODEL_PROBES = [
    ("1080Ti", GpuKind.GTX_1080TI),
    ("1080", GpuKind.GTX_1080),
    ("2080Ti", GpuKind.GTX_2080TI),
    ("2080", GpuKind.GTX_2080),
    ("V100", GpuKind.V100),
]


class CpuArch(IntEnum):
    """CPU architecture families (reference: CfgTopology.py:18-24)."""

    ANY = 0
    HASWELL = 1
    BROADWELL = 2
    SKYLAKE = 3
    COOPER_LAKE = 4
    ICE_LAKE = 5

    @staticmethod
    def from_config_name(name: str) -> Optional["CpuArch"]:
        """Config spelling → arch (reference: CfgTopology.py:176-187)."""
        return _CPU_CONFIG_NAMES.get(name)


_CPU_CONFIG_NAMES = {
    "ANY": CpuArch.ANY,
    "HASWELL": CpuArch.HASWELL,
    "BROADWELL": CpuArch.BROADWELL,
    "SKYLAKE": CpuArch.SKYLAKE,
    "COOPER_LAKE": CpuArch.COOPER_LAKE,
    "ICE_LAKE": CpuArch.ICE_LAKE,
}


class NicDir(IntEnum):
    """Direction a NIC-attached core serves (reference: CfgTopology.py:26-29)."""

    NONE = 0
    RX = 1
    TX = 2


class SmtMode(IntEnum):
    """Whether a core set may be packed onto SMT siblings
    (reference: CfgTopology.py:31-33)."""

    OFF = 0
    ON = 1


class NumaHint(IntEnum):
    """Logical NUMA placement hint for a core (reference: CfgTopology.py:35-39)."""

    DONT_CARE = -1
    NUMA_0 = 0
    NUMA_1 = 1
    GROUP = 2


class MapMode(IntEnum):
    """Topology mapping strictness (reference: CfgTopology.py:41-45).

    NUMA: all resources of a processing group co-located on one NUMA node.
    PCI:  NUMA plus GPU↔NIC pairing on the same PCIe switch (GPUDirect).
    """

    INVALID = 0
    NUMA = 1
    PCI = 2
    NONE = 3

    @staticmethod
    def from_config_name(name: str) -> "MapMode":
        """Reference: CfgTopology.py:234-242 (invalid names → INVALID)."""
        return {"NUMA": MapMode.NUMA, "PCI": MapMode.PCI}.get(name, MapMode.INVALID)


@dataclass
class Core:
    """One requested CPU core (reference: CfgTopology.py:48-55).

    ``name`` is the config path of the field holding this core's number so the
    solved physical ID can be written back into the pod's own config text.
    ``nic_speed`` is in Gbps. ``core`` is filled in by the scheduler.
    """

    name: str
    nic_speed: float = 0.0
    nic_dir: NicDir = NicDir.NONE
    numa: NumaHint = NumaHint.DONT_CARE
    core: int = -1


@dataclass
class NicPair:
    """An rx/tx core pair sharing one physical NIC
    (reference: CfgTopology.py:57-68). ``mac`` is assigned at schedule time;
    when re-parsing a deployed config it is reloaded from Network_Config."""

    rx_core: Core
    tx_core: Core
    mac: str = ""
    rx_ring_size: int = 4096


@dataclass
class Gpu:
    """A requested GPU with its feeder CPU cores (reference: CfgTopology.py:70-75).

    ``dev_id_names`` are config paths of the device-id fields; ``device_id``
    is the physical GPU chosen by the scheduler.
    """

    cpu_cores: List[Core]
    dev_id_names: List[str]
    kind: GpuKind = GpuKind.ANY
    device_id: int = -1


@dataclass
class VlanInfo:
    """A VLAN-holding config field (reference: CfgTopology.py:77-80)."""

    name: str
    vlan: int = 0


@dataclass
class ProcGroup:
    """A processing group: cores+GPUs+NICs that must share a NUMA node
    (reference: CfgTopology.py:82-110)."""

    proc_cores: List[Core] = field(default_factory=list)
    misc_cores: List[Core] = field(default_factory=list)
    gpus: List[Gpu] = field(default_factory=list)
    proc_smt: SmtMode = SmtMode.OFF
    helper_smt: SmtMode = SmtMode.OFF
    vlan: Optional[VlanInfo] = None

    def cpu_proc_request(self) -> int:
        """Cores needed by the group's processing side: its own proc cores
        plus every GPU's feeder cores (reference: CfgTopology.py:210)."""
        return len(self.proc_cores) + sum(len(g.cpu_cores) for g in self.gpus)

    def nic_bw_request(self) -> tuple:
        """(rx, tx) Gbps summed over NIC-serving proc cores
        (reference: CfgTopology.py:219-232)."""
        rx = sum(c.nic_speed for c in self.proc_cores if c.nic_dir == NicDir.RX)
        tx = sum(c.nic_speed for c in self.proc_cores if c.nic_dir == NicDir.TX)
        return (rx, tx)


@dataclass
class PodTopology:
    """Full pod requirement description (reference: CfgTopology.py:126-242)."""

    arch: CpuArch = CpuArch.ANY
    misc_cores: List[Core] = field(default_factory=list)
    misc_cores_smt: SmtMode = SmtMode.OFF
    proc_groups: List[ProcGroup] = field(default_factory=list)
    nic_pairs: List[NicPair] = field(default_factory=list)
    map_mode: MapMode = MapMode.INVALID
    ctrl_vlan: Optional[VlanInfo] = None
    data_default_gw: str = ""
    hugepages_gb: int = 0

    # ---- request summaries consumed by the matcher ----

    def gpus_requested(self) -> List[int]:
        """Per-group GPU counts (reference: CfgTopology.py:199-200)."""
        return [len(g.gpus) for g in self.proc_groups]

    def needs_gpu(self) -> bool:
        return any(self.gpus_requested())

    def add_pod_reservations(self, resources: Dict[str, int]) -> None:
        """Fold in pod-spec-native resources (reference: CfgTopology.py:146-149)."""
        if "hugepages-1Gi" in resources:
            self.hugepages_gb = int(resources["hugepages-1Gi"])

    # ---- NIC pair lookups used during physical assignment ----

    def nic_pair_for_core(self, core: Core) -> Optional[NicPair]:
        """Find the rx/tx pair a NIC-serving core belongs to
        (reference: CfgTopology.py:160-166; identity comparison intended)."""
        for pair in self.nic_pairs:
            if (core.nic_dir == NicDir.RX and pair.rx_core is core) or (
                core.nic_dir == NicDir.TX and pair.tx_core is core
            ):
                return pair
        return None

    def nic_pair_for_core_numbers(self, rx: int, tx: int) -> Optional[NicPair]:
        """Find the pair by already-assigned physical core numbers
        (reference: CfgTopology.py:168-173)."""
        for pair in self.nic_pairs:
            if pair.rx_core.core == rx and pair.tx_core.core == tx:
                return pair
        return None

    def set_data_default_gw(self, gw: str) -> None:
        self.data_default_gw = gw
