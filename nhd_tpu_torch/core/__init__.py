from nhd_tpu_torch.core.topology import (
    Core,
    CpuArch,
    Gpu,
    GpuKind,
    MapMode,
    NicDir,
    NicPair,
    NumaHint,
    PodTopology,
    ProcGroup,
    SmtMode,
    VlanInfo,
)
from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
from nhd_tpu_torch.core.node import HostNode, NodeCpuCore, NodeGpu, NodeMemory, NodeNic

__all__ = [
    "Core",
    "CpuArch",
    "CpuRequest",
    "Gpu",
    "GpuKind",
    "GroupRequest",
    "HostNode",
    "MapMode",
    "NicDir",
    "NicPair",
    "NodeCpuCore",
    "NodeGpu",
    "NodeMemory",
    "NodeNic",
    "NumaHint",
    "PodRequest",
    "PodTopology",
    "ProcGroup",
    "SmtMode",
    "VlanInfo",
]
