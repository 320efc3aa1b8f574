"""The port's hand-written Hopper kernels and their wrappers.

Three CUDA C++ kernels carry the solve (sources beside this file, built by
``build.py`` at first use):

* ``nic_node_masks`` — pick validity and the PCI-switch check per
  (node, combo·pick) slot (reference: nhd_tpu/solver/kernel.py:136-160);
* ``nic_any_first`` — the NIC feasibility stage, the port of the Pallas
  kernel attic/nic_pallas.py nic_any_first (pl.pallas_call at :89);
* ``solve_planes`` — the rest of the solve, the policy preference and the
  selection value, as [T, N] int32 planes (kernel.py:41-204, :320-338).

Each wrapper takes its plain version (``reference.py``) only for tensors
on the CPU. For CUDA tensors it checks shapes, types and contiguity
against the kernel's interface table (``abi.ABI``), launches the kernel
on PyTorch's current stream, adds one to ``LAUNCHES[name]`` and raises if
the launch failed: there is no fallback.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.kernels.abi import ABI, shape
from nhd_tpu_torch.kernels.reference import PLANES

Tensor = torch.Tensor

KERNELS = tuple(ABI)

#: launches per kernel since the last reset_launches() — counted where a
#: wrapper launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cpu(t: Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} for the solve kernels")
    return False


def _check(name: str, t: Tensor, dtype, shape: Sequence[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, inputs: Sequence[Tensor], sizes: Dict[str, int]
            ) -> Tuple[Tensor, ...]:
    """Check *inputs* against kernel *name*'s interface, allocate its
    outputs, launch it on the current stream and count the launch."""
    from nhd_tpu_torch.kernels import build

    spec = ABI[name]
    if len(inputs) != len(spec.inputs):
        raise TypeError(
            f"{name}: {len(inputs)} tensors, expected {len(spec.inputs)}"
        )
    dev = inputs[0].device
    for arg, t in zip(spec.inputs, inputs):
        _check(arg.name, t, getattr(torch, arg.dtype), shape(arg, sizes), dev)
    outs = tuple(
        torch.empty(shape(arg, sizes), dtype=getattr(torch, arg.dtype), device=dev)
        for arg in spec.outputs
    )
    build.launch(
        name,
        *(t.data_ptr() for t in (*inputs, *outs)),
        *(sizes[s] for s in spec.sizes),
        dev.index, _stream(dev),
    )
    LAUNCHES[name] += 1
    return outs


def nic_node_masks(
    nic_count: Tensor, nic_sw: Tensor, gpu_free_sw: Tensor,
    combo: Tensor, pick: Tensor, need_max: Tensor,
) -> Tuple[Tensor, Tensor]:
    """(valid [N, C*A] bool, pci_ok [N, C*A] bool)."""
    args = (nic_count, nic_sw, gpu_free_sw, combo, pick, need_max)
    if _on_cpu(nic_count):
        return reference.nic_node_masks(*args)
    N, U = nic_count.shape
    C, G = combo.shape
    A = pick.shape[0]
    sizes = dict(N=N, U=U, K=nic_sw.shape[-1], S=gpu_free_sw.shape[-1],
                 G=G, C=C, A=A, CA=C * A)
    valid, pci_ok = _launch("nic_node_masks", args, sizes)
    return valid, pci_ok


def nic_any_first(
    free_rx: Tensor, free_tx: Tensor, dem_rx: Tensor, dem_tx: Tensor,
    unchosen: Tensor, valid: Tensor, pci_ok: Tensor, map_pci: Tensor,
    *, U: int, K: int, C: int, A: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(nic_any [T, N, C] bool, first_a [T, N, C] int32, n_picks [T, N, C]
    int32), the signature of attic/nic_pallas.py nic_any_first."""
    if _on_cpu(free_rx):
        return reference.nic_any_first(
            free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok,
            map_pci, U=U, K=K, C=C, A=A,
        )
    map_pci = (map_pci if map_pci.dtype == torch.bool else map_pci != 0).contiguous()
    sizes = dict(T=dem_rx.shape[0], N=free_rx.shape[0], UK=U * K, C=C, A=A,
                 CA=C * A)
    nic_any, first_a, n_picks = _launch(
        "nic_any_first",
        (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci),
        sizes,
    )
    return nic_any, first_a, n_picks


def solve_planes(
    numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
    hp_free, cpu_free, gpu_free, node_class,
    cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
    class_score,
    combo, maxdig, skew,
    nic_any, first_a, n_picks,
) -> Tensor:
    """[8, T, N] int32 planes, rows in ``PLANES`` order."""
    args = (
        numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
        hp_free, cpu_free, gpu_free, node_class,
        cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
        class_score, combo, maxdig, skew, nic_any, first_a, n_picks,
    )
    if _on_cpu(numa_nodes):
        return reference.solve_planes(*args)
    T, N, C = nic_any.shape
    G = combo.shape[-1]
    NCLS = class_score.shape[-1]
    if NCLS < 1:
        raise ValueError("class_score needs at least one class column")
    sizes = dict(T=T, N=N, U=cpu_free.shape[-1], G=G, C=C, NCLS=NCLS,
                 G1=G + 1, P=len(PLANES))
    (out,) = _launch("solve_planes", args, sizes)
    return out
