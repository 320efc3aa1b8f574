"""The port's hand-written Hopper kernels and their wrappers.

Six CUDA C++ kernels (sources beside this file, built by ``build.py`` at
first use). Three carry the solve:

* ``nic_node_masks`` — pick validity and the PCI-switch check per
  (node, combo·pick) slot (reference: nhd_tpu/solver/kernel.py:136-160);
* ``nic_any_first`` — the NIC feasibility stage, the port of the Pallas
  kernel attic/nic_pallas.py nic_any_first (pl.pallas_call at :89);
* ``solve_planes`` — the rest of the solve, the policy preference and the
  selection value, as [T, N] int32 planes (kernel.py:41-204, :320-338).

Three carry the claims of the speculative megaround between its solves
(reference: nhd_tpu/solver/speculate.py:301-531):

* ``spec_elect`` — each node's type election and copy capacity;
* ``spec_fill`` — each type's balanced fill over its elected nodes;
* ``spec_apply`` — the claim deltas on the resident node state (in
  place) and the packed claim words.

``sweep.py`` makes random inputs at the shapes where the kernels' index
logic can break; chip_smoke.py and the card tests hold the kernels to
their plain versions on them.

Each wrapper takes its plain version (``reference.py``) only for tensors
on the CPU. For CUDA tensors it checks shapes, types and contiguity
against the kernel's interface table (``abi.ABI``), launches the kernel
on PyTorch's current stream, adds one to ``LAUNCHES[name]`` and raises if
the launch failed: there is no fallback.

Threads: the streaming tiler (solver/streaming.py) launches from several
worker threads at once. The counts are kept under a lock, and each
thread also keeps its own (``thread_launches``), so a caller can hold the
total to the sum of what each sub-call launched. A worker thread that
never picked a stream launches on the device's default stream, as every
other thread does, so the launches of different tiles are ordered on the
card; the build is under ``build._LOCK``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.kernels.abi import ABI, shape
from nhd_tpu_torch.kernels.reference import PLAN, PLANES

Tensor = torch.Tensor

KERNELS = tuple(ABI)
#: the kernels of one solve, in launch order
SOLVE_KERNELS = ("nic_node_masks", "nic_any_first", "solve_planes")
#: the megaround's claim kernels, in launch order (after the solves)
CLAIM_KERNELS = ("spec_elect", "spec_fill", "spec_apply")
assert set(KERNELS) == set(SOLVE_KERNELS + CLAIM_KERNELS)

#: launches per kernel since the last reset_launches() — counted where a
#: wrapper launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0


def thread_launches() -> Dict[str, int]:
    """The calling thread's launches per kernel since the thread started
    (never reset): the difference of two readings is what the thread
    launched between them."""
    return dict(getattr(_THREAD, "counts", None) or dict.fromkeys(KERNELS, 0))


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    counts = getattr(_THREAD, "counts", None)
    if counts is None:
        counts = _THREAD.counts = dict.fromkeys(KERNELS, 0)
    counts[name] += 1


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


def _launch(name: str, inputs: Sequence[Tensor], sizes: Dict[str, int],
            outs: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, ...]:
    """Check *inputs* against kernel *name*'s interface, allocate its
    outputs (or check the caller's *outs*), launch it on the current
    stream and count the launch."""
    from nhd_tpu_torch.kernels import build

    spec = ABI[name]
    if len(inputs) != len(spec.inputs):
        raise TypeError(
            f"{name}: {len(inputs)} tensors, expected {len(spec.inputs)}"
        )
    dev = inputs[0].device
    for arg, t in zip(spec.inputs, inputs):
        _check(arg.name, t, getattr(torch, arg.dtype), shape(arg, sizes), dev)
    if outs is None:
        outs = tuple(
            torch.empty(shape(arg, sizes), dtype=getattr(torch, arg.dtype),
                        device=dev)
            for arg in spec.outputs
        )
    else:
        outs = tuple(outs)
        for arg, t in zip(spec.outputs, outs, strict=True):
            _check(arg.name, t, getattr(torch, arg.dtype), shape(arg, sizes), dev)
    build.launch(
        name,
        *(t.data_ptr() for t in (*inputs, *outs)),
        *(sizes[s] for s in spec.sizes),
        dev.index, _stream(dev),
    )
    _count(name)
    return outs


def sizes_for(name: str, args: Sequence[Tensor], **kw) -> Dict[str, int]:
    """Kernel *name*'s size symbols on *args* (its input tensors in
    ``ABI`` order) and the wrapper's keywords *kw*: the wrappers and any
    direct caller of an entry point derive them here alone."""
    t = dict(zip((a.name for a in ABI[name].inputs), args, strict=True))
    if name == "nic_node_masks":
        N, U = t["nic_count"].shape
        C, G = t["combo"].shape
        A = t["pick"].shape[0]
        return dict(N=N, U=U, K=t["nic_sw"].shape[-1],
                    S=t["gpu_free_sw"].shape[-1], G=G, C=C, A=A, CA=C * A)
    if name == "nic_any_first":
        C, A = kw["C"], kw["A"]
        return dict(T=t["dem_rx"].shape[0], N=t["free_rx"].shape[0],
                    UK=kw["U"] * kw["K"], C=C, A=A, CA=C * A)
    if name == "solve_planes":
        T, N, C = t["nic_any"].shape
        G = t["combo"].shape[-1]
        return dict(T=T, N=N, U=t["cpu_free"].shape[-1], G=G, C=C,
                    NCLS=t["class_score"].shape[-1], G1=G + 1, P=len(PLANES))
    if name == "spec_fill":
        TT1 = t["status"].shape[0]
        return dict(TT=TT1 - 1, TT1=TT1, N=t["plan"].shape[1])
    TT = t["trow"].shape[0]
    N, U = t["cpu_free"].shape
    K = t["nic_free"].shape[2]
    sizes = dict(TT=TT, TT1=TT + 1, N=N, U=U, K=K, UK=U * K,
                 CM=t["cpu_g"].shape[2], CAM=t["nic_occ"].shape[1],
                 SHARING=int(bool(kw["sharing"])),
                 BUSY=int(bool(kw["respect_busy"])))
    if name == "spec_elect":
        sizes["PL"] = t["planes"].shape[0]
    else:
        sizes.update(S=t["gpu_free_sw"].shape[1], IT=t["claims"].shape[0],
                     it=int(kw["it"]))
    return sizes


def nic_node_masks(
    nic_count: Tensor, nic_sw: Tensor, gpu_free_sw: Tensor,
    combo: Tensor, pick: Tensor, need_max: Tensor,
) -> Tuple[Tensor, Tensor]:
    """(valid [N, C*A] bool, pci_ok [N, C*A] bool)."""
    args = (nic_count, nic_sw, gpu_free_sw, combo, pick, need_max)
    if _on_cpu(nic_count):
        return reference.nic_node_masks(*args)
    valid, pci_ok = _launch("nic_node_masks", args, sizes_for("nic_node_masks", args))
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
    args = (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci)
    nic_any, first_a, n_picks = _launch(
        "nic_any_first", args, sizes_for("nic_any_first", args, U=U, K=K, C=C, A=A),
    )
    return nic_any, first_a, n_picks


def solve_planes(
    numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
    hp_free, cpu_free, gpu_free, node_class,
    cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
    class_score,
    combo, maxdig, skew,
    nic_any, first_a, n_picks,
    *, out: Optional[Tensor] = None,
) -> Tensor:
    """[8, T, N] int32 planes, rows in ``PLANES`` order; written into
    *out* when given (a contiguous [8, T, N] int32 tensor)."""
    args = (
        numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
        hp_free, cpu_free, gpu_free, node_class,
        cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
        class_score, combo, maxdig, skew, nic_any, first_a, n_picks,
    )
    if _on_cpu(numa_nodes):
        planes = reference.solve_planes(*args)
        return planes if out is None else out.copy_(planes)
    if class_score.shape[-1] < 1:
        raise ValueError("class_score needs at least one class column")
    sizes = sizes_for("solve_planes", args)
    (planes,) = _launch("solve_planes", args, sizes,
                        None if out is None else (out,))
    return planes


def spec_elect(
    planes, plane_off, trow, smt, cpu_free, gpu_free, hp_free, nic_free,
    cpu_g, cpu_m, gpu_g, nic_occ, status, *, sharing: bool, respect_busy: bool,
) -> Tensor:
    """The per-node plan [7, N] int32 (``PLAN`` rows); clears status[0]."""
    args = (planes, plane_off, trow, smt, cpu_free, gpu_free, hp_free,
            nic_free, cpu_g, cpu_m, gpu_g, nic_occ, status)
    if _on_cpu(planes):
        return reference.spec_elect(*args, sharing=sharing,
                                    respect_busy=respect_busy)
    sizes = sizes_for("spec_elect", args, sharing=sharing,
                      respect_busy=respect_busy)
    (plan,) = _launch("spec_elect", args, sizes)
    return plan


def spec_fill(plan: Tensor, status: Tensor) -> None:
    """Fill plan's count row; update the need and progress in *status*."""
    if _on_cpu(plan):
        return reference.spec_fill(plan, status)
    _launch("spec_fill", (plan, status), sizes_for("spec_fill", (plan, status)))
    return None


def spec_apply(
    plan, trow, smt, nic_sw, cpu_g, cpu_m, gpu_g, nic_occ, gpu_uk, nic_rx,
    nic_tx, busy, hp_free, cpu_free, gpu_free, nic_free, gpu_free_sw,
    claims, counts, *, it: int, sharing: bool, respect_busy: bool,
) -> None:
    """Apply the claims of *plan* to the node tensors in place and record
    them in row *it* of claims and counts."""
    args = (plan, trow, smt, nic_sw, cpu_g, cpu_m, gpu_g, nic_occ, gpu_uk,
            nic_rx, nic_tx, busy, hp_free, cpu_free, gpu_free, nic_free,
            gpu_free_sw, claims, counts)
    if _on_cpu(plan):
        return reference.spec_apply(*args, it=it, sharing=sharing,
                                    respect_busy=respect_busy)
    sizes = sizes_for("spec_apply", args, it=it, sharing=sharing,
                      respect_busy=respect_busy)
    _launch("spec_apply", args, sizes)
    return None
