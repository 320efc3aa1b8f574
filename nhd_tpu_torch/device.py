"""Device resolution for the port's entry points.

Every entry point (``BatchScheduler``, ``find_nodes``, the solve
functions) takes an explicit ``device`` and resolves it here. CUDA is
the default; a CUDA request on a machine without a usable GPU raises
instead of quietly continuing on the CPU. The CPU device is for the
tests and for parity runs, where every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``, validated: only ``cpu`` and
    ``cuda`` are accepted, and ``cuda`` needs a visible GPU. On CUDA,
    TF32 is switched off for matmuls and cuDNN (no solve step uses
    either, but the NIC demand sums must stay full float32 if one ever
    does)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev



def resolve_for_tool(device: DeviceLike, prog: str):
    """``resolve_device`` for a command-line gate: the device, or None
    with the refusal printed to stderr under *prog*'s name, so the gate
    exits non-zero before any work (a CUDA request without a GPU names
    cuda and never continues on the CPU)."""
    import sys

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as exc:
        print(f"{prog}: {exc}", file=sys.stderr)
        return None
