"""nhd_tpu_torch: the NHD batch scheduler on PyTorch and CUDA (Hopper).

The counterpart of ``nhd_tpu`` (the JAX reference) for an NVIDIA H100.
Host-side modules (node model, encode, oracle, native assignment core)
are copies of the reference's with only their import paths changed; the
solver's device programs are hand-written CUDA kernels
(``nhd_tpu_torch/kernels``) with plain PyTorch versions beside them.

This package imports ``torch`` and ``numpy`` and never ``jax`` or
``nhd_tpu``. Entry points take an explicit ``device`` (default
``"cuda"``); asking for CUDA on a machine without it raises.
"""

from nhd_tpu_torch.device import resolve_device

__version__ = "0.1.0"

NHD_SCHED_NAME = "nhd-scheduler"

__all__ = ["NHD_SCHED_NAME", "__version__", "resolve_device"]
