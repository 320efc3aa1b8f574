"""Build and load the port's CUDA kernels.

Each ``*.cu`` source in this directory is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ctypes. The wrappers pass raw device pointers (``tensor.data_ptr()``)
and PyTorch's current stream, in the order ``abi.ABI`` gives for each
kernel. No source includes PyTorch's headers, so a
build takes seconds, not the minutes ``torch.utils.cpp_extension.load``
needs for a binding file.

Libraries land in ``nhd_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source rebuilds. The
first kernel call builds every source at once, one ``nvcc`` process per
source, all started together. Nothing here runs at import: this module
is imported on machines without ``nvcc`` (the CPU tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from nhd_tpu_torch.kernels.abi import ABI

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build_all (0.0 when every library was cached)
BUILD_SECONDS: Dict[str, float] = {"total": 0.0}


def nvcc_path() -> str:
    """The CUDA compiler: CUDA_HOME (as PyTorch resolves it), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates: List[Optional[str]] = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def source_path(name: str) -> Path:
    return _DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha1(
        source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, all nvcc
    processes in parallel. Returns {name: compiler log} of what was built
    (ptxas prints registers, shared memory and spills per kernel). Raises
    with the compiler's output when any build fails."""
    todo = [n for n in ABI if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
    BUILD_SECONDS["total"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel *name*, building at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        spec = ABI[name]
        fn = getattr(lib, spec.entry)
        fn.restype = ctypes.c_int
        # tensor pointers, int sizes, then the device index and the stream
        fn.argtypes = (
            [ctypes.c_void_p] * len(spec.args)
            + [ctypes.c_int] * len(spec.sizes)
            + [ctypes.c_int, ctypes.c_void_p]
        )
        err = getattr(lib, spec.entry + "_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
        return lib


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a cudaError code: the launcher's
    own refusal of its sizes (``cudaErrorInvalidValue``) or what
    ``cudaGetLastError`` reported after the launch. ``code`` is the
    cudaError value; the solver guard classifies by it
    (solver/guard.py)."""

    def __init__(self, name: str, code: int, msg: str):
        super().__init__(f"CUDA kernel {name} failed to launch: {msg} ({code})")
        self.kernel = name
        self.code = code


def launch(name: str, *args) -> None:
    """Call kernel *name*'s C entry point; raise KernelLaunchError on a
    launch error (a refused launch never runs, and a later synchronize
    would not say so)."""
    lib = load(name)
    entry = ABI[name].entry
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = getattr(lib, entry + "_error")(rc).decode()
        raise KernelLaunchError(name, rc, msg)
