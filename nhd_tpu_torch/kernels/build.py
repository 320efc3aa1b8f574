"""Build and load the port's CUDA kernels.

Each ``*.cu`` source in this directory is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ctypes. The wrappers pass raw device pointers (``tensor.data_ptr()``)
and PyTorch's current stream, in the order ``abi.ABI`` gives for each
kernel. ``graph_while.cu`` holds no kernel: its entry points
(``abi.HELPERS``) are the CUDA runtime calls that capture the
megaround's WHILE node, called through ``call_helper``. No source includes PyTorch's headers, so a
build takes seconds, not the minutes ``torch.utils.cpp_extension.load``
needs for a binding file.

Libraries land in the kernel cache's directory (``NHDC_AOT_DIR``,
default ``nhd_tpu_torch/_build/``, git-ignored), named by a fingerprint
of the source, ``abi.py`` and the flags, so an edited source rebuilds.
Each library carries a sidecar meta (solver/aot.py) that names the
toolchain and the card it was built for; ``load`` validates it, and a
library that fails validation, ``dlopen`` or its entry symbols is
quarantined and rebuilt from source, or the load raises. The first
kernel call builds every missing source at once, one ``nvcc`` process
per source, all started together. Nothing here runs at import: this
module is imported on machines without ``nvcc`` (the CPU tests).
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

from nhd_tpu_torch.kernels.abi import ABI, HELPERS, SOURCES, WIDE

_DIR = Path(__file__).resolve().parent
#: the default build directory (the kernel cache's, solver/aot.py)
BUILD_DIR = _DIR.parent / "_build"
#: the architecture every library is built for
TARGET = "sm_90a"

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

#: seconds one nvcc process may take before it is killed and the build
#: fails: a compiler that hangs must not hold ``_LOCK`` (every thread's
#: first launch waits on it) forever
NVCC_TIMEOUT_S = 300.0

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build_all (0.0 when every library was cached)
BUILD_SECONDS: Dict[str, float] = {"total": 0.0}
#: libraries compiled, opened and quarantined by this process
COUNTS: Dict[str, int] = {"builds": 0, "loads": 0, "quarantined": 0}


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


def build_dir() -> Path:
    from nhd_tpu_torch.solver.aot import AOT

    return Path(AOT.directory())


def fingerprint(name: str) -> str:
    """Hash over kernel *name*'s source, the interface table and the
    compiler flags: what the library's code depends on in this tree."""
    h = hashlib.sha1(source_path(name).read_bytes())
    h.update((_DIR / "abi.py").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{fingerprint(name)}.so"


def meta_path(name: str) -> Path:
    return library_path(name).with_suffix(".json")


_TOOLCHAIN: Dict[str, str] = {}


def toolchain() -> Dict[str, str]:
    """What a library's machine code depends on outside the tree: the
    nvcc release, the target, torch and its CUDA, and the card."""
    if not _TOOLCHAIN:
        import torch

        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, check=True).stdout
        _TOOLCHAIN.update(
            nvcc_version=out.strip().splitlines()[-1],
            target=TARGET,
            torch_version=torch.__version__,
            cuda_version=str(torch.version.cuda),
            device_name=torch.cuda.get_device_name(torch.cuda.current_device()),
        )
    return dict(_TOOLCHAIN)


def library_meta(name: str) -> Dict[str, object]:
    """The sidecar meta a valid library of kernel *name* carries."""
    from nhd_tpu_torch.solver.aot import AOT_SCHEMA_VERSION

    return {"aot_schema": AOT_SCHEMA_VERSION, "kind": "library",
            "kernel": name, "fingerprint": fingerprint(name), **toolchain()}


def stale_reason(name: str) -> Optional[str]:
    """Why kernel *name*'s library cannot be used as it is on disk, or
    None when its file and meta are there and the meta matches."""
    import json

    so, meta = library_path(name), meta_path(name)
    if not so.exists():
        return "missing library"
    try:
        got = json.loads(meta.read_text())
    except (OSError, ValueError) as exc:
        return f"unreadable meta: {exc}"
    want = library_meta(name)
    for field, value in want.items():
        if got.get(field) != value:
            return f"{field} {got.get(field)!r} != {value!r}"
    return None


def _quarantine(name: str, why: str) -> None:
    from nhd_tpu_torch.solver.aot import AOT

    if AOT.quarantine([library_path(name), meta_path(name)], why):
        COUNTS["quarantined"] += 1


def build_all() -> Dict[str, str]:
    """Compile every kernel source whose library is missing or stale
    (a stale one is quarantined first), all nvcc processes in parallel,
    and write each new library's meta. Returns {name: compiler log} of
    what was built (ptxas prints registers, shared memory and spills
    per kernel). Raises with the compiler's output when any build
    fails."""
    import json

    todo = []
    for name in SOURCES:
        why = stale_reason(name)
        if why is None:
            continue
        if why != "missing library":
            _quarantine(name, why)
        todo.append(name)
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
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
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            log = f"killed after {NVCC_TIMEOUT_S:g} s\n{log}"
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
            meta = meta_path(name)
            tmp_meta = meta.with_suffix(f".tmp{os.getpid()}")
            tmp_meta.write_text(json.dumps(library_meta(name), indent=1,
                                           sort_keys=True))
            os.replace(tmp_meta, meta)
            COUNTS["builds"] += 1
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
    BUILD_SECONDS["total"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _open(name: str) -> ctypes.CDLL:
    """dlopen kernel *name*'s library and bind its entry points; raises
    OSError or AttributeError for a library that is not what it says."""
    # the one caller, load, memoizes the handle in _LIBS
    lib = ctypes.CDLL(str(library_path(name)))  # nhdlint: ignore[NHD104]
    if name in HELPERS:
        entries = {e.entry: [_KIND[k] for _, k in e.params] for e in HELPERS[name]}
        errors = dict.fromkeys(entries, helper_error(name))
    else:
        spec = ABI[name]
        # tensor pointers, int sizes, then the device index and the stream
        entries = {spec.entry: (
            [ctypes.c_void_p] * len(spec.args)
            + [ctypes.c_uint64 if s in WIDE else ctypes.c_int for s in spec.sizes]
            + [ctypes.c_int, ctypes.c_void_p]
        )}
        errors = {spec.entry: spec.entry + "_error"}
    try:
        bound = [(getattr(lib, entry), getattr(lib, errors[entry]), argtypes)
                 for entry, argtypes in entries.items()]
    except AttributeError:
        # unmap it: a rebuild lands at the same path, and while this
        # handle stays open dlopen would hand it back
        import _ctypes

        _ctypes.dlclose(lib._handle)
        raise
    for fn, err, argtypes in bound:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return lib


#: the ctypes type of each C kind in ``abi.HELPERS``
_KIND = {"ptr": ctypes.c_void_p, "u64": ctypes.c_uint64,
         "u64ptr": ctypes.POINTER(ctypes.c_uint64), "int": ctypes.c_int}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel *name*, built (or rebuilt) at first
    use. A library that will not open or lacks its entry symbols is
    quarantined and rebuilt once; if the rebuild fails too, this
    raises: there is no fallback."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build_all()
        try:
            lib = _open(name)
        except (OSError, AttributeError) as exc:
            _quarantine(name, f"dlopen/symbols: {exc}")
            build_all()
            try:
                lib = _open(name)
            except (OSError, AttributeError) as again:
                raise RuntimeError(
                    f"kernel library {name} rebuilt from source and still "
                    f"failed to load: {again}"
                ) from again
        COUNTS["loads"] += 1
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
    _call(name, ABI[name].entry, ABI[name].entry + "_error", args)


def helper_error(source: str) -> str:
    """The error-string function of helper *source*: one per source."""
    return f"nhd_{source}_error"


def call_helper(source: str, entry: str, *args) -> None:
    """Call helper *source*'s C entry point *entry* (``abi.HELPERS``);
    raise KernelLaunchError, named *source*, on the cudaError it returns."""
    _call(source, entry, helper_error(source), args)


def _call(name: str, entry: str, error: str, args) -> None:
    lib = load(name)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = getattr(lib, error)(rc).decode()
        raise KernelLaunchError(name, rc, msg)
