"""ctypes loader for the native assignment core (native/nhd_assign.cc).

The port's own loader: it compiles the repository's ``native/nhd_assign.cc``
with ``g++ -O2 -shared -fPIC`` into the port's git-ignored build directory
(``nhd_tpu_torch/_build/``) at first use, and never loads the reference
package's prebuilt library. ``LIB`` resolves lazily (module
``__getattr__``), so importing this module starts no compiler; when no
compiler is available ``LIB`` is None and callers take the pure-numpy
assignment path (same results, slower per pod). ``NHD_TPU_NATIVE=0``
disables it, as in the reference.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parents[2] / "native" / "nhd_assign.cc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SO = _BUILD / "libnhd_assign.so"

_LOCK = threading.Lock()
_STATE: dict = {}


def _build() -> bool:
    """Compile to a temp file and rename into place — atomic for
    concurrent importers (a half-written .so must never be dlopen'd)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("NHD_TPU_NATIVE") == "0":
        return None
    have_src = _SRC.exists()
    stale = (
        have_src
        and _SO.exists()
        and _SO.stat().st_mtime < _SRC.stat().st_mtime
    )
    if not _SO.exists() or stale:
        if not have_src or not _build():
            if not _SO.exists():
                return None
    try:
        # the one caller, _lib, memoizes the handle in _STATE
        lib = ctypes.CDLL(str(_SO))  # nhdlint: ignore[NHD104]
    except OSError:
        return None
    # all pointers as c_void_p: callers pass raw integer addresses
    # (arr.ctypes.data + row offset)
    p = ctypes.c_void_p
    i = ctypes.c_int
    if not hasattr(lib, "nhd_assign_pod") or not hasattr(lib, "nhd_assign_round"):
        return None  # stale/foreign library without our symbols
    lib.nhd_assign_pod.restype = ctypes.c_int
    lib.nhd_assign_pod.argtypes = [
        p, p, i, i,          # core overlay, sockets, P, smt
        p, p, p, i,          # gpu overlay, numa, sw, n_gpus
        i,                   # n_groups
        p, p,                # g_numa, g_nic_sw
        p, p, p, p, p,       # proc, proc_smt, helpers, helper_smt, gpus
        i, i, i, i,          # misc numa/count/smt, pci
        p, p, p,             # out cores/counts/gpus
    ]
    lib.nhd_assign_round.restype = ctypes.c_int
    lib.nhd_assign_round.argtypes = (
        [p, p, p, p, i]          # core_used, socket, phys, smt, L
        + [p, p, p, p, p, i]     # gpu used/numa/sw/sw_dense/n_gpus, GM
        + [p, p, p, p, p, p, i, i]  # nic flat/sw/rx/tx/pods/cap, U, K
        + [p]                    # hp_free (int64)
        + [p, p, p, p, p, p, i, i, i]  # cpu_free, gpu_free, gpu_free_sw,
                                       # nic_free, hp_free32, busy, S,
                                       # set_busy, enable_sharing
        + [i, p, p, p, p, p, p, p, p, p, p, p]  # G + 11 type arrays
        + [i, p, p, p, p]        # W, w_node/type/c/m
        + [p, p, p, p, p, p, i, i]  # out status/cores/counts/nic/gpus/pick,
                                    # MAXC, GMX
    )
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    with _LOCK:
        if "lib" not in _STATE:
            _STATE["lib"] = _load()
        return _STATE["lib"]


def __getattr__(name: str):
    if name == "LIB":
        return _lib()
    raise AttributeError(name)


def available() -> bool:
    return _lib() is not None
