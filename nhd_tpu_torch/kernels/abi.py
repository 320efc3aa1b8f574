"""The C interface of each CUDA kernel, written out once.

Every ``extern "C"`` entry point in this directory takes its tensors as
raw pointers (inputs, then outputs), then its int sizes, then the device
index and the stream. The table below holds that order with each
tensor's dtype and its shape as size symbols. The wrappers
(``kernels/__init__.py``) check tensors and allocate outputs from it,
``build.py`` derives the ctypes argument types from it, and a CPU test
holds it against the parameter names of every ``.cu`` entry point, so a
swapped pair of pointers cannot build unnoticed.

Size symbols name the kernel's int sizes; ``CA`` (C*A), ``UK`` (U*K),
``G1`` (G+1) and ``P`` (the solve_planes row count) are derived by the
wrapper. ``T`` is the pod-type axis and ``N`` the node axis.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Arg(NamedTuple):
    name: str              # the .cu parameter name
    dtype: str             # a torch dtype name
    dims: Tuple[str, ...]  # shape as size symbols
    out: bool = False      # written by the kernel


class KernelABI(NamedTuple):
    entry: str               # the extern "C" launcher
    args: Tuple[Arg, ...]    # pointer arguments: inputs, then outputs
    sizes: Tuple[str, ...]   # the int arguments that follow them

    @property
    def inputs(self) -> Tuple[Arg, ...]:
        return tuple(a for a in self.args if not a.out)

    @property
    def outputs(self) -> Tuple[Arg, ...]:
        return tuple(a for a in self.args if a.out)


def _a(name, dtype, dims, out=False):
    return Arg(name, dtype, tuple(dims.split()), out)


ABI: Dict[str, KernelABI] = {
    "nic_node_masks": KernelABI(
        "nhd_nic_node_masks",
        (
            _a("nic_count", "int32", "N U"),
            _a("nic_sw", "int32", "N U K"),
            _a("gpu_free_sw", "int32", "N S"),
            _a("combo", "int32", "C G"),
            _a("pick", "int32", "A G"),
            _a("need_max", "int32", "C A U"),
            _a("valid", "bool", "N CA", out=True),
            _a("pci_ok", "bool", "N CA", out=True),
        ),
        ("N", "U", "K", "S", "G", "C", "A"),
    ),
    "nic_any_first": KernelABI(
        "nhd_nic_any_first",
        (
            _a("free_rx", "float32", "N UK"),
            _a("free_tx", "float32", "N UK"),
            _a("dem_rx", "float32", "T CA UK"),
            _a("dem_tx", "float32", "T CA UK"),
            _a("unchosen", "bool", "CA UK"),
            _a("valid", "bool", "N CA"),
            _a("pci_ok", "bool", "N CA"),
            _a("map_pci", "bool", "T"),
            _a("nic_any", "bool", "T N C", out=True),
            _a("first_a", "int32", "T N C", out=True),
            _a("n_picks", "int32", "T N C", out=True),
        ),
        ("T", "N", "UK", "C", "A"),
    ),
    "solve_planes": KernelABI(
        "nhd_solve_planes",
        (
            _a("numa_nodes", "int8", "N"),
            _a("smt", "bool", "N"),
            _a("active", "bool", "N"),
            _a("maintenance", "bool", "N"),
            _a("busy", "bool", "N"),
            _a("gpuless", "bool", "N"),
            _a("node_gmask", "int64", "N"),
            _a("hp_free", "int32", "N"),
            _a("cpu_free", "int32", "N U"),
            _a("gpu_free", "int32", "N U"),
            _a("node_class", "int32", "N"),
            _a("cpu_dem_smt", "int32", "T G1"),
            _a("cpu_dem_raw", "int32", "T G1"),
            _a("gpu_dem", "int32", "T G"),
            _a("hp", "int32", "T"),
            _a("needs_gpu", "bool", "T"),
            _a("pod_gmask", "int64", "T"),
            _a("class_score", "int32", "T NCLS"),
            _a("combo", "int32", "C G"),
            _a("maxdig", "int32", "C"),
            _a("skew", "int32", "C"),
            _a("nic_any", "bool", "T N C"),
            _a("first_a", "int32", "T N C"),
            _a("n_picks", "int32", "T N C"),
            _a("out", "int32", "P T N", out=True),
        ),
        ("T", "N", "U", "G", "C", "NCLS"),
    ),
}

def shape(arg: Arg, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of *arg* at *sizes*."""
    return tuple(sizes[d] for d in arg.dims)
