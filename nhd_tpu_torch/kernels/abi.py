"""The C interface of each CUDA kernel, written out once.

Every ``extern "C"`` entry point in this directory takes its tensors as
raw pointers (inputs, then outputs), then its int sizes, then the device
index and the stream. An input marked ``inplace`` is a tensor the caller
owns that the kernel also writes (the megaround's resident node state,
its claim planes and its need vector); it is passed as a non-const
pointer, and the wrapper allocates nothing for it. The table below holds that order with each
tensor's dtype and its shape as size symbols. The wrappers
(``kernels/__init__.py``) check tensors and allocate outputs from it,
``build.py`` derives the ctypes argument types from it, and a CPU test
holds it against the parameter names of every ``.cu`` entry point, so a
swapped pair of pointers cannot build unnoticed.

Size symbols name the kernel's int sizes; ``CA`` (C*A), ``UK`` (U*K),
``G1`` (G+1) and ``P`` (the solve_planes row count) are derived by the
wrapper; solve_planes' ``node_base`` and ``n_global`` place its N nodes
on the global node axis of a mesh (0 and N on one device). ``T`` is the pod-type axis and ``N`` the node axis. The claim
kernels run over the megaround's global type axis ``TT`` (every bucket's
padded rows, bucket after bucket; ``TT1`` = TT + 1 for the status
vector), with ``CM`` and ``CAM`` the largest C and C*A of its buckets,
``PL`` the length of the flat solve-plane buffer and ``IT`` the
iteration depth; ``it``, ``SHARING`` and ``BUSY`` are plain ints.

The rank kernels take the solve's planes (``P`` = 8 rows) and write the
packed rank tensor, ``RANK`` = 9 rows of ``R`` slots a type row:
``rank_top`` from one solve's [P, T, N] planes and node free tensors,
its index row placed on the global node axis by ``node_base``;
``rank_merge`` from the [RANK, T, M] candidates of a mesh's shards.

Every kernel but ``spec_gate`` takes a ``gate`` (its last input): one
int32 word, and where it is 0 the kernel returns at once. In the
megaround it is a word of the control tensor ``ctl`` [B + 2] (``B``
buckets; ``B1`` = B + 1 bucket offsets, ``B2`` = B + 2) that
``spec_gate`` writes at the start of each iteration: ``ctl[0]`` the
loop's alive flag (the claim kernels' gate), ``ctl[1]`` the iterations
used, ``ctl[2 + b]`` bucket b's live flag (its solve kernels' gate).
Elsewhere it is a word that is always 1 (``kernels.live_gate``); the
rank kernels run only there.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Arg(NamedTuple):
    name: str              # the .cu parameter name
    dtype: str             # a torch dtype name
    dims: Tuple[str, ...]  # shape as size symbols
    out: bool = False      # allocated by the wrapper, written by the kernel
    inplace: bool = False  # the caller's tensor, read and written


class KernelABI(NamedTuple):
    entry: str               # the extern "C" launcher
    args: Tuple[Arg, ...]    # pointer arguments: inputs, then outputs
    sizes: Tuple[str, ...]   # the int arguments that follow them

    @property
    def inputs(self) -> Tuple[Arg, ...]:
        """The tensors the caller passes (``inplace`` ones included)."""
        return tuple(a for a in self.args if not a.out)

    @property
    def outputs(self) -> Tuple[Arg, ...]:
        return tuple(a for a in self.args if a.out)


def _a(name, dtype, dims, out=False, inplace=False):
    return Arg(name, dtype, tuple(dims.split()), out, inplace)


def _io(name, dtype, dims):
    return _a(name, dtype, dims, inplace=True)


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
            _a("gate", "int32", "ONE"),
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
            _a("gate", "int32", "ONE"),
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
            _a("gate", "int32", "ONE"),
            _a("out", "int32", "P T N", out=True),
        ),
        ("T", "N", "U", "G", "C", "NCLS", "node_base", "n_global"),
    ),
    "spec_elect": KernelABI(
        "nhd_spec_elect",
        (
            _a("planes", "int32", "PL"),
            _a("plane_off", "int64", "TT TWO"),
            _a("trow", "int32", "TT FOUR"),
            _a("smt", "bool", "N"),
            _a("cpu_free", "int32", "N U"),
            _a("gpu_free", "int32", "N U"),
            _a("hp_free", "int32", "N"),
            _a("nic_free", "float32", "N U K TWO"),
            _a("cpu_g", "float32", "TWO TT CM U"),
            _a("cpu_m", "float32", "TWO TT U U"),
            _a("gpu_g", "float32", "TT CM U"),
            _a("nic_occ", "float32", "TT CAM U"),
            _io("status", "int32", "TT1"),
            _a("gate", "int32", "ONE"),
            _a("plan", "int32", "PLAN N", out=True),
        ),
        ("TT", "N", "U", "K", "CM", "CAM", "SHARING", "BUSY"),
    ),
    "spec_fill": KernelABI(
        "nhd_spec_fill",
        (
            _io("plan", "int32", "PLAN N"),
            _io("status", "int32", "TT1"),
            _a("gate", "int32", "ONE"),
        ),
        ("TT", "N"),
    ),
    "spec_apply": KernelABI(
        "nhd_spec_apply",
        (
            _a("plan", "int32", "PLAN N"),
            _a("trow", "int32", "TT FOUR"),
            _a("smt", "bool", "N"),
            _a("nic_sw", "int32", "N U K"),
            _a("cpu_g", "float32", "TWO TT CM U"),
            _a("cpu_m", "float32", "TWO TT U U"),
            _a("gpu_g", "float32", "TT CM U"),
            _a("nic_occ", "float32", "TT CAM U"),
            _a("gpu_uk", "float32", "TT CAM UK"),
            _a("nic_rx", "float32", "TT CAM UK"),
            _a("nic_tx", "float32", "TT CAM UK"),
            _io("busy", "bool", "N"),
            _io("hp_free", "int32", "N"),
            _io("cpu_free", "int32", "N U"),
            _io("gpu_free", "int32", "N U"),
            _io("nic_free", "float32", "N U K TWO"),
            _io("gpu_free_sw", "int32", "N S"),
            _io("claims", "int32", "IT N"),
            _io("counts", "int32", "IT N"),
            _a("gate", "int32", "ONE"),
        ),
        ("TT", "N", "U", "K", "S", "CM", "CAM", "IT", "it", "SHARING", "BUSY"),
    ),
    "spec_gate": KernelABI(
        "nhd_spec_gate",
        (
            _a("status", "int32", "TT1"),
            _a("offsets", "int32", "B1"),
            _io("ctl", "int32", "B2"),
        ),
        ("TT", "B"),
    ),
    "rank_top": KernelABI(
        "nhd_rank_top",
        (
            _a("planes", "int32", "P T N"),
            _a("gpu_free", "int32", "N U"),
            _a("cpu_free", "int32", "N U"),
            _a("hp_free", "int32", "N"),
            _a("gate", "int32", "ONE"),
            _a("out", "int32", "RANK T R", out=True),
        ),
        ("T", "N", "U", "R", "node_base"),
    ),
    "rank_merge": KernelABI(
        "nhd_rank_merge",
        (
            _a("cand", "int32", "RANK T M"),
            _a("gate", "int32", "ONE"),
            _a("out", "int32", "RANK T R", out=True),
        ),
        ("T", "M", "R"),
    ),
}

#: fixed size symbols: the small constant axes of the claim kernels'
#: tables, and the rows of the packed rank tensor (RankOut)
FIXED = {"TWO": 2, "FOUR": 4, "PLAN": 7, "ONE": 1, "RANK": 9}

def shape(arg: Arg, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of *arg* at *sizes*."""
    return tuple(FIXED[d] if d in FIXED else sizes[d] for d in arg.dims)
