"""The batched feasibility solve on PyTorch, through the Hopper kernels.

The counterpart of the reference's nhd_tpu/solver/kernel.py. Every
predicate of the reference's ``_solve`` is evaluated per (type t, node n)
by three hand-written kernels (nhd_tpu_torch/kernels), and a fourth
ranks the nodes:

1. ``nic_node_masks``: the node-only NIC masks (pick validity, PCI);
2. ``nic_any_first``: the NIC stage over the dense [C*A, U*K] slot form;
3. ``solve_planes``: node filter, GPU/CPU fit, combo choice, policy
   preference and the selection value, as [T, N] int32 planes;
4. ``rank_top``: per type row the top R of the sel plane and the packed
   [9, T, R] rank tensor (RankOut rows) gathered at the winners — the
   reference's ``_rank_body``, which it runs as ``lax.top_k`` and
   gathers.

Equal sel values rank in ascending node index, lax.top_k's order, so the
whole rank tensor, val 0 slots included, is the reference's. On CPU
tensors every kernel wrapper takes its plain PyTorch version; the
decisions are the same integers either way.

On a node-sharded mesh (parallel/sharding.py) the reference runs the same
fused program under GSPMD, which computes sel over the global padded node
axis and inserts the top-k collective. Here each shard runs the three
solve kernels on its own rows with its global ``node_base`` (so its sel
values are the unsharded solve's) and ``rank_top`` ranks its top
min(R, shard rows) with indices made global; the shards' candidates,
joined in shard order, are merged by ``rank_merge`` on the lead shard's
device (``rank_shards``). The merge is exact on every val > 0 slot
because sel is unique there (it ends in n_global - n), and on the val 0
slots because each shard's zero candidates are its lowest-index zero
nodes, in order.

Argument order, padding rules, rank widths and shape keys are the
reference's, so one set of knobs (``NHD_TPU_RANK_CAP``,
``NHD_TPU_MAX_LATTICE``) drives both sides of a parity test.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import live_gate
from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.solver.combos import get_tables

Tensor = torch.Tensor


class SolveOut(NamedTuple):
    cand: Tensor      # [T, N] bool — node feasible for type
    pref: Tensor      # [T, N] int32 — 0 invalid / 1 candidate / 2 preferred
    best_c: Tensor    # [T, N] int32 — skew-maximal feasible combo
    best_m: Tensor    # [T, N] int32 — first feasible misc NUMA for best_c
    best_a: Tensor    # [T, N] int32 — first feasible NIC pick for best_c
    n_combos: Tensor  # [T, N] int32 — feasible combo count
    n_picks: Tensor   # [T, N] int32 — feasible NIC picks at best_c


class RankOut(NamedTuple):
    """Field order of the packed [9, T, R] int32 rank tensor (rows)."""

    val: Tensor       # [T, R] ranking value, 0 = not a candidate
    idx: Tensor       # [T, R] node index, descending val
    best_c: Tensor
    best_m: Tensor
    best_a: Tensor
    n_picks: Tensor
    free_gpu: Tensor  # node free-GPU totals at idx
    free_cpu: Tensor
    free_hp: Tensor


# The node-array / pod-array argument-order contract (the reference's
# kernel.py:214-227, pinned equal to it by the tests).
_MUTABLE = ("busy", "hp_free", "cpu_free", "gpu_free", "nic_free", "gpu_free_sw")
_STATIC = (
    "numa_nodes", "smt", "active", "maintenance", "gpuless", "group_mask",
    "nic_count", "nic_sw", "node_class",
)
_ARG_ORDER = (
    "numa_nodes", "smt", "active", "maintenance", "busy", "gpuless",
    "group_mask", "hp_free", "cpu_free", "gpu_free", "nic_count",
    "nic_free", "nic_sw", "gpu_free_sw", "node_class",
)
_POD_ARG_ORDER = (
    "cpu_dem_smt", "cpu_dem_raw", "gpu_dem", "rx", "tx", "hp", "needs_gpu",
    "map_pci", "group_mask", "class_score",
)

# combo-lattice ceiling: (U^G) * (K^G) above this routes the bucket to the
# serial oracle instead of enumerating a huge static axis
MAX_LATTICE = int(os.environ.get("NHD_TPU_MAX_LATTICE", str(1 << 16)))


def bucket_tractable(n_groups: int, n_numa: int, max_nic: int) -> bool:
    """Whether a (G, U, K) bucket fits the dense-enumeration budget."""
    return (n_numa ** n_groups) * (max(max_nic, 1) ** n_groups) <= MAX_LATTICE


def _pad_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def pad_nodes(n: int, n_dev: int = 1, floor: int = 8) -> int:
    """Padded node-axis length of the resident tensors: the reference's
    power-of-two bucket, rounded up to a multiple of the mesh's shard
    count (even shards). The padded N enters the selection value, so
    both sides must pad alike."""
    p = _pad_pow2(max(n, 1), floor=max(floor, n_dev))
    if p % n_dev:
        p += n_dev - (p % n_dev)
    return p


def rank_cap(accelerator: bool) -> int:
    """Ceiling for the top-R rank width: 512 on an accelerator, 1024 on
    the CPU, ``NHD_TPU_RANK_CAP`` overriding both (the reference's
    defaults, kept until an H100 measurement says otherwise)."""
    env = os.environ.get("NHD_TPU_RANK_CAP")
    if env:
        return int(env)
    return 512 if accelerator else 1024


def rank_budget(max_need: int, n_padded: int, *, accelerator: bool = False) -> int:
    """The R for a batch (the reference's rule): a pure function of the
    cluster size on the CPU, need-proportional on an accelerator."""
    cap = rank_cap(accelerator)
    if not accelerator:
        return min(_pad_pow2(max(n_padded, 1), floor=8), cap)
    return min(n_padded, _pad_pow2(min(max(max_need, 1), cap), floor=64))


def mesh_desc(mesh) -> str:
    """Canonical descriptor of a 1-D node mesh ("nodes8" = a ``nodes``
    axis of 8 shards; "" for no mesh): the string every layer that names
    a sharded dispatch shares (jit-stats shape keys, kernel-cache keys,
    the NHD_MESH knob's log line), as in the reference."""
    if mesh is None:
        return ""
    (axis,) = mesh.axis_names
    return f"{axis}{mesh.size}"


def parse_mesh_desc(desc: str):
    """(axis, n_shards) from a mesh_desc string, or None for ""."""
    if not desc:
        return None
    axis = desc.rstrip("0123456789")
    return axis, int(desc[len(axis):])


def ranked_shape_key(G, U, K, R, Tp, Np, mesh: str = "") -> str:
    """The shape key of one solve+rank dispatch (the reference's format,
    so both packages' accounting tables read alike); ``mesh``: the
    mesh_desc of a sharded dispatch."""
    key = f"G{G}_U{U}_K{K}_R{R}_T{Tp}_N{Np}"
    return key + (f"_M{mesh}" if mesh else "")


def parse_ranked_shape_key(key: str):
    """(G, U, K, R, Tp, Np, mesh_desc) of a ranked_shape_key string, or
    None."""
    import re

    m = re.fullmatch(
        r"G(\d+)_U(\d+)_K(\d+)_R(\d+)_T(\d+)_N(\d+)(?:_M(.+))?", key
    )
    if m is None:
        return None
    return tuple(int(x) for x in m.groups()[:6]) + (m.group(7) or "",)


@dataclass(frozen=True)
class BucketTables:
    """The combo tables of one (G, U, K) bucket on one device, plus the
    host-side slot map the NIC demand is built from."""

    G: int
    U: int
    K: int
    C: int
    A: int
    combo: Tensor     # [C, G] int32
    pick: Tensor      # [A, G] int32
    need_max: Tensor  # [C, A, U] int32
    skew: Tensor      # [C] int32
    maxdig: Tensor    # [C] int32
    unchosen: Tensor  # [C*A, U*K] bool — slot used by no group of the pick
    slot: np.ndarray  # [C*A, G] int64 — the (u, k) slot each group chose


@lru_cache(maxsize=None)
def bucket_tables(G: int, U: int, K: int, device: torch.device) -> BucketTables:
    """The (G, U, K) tables on *device*, uploaded once and cached."""
    t = get_tables(G, U, K)
    C, A = t.C, t.A
    slot = (
        t.combo.astype(np.int64)[:, None, :] * t.K
        + t.pick.astype(np.int64)[None, :, :]
    ).reshape(C * A, G)
    unchosen = np.ones((C * A, t.U * t.K), bool)
    rows = np.arange(C * A)
    for g in range(G):
        unchosen[rows, slot[:, g]] = False

    def up(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)  # always a copy

    i32 = torch.int32
    return BucketTables(
        G=G, U=t.U, K=t.K, C=C, A=A,
        combo=up(t.combo, i32), pick=up(t.pick, i32),
        need_max=up(t.need_max, i32), skew=up(t.skew, i32),
        maxdig=up(t.combo_maxdig, i32), unchosen=up(unchosen, torch.bool),
        slot=slot,
    )


def nic_demand(rx: np.ndarray, tx: np.ndarray, tables: BucketTables):
    """The dense NIC demand (dem_rx, dem_tx), each [T, C*A, U*K] float32:
    the rx/tx of every group that chose slot (u, k), summed in float32 in
    group order (the reference's group-indexed einsum gives the same sums
    for every bandwidth on a 0.5 Gbps grid)."""
    T = rx.shape[0]
    CA, UK = tables.C * tables.A, tables.U * tables.K
    rows = np.arange(CA)
    out = []
    for bw in (rx, tx):
        dem = np.zeros((T, CA, UK), np.float32)
        for g in range(tables.G):
            # each pick row chooses ONE slot per group: no repeated index
            dem[:, rows, tables.slot[:, g]] += bw[:, g].astype(np.float32)[:, None]
        out.append(dem)
    return out[0], out[1]


def to_device(a: np.ndarray, device: torch.device) -> Tensor:
    """Upload a host array as a tensor that never aliases it: on the CPU
    ``torch.from_numpy`` shares memory, and an in-place update of a
    resident tensor would then write into the host mirror."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


class PodTensors(NamedTuple):
    """One bucket's padded pod-type tensors on the device: the 10 arrays
    of ``_POD_ARG_ORDER`` plus the dense NIC demand and the tables."""

    args: List[Tensor]
    dem_rx: Tensor
    dem_tx: Tensor
    tables: BucketTables


def _pad_rows_to(a: np.ndarray, size: int) -> np.ndarray:
    if a.shape[0] == size:
        return a
    return np.concatenate(
        [a, np.zeros((size - a.shape[0], *a.shape[1:]), a.dtype)], axis=0
    )


def upload_pods(pods, Tp: int, U: int, K: int, device: torch.device) -> PodTensors:
    """Pad *pods* (a PodTypeArrays or anything with its fields) to Tp
    type rows and upload them with their NIC demand."""
    tables = bucket_tables(pods.G, U, K, device)
    host = [_pad_rows_to(getattr(pods, name), Tp) for name in _POD_ARG_ORDER]
    dem_rx, dem_tx = nic_demand(
        host[_POD_ARG_ORDER.index("rx")], host[_POD_ARG_ORDER.index("tx")],
        tables,
    )
    return PodTensors(
        [to_device(a, device) for a in host],
        to_device(dem_rx, device), to_device(dem_tx, device), tables,
    )


def _gate(gate: Optional[Tensor], node: Sequence[Tensor]) -> Tensor:
    return live_gate(node[0].device) if gate is None else gate


def mask_args(node: Sequence[Tensor], pod: PodTensors,
              gate: Optional[Tensor] = None) -> tuple:
    """The arguments of ``kernels.nic_node_masks`` for one solve, its
    *gate* last (default: always live)."""
    a = dict(zip(_ARG_ORDER, node))
    tb = pod.tables
    return (a["nic_count"], a["nic_sw"], a["gpu_free_sw"],
            tb.combo, tb.pick, tb.need_max, _gate(gate, node))


def free_planes(node: Sequence[Tensor],
                out: Optional[Tuple[Tensor, Tensor]] = None) -> Tuple[Tensor, Tensor]:
    """The node NIC headroom split into contiguous rx/tx [N, U*K] planes,
    copied into *out* when given (two float32 [N, U*K] tensors)."""
    a = dict(zip(_ARG_ORDER, node))
    nic_free = a["nic_free"].reshape(a["nic_free"].shape[0], -1, 2)
    if out is None:
        return nic_free[..., 0].contiguous(), nic_free[..., 1].contiguous()
    out[0].copy_(nic_free[..., 0])
    out[1].copy_(nic_free[..., 1])
    return out[0], out[1]


class SolveBuffers(NamedTuple):
    """The intermediate outputs of one bucket's solve, held by a caller
    whose solve must allocate nothing (the megaround graph's WHILE body):
    ``nic_node_masks``' two, then ``nic_any_first``'s three."""

    valid: Tensor    # [N, C*A] bool
    pci_ok: Tensor   # [N, C*A] bool
    nic_any: Tensor  # [T, N, C] bool
    first_a: Tensor  # [T, N, C] int32
    n_picks: Tensor  # [T, N, C] int32


def solve_buffers(Tp: int, N: int, pod: PodTensors) -> SolveBuffers:
    """Empty ``SolveBuffers`` for a bucket of *Tp* type rows on *N* nodes
    (its tables from *pod*), on *pod*'s device."""
    tb = pod.tables
    dev = pod.dem_rx.device
    b, i32 = torch.bool, torch.int32
    return SolveBuffers(
        torch.zeros((N, tb.C * tb.A), dtype=b, device=dev),
        torch.zeros((N, tb.C * tb.A), dtype=b, device=dev),
        torch.zeros((Tp, N, tb.C), dtype=b, device=dev),
        torch.zeros((Tp, N, tb.C), dtype=i32, device=dev),
        torch.zeros((Tp, N, tb.C), dtype=i32, device=dev),
    )


def nic_args(node: Sequence[Tensor], pod: PodTensors, valid: Tensor,
             pci_ok: Tensor, gate: Optional[Tensor] = None,
             free: Optional[Tuple[Tensor, Tensor]] = None):
    """(args, keywords) of ``kernels.nic_any_first`` for one solve: the
    headroom planes *free* (default ``free_planes(node)``)."""
    tb = pod.tables
    map_pci = pod.args[_POD_ARG_ORDER.index("map_pci")]
    return (
        (*(free_planes(node) if free is None else free),
         pod.dem_rx, pod.dem_tx, tb.unchosen, valid, pci_ok, map_pci,
         _gate(gate, node)),
        dict(U=tb.U, K=tb.K, C=tb.C, A=tb.A),
    )


def plane_args(node: Sequence[Tensor], pod: PodTensors, nic_any: Tensor,
               first_a: Tensor, n_picks: Tensor,
               gate: Optional[Tensor] = None) -> tuple:
    """The arguments of ``kernels.solve_planes`` for one solve."""
    a = dict(zip(_ARG_ORDER, node))
    p = dict(zip(_POD_ARG_ORDER, pod.args))
    tb = pod.tables
    return (
        a["numa_nodes"], a["smt"], a["active"], a["maintenance"], a["busy"],
        a["gpuless"], a["group_mask"], a["hp_free"], a["cpu_free"],
        a["gpu_free"], a["node_class"],
        p["cpu_dem_smt"], p["cpu_dem_raw"], p["gpu_dem"], p["hp"],
        p["needs_gpu"], p["group_mask"], p["class_score"],
        tb.combo, tb.maxdig, tb.skew, nic_any, first_a, n_picks,
        _gate(gate, node),
    )


def solve_planes(G: int, U: int, K: int, node: Sequence[Tensor],
                 pod: PodTensors, out: Optional[Tensor] = None, *,
                 node_base: int = 0, n_global: Optional[int] = None,
                 gate: Optional[Tensor] = None,
                 free: Optional[Tuple[Tensor, Tensor]] = None,
                 bufs: Optional[SolveBuffers] = None) -> Tensor:
    """The padded solve: [8, Tp, Np] int32 planes (kernels.PLANES order)
    from the 15 node tensors (``_ARG_ORDER``) and one bucket's pod
    tensors — three kernel launches on CUDA tensors. With *out*, the
    planes are written there (the megaround's plane buffer). On a mesh
    shard, *node* holds global rows [node_base, node_base + Ns) of a
    padded axis of *n_global* rows, and sel ranks by the global index.
    *gate*: the bucket's live flag in the megaround (``kernels/abi.py``):
    where it is 0 the three kernels return at once and *out* keeps its
    planes. *free*: ``free_planes(node)``, when the caller has them.
    *bufs*: where the intermediate outputs go (``SolveBuffers``), so that
    with *out* and *free* the solve allocates nothing."""
    tb = pod.tables
    if (tb.G, tb.U, tb.K) != (G, U, K):
        raise ValueError(f"pod tensors were built for {(tb.G, tb.U, tb.K)}")
    valid, pci_ok = kernels.nic_node_masks(
        *mask_args(node, pod, gate), out=None if bufs is None else bufs[:2])
    args, kw = nic_args(node, pod, valid, pci_ok, gate, free)
    nic = kernels.nic_any_first(*args, **kw,
                                out=None if bufs is None else bufs[2:])
    return kernels.solve_planes(*plane_args(node, pod, *nic, gate), out=out,
                                node_base=node_base, n_global=n_global)


_P = {name: i for i, name in enumerate(kernels.PLANES)}


def rank_planes(R: int, planes: Tensor, node: Sequence[Tensor], *,
                node_base: int = 0) -> Tensor:
    """The packed [9, Tp, R] int32 rank tensor (RankOut order): top-R of
    the sel plane per type, equal values in ascending node index (the
    reference's lax.top_k order), and the decision planes and node free
    totals gathered at the ranked nodes — one ``rank_top`` launch on CUDA
    tensors. The index row is offset by *node_base* (a mesh shard's first
    global row)."""
    a = dict(zip(_ARG_ORDER, node))
    return kernels.rank_top(planes, a["gpu_free"], a["cpu_free"],
                            a["hp_free"], R=R, node_base=node_base)


def rank_shard(R: int, G: int, U: int, K: int, node: Sequence[Tensor],
               pod: PodTensors, node_base: int, n_global: int) -> Tensor:
    """One shard's candidates: the packed [9, Tp, k] rank tensor of its
    rows (k = min(R, shard rows)) with the index row made global."""
    planes = solve_planes(G, U, K, node, pod, node_base=node_base,
                          n_global=n_global)
    return rank_planes(min(R, planes.shape[2]), planes, node,
                       node_base=node_base)


def rank_shards(G: int, U: int, K: int, R: int, Np: int,
                shards: Sequence[Sequence[Tensor]],
                pods: Sequence[PodTensors], *, first: int = 0,
                group=None) -> Tensor:
    """Solve + rank over a node-sharded mesh: this process's shard i is
    global shard ``first + i`` (rows [(first+i)*Ns, (first+i+1)*Ns) on
    its own device); it is solved and ranked on that device and its
    candidates are copied to the lead shard's device. With a
    ``torch.distributed`` *group*, every rank's candidates are gathered
    (in rank order, so every rank merges the same tensor); then
    ``rank_merge`` takes the top R of the candidates, joined in shard
    order, on the lead device. Returns the packed [9, Tp, R] tensor
    there."""
    Ns = shards[0][0].shape[0]
    lead = shards[0][0].device
    parts = [
        rank_shard(R, G, U, K, node, pod, (first + s) * Ns, Np).to(lead)
        for s, (node, pod) in enumerate(zip(shards, pods))
    ]
    cand = torch.cat(parts, dim=2)
    if group is not None:
        cand = _all_gather_nodes(cand, group)
    return kernels.rank_merge(cand, R=R)


def _all_gather_nodes(t: Tensor, group) -> Tensor:
    """Every rank's *t* (equal shapes), concatenated in rank order along
    the last axis, on *t*'s device. gloo's all_gather takes no CUDA
    tensors, so under gloo the candidates go through an explicit host
    copy; NCCL gathers them on the card."""
    import torch.distributed as dist

    # gloo's host copy: the gather itself is a sync point of the mesh
    send = t.cpu() if dist.get_backend(group) == "gloo" else t  # nhdlint: ignore[NHD107]
    bufs = [torch.empty_like(send)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, send, group=group)
    return torch.cat(bufs, dim=-1).to(t.device)


def dispatch_ranked(G, U, K, R, Tp, Np, node, pod, mesh=None) -> Tensor:
    """Solve + rank for one padded shape: the single seam the host path
    and the device-resident path share. Records the dispatch under the
    reference's shape key (a first-seen key is a new shape), is the
    solver guard's ``dispatch`` fault-injection site (solver/guard.py),
    and, when the kernel cache saves (solver/aot.py), records the key to
    its manifest so the next start prewarms it — unless the guard has
    quarantined the shape, which must not re-seed the cache it was just
    evicted from (the reference's check, nhd_tpu/solver/kernel.py:
    530-547). With ``mesh`` (parallel/sharding.py), *node* and *pod* are
    per shard (each shard's 15 node tensors and its device's pod
    tensors), the key carries the mesh_desc and the solve is
    ``rank_shards``."""
    from nhd_tpu_torch.solver import aot, guard

    desc = mesh_desc(mesh)
    key_str = ranked_shape_key(G, U, K, R, Tp, Np, desc)
    JIT_STATS.record_use("solve_ranked", key_str)
    # chaos fault-injection seam (solver/guard.py): no-op in production
    guard.maybe_inject("dispatch", key_str)
    if not guard.GUARD.shape_quarantined(key_str):
        one_node, one_pod = (node, pod) if mesh is None else (node[0], pod[0])
        aot.maybe_record(aot.ShapeKey("ranked", key_str), lambda: dict(
            G=G, U=U, K=K, R=R, Tp=Tp, Np=Np, node=aot.arg_spec(one_node),
            pod=aot.arg_spec(one_pod.args), mesh=desc,
        ))
    if mesh is not None:
        return rank_shards(G, U, K, R, Np, node, pod,
                           first=mesh.first_shard, group=mesh.group)
    return rank_planes(R, solve_planes(G, U, K, node, pod), node)


def padded_args(cluster, pods, Tp: int, Np: int) -> list:
    """The 25 padded host arrays (node arrays in ``_ARG_ORDER``, then pod
    arrays in ``_POD_ARG_ORDER``): the one place the host padding rule
    lives."""
    return [
        _pad_rows_to(getattr(cluster, name), Np) for name in _ARG_ORDER
    ] + [
        _pad_rows_to(getattr(pods, name), Tp) for name in _POD_ARG_ORDER
    ]


def _host_inputs(cluster, pods, device):
    T, N = pods.n_types, cluster.n_nodes
    Tp, Np = _pad_pow2(T), _pad_pow2(N, floor=8)
    host = padded_args(cluster, pods, Tp, Np)
    node = [to_device(a, device) for a in host[: len(_ARG_ORDER)]]
    pod = upload_pods(pods, Tp, cluster.U, cluster.K, device)
    return Tp, Np, node, pod


def solve_bucket_ranked(cluster, pods, R: int, *, device: DeviceLike = "cuda") -> Tensor:
    """Solve + top-R ranking for (ClusterArrays, PodTypeArrays) uploaded
    from the host, node axis padded to its power of two. Returns the
    packed [9, Tp, R'] tensor on *device* (R' = min(R, Np)); callers
    slice [:, :T]."""
    dev = resolve_device(device)
    Tp, Np, node, pod = _host_inputs(cluster, pods, dev)
    return dispatch_ranked(
        pods.G, cluster.U, cluster.K, min(R, Np), Tp, Np, node, pod
    )


def planes_to_solveout(planes: Tensor, T: int, N: int) -> SolveOut:
    """The [8, Tp, Np] planes as a SolveOut sliced to [T, N]."""
    pl = planes[:, :T, :N]
    return SolveOut(
        pl[_P["cand"]] != 0, pl[_P["pref"]], pl[_P["best_c"]],
        pl[_P["best_m"]], pl[_P["best_a"]], pl[_P["n_combos"]],
        pl[_P["n_picks"]],
    )


def solve_bucket(cluster, pods, *, device: DeviceLike = "cuda") -> SolveOut:
    """The plain solve surface: SolveOut with [T, N] tensors on *device*
    (padded node rows are inactive; padded type rows are sliced off)."""
    dev = resolve_device(device)
    Tp, Np, node, pod = _host_inputs(cluster, pods, dev)
    JIT_STATS.record_use(
        "solve", f"G{pods.G}_U{cluster.U}_K{cluster.K}_T{Tp}_N{Np}"
    )
    planes = solve_planes(pods.G, cluster.U, cluster.K, node, pod)
    return planes_to_solveout(planes, pods.n_types, cluster.n_nodes)
