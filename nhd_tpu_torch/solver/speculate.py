"""The speculative multi-round (the megaround) on PyTorch, through the
Hopper kernels.

The counterpart of the reference's nhd_tpu/solver/speculate.py. Round 0
of a batch runs the whole greedy claim loop against the resident node
tensors: each iteration solves every bucket that still has need, elects
one type per node (selection preference first, then the largest
remaining need), gives each elected node up to its per-NUMA copy
capacity by a balanced fill, applies the aggregate claim deltas to the
node state (cpu, gpu and hugepages, NIC occupancy or bandwidth, the
per-switch GPUs of PCI types, busy) and records one packed claim word
per (iteration, node) plus a counts plane. The host then re-verifies
every claim through the native assignment, exactly like a classic round;
what it rejects retries in the classic rounds that follow.

The reference runs the loop as one ``lax.while_loop``. On one device
(and on a mesh whose shards all sit on one device, below) the port runs
it as one CUDA graph with the same loop inside: the resets and one
``spec_gate`` (``megaround_open``), then a WHILE node
(kernels/graph_while.cu) whose body is one iteration
(``megaround_iteration``: the three solve kernels of each bucket,
``spec_elect``, ``spec_fill``, ``spec_apply``, then ``spec_gate``).
``spec_gate`` decides on the card what the reference's ``cond`` decides
(progress, need left, ``it < iters``) and which buckets still have need
(its ``lax.cond``), writes it to the control tensor and sets the node's
condition, so the node runs exactly the reference's iterations and
nothing launches after the exit. ``spec_apply`` writes claim row
``ctl[1] - 1``, so one captured body serves every pass.
``MegaroundGraph`` holds every buffer the graph reads or writes at
fixed addresses (its own copy of the node tensors, the pod arrays, the
hoisted tables, the status and control tensors, refilled through one
pinned staging copy a dispatch; the body's intermediate outputs, since
its capture has no allocator pool) and captures the graph once per key
in the process (``GRAPHS``); a dispatch is one replay and no
device-to-host read. The same body issued launch by launch is the fixed
trip (``MegaroundGraph.trip``: ``spec_iters()`` iterations, every kernel
of an iteration after the exit returning at once on its gate word),
which the card runs with ``REPLAY`` off; the CPU loops on the plain
``spec_gate``'s result (``MegaroundGraph.loop``). The per-bucket demand
projections are hoisted out of the loop into tables over the global
type axis, as the reference hoists them (speculate.py:176-248). The
claim kernels update the node tensors in place.

``run_megaround_shards`` keeps the host loop: per iteration the solves
of each live bucket and the claim kernels, then one small pull of the
status vector to decide the next. ``run_megaround`` is its one-device
case, kept as the yardstick the graph is held to.

On a node mesh (parallel/sharding.py) the body is per node except the
balanced fill, which takes each type's winner count and its exclusive
scans over all nodes, and the need and progress flag, which are global:
GSPMD placed those collectives for the reference. Here an iteration runs
the three solve kernels and ``spec_elect`` on every shard, joins the
shards' plans into one [7, Np] plan, runs ONE ``spec_fill`` over it,
copies each shard's slice of the count row back and runs ``spec_apply``
per shard: exact by construction, with ``spec_fill`` unchanged. The
claim words and counts of the shards join in shard order into the
[iters, Np] layout ``decode_claims*`` reads. Where every shard sits on
one device, ``megaround_iteration`` takes the shards and the join is
slice copies into a held plan, so the mesh's dispatch is one graph
replay as one device's is (``graph_serves``). A WHILE node's body holds
the work of one CUDA context only, so a mesh over several devices keeps
the host loop (``run_megaround_shards``: the plans gathered on the lead
device, the status copied out to the shards).

Claim word (one int32, -1 = no claim):
    word = t_global * 2^21 + (c * U + m) * A_bucket(t) + a
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import capturing, count_replay
from nhd_tpu_torch.kernels.reference import (
    FLAG_HAS_NIC,
    FLAG_MAP_PCI,
    FLAG_NEEDS_GPU,
)
from nhd_tpu_torch.solver.combos import get_tables
from nhd_tpu_torch.solver.device_state import HostPull
from nhd_tpu_torch.solver.kernel import (
    _ARG_ORDER,
    _MUTABLE,
    _POD_ARG_ORDER,
    PodTensors,
    SolveBuffers,
    _pad_pow2,
    _pad_rows_to,
    bucket_tables,
    free_planes,
    nic_demand,
    solve_buffers,
    solve_planes,
    to_device,
)

Tensor = torch.Tensor
_HOST = torch.device("cpu")

# t_global < 1024 (the 31 - _T_SHIFT bound enforced at dispatch,
# batch._speculate_dispatch) and (c*U + m)*A + a < 2^21 for every
# tractable lattice, so the word always fits int32
_T_SHIFT = 21


def spec_iters() -> int:
    """Claim-loop depth: one pod per node per iteration, so this bounds
    pods-per-node per dispatch; leftovers take classic rounds."""
    return int(os.environ.get("NHD_TPU_SPEC_ITERS", "16"))


def speculate_enabled(device: torch.device) -> bool:
    """NHD_TPU_SPECULATE: 1 forces on, 0 forces off, auto (default) = on
    exactly when the scheduler's device is CUDA — on the CPU the extra
    per-iteration solves cost more than the rounds they save."""
    val = os.environ.get("NHD_TPU_SPECULATE", "auto").lower()
    if val in ("1", "true", "on"):
        return True
    if val in ("0", "false", "off"):
        return False
    if val != "auto":
        raise ValueError(f"NHD_TPU_SPECULATE must be 0/1/auto, got {val!r}")
    return device.type == "cuda"


class SpecTables(NamedTuple):
    """The hoisted, state-independent inputs of the claim kernels for one
    dispatch, over the global type axis TT (every bucket's Tp rows, in
    bucket order). C and C*A axes are padded to the buckets' largest."""

    offsets: np.ndarray  # [B + 1] first global row of each bucket
    trow: Tensor         # [TT, 4] int32: A, C, flags, hugepages
    plane_off: Tensor    # [TT, 2] int64: base and plane stride in `planes`
    planes: Tensor       # flat int32: bucket b's [8, Tp_b, Np] solve planes
    views: List[Tensor]  # bucket b's [8, Tp_b, Np] view of `planes`
    cpu_g: Tensor        # [2, TT, CM, U] f32: group cpu demand (SMT, raw)
    cpu_m: Tensor        # [2, TT, U, U] f32: misc-slot cpu demand
    gpu_g: Tensor        # [TT, CM, U] f32
    nic_occ: Tensor      # [TT, CAM, U] f32: distinct NICs a claim occupies
    gpu_uk: Tensor       # [TT, CAM, U*K] f32: PCI GPU demand per slot
    nic_rx: Tensor       # [TT, CAM, U*K] f32: NIC demand per slot
    nic_tx: Tensor


def _shapes(bucket_pods: Sequence, pod_tensors: Optional[Sequence[PodTensors]] = None
            ) -> List[Tuple[int, int]]:
    """(G, Tp) per bucket: Tp from the uploads when given, else the
    power-of-two padding ``DeviceClusterState.pod_tensors`` uploads."""
    if pod_tensors is not None:
        return [(p.G, int(pt.dem_rx.shape[0])) for p, pt in zip(bucket_pods, pod_tensors)]
    return [(p.G, _pad_pow2(p.n_types)) for p in bucket_pods]


def table_arrays(bucket_pods: Sequence, shapes: Sequence[Tuple[int, int]],
                 U: int, K: int, Np: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The hoisted tables (speculate.py:176-248 of the reference) on the
    host, with each bucket's padded pod arrays and NIC demand as
    ``upload_pods`` makes them: (offsets, {name: array}), the tables by
    their ``SpecTables`` names and bucket b's pod arrays as
    ``"{b}.{name}"`` (``_POD_ARG_ORDER``, then ``dem_rx``, ``dem_tx``).
    Every entry is an integer or a sum of bandwidths on the request grid,
    so the float32 values are the reference's einsums exactly."""
    f32 = np.float32
    offsets = np.cumsum([0] + [tp for _, tp in shapes])
    TT = int(offsets[-1])
    tabs = [get_tables(G, U, K) for G, _ in shapes]
    CM = max(tb.C for tb in tabs)
    CAM = max(tb.C * tb.A for tb in tabs)
    UK = U * K
    trow = np.zeros((TT, 4), np.int32)
    plane_off = np.zeros((TT, 2), np.int64)
    cpu_g = np.zeros((2, TT, CM, U), f32)
    cpu_m = np.zeros((2, TT, U, U), f32)
    gpu_g = np.zeros((TT, CM, U), f32)
    nic_occ = np.zeros((TT, CAM, U), f32)
    gpu_uk = np.zeros((TT, CAM, UK), f32)
    nic_rx = np.zeros((TT, CAM, UK), f32)
    nic_tx = np.zeros((TT, CAM, UK), f32)
    out: Dict[str, np.ndarray] = {}
    base = 0
    for b, (pods, tb, (G, Tp)) in enumerate(zip(bucket_pods, tabs, shapes)):
        lo = int(offsets[b])
        rows = slice(lo, lo + Tp)
        host = {name: _pad_rows_to(getattr(pods, name), Tp) for name in _POD_ARG_ORDER}
        C, A = tb.C, tb.A
        dev_tb = bucket_tables(G, U, K, _HOST)
        dem_rx, dem_tx = nic_demand(host["rx"], host["tx"], dev_tb)
        out.update({f"{b}.{name}": a for name, a in host.items()})
        out[f"{b}.dem_rx"], out[f"{b}.dem_tx"] = dem_rx, dem_tx
        onehot = tb.combo_onehot  # [C, G, U]
        for s, name in enumerate(("cpu_dem_smt", "cpu_dem_raw")):
            dem = host[name].astype(f32)
            cpu_g[s, rows, :C] = np.einsum("tg,cgu->tcu", dem[:, :G], onehot)
            cpu_m[s, rows] = dem[:, G][:, None, None] * tb.misc_onehot[None]
        gpu_dem = host["gpu_dem"].astype(f32)
        gpu_g[rows, :C] = np.einsum("tg,cgu->tcu", gpu_dem, onehot)
        rx, tx = host["rx"].astype(f32), host["tx"].astype(f32)
        needs_nic = (rx + tx) > 0                      # [Tp, G]
        map_pci = host["map_pci"].astype(bool)
        slot = dev_tb.slot                             # [C*A, G] u*K + k
        ca_rows = np.arange(C * A)
        occ = np.zeros((Tp, C * A, UK), f32)
        guk = np.zeros((Tp, C * A, UK), f32)
        for g in range(G):
            # each pick chooses ONE slot per group: no repeated index
            occ[:, ca_rows, slot[:, g]] += needs_nic[:, g].astype(f32)[:, None]
            guk[:, ca_rows, slot[:, g]] += (gpu_dem[:, g] * map_pci)[:, None]
        nic_occ[rows, : C * A] = (occ > 0).reshape(Tp, C * A, U, K).sum(-1)
        gpu_uk[rows, : C * A] = guk
        nic_rx[rows, : C * A] = dem_rx
        nic_tx[rows, : C * A] = dem_tx
        flags = (
            FLAG_NEEDS_GPU * host["needs_gpu"].astype(np.int32)
            + FLAG_MAP_PCI * map_pci.astype(np.int32)
            + FLAG_HAS_NIC * needs_nic.any(1).astype(np.int32)
        )
        trow[rows] = np.stack(
            [np.full(Tp, A), np.full(Tp, C), flags, host["hp"]], axis=1)
        plane_off[rows, 0] = base + np.arange(Tp, dtype=np.int64) * Np
        plane_off[rows, 1] = Tp * Np
        base += 8 * Tp * Np
    out.update(trow=trow, plane_off=plane_off, cpu_g=cpu_g, cpu_m=cpu_m,
               gpu_g=gpu_g, nic_occ=nic_occ, gpu_uk=gpu_uk, nic_rx=nic_rx,
               nic_tx=nic_tx)
    return offsets, out


def spec_tables(bucket_pods: Sequence, pod_tensors: Sequence[PodTensors],
                U: int, K: int, Np: int, device: torch.device) -> SpecTables:
    """The hoisted tables of ``table_arrays`` uploaded to *device*, with
    a fresh plane buffer (the type rows padded as *pod_tensors* are)."""
    shapes = _shapes(bucket_pods, pod_tensors)
    offsets, host = table_arrays(bucket_pods, shapes, U, K, Np)
    planes, views = plane_buffer(shapes, Np, device)
    up = lambda name: to_device(host[name], device)  # noqa: E731
    return SpecTables(
        offsets, up("trow"), up("plane_off"), planes, views, up("cpu_g"),
        up("cpu_m"), up("gpu_g"), up("nic_occ"), up("gpu_uk"), up("nic_rx"),
        up("nic_tx"),
    )


def plane_buffer(shapes: Sequence[Tuple[int, int]], Np: int,
                 device: torch.device) -> Tuple[Tensor, List[Tensor]]:
    """The flat solve-plane buffer of one (shard's) node axis of Np rows
    and each bucket's [8, Tp_b, Np] view of it, in bucket order."""
    sizes = [8 * Tp * Np for _, Tp in shapes]
    planes = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    views, at = [], 0
    for (_, Tp), n in zip(shapes, sizes):
        views.append(planes[at: at + n].view(8, Tp, Np))
        at += n
    return planes, views


def run_megaround(
    node: Dict[str, Tensor],
    bucket_pods: Sequence,
    pod_tensors: Sequence[PodTensors],
    needs: Sequence[np.ndarray],
    U: int,
    K: int,
    iters: int,
    respect_busy: bool,
) -> Megaround:
    """The claim loop against the resident node tensors *node* (by
    ``_ARG_ORDER`` name; the mutable ones are updated in place) on one
    device: ``run_megaround_shards`` with one shard.

    ``bucket_pods``: the buckets' PodTypeArrays; ``pod_tensors``: their
    padded uploads; ``needs``: per-bucket [Tp] int32 pending counts.
    Returns device tensors (claims [iters, Np] int32 packed words, counts
    [iters, Np] int32, need_left [TT] int32, iterations used, a scalar).
    """
    return run_megaround_shards([node], bucket_pods, [pod_tensors], needs,
                                U, K, iters, respect_busy)


def run_megaround_shards(
    shards: Sequence[Dict[str, Tensor]],
    bucket_pods: Sequence,
    pod_tensors: Sequence[Sequence[PodTensors]],
    needs: Sequence[np.ndarray],
    U: int,
    K: int,
    iters: int,
    respect_busy: bool,
) -> Megaround:
    """The claim loop over the node shards of a mesh: ``shards[s]`` holds
    global rows [s*Ns, (s+1)*Ns) by ``_ARG_ORDER`` name on its own device
    (shard 0's is the lead), ``pod_tensors[s]`` the buckets' uploads on
    that device. The mutable tensors are updated in place; the returned
    tensors are on the lead device, as ``run_megaround``'s."""
    from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING as sharing

    S = len(shards)
    devs = [shard["hp_free"].device for shard in shards]
    lead = devs[0]
    Ns = shards[0]["hp_free"].shape[0]
    Np = S * Ns
    # the hoisted tables once per device; a plane buffer per shard
    shapes = [(p.G, int(pt.dem_rx.shape[0]))
              for p, pt in zip(bucket_pods, pod_tensors[0])]
    by_dev: Dict[torch.device, SpecTables] = {}
    tabs = []
    for s, d in enumerate(devs):
        if d not in by_dev:
            by_dev[d] = spec_tables(bucket_pods, pod_tensors[s], U, K, Ns, d)
            tabs.append(by_dev[d])
        else:
            planes, views = plane_buffer(shapes, Ns, d)
            tabs.append(by_dev[d]._replace(planes=planes, views=views))
    offsets = tabs[0].offsets
    need0 = np.concatenate([
        _pad_rows_to(n.astype(np.int32), tp) for n, (_, tp) in zip(needs, shapes)
    ])
    status = to_device(np.concatenate([[1], need0]).astype(np.int32), lead)
    # each shard reads its own copy of the status; shards on the lead
    # device read the lead's (spec_elect clears its progress flag)
    st_s = [status if d == lead else status.to(d) for d in devs]
    claims = [torch.full((iters, Ns), -1, dtype=torch.int32, device=d) for d in devs]
    counts = [torch.zeros((iters, Ns), dtype=torch.int32, device=d) for d in devs]
    # spec_apply's claim row is a device word: iteration it writes row it
    steps = [torch.arange(1, iters + 1, dtype=torch.int32, device=d) for d in devs]
    node_lists = [[shard[name] for name in _ARG_ORDER] for shard in shards]
    need_b = [int(need0[offsets[b]: offsets[b + 1]].sum())
              for b in range(len(bucket_pods))]
    # one pinned host buffer for every iteration's status pull
    pinned = (torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
              if lead.type == "cuda" else None)
    it = 0
    progress = True
    while it < iters and sum(need_b) > 0 and progress:
        plans = []
        for s, (node, tb) in enumerate(zip(shards, tabs)):
            for b, (pods, pt) in enumerate(zip(bucket_pods, pod_tensors[s])):
                if need_b[b] > 0:  # a bucket with no need skips its solve
                    solve_planes(pods.G, U, K, node_lists[s], pt, out=tb.views[b],
                                 node_base=s * Ns, n_global=Np)
            plans.append(kernels.spec_elect(
                tb.planes, tb.plane_off, tb.trow, node["smt"],
                node["cpu_free"], node["gpu_free"], node["hp_free"],
                node["nic_free"], tb.cpu_g, tb.cpu_m, tb.gpu_g, tb.nic_occ,
                st_s[s], sharing=sharing, respect_busy=respect_busy,
            ))
        if S == 1:
            kernels.spec_fill(plans[0], status)
        else:
            plan = torch.cat([p.to(lead) for p in plans], dim=1)
            kernels.spec_fill(plan, status)
            for s, p in enumerate(plans):
                p[6].copy_(plan[6, s * Ns: (s + 1) * Ns])
                if st_s[s] is not status:
                    st_s[s].copy_(status)
        for s, (node, tb) in enumerate(zip(shards, tabs)):
            kernels.spec_apply(
                plans[s], tb.trow, node["smt"], node["nic_sw"], tb.cpu_g,
                tb.cpu_m, tb.gpu_g, tb.nic_occ, tb.gpu_uk, tb.nic_rx,
                tb.nic_tx, node["busy"], node["hp_free"], node["cpu_free"],
                node["gpu_free"], node["nic_free"], node["gpu_free_sw"],
                claims[s], counts[s], steps[s][it: it + 1], sharing=sharing,
                respect_busy=respect_busy,
            )
        st = HostPull(status, into=pinned).numpy()
        progress = bool(st[0])
        need_b = [int(st[1 + offsets[b]: 1 + offsets[b + 1]].sum())
                  for b in range(len(bucket_pods))]
        it += 1
    it_t = torch.tensor(it, dtype=torch.int32, device=lead)
    if S == 1:
        return Megaround((claims[0], counts[0], status[1:], it_t))

    def join(parts):
        return torch.cat([t.to(lead) for t in parts], dim=1)

    return Megaround((join(claims), join(counts), status[1:], it_t))


#: a megaround on one CUDA device (its shards, on a mesh) is a graph
#: replay; a check that copies every launch's inputs (chip_smoke.py) sets
#: it False for the duration, and the fixed trip then launches one kernel
#: at a time
REPLAY = True


def graph_serves(devices: Sequence[torch.device]) -> bool:
    """Whether one megaround graph serves node shards on *devices*: a
    WHILE node's body may hold the work of one CUDA context only (no
    kernel or copy on another device), so all of them must be one
    device. A mesh over several devices keeps the host loop
    (``run_megaround_shards``)."""
    return len(set(devices)) == 1


class BodyBuffers(NamedTuple):
    """What one iteration writes on one shard besides the node state, the
    planes, the claims and the control words: the NIC headroom planes,
    each bucket's intermediate solve outputs, the plan and the joined
    plan, held so that the iteration allocates nothing (the WHILE body's
    capture has no allocator pool)."""

    free: Tuple[Tensor, Tensor]   # [Ns, U*K] float32 rx, tx
    solve: List[SolveBuffers]     # per bucket
    plan: Tensor                  # [7, Ns] int32
    joined: Tensor                # [7, Np] int32, one for every shard; the plan with one


def body_buffers(shards: Sequence[Sequence[Tensor]], pods: Sequence[PodTensors]
                 ) -> List[BodyBuffers]:
    """Empty ``BodyBuffers`` for each shard's node tensors (``_ARG_ORDER``)
    and the buckets' uploads *pods*; the shards share one joined plan."""
    f32 = torch.float32
    parts = []
    for node in shards:
        n = dict(zip(_ARG_ORDER, node))
        N, U, K = n["nic_free"].shape[:3]
        dev = n["nic_free"].device
        parts.append((
            (torch.zeros((N, U * K), dtype=f32, device=dev),
             torch.zeros((N, U * K), dtype=f32, device=dev)),
            [solve_buffers(int(pt.dem_rx.shape[0]), N, pt) for pt in pods],
            torch.zeros((7, N), dtype=torch.int32, device=dev),
        ))
    plan = parts[0][2]
    joined = plan if len(parts) == 1 else plan.new_zeros((7, len(parts) * plan.shape[1]))
    return [BodyBuffers(*part, joined) for part in parts]


def megaround_open(status: Tensor, offsets: Tensor, ctl: Tensor, claims: Tensor,
                   counts: Tensor, handle: int = 0) -> Optional[bool]:
    """Before the claim loop: the claim planes (each shard's [iters, Ns],
    stacked) reset, then ``spec_gate`` for the first iteration (setting
    *handle*, the WHILE node's, where it is not 0). ctl must start at
    (1, 0, ...) and status[0] at 1. Returns the gate's alive flag on the
    CPU, None on the card."""
    claims.fill_(-1)
    counts.zero_()
    return kernels.spec_gate(status, offsets, ctl, iters=claims.shape[-2],
                             handle=handle)


def megaround_iteration(
    shards: Sequence[Sequence[Tensor]],
    bucket_G: Sequence[int],
    pods: Sequence[PodTensors],
    tabs: Sequence[SpecTables],
    status: Tensor,
    offsets: Tensor,
    ctl: Tensor,
    claims: Sequence[Tensor],
    counts: Sequence[Tensor],
    body: Sequence[BodyBuffers],
    U: int,
    K: int,
    respect_busy: bool,
    sharing: bool,
    handle: int = 0,
) -> Optional[bool]:
    """One iteration of the claim loop over the node shards of one
    device, its control on the device: on each shard s (``shards[s]``:
    global rows [s*Ns, (s+1)*Ns) by ``_ARG_ORDER``; the mutable ones
    updated in place) the three solve kernels of every bucket into its
    planes (``tabs[s]``) and ``spec_elect``; the shards' plans copied
    side by side into the joined plan, one ``spec_fill`` over it, then on
    each shard its count row copied back and ``spec_apply`` into its
    claims and counts; then ``spec_gate`` for the next iteration (setting
    *handle* where it is not 0). One shard launches no copy. The shards
    share *status*, *offsets* and the gate words of *ctl* [B + 2],
    written by the gate before: a bucket with no need skips its solves,
    and where the loop is dead every kernel returns at once;
    ``spec_apply`` writes claim row ctl[1] - 1. Nothing here reads the
    device from the host or allocates (*body* holds the outputs), so it
    is the WHILE node's body as it stands. Returns the closing gate's
    alive flag on the CPU, None on the card."""
    alive = ctl[0:1]
    S = len(shards)
    Ns = int(body[0].plan.shape[1])
    named = [dict(zip(_ARG_ORDER, node)) for node in shards]
    plans = []
    for s, (node, n, tb, bb) in enumerate(zip(shards, named, tabs, body)):
        free = free_planes(node, bb.free)  # the iteration's headroom, for every bucket
        for b, (G, pt) in enumerate(zip(bucket_G, pods)):
            solve_planes(G, U, K, node, pt, out=tb.views[b],
                         gate=ctl[2 + b: 3 + b], free=free, bufs=bb.solve[b],
                         node_base=s * Ns, n_global=S * Ns)
        plans.append(kernels.spec_elect(
            tb.planes, tb.plane_off, tb.trow, n["smt"], n["cpu_free"],
            n["gpu_free"], n["hp_free"], n["nic_free"], tb.cpu_g, tb.cpu_m,
            tb.gpu_g, tb.nic_occ, status, alive, sharing=sharing,
            respect_busy=respect_busy, out=bb.plan,
        ))
    joined = body[0].joined
    if S > 1:
        for s, plan in enumerate(plans):
            joined[:, s * Ns: (s + 1) * Ns].copy_(plan)
    kernels.spec_fill(joined, status, alive)
    for s, (n, tb, plan) in enumerate(zip(named, tabs, plans)):
        if S > 1:
            plan[6].copy_(joined[6, s * Ns: (s + 1) * Ns])
        kernels.spec_apply(
            plan, tb.trow, n["smt"], n["nic_sw"], tb.cpu_g, tb.cpu_m,
            tb.gpu_g, tb.nic_occ, tb.gpu_uk, tb.nic_rx, tb.nic_tx,
            n["busy"], n["hp_free"], n["cpu_free"], n["gpu_free"],
            n["nic_free"], n["gpu_free_sw"], claims[s], counts[s], ctl[1:2],
            alive, sharing=sharing, respect_busy=respect_busy,
        )
    return kernels.spec_gate(status, offsets, ctl, iters=claims[0].shape[0],
                             handle=handle)


class Megaround(tuple):
    """A megaround's (claims [iters, Np], counts [iters, Np], need left
    [TT], iterations used as a scalar), with ``body``: the launches of one
    pass of its graph's WHILE node, which the replay could not count, to
    be counted once per iteration by whoever reads the iteration word
    (``kernels.count_passes``); empty where every launch was counted as
    it was made."""

    body: Dict[str, int]

    def __new__(cls, results: Sequence[Tensor], body: Optional[Dict[str, int]] = None):
        self = super().__new__(cls, results)
        self.body = dict(body or {})
        return self


def control_arrays(needs: Sequence[np.ndarray], shapes: Sequence[Tuple[int, int]]
                   ) -> Dict[str, np.ndarray]:
    """The part of a dispatch's table buffer that changes with the need:
    the status vector (progress 1, then the padded need), the bucket
    offsets and the control tensor's start (1, 0, ...)."""
    need0 = np.concatenate([
        _pad_rows_to(n.astype(np.int32), tp) for n, (_, tp) in zip(needs, shapes)
    ])
    ctl = np.zeros(len(shapes) + 2, np.int32)
    ctl[0] = 1
    return {
        "status": np.concatenate([[1], need0]).astype(np.int32),
        "offsets": np.cumsum([0] + [tp for _, tp in shapes]).astype(np.int32),
        "ctl": ctl,
    }


def trip_arrays(bucket_pods: Sequence, needs: Sequence[np.ndarray],
                shapes: Sequence[Tuple[int, int]], U: int, K: int, Np: int
                ) -> Dict[str, np.ndarray]:
    """Everything one dispatch writes into its graph's table buffer:
    ``control_arrays``, then ``table_arrays``."""
    return {**control_arrays(needs, shapes),
            **table_arrays(bucket_pods, shapes, U, K, Np)[1]}


def pods_digest(bucket_pods: Sequence) -> bytes:
    """A digest of the buckets' type rows: with the key's shapes, U, K
    and Np, ``table_arrays`` is a function of them alone."""
    h = hashlib.blake2b(digest_size=16)
    for pods in bucket_pods:
        h.update(f"G{pods.G}".encode())
        for name in _POD_ARG_ORDER:
            a = np.ascontiguousarray(getattr(pods, name))
            h.update(f"{name}{a.dtype.str}{a.shape}".encode())
            h.update(a.data)
    return h.digest()


class TableBuffer:
    """A megaround's per-dispatch inputs at fixed device addresses: one
    device byte buffer holding a typed view per input (``views[name]``,
    each at a 512-byte aligned offset), refilled from the host through
    one pinned staging buffer and one copy. On the CPU the views are
    filled in place."""

    ALIGN = 512

    def __init__(self, layout: Sequence[Tuple[str, str, Tuple[int, ...]]],
                 device: torch.device):
        places, at = [], 0
        for name, dtype, shape in layout:
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            places.append((name, np.dtype(dtype), shape, at, n))
            at += -(-n // self.ALIGN) * self.ALIGN
        self.device = device
        self.nbytes = max(at, self.ALIGN)
        self.dev = torch.zeros(self.nbytes, dtype=torch.uint8, device=device)
        self.host = (torch.zeros(self.dev.shape, dtype=torch.uint8, pin_memory=True)
                     if device.type == "cuda" else self.dev)
        raw = self.host.numpy()
        self.views: Dict[str, Tensor] = {}
        self._host: Dict[str, np.ndarray] = {}
        self._span = {name: (at, n) for name, _d, _s, at, n in places}
        for name, dtype, shape, at, n in places:
            tdt = torch.from_numpy(np.empty(0, dtype)).dtype
            self.views[name] = self.dev[at: at + n].view(tdt).view(shape)
            self._host[name] = raw[at: at + n].view(dtype).reshape(shape)
        self._copied = None  # the event after the last staging copy

    def fill(self, arrays: Dict[str, np.ndarray]) -> None:
        """Write *arrays* (names of the layout) into their views, in
        stream order after everything queued before: one copy of the
        span of the buffer they cover (the whole buffer when they are
        every name); the other views keep what they hold."""
        if self._copied is not None:
            # the previous copy has read the staging buffer: long done
            # wherever its dispatch's results were pulled
            self._copied.synchronize()  # nhdlint: ignore[NHD107]
        lo, hi = self.nbytes, 0
        for name, a in arrays.items():
            self._host[name][...] = a
            at, n = self._span[name]
            lo, hi = min(lo, at), max(hi, at + n)
        if self.host is not self.dev and hi > lo:
            self.dev[lo:hi].copy_(self.host[lo:hi], non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))


#: the host's parts of a graph dispatch, timed in ``MegaroundGraph.host_s``:
#: the key and digest, the table build (when the type rows changed), the
#: staging copy, the node tensors in, the replay's enqueue (the trip's
#: launches on the CPU) and the mutable tensors back with the results
DISPATCH_PARTS = ("key", "tables", "fill", "copy_in", "replay", "copy_out")

#: one capture at a time in the process: a capture must not meet another
#: thread's capture on the card
_CAPTURE_LOCK = threading.Lock()


def _graph_error(what: str, exc: BaseException) -> BaseException:
    """*exc*, from a capture or a replay, as a KernelLaunchError with the
    CUDA error code it carries (901, a stream capture invalidated, where
    it names none), so the solver guard classifies it as any launch."""
    from nhd_tpu_torch.kernels.build import KernelLaunchError

    if isinstance(exc, KernelLaunchError):
        return exc
    code = getattr(exc, "error_code", None)
    return KernelLaunchError(kernels.GRAPH, code if isinstance(code, int) else 901,
                             f"{what}: {exc}")


class MegaroundGraph:
    """One megaround at fixed shapes over the S node shards of one device
    (S = 1 without a mesh): its own copy of the node tensors (each
    [Np, ...], shard s a view of rows [s*Ns, (s+1)*Ns)), the table buffer
    (pod arrays, the hoisted tables at the shard width Ns, status,
    offsets, control), a plane buffer per shard and the claim planes
    ([S, iters, Ns]), all held here so their addresses never move, with
    each shard's intermediate outputs (``BodyBuffers``), and on CUDA the
    captured graph over them: ``megaround_open``, then a WHILE node whose
    body is one ``megaround_iteration`` over the shards, both gates
    setting the node's condition. A dispatch copies the caller's
    resident node tensors in, refills the table buffer, replays (with
    ``REPLAY`` off, issues the fixed trip launch by launch, ``trip``; on
    the CPU, ``loop``), copies the six mutable node tensors back and
    returns copies of the results. The graph bakes in no address of the
    caller's, so one capture serves every resident state of the key:
    each batch's own, each tile's, a rebuilt one's."""

    def __init__(self, shards: Sequence[Dict[str, Tensor]], bucket_G: Sequence[int],
                 shapes: Sequence[Tuple[int, int]], U: int, K: int,
                 iters: int, respect_busy: bool, sharing: bool,
                 layout: Sequence[Tuple[str, str, Tuple[int, ...]]]):
        first = shards[0]
        self.device = first["hp_free"].device
        S = len(shards)
        Ns = int(first["hp_free"].shape[0])
        self.node = {name: first[name].new_zeros((S * Ns, *first[name].shape[1:]))
                     for name in _ARG_ORDER}
        self.shards = [[self.node[name][s * Ns: (s + 1) * Ns] for name in _ARG_ORDER]
                       for s in range(S)]
        self.bucket_G = list(bucket_G)
        self.U, self.K = U, K
        self.respect_busy, self.sharing = respect_busy, sharing
        self.buf = TableBuffer(layout, self.device)
        v = self.buf.views
        self.tabs = []
        for _ in range(S):
            planes, views = plane_buffer(shapes, Ns, self.device)
            self.tabs.append(SpecTables(
                None, v["trow"], v["plane_off"], planes, views, v["cpu_g"],
                v["cpu_m"], v["gpu_g"], v["nic_occ"], v["gpu_uk"], v["nic_rx"],
                v["nic_tx"],
            ))
        self.pods = [
            PodTensors([v[f"{b}.{name}"] for name in _POD_ARG_ORDER],
                       v[f"{b}.dem_rx"], v[f"{b}.dem_tx"],
                       bucket_tables(G, U, K, self.device))
            for b, G in enumerate(self.bucket_G)
        ]
        i32 = torch.int32
        self.claims = torch.full((S, iters, Ns), -1, dtype=i32, device=self.device)
        self.counts = torch.zeros((S, iters, Ns), dtype=i32, device=self.device)
        self.body = body_buffers(self.shards, self.pods)
        self.lock = threading.Lock()
        self.graph = None
        #: the launches a replay makes before the WHILE node, and those of
        #: one pass of its body (``kernels.count_replay``/``count_passes``)
        self.tally: Dict[str, int] = {}
        self.body_tally: Dict[str, int] = {}
        #: host seconds of the warm-up and the capture (None until captured)
        self.capture_s: Optional[float] = None
        self.replays = 0
        #: host seconds of the dispatches by part (``DISPATCH_PARTS``)
        self.host_s = dict.fromkeys(DISPATCH_PARTS, 0.0)
        self.dispatches = 0
        self._done = None  # the event after the last dispatch's copies
        self._digest: Optional[bytes] = None  # the type rows the tables hold

    def open(self, handle: int = 0) -> Optional[bool]:
        v = self.buf.views
        return megaround_open(v["status"], v["offsets"], v["ctl"], self.claims,
                              self.counts, handle)

    def iteration(self, handle: int = 0) -> Optional[bool]:
        v = self.buf.views
        return megaround_iteration(
            self.shards, self.bucket_G, self.pods, self.tabs, v["status"],
            v["offsets"], v["ctl"], self.claims, self.counts, self.body,
            self.U, self.K, self.respect_busy, self.sharing, handle)

    def trip(self, passes: Optional[int] = None) -> None:
        """The fixed trip launch by launch: ``megaround_open`` and
        *passes* (default the depth) iterations, each closed by the gate
        that opens the next; after the exit every kernel returns at
        once."""
        self.open()
        for _ in range(self.claims.shape[1] if passes is None else passes):
            self.iteration()

    def loop(self) -> None:
        """The WHILE node's loop on the CPU: an iteration while the plain
        gate's alive flag (a CPU tensor's value) holds."""
        alive = self.open()
        while alive:
            alive = self.iteration()

    def capture(self) -> None:
        """Warm every launch once with the loop dead (each kernel and the
        helper load, and the kernels return; nothing is written but the
        claim planes' reset), then capture the graph on a side stream of
        its own, one capture at a time in the process: the resets and the
        first gate, a WHILE node on a conditional handle, its body (one
        iteration) captured once on a second stream. A failure raises
        KernelLaunchError: there is no other form to fall back to."""
        from nhd_tpu_torch.kernels import build

        t0 = time.perf_counter()
        self.buf.views["ctl"].zero_()
        self.trip(passes=1)
        build.load("graph_while")  # nhdlint: ignore[NHD104] memoized; once per capture
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        body = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()  # nhdlint: ignore[NHD104] once per cache entry
        try:
            with _CAPTURE_LOCK, torch.cuda.stream(side), capturing() as tally:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    handle = kernels.while_handle(side, dev)
                    self.open(handle)
                    kernels.while_open(side, handle, body, dev)
                    try:
                        with torch.cuda.stream(body), capturing() as body_tally:
                            self.iteration(handle)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            kernels.while_close(body, dev)
                        raise
                    kernels.while_close(body, dev)
                except BaseException:
                    # the capture ends either way; its own error (a graph
                    # left half built) must not hide the first one
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except Exception as exc:
            raise _graph_error("megaround capture", exc) from exc
        cur.wait_stream(side)
        self.graph, self.tally, self.body_tally = graph, dict(tally), dict(body_tally)
        self.capture_s = time.perf_counter() - t0

    def run(self, shards: Sequence[Dict[str, Tensor]], control: Dict[str, np.ndarray],
            digest: bytes, tables: Callable[[], Dict[str, np.ndarray]]
            ) -> Megaround:
        """One dispatch against the resident tensors of each shard
        *shards[s]* (updated in place), with the need in *control*
        (``control_arrays``) and the buckets' type rows of *digest*
        (``pods_digest``), whose tables *tables* builds: built and copied
        only when the digest differs from the last dispatch's (no kernel
        writes them). Returns (claims [iters, Np], counts [iters, Np], the
        shards' joined in shard order, need left [TT], iterations used as
        a scalar), device copies that the next dispatch does not touch,
        with the WHILE body's launches still to count
        (``Megaround.body``). Call under ``lock``."""
        cuda = self.device.type == "cuda"
        graph = cuda and REPLAY
        if graph and self.graph is None:
            self.capture()
        clock = [time.perf_counter()]

        def lap(part: str) -> None:
            clock.append(time.perf_counter())
            self.host_s[part] += clock[-1] - clock[-2]

        if cuda and self._done is not None:
            # the last dispatch's work is queued before this one's even
            # where its thread launched on another stream
            torch.cuda.current_stream(self.device).wait_event(self._done)
        if digest != self._digest:
            self._digest = None  # until the fill below is queued
            arrays = {**control, **tables()}
            lap("tables")
            self.buf.fill(arrays)
            self._digest = digest
        else:
            self.buf.fill(control)
        lap("fill")
        for node, held in zip(shards, self.shards):
            for name, t in zip(_ARG_ORDER, held):
                t.copy_(node[name])
        lap("copy_in")
        if graph:
            try:
                self.graph.replay()
            except Exception as exc:
                raise _graph_error("megaround replay", exc) from exc
            count_replay(self.tally)
            self.replays += 1
        elif cuda:
            self.trip()
        else:
            self.loop()
        lap("replay")
        for node, held in zip(shards, self.shards):
            held = dict(zip(_ARG_ORDER, held))
            for name in _MUTABLE:
                node[name].copy_(held[name])
        v = self.buf.views
        out = (torch.cat(tuple(self.claims), dim=1), torch.cat(tuple(self.counts), dim=1),
               v["status"][1:].clone(), v["ctl"][1].clone())
        if cuda:
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
        lap("copy_out")
        self.dispatches += 1
        return Megaround(out, self.body_tally if graph else None)


class MegaroundCache:
    """The process's megaround graphs, keyed by the bucket shapes, U, K,
    the shard count and a shard's node tensors' shapes and types (Ns
    among them), the depth, respect_busy, NIC sharing, the device and
    the layout of the table buffer; the least recently used goes past
    ``MAX_ENTRIES``. The
    threads that share a key (the streaming tiler's workers, each with
    its own tile's resident tensors) take its lock from filling its
    buffers to enqueuing its output copies."""

    MAX_ENTRIES = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, MegaroundGraph]" = (
            collections.OrderedDict())

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> List[MegaroundGraph]:
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def run(self, shards: Sequence[Dict[str, Tensor]], bucket_pods: Sequence,
            needs: Sequence[np.ndarray], U: int, K: int, iters: int,
            respect_busy: bool) -> Megaround:
        """The megaround against *shards* (the resident tensors by
        ``_ARG_ORDER`` name of each node shard of one device, in row
        order: one without a mesh; the mutable ones updated in place):
        ``run_megaround_shards``' results, from one replay of the key's
        graph."""
        from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING as sharing

        t0 = time.perf_counter()
        first = shards[0]
        device = first["hp_free"].device
        if not graph_serves([node["hp_free"].device for node in shards]):
            raise ValueError("one megaround graph serves the shards of one device")
        Ns = int(first["hp_free"].shape[0])
        shapes = _shapes(bucket_pods)
        control = control_arrays(needs, shapes)
        built: Dict[str, np.ndarray] = {}

        def tables() -> Dict[str, np.ndarray]:
            # at the shard width: the plane offsets index a shard's planes
            if not built:
                built.update(table_arrays(bucket_pods, shapes, U, K, Ns)[1])
            return built

        # the key decides the layout of the table buffer: the shapes, and
        # the types and trailing widths of the pods' arrays
        pod_types = tuple(
            tuple((np.asarray(getattr(pods, name)).dtype.str,
                   np.shape(getattr(pods, name))[1:]) for name in _POD_ARG_ORDER)
            for pods in bucket_pods)
        key = (tuple(shapes), U, K, iters, bool(respect_busy), bool(sharing),
               device, pod_types, len(shards),
               tuple((name, first[name].dtype, tuple(first[name].shape))
                     for name in _ARG_ORDER))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if len(self._entries) >= self.MAX_ENTRIES:
                    self._entries.popitem(last=False)
                layout = tuple((name, a.dtype.str, a.shape)
                               for name, a in {**control, **tables()}.items())
                entry = self._entries[key] = MegaroundGraph(
                    shards, [G for G, _ in shapes], shapes, U, K, iters,
                    respect_busy, bool(sharing), layout)
            self._entries.move_to_end(key)
        digest = pods_digest(bucket_pods)
        with entry.lock:
            entry.host_s["key"] += time.perf_counter() - t0
            return entry.run(shards, control, digest, tables)


def graph_stats() -> Dict[str, float]:
    """The process's megaround graphs in sum (``GRAPHS``, the entries it
    holds): entries, captures and their seconds, dispatches, replays and
    the host seconds of each dispatch part (``DISPATCH_PARTS``)."""
    entries = GRAPHS.entries()
    out = {"entries": len(entries),
           "captures": sum(e.capture_s is not None for e in entries),
           "capture_s": sum(e.capture_s or 0.0 for e in entries),
           "dispatches": sum(e.dispatches for e in entries),
           "replays": sum(e.replays for e in entries)}
    for part in DISPATCH_PARTS:
        out[f"{part}_s"] = sum(e.host_s[part] for e in entries)
    return out


#: the process's megaround graphs (``DeviceClusterState.megaround`` on
#: one device or a mesh of one device's shards, the prewarm)
GRAPHS = MegaroundCache()


def decode_claims_grouped(
    claims: np.ndarray,       # [iters, N] int32 packed words, -1 = none
    bucket_shapes: Sequence[Tuple[int, int]],
    bucket_keys: Sequence[int],
    U: int,
    K: int,
    counts: Optional[np.ndarray] = None,  # [iters, N] int32 copies, 0 = none
) -> Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]:
    """Unpack the device claim tensor into
    {bucket key: {local type: (nodes, c, m, a) arrays}} with array order =
    (iteration, node index) — the order speculative copies were made. A
    count-k claim (multi-copy) expands to k consecutive entries."""
    offsets = np.cumsum([0] + [tp for _, tp in bucket_shapes])
    a_width = np.concatenate([
        np.full(tp, get_tables(G, U, K).A, np.int64)
        for G, tp in bucket_shapes
    ])
    out: Dict[int, Dict[int, tuple]] = {gk: {} for gk in bucket_keys}
    its, nodes = np.nonzero(claims >= 0)   # row-major == (iter, node) order
    if not len(its):
        return out
    word = claims[its, nodes].astype(np.int64)
    cnt = (
        counts[its, nodes].astype(np.int64)
        if counts is not None
        else np.ones(len(its), np.int64)
    )
    tg = word >> _T_SHIFT
    rest = word & ((1 << _T_SHIFT) - 1)
    aw = a_width[tg]
    a = rest % aw
    cm = rest // aw
    c = cm // U
    m = cm % U
    # stable sort groups claims by global type, preserving (iter, node)
    # order within each type
    order = np.argsort(tg, kind="stable")
    tg_s = tg[order]
    cnt_s = cnt[order]
    # multi-copy expansion: k copies become k consecutive rows (pods of a
    # type consume them in order, so copy order within a claim is moot)
    nodes_s = np.repeat(nodes[order], cnt_s)
    c_s = np.repeat(c[order], cnt_s)
    m_s = np.repeat(m[order], cnt_s)
    a_s = np.repeat(a[order], cnt_s)
    tg_x = np.repeat(tg_s, cnt_s)
    uniq, starts = np.unique(tg_x, return_index=True)
    bounds = np.append(starts, len(tg_x))
    b_of = np.searchsorted(offsets, uniq, side="right") - 1
    for u, b, lo, hi in zip(uniq, b_of, bounds[:-1], bounds[1:]):
        t_local = int(u - offsets[b])
        out[bucket_keys[int(b)]][t_local] = (
            nodes_s[lo:hi], c_s[lo:hi], m_s[lo:hi], a_s[lo:hi]
        )
    return out


def decode_claims(
    claims: np.ndarray,
    bucket_shapes: Sequence[Tuple[int, int]],
    bucket_keys: Sequence[int],
    U: int,
    K: int,
    counts: Optional[np.ndarray] = None,
) -> Dict[int, Dict[int, List[Tuple[int, int, int, int]]]]:
    """decode_claims_grouped with per-claim tuple lists (test/debug API)."""
    grouped = decode_claims_grouped(
        claims, bucket_shapes, bucket_keys, U, K, counts
    )
    return {
        gk: {
            t: list(zip(n.tolist(), c.tolist(), m.tolist(), a.tolist()))
            for t, (n, c, m, a) in per.items()
        }
        for gk, per in grouped.items()
    }
