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

The reference runs the loop as one ``lax.while_loop``. Here it is a host
loop of at most ``spec_iters()`` iterations: per iteration the three
solve kernels for each live bucket (nhd_tpu_torch/kernels), then the
three claim kernels ``spec_elect``, ``spec_fill`` and ``spec_apply``,
then ONE small pull of the status vector (the progress flag and the need
of every type row). The loop stops where the reference's ``cond`` stops
it and skips a bucket with no need where its ``lax.cond`` does, so the
iteration count and the claims are the reference's. The per-bucket
demand projections are hoisted out of the loop into tables over the
global type axis, as the reference hoists them (speculate.py:176-248).
The claim kernels update the resident node tensors in place.

On a node mesh (parallel/sharding.py) the loop body is per node except
the balanced fill, which takes each type's winner count and its
exclusive scans over all nodes, and the need and progress flag, which
are global: GSPMD placed those collectives for the reference. Here each
iteration runs the three solve kernels and ``spec_elect`` on every shard
(each reading its own copy of the status vector), joins the shards'
plans into one [7, Np] plan on the lead device, runs ONE ``spec_fill``
over it with the lead status, copies each shard's slice of the count row
back and the status out to the shards, and runs ``spec_apply`` per
shard: exact by construction, with ``spec_fill`` unchanged. The claim
words and counts of the shards join in shard order into the [iters, Np]
layout ``decode_claims*`` reads.

Claim word (one int32, -1 = no claim):
    word = t_global * 2^21 + (c * U + m) * A_bucket(t) + a
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels.reference import (
    FLAG_HAS_NIC,
    FLAG_MAP_PCI,
    FLAG_NEEDS_GPU,
)
from nhd_tpu_torch.solver.combos import get_tables
from nhd_tpu_torch.solver.device_state import HostPull
from nhd_tpu_torch.solver.kernel import (
    _ARG_ORDER,
    _POD_ARG_ORDER,
    PodTensors,
    _pad_rows_to,
    bucket_tables,
    solve_planes,
    to_device,
)

Tensor = torch.Tensor

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


def spec_tables(bucket_pods: Sequence, pod_tensors: Sequence[PodTensors],
                U: int, K: int, Np: int, device: torch.device) -> SpecTables:
    """Build the hoisted tables (speculate.py:176-248 of the reference):
    every entry is an integer or a sum of bandwidths on the request grid,
    so the float32 values are the reference's einsums exactly."""
    f32 = np.float32
    shapes = [(p.G, int(pt.dem_rx.shape[0])) for p, pt in zip(bucket_pods, pod_tensors)]
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
    base = 0
    for b, (pods, tb, (G, Tp)) in enumerate(zip(bucket_pods, tabs, shapes)):
        lo = int(offsets[b])
        rows = slice(lo, lo + Tp)
        host = {name: _pad_rows_to(getattr(pods, name), Tp) for name in _POD_ARG_ORDER}
        C, A = tb.C, tb.A
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
        slot = bucket_tables(G, U, K, device).slot     # [C*A, G] u*K + k
        ca_rows = np.arange(C * A)
        occ = np.zeros((Tp, C * A, UK), f32)
        guk = np.zeros((Tp, C * A, UK), f32)
        for g in range(G):
            # each pick chooses ONE slot per group: no repeated index
            occ[:, ca_rows, slot[:, g]] += needs_nic[:, g].astype(f32)[:, None]
            guk[:, ca_rows, slot[:, g]] += (gpu_dem[:, g] * map_pci)[:, None]
        nic_occ[rows, : C * A] = (occ > 0).reshape(Tp, C * A, U, K).sum(-1)
        gpu_uk[rows, : C * A] = guk
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

    planes, views = plane_buffer(shapes, Np, device)

    def pad_slots(t: Tensor, C: int, A: int) -> Tensor:
        out = torch.zeros((t.shape[0], CAM, UK), dtype=t.dtype, device=device)
        out[:, : C * A] = t
        return out

    nic_rx = torch.cat([pad_slots(pt.dem_rx, tb.C, tb.A) for pt, tb in zip(pod_tensors, tabs)])
    nic_tx = torch.cat([pad_slots(pt.dem_tx, tb.C, tb.A) for pt, tb in zip(pod_tensors, tabs)])
    up = lambda a: to_device(a, device)  # noqa: E731
    return SpecTables(
        offsets, up(trow), up(plane_off), planes, views, up(cpu_g), up(cpu_m),
        up(gpu_g), up(nic_occ), up(gpu_uk), nic_rx, nic_tx,
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
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
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
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
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
                claims[s], counts[s], it=it, sharing=sharing,
                respect_busy=respect_busy,
            )
        st = HostPull(status, into=pinned).numpy()
        progress = bool(st[0])
        need_b = [int(st[1 + offsets[b]: 1 + offsets[b + 1]].sum())
                  for b in range(len(bucket_pods))]
        it += 1
    it_t = torch.tensor(it, dtype=torch.int32, device=lead)
    if S == 1:
        return claims[0], counts[0], status[1:], it_t

    def join(parts):
        return torch.cat([t.to(lead) for t in parts], dim=1)

    return join(claims), join(counts), status[1:], it_t


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
