"""Plain PyTorch versions of the port's CUDA kernels.

One function per kernel, same arguments and outputs, written with
broadcast tensor ops. The CPU path and the tests run these; on the card
``chip_smoke.py`` holds each kernel against its plain version on the same
inputs. Where the reference takes an argmax, these take ``argmax`` of an
integer cast, which returns the FIRST maximum as ``jnp.argmax`` does
(``torch.argmax`` rejects bool).

The NIC stage loops over the U*K slots the way the TPU kernel unrolled
them, so its largest temporary is [T, N, C*A], never [T, N, C*A, U*K].

Each takes the kernel's ``gate`` word (``abi.py``; None reads as 1) and
honours it as the kernel does: a gate of 0 writes nothing in place, and
an output the kernel would leave unwritten comes back as zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

def _dead(gate: Optional[Tensor]) -> bool:
    """A gate word of 0: the kernel returns at once."""
    return gate is not None and int(gate[0]) == 0


#: solve_planes output rows, in order
PLANES = (
    "sel", "cand", "pref", "best_c", "best_m", "best_a", "n_combos", "n_picks",
)


def nic_node_masks(
    nic_count: Tensor,    # [N, U] int32
    nic_sw: Tensor,       # [N, U, K] int32, -1 = no NIC
    gpu_free_sw: Tensor,  # [N, S] int32
    combo: Tensor,        # [C, G] int32
    pick: Tensor,         # [A, G] int32
    need_max: Tensor,     # [C, A, U] int32
    gate: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(valid, pci_ok), each [N, C*A] bool (kernel.py:136-160 of the
    reference)."""
    N, U = nic_count.shape
    S = gpu_free_sw.shape[1]
    C, G = combo.shape
    A = pick.shape[0]
    if _dead(gate):
        zero = torch.zeros((N, C * A), dtype=torch.bool, device=nic_count.device)
        return zero, zero.clone()
    valid = (need_max[None] <= nic_count[:, None, None, :]).all(-1)  # [N,C,A]
    u_idx = combo.long()[:, None, :].expand(C, A, G)
    k_idx = pick.long()[None, :, :].expand(C, A, G)
    sw_at = nic_sw[:, u_idx, k_idx]  # [N, C, A, G]
    share = (sw_at[..., :, None] == sw_at[..., None, :]).sum(-1)
    idx = torch.where(sw_at < 0, sw_at + S, sw_at).long()
    in_range = (idx >= 0) & (idx < S)
    free_at = torch.gather(
        gpu_free_sw, 1, idx.clamp(0, S - 1).reshape(N, -1)
    ).reshape(sw_at.shape)
    nonneg = (gpu_free_sw >= 0).all(-1)
    pci_ok = (in_range & (share <= free_at)).all(-1) & nonneg[:, None, None]
    return valid.reshape(N, C * A), pci_ok.reshape(N, C * A)


def nic_any_first(
    free_rx: Tensor,   # [N, U*K] float32, -1 = absent
    free_tx: Tensor,
    dem_rx: Tensor,    # [T, C*A, U*K] float32
    dem_tx: Tensor,
    unchosen: Tensor,  # [C*A, U*K] bool
    valid: Tensor,     # [N, C*A] bool
    pci_ok: Tensor,    # [N, C*A] bool
    map_pci: Tensor,   # [T] bool or int
    gate: Optional[Tensor] = None,
    *, U: int, K: int, C: int, A: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(nic_any [T, N, C] bool, first_a [T, N, C] int32, n_picks [T, N, C]
    int32) — attic/nic_pallas.py nic_any_first."""
    T, N = dem_rx.shape[0], free_rx.shape[0]
    if _dead(gate):
        zero = torch.zeros((T, N, C), dtype=torch.int32, device=free_rx.device)
        return zero.bool(), zero, zero.clone()
    pci = map_pci != 0
    fit = valid[None] & (pci_ok[None] | ~pci[:, None, None])  # [T, N, CA]
    for uk in range(U * K):
        ok = (dem_rx[:, None, :, uk] <= free_rx[None, :, None, uk]) & (
            dem_tx[:, None, :, uk] <= free_tx[None, :, None, uk]
        )
        fit &= unchosen[None, None, :, uk] | ok
    fit3 = fit.reshape(T, N, C, A)
    return (
        fit3.any(-1),
        fit3.to(torch.uint8).argmax(-1).to(torch.int32),
        fit3.sum(-1, dtype=torch.int32),
    )


def solve_planes(
    numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
    hp_free, cpu_free, gpu_free, node_class,
    cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
    class_score,
    combo, maxdig, skew,
    nic_any, first_a, n_picks, gate=None,
    *, node_base: int = 0, n_global: Optional[int] = None,
) -> Tensor:
    """[8, T, N] int32 planes in PLANES order (kernel.py:41-204 minus the
    NIC stage, plus _policy_pref and the rank's sel value). The N nodes
    are rows [node_base, node_base + N) of a node axis of *n_global*
    (default N) padded rows: sel ranks them by their global index, as the
    unsharded solve does."""
    T, N, C = nic_any.shape
    U = cpu_free.shape[1]
    G = combo.shape[1]
    dev = nic_any.device
    i32 = torch.int32
    if _dead(gate):
        return torch.zeros((len(PLANES), T, N), dtype=i32, device=dev)
    onehot = (
        combo.long()[:, :, None] == torch.arange(U, device=dev)
    ).to(i32)  # [C, G, U]
    node_ok = (
        active[None]
        & ~maintenance[None]
        & (hp[:, None] <= hp_free[None])
        & ((pod_gmask[:, None] & node_gmask[None]) != 0)
        & (~needs_gpu[:, None] | ~busy[None])
    )  # [T, N]
    combo_valid = maxdig[None, :] < numa_nodes.to(i32)[:, None]  # [N, C]
    gpu_need = (gpu_dem[:, None, :, None] * onehot[None]).sum(2)  # [T, C, U]
    gpu_ok = (gpu_need[:, None] <= gpu_free[None, :, None, :]).all(-1)
    eye = torch.eye(U, dtype=i32, device=dev)

    def cpu_fit(dem):  # dem [T, G+1] -> [T, N, C, M]
        group = (dem[:, None, :G, None] * onehot[None]).sum(2)  # [T, C, U]
        misc = dem[:, G][:, None, None] * eye[None]  # [T, M, U]
        total = group[:, :, None, :] + misc[:, None, :, :]  # [T, C, M, U]
        return (total[:, None] <= cpu_free[None, :, None, None, :]).all(-1)

    cpu_ok = torch.where(
        smt[None, :, None, None], cpu_fit(cpu_dem_smt), cpu_fit(cpu_dem_raw)
    )
    feasible = (
        node_ok[:, :, None] & combo_valid[None] & gpu_ok & cpu_ok.any(-1)
        & nic_any
    )  # [T, N, C]
    cand = feasible.any(-1)
    n_combos = feasible.sum(-1, dtype=i32)
    cidx = torch.arange(C, device=dev, dtype=i32)
    combo_val = torch.where(
        feasible, skew[None, None, :] * (C + 1) + (C - cidx)[None, None, :], -1
    )
    best_c = combo_val.argmax(-1)  # [T, N] int64, first maximum
    bc = best_c[:, :, None]
    best_m = torch.gather(
        cpu_ok, 2, bc[..., None].expand(T, N, 1, U)
    )[:, :, 0, :].to(torch.uint8).argmax(-1)
    best_a = torch.gather(first_a, 2, bc)[..., 0]
    picks = torch.gather(n_picks, 2, bc)[..., 0]
    pref = torch.where(
        cand, 1 + (~needs_gpu[:, None] & gpuless[None]).to(i32), 0
    ).to(i32)
    cls = node_class.long().clamp(0, class_score.shape[1] - 1)
    score = class_score[:, cls]  # [T, N]
    NG = N if n_global is None else n_global
    nidx = node_base + torch.arange(N, device=dev, dtype=i32)
    sel = torch.where(
        cand, (pref + 3 * score) * (NG + 1) + (NG - nidx)[None, :], 0
    )
    return torch.stack([
        sel.to(i32), cand.to(i32), pref, best_c.to(i32), best_m.to(i32),
        best_a.to(i32), n_combos, picks.to(i32),
    ])


# ---- the speculative megaround's claim kernels (nhd_tpu/solver/speculate.py
# :301-531), one function per kernel over the megaround's global type axis.
# The kernels update the caller's tensors in place (the reference donated
# them); so do these.

#: rows of the per-node plan written by spec_elect (and, for "count", by
#: spec_fill). A node with no eligible type has elect -1 and zeros.
PLAN = ("elect", "hi", "cap", "c", "m", "a", "count")
#: columns of the per-type row table: the bucket's pick width A and combo
#: count C, the flag bits below, hugepages per pod
TROW = ("A", "C", "flags", "hp")
FLAG_NEEDS_GPU, FLAG_MAP_PCI, FLAG_HAS_NIC = 1, 2, 4
_INF = float(1 << 20)
_T_SHIFT = 21


def _plane_rows(planes: Tensor, plane_off: Tensor, N: int):
    """(row base [TT, N] int64, plane stride [TT, 1]) into the flat plane
    buffer: plane p of global type t at node n is planes[base + p*stride]."""
    n_idx = torch.arange(N, device=planes.device, dtype=torch.int64)
    return plane_off[:, :1] + n_idx[None, :], plane_off[:, 1:2]


def _elected_rows(trow, plan, cpu_g, cpu_m, gpu_g, nic_occ, smt, U):
    """The per-node demand rows at each node's (elect, c, m, a), the
    reference's bucket-merged gathers (speculate.py:339-376), clipped as
    it clips them. Nodes with elect -1 read type row 0."""
    t = plan[0].clamp(min=0).long()
    A_t, C_t = trow[t, 0].long(), trow[t, 1].long()
    zero = torch.zeros_like(t)
    cb = torch.minimum(torch.maximum(plan[3].long(), zero), C_t - 1)
    mb = plan[4].long().clamp(0, U - 1)
    ab = torch.minimum(torch.maximum(plan[5].long(), zero), A_t - 1)
    ca = cb * A_t + ab
    s = (~smt).long()  # 0: the SMT demand, 1: the raw one
    cpu_dem = cpu_g[s, t, cb] + cpu_m[s, t, mb]   # [N, U]
    return t, ca, cpu_dem, gpu_g[t, cb], nic_occ[t, ca]


def _div_min_u(free_u: Tensor, dem_u: Tensor) -> Tensor:
    per_u = torch.where(
        dem_u > 0,
        torch.floor(free_u / torch.clamp(dem_u, min=1e-6)),
        torch.full_like(dem_u, _INF),
    )
    return per_u.min(dim=1).values


def spec_elect(
    planes, plane_off, trow, smt, cpu_free, gpu_free, hp_free, nic_free,
    cpu_g, cpu_m, gpu_g, nic_occ, status, gate=None, *, sharing: bool,
    respect_busy: bool,
) -> Tensor:
    """The election and the capacity (speculate.py:301-404): [7, N] int32
    in PLAN order. Clears the progress flag status[0]."""
    N, U = cpu_free.shape
    i32 = torch.int32
    if _dead(gate):
        return torch.zeros((len(PLAN), N), dtype=i32, device=planes.device)
    need = status[1:]
    rows, ps = _plane_rows(planes, plane_off, N)
    cand = planes[rows + ps] != 0
    pref = planes[rows + 2 * ps]
    elig = cand & (need > 0)[:, None]
    key = torch.where(
        elig, pref * (1 << 24) + need.clamp(max=1 << 20)[:, None],
        torch.full_like(pref, -1),
    )
    elect = key.argmax(0)             # first maximum, as jnp.argmax
    has = elig.any(0)
    n_idx = torch.arange(N, device=planes.device)
    at = rows[elect, n_idx]
    stride = ps[elect, 0]
    c, m, a = (planes[at + p * stride] for p in (3, 4, 5))
    hi = (planes[at + 2 * stride] == 2).to(i32)
    plan = torch.stack([elect.to(i32), hi, torch.zeros_like(hi), c, m, a,
                        torch.zeros_like(hi)])
    t, _ca, cpu_dem, gpu_dem, occ = _elected_rows(
        trow, plan, cpu_g, cpu_m, gpu_g, nic_occ, smt, U)
    cap = _div_min_u(cpu_free.float(), cpu_dem)
    cap = torch.minimum(cap, _div_min_u(gpu_free.float(), gpu_dem))
    if not sharing:
        free_nic = (nic_free[..., 0] > 0).float().sum(2)  # [N, U]
        cap = torch.minimum(cap, _div_min_u(free_nic, occ))
    hp_t = trow[t, 3].float()
    cap = torch.minimum(cap, torch.where(
        hp_t > 0, torch.floor(hp_free.float() / torch.clamp(hp_t, min=1e-6)),
        torch.full_like(hp_t, _INF),
    ))
    flags = trow[t, 2]
    one = (flags & FLAG_MAP_PCI) != 0
    if respect_busy:
        one |= (flags & FLAG_NEEDS_GPU) != 0
    if sharing:
        one |= (flags & FLAG_HAS_NIC) != 0
    cap = torch.where(one, torch.clamp(cap, max=1.0), cap)
    plan[2] = torch.clamp(cap, min=0.0).to(i32)
    plan = torch.where(has[None], plan, torch.zeros_like(plan))
    plan[0] = torch.where(has, elect.to(i32), torch.full_like(plan[0], -1))
    status[0] = 0
    return plan


def spec_fill(plan: Tensor, status: Tensor, gate: Optional[Tensor] = None) -> None:
    """The balanced fill (speculate.py:406-448, 529): each type's copies
    go to its elected nodes at ceil(need / winners) each, pref-2 winners by
    node index first, then pref-1 winners. Writes plan's count row,
    subtracts the takes from the need (status[1:]) and sets the progress
    flag status[0] when anything was taken."""
    if _dead(gate):
        return
    TT, N = status.shape[0] - 1, plan.shape[1]
    i32 = torch.int32
    need = status[1:]
    win = plan[0][None, :] == torch.arange(TT, device=plan.device, dtype=i32)[:, None]
    n_win = win.sum(1, dtype=i32).clamp(min=1)
    fair = torch.div(need + n_win - 1, n_win, rounding_mode="floor")
    zero = torch.zeros((), dtype=i32, device=plan.device)
    capw = torch.where(
        win, torch.minimum(plan[2].clamp(min=1)[None, :], fair[:, None]), zero)
    hi = win & (plan[1] != 0)[None, :]
    cap_hi = torch.where(hi, capw, zero)
    cap_lo = torch.where(win & ~hi, capw, zero)
    prefix_hi = torch.cumsum(cap_hi, 1, dtype=i32) - cap_hi
    prefix_lo = (cap_hi.sum(1, keepdim=True, dtype=i32)
                 + torch.cumsum(cap_lo, 1, dtype=i32) - cap_lo)
    prefix = torch.where(hi, prefix_hi, prefix_lo)
    take = torch.where(
        win, torch.minimum(torch.clamp(need[:, None] - prefix, min=0), capw), zero)
    plan[6] = take.max(0).values
    taken = take.sum(1, dtype=i32)
    status[1:] = need - taken
    if bool((taken > 0).any()):
        status[0] = 1


def spec_apply(
    plan, trow, smt, nic_sw, cpu_g, cpu_m, gpu_g, nic_occ, gpu_uk, nic_rx,
    nic_tx, busy, hp_free, cpu_free, gpu_free, nic_free, gpu_free_sw,
    claims, counts, step, gate=None, *, sharing: bool, respect_busy: bool,
) -> None:
    """The claim deltas and the claim record (speculate.py:448-527) for the
    nodes that took copies: cpu, gpu and hugepages, NIC bandwidth (sharing
    on) or the lowest free NICs zeroed (sharing off), the per-switch GPUs
    through nic_sw, busy; the packed claim word and the count go to row
    step[0] - 1 of claims and counts (a row outside them: nothing). Every
    float step is the reference's: f32 arithmetic, then a truncating cast
    back."""
    it = int(step[0]) - 1
    if _dead(gate) or not 0 <= it < claims.shape[0]:
        return
    U = cpu_free.shape[1]
    K = nic_sw.shape[2]
    S = gpu_free_sw.shape[1]
    taken = (plan[0] >= 0) & (plan[6] > 0)
    ns = taken.nonzero().flatten()
    if ns.numel() == 0:
        return
    p = plan[:, ns]
    t, ca, cpu_dem, gpu_dem, occ = _elected_rows(
        trow, p, cpu_g, cpu_m, gpu_g, nic_occ, smt[ns], U)
    kf = p[6].float()
    i32 = torch.int32
    cpu_free[ns] = (cpu_free[ns].float() - kf[:, None] * cpu_dem).to(i32)
    gpu_free[ns] = (gpu_free[ns].float() - kf[:, None] * gpu_dem).to(i32)
    hp_free[ns] = hp_free[ns] - (kf * trow[t, 3].float()).to(i32)
    nf = nic_free[ns].reshape(len(ns), U * K, 2)
    if sharing:
        nf[..., 0] = nf[..., 0] - kf[:, None] * nic_rx[t, ca]
        nf[..., 1] = nf[..., 1] - kf[:, None] * nic_tx[t, ca]
        nic_free[ns] = nf.reshape(len(ns), U, K, 2)
    else:
        cur = nic_free[ns]
        unocc = cur[..., 0] > 0                                  # [n, U, K]
        used = unocc & (
            torch.cumsum(unocc.to(i32), 2) <= (kf[:, None] * occ)[..., None]
        )
        nic_free[ns] = torch.where(used[..., None], torch.zeros_like(cur), cur)
    guk = kf[:, None] * gpu_uk[t, ca]                            # [n, U*K]
    onehot = (nic_sw[ns].reshape(len(ns), U * K)[..., None]
              == torch.arange(S, device=nic_sw.device)).float()
    sw_delta = (guk[..., None] * onehot).sum(1)                  # [n, S]
    gpu_free_sw[ns] = (gpu_free_sw[ns].float() - sw_delta).to(i32)
    if respect_busy:
        busy[ns] = True
    word = t.to(i32) * (1 << _T_SHIFT) + (p[3] * U + p[4]) * trow[t, 0] + p[5]
    claims[it, ns] = word
    counts[it, ns] = p[6]


def spec_gate(status: Tensor, offsets: Tensor, ctl: Tensor, *, iters: int,
              handle: int = 0) -> bool:
    """The megaround's loop condition (spec_gate.cu; the reference's
    while-loop cond, speculate.py:533-535, and its per-bucket skip,
    :286-289), written into *ctl* [B + 2] from the progress flag
    status[0], the need status[1:] and the buckets' first rows *offsets*
    [B + 1]: ctl[0] = ctl[0] and status[0] and sum(need) > 0 and
    ctl[1] < iters (alive), ctl[1] += alive, ctl[2 + b] = alive and
    bucket b's need sum > 0. Returns alive, the value the kernel sets its
    graph's conditional *handle* to (no graph here: the handle is not
    read), so a loop on the CPU can stop where the WHILE node stops."""
    need = status[1:].long()
    TT, B = need.shape[0], offsets.shape[0] - 1
    rows = torch.arange(TT, device=status.device)
    bucket = torch.searchsorted(offsets[1:].long(), rows, right=True)
    per = torch.zeros(B, dtype=torch.int64, device=status.device)
    per.index_add_(0, bucket, need)
    alive = (ctl[0] != 0) & (status[0] != 0) & (per.sum() > 0) & (ctl[1] < iters)
    ctl[1] += alive.to(ctl.dtype)
    ctl[2:] = ((per > 0) & alive).to(ctl.dtype)
    ctl[0] = alive.to(ctl.dtype)
    return bool(alive)


def _top(key: Tensor, R: int) -> Tuple[Tensor, Tensor]:
    """The top *R* of each row of *key* [T, M] as (values, positions):
    values descending, equal values in ascending position (lax.top_k's
    order), by a stable descending sort."""
    val, pos = torch.sort(key, dim=1, descending=True, stable=True)
    return val[:, :R], pos[:, :R]


def rank_top(
    planes: Tensor,    # [8, T, N] int32, PLANES order
    gpu_free: Tensor,  # [N, U] int32
    cpu_free: Tensor,  # [N, U] int32
    hp_free: Tensor,   # [N] int32
    gate: Optional[Tensor] = None,
    *, R: int, node_base: int = 0,
) -> Tensor:
    """The packed [9, T, R] int32 rank tensor (rank_top.cu; the
    reference's _rank_body, nhd_tpu/solver/kernel.py:297-317, in RankOut
    order): per type row the top R of the sel plane (ties in ascending
    node index), the decision planes at the winners, the winners' free
    GPU, CPU and hugepage totals, and the winners' indices plus
    *node_base* (a mesh shard's first global row)."""
    T = planes.shape[1]
    if _dead(gate):
        return torch.zeros((9, T, R), dtype=torch.int32, device=planes.device)
    val, idx = _top(planes[PLANES.index("sel")], R)
    i32 = torch.int32

    def gat(name):
        return torch.gather(planes[PLANES.index(name)], 1, idx)

    return torch.stack([
        val, (idx + node_base).to(i32), gat("best_c"), gat("best_m"),
        gat("best_a"), gat("n_picks"),
        gpu_free[idx].sum(-1, dtype=i32), cpu_free[idx].sum(-1, dtype=i32),
        hp_free[idx].to(i32),
    ])


def rank_merge(cand: Tensor, gate: Optional[Tensor] = None, *, R: int) -> Tensor:
    """The packed [9, T, R] int32 rank tensor from a mesh's candidates
    [9, T, M] (rank_merge.cu; the top-R across shards that the
    reference's node-sharded program leaves to GSPMD): per type row the
    top R of row 0 (ties in ascending position), all nine rows of each
    winner carried with it."""
    T = cand.shape[1]
    if _dead(gate):
        return torch.zeros((9, T, R), dtype=torch.int32, device=cand.device)
    _, pos = _top(cand[0], R)
    return torch.gather(cand, 2, pos.unsqueeze(0).expand(cand.shape[0], -1, -1))
