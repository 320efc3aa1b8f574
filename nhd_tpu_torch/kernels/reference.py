"""Plain PyTorch versions of the port's CUDA kernels.

One function per kernel, same arguments and outputs, written with
broadcast tensor ops. The CPU path and the tests run these; on the card
``chip_smoke.py`` holds each kernel against its plain version on the same
inputs. Where the reference takes an argmax, these take ``argmax`` of an
integer cast, which returns the FIRST maximum as ``jnp.argmax`` does
(``torch.argmax`` rejects bool).

The NIC stage loops over the U*K slots the way the TPU kernel unrolled
them, so its largest temporary is [T, N, C*A], never [T, N, C*A, U*K].
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

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
) -> Tuple[Tensor, Tensor]:
    """(valid, pci_ok), each [N, C*A] bool (kernel.py:136-160 of the
    reference)."""
    N, U = nic_count.shape
    S = gpu_free_sw.shape[1]
    C, G = combo.shape
    A = pick.shape[0]
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
    *, U: int, K: int, C: int, A: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(nic_any [T, N, C] bool, first_a [T, N, C] int32, n_picks [T, N, C]
    int32) — attic/nic_pallas.py nic_any_first."""
    T, N = dem_rx.shape[0], free_rx.shape[0]
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
    nic_any, first_a, n_picks,
) -> Tensor:
    """[8, T, N] int32 planes in PLANES order (kernel.py:41-204 minus the
    NIC stage, plus _policy_pref and the rank's sel value)."""
    T, N, C = nic_any.shape
    U = cpu_free.shape[1]
    G = combo.shape[1]
    dev = nic_any.device
    i32 = torch.int32
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
    nidx = torch.arange(N, device=dev, dtype=i32)
    sel = torch.where(
        cand, (pref + 3 * score) * (N + 1) + (N - nidx)[None, :], 0
    )
    return torch.stack([
        sel.to(i32), cand.to(i32), pref, best_c.to(i32), best_m.to(i32),
        best_a.to(i32), n_combos, picks.to(i32),
    ])
