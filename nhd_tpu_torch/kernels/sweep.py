"""Random kernel inputs at the shapes where the kernels' index logic can break.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold ``nic_any_first``
and ``solve_planes`` against their plain versions, exactly, on every case
here; the CPU tests check that the cases cover what the comments claim.
Inputs are made with numpy from a seed, in each kernel's argument order.

``NIC_SWEEP`` rows are (T, N, U, K, C, A, fill): picks per combo A across
one and several 32-lane chunks (1, 7, 31, 32, 33, 49, 512), combos C from
1 to 8 so that combo ranges straddle chunks, T = 1, node counts that are
no multiple of a block's node tile, U*K of 16 and past 32, a combo larger
than 32 lanes x 8 warps (a warp takes a second chunk), U*K = 1000 (the
headroom read through L1) and picks that choose every slot (more than a
lane keeps in registers). ``fill`` "none" fits no pick, "all" every pick,
"dense" chooses every slot of every pick.

``PLANE_SWEEP`` rows are (T, N, U, G, C, NCLS, fill): C of 1, 2, 4, 8, not
a power of two, and past 32 (lanes loop over combos); "tie" gives every
combo the same skew (the first maximum must win), "none" leaves no combo
feasible (best_c 0, best_m still read at combo 0).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

NIC_SWEEP = (
    (1, 1021, 2, 8, 1, 1, "rand"),
    (2, 1021, 2, 8, 8, 1, "rand"),
    (3, 517, 2, 7, 2, 7, "rand"),
    (2, 333, 2, 8, 4, 31, "rand"),
    (2, 333, 2, 8, 2, 32, "rand"),
    (2, 333, 2, 8, 8, 33, "rand"),
    (3, 1021, 2, 7, 4, 49, "rand"),
    (2, 257, 2, 8, 8, 512, "rand"),
    (1, 1021, 2, 7, 4, 49, "none"),
    (1, 1021, 2, 7, 4, 49, "all"),
    (2, 99, 4, 10, 4, 33, "rand"),
    (2, 99, 2, 8, 2, 2000, "rand"),
    (2, 45, 1, 1000, 2, 3, "rand"),
    (2, 99, 2, 3, 2, 9, "dense"),
)

PLANE_SWEEP = (
    (1, 77, 2, 1, 1, 1, "rand"),
    (1, 1021, 2, 1, 2, 4, "rand"),
    (3, 1021, 2, 2, 4, 4, "rand"),
    (2, 1021, 2, 3, 8, 4, "rand"),
    (2, 333, 3, 2, 9, 4, "rand"),
    (2, 333, 2, 6, 64, 4, "rand"),
    (2, 517, 2, 2, 4, 4, "tie"),
    (2, 517, 2, 2, 4, 4, "none"),
)


def nic_case(seed: int, T: int, N: int, U: int, K: int, C: int, A: int,
             fill: str = "rand") -> Tuple[tuple, Dict[str, int]]:
    """(args, keywords) of ``nic_any_first``: every pick chooses 1 to 4
    slots, as a pick of the main path chooses one slot per group (every
    slot where *fill* is "dense")."""
    rng = np.random.default_rng(seed)
    UK, CA = U * K, C * A
    free_rx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    free_tx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    dem_rx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    dem_tx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    unchosen = np.ones((CA, UK), bool)
    rows = np.arange(CA)
    for _ in range(3):
        pick = rng.integers(0, UK, CA)
        unchosen[rows, pick] &= rng.random(CA) < 0.5
    unchosen[rows, rng.integers(0, UK, CA)] = False
    if fill == "dense":
        unchosen[:] = False
        dem_rx *= 0.25
        dem_tx *= 0.25
    dem_rx[:, unchosen] = 0.0
    dem_tx[:, unchosen] = 0.0
    valid = rng.random((N, CA)) < 0.8
    pci_ok = rng.random((N, CA)) < 0.7
    map_pci = rng.random(T) < 0.5
    if fill == "none":
        valid[:] = False
    elif fill == "all":
        valid[:] = True
        pci_ok[:] = True
        free_rx[:] = 100.0
        free_tx[:] = 100.0
    args = (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci)
    return args, dict(U=U, K=K, C=C, A=A)


def plane_case(seed: int, T: int, N: int, U: int, G: int, C: int, NCLS: int,
               fill: str = "rand") -> tuple:
    """The 24 arguments of ``solve_planes`` (node rows, type rows, combo
    tables, NIC planes)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    combo = rng.integers(0, U, (C, G)).astype(i32)
    maxdig = (combo.max(1) if G else np.zeros(C)).astype(i32)
    skew = rng.integers(0, 3, C).astype(i32)
    if fill == "tie":
        skew[:] = 1
    gpu_dem = rng.integers(0, 2, (T, G)).astype(i32)
    nic_any = rng.random((T, N, C)) < 0.8
    if fill == "none":
        nic_any[:] = False
    return (
        rng.integers(1, U + 1, N).astype(np.int8),     # numa_nodes
        rng.random(N) < 0.7,                            # smt
        rng.random(N) < 0.95,                           # active
        rng.random(N) < 0.03,                           # maintenance
        rng.random(N) < 0.1,                            # busy
        rng.random(N) < 0.2,                            # gpuless
        rng.integers(1, 4, N).astype(np.int64),         # node_gmask
        rng.integers(0, 257, N).astype(i32),            # hp_free
        rng.integers(0, 33, (N, U)).astype(i32),        # cpu_free
        rng.integers(0, 5, (N, U)).astype(i32),         # gpu_free
        rng.integers(-1, NCLS + 1, N).astype(i32),      # node_class
        rng.integers(0, 7, (T, G + 1)).astype(i32),     # cpu_dem_smt
        rng.integers(0, 9, (T, G + 1)).astype(i32),     # cpu_dem_raw
        gpu_dem,
        rng.integers(0, 9, T).astype(i32),              # hp
        gpu_dem.sum(1) > 0,                             # needs_gpu
        rng.integers(1, 4, T).astype(np.int64),         # pod_gmask
        rng.integers(0, 4, (T, NCLS)).astype(i32),      # class_score
        combo, maxdig, skew,
        nic_any,
        rng.integers(0, 50, (T, N, C)).astype(i32),     # first_a
        rng.integers(0, 50, (T, N, C)).astype(i32),     # n_picks
    )
