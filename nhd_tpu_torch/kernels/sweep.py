"""Random kernel inputs at the shapes where the kernels' index logic can break.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold ``nic_node_masks``,
``nic_any_first``, ``solve_planes`` and the megaround's claim kernels
against their plain versions, exactly, on every case here; the CPU tests
check that the cases cover what the comments claim. Inputs are made with
numpy from a seed, in each kernel's argument order.

``NODE_SWEEP`` rows are (N, U, K, S, G, C, A, fill) of ``nic_node_masks``:
G from 1 to 4 and one past 4 (the kernel's wider slot table), C*A of 1,
of 4096 (16 chunks of lanes) and not a multiple of 4 or 32, U past the 4
need entries a lane keeps in registers, U*K past 32, node counts that
leave a ragged last strip, and U*K = 13000 (a node's switch row past 48 KB
of shared memory, read from global memory). ``fill`` "oob" puts switch
ids outside [-S, S) (the check fails), "onesw" puts every present NIC
on one switch (share = G), "neg" makes gpu_free_sw entries negative often (the
node fails every pick); every case has switch id -1 (the wrap to S-1).

``SPEC_SWEEP`` rows are (N, U, K, S, buckets, sharing, respect_busy, fill)
of the claim kernels, ``buckets`` a tuple of (Tp, C, A): one and several
buckets of different C and C*A (the tables' padded axes), node counts
past one and several fill tiles of 256, both NIC-sharing branches and
both busy rules, more than 32 global type rows (a lane of spec_elect takes
a second row), U*K = 36 (a warp of spec_apply takes its slots in two
steps, a NUMA node's segment straddling them) and 2000 switches (fewer
warps a block of spec_apply, to fit their switch sums in 48 KB). ``fill`` "tie" gives every
eligible row of a node the same key (the lowest row must win, across the
32-row lane wrap too), "none" leaves every third node no candidate row
(every eighth in the other fills but "rand"), "multi" asks for many copies of small demand on single-copy-free rows with
half the NICs absent, so nodes take k > 1 copies and some take a copy whose
NIC consumption exceeds their NUMA node's free NICs.

``NIC_SWEEP`` rows are (T, N, U, K, C, A, fill): picks per combo A across
one and several 32-lane chunks (1, 7, 31, 32, 33, 49, 512), combos C from
1 to 8 so that combo ranges straddle chunks, T = 1, node counts that are
no multiple of a block's node tile, U*K of 16 and past 32, a combo larger
than 32 lanes x 8 warps (a warp takes a second chunk), U*K = 1000 (the
headroom read through L1) and picks that choose every slot (more than a
lane keeps in registers). ``fill`` "none" fits no pick, "all" every pick,
"dense" chooses every slot of every pick.

``FILL_SWEEP`` rows are (TT, N, fill) of ``spec_fill`` alone, its plan
rows and need drawn directly (``fill_case``), which reaches shapes the
elect-fed ``SPEC_SWEEP`` does not: N under one warp, ragged int4 tails
(N not a multiple of 4), one whole 1024-node tile, one node past it and
many tiles (a running carry), TT of 1, 16 and 48. ``fill`` "every" has
row 0 elect every node; "hi", "lo" and "interleave" make every winner
pref 2, pref 1, or alternate along each row's winners; "exact", "below"
and "above" set each row's need to its sum of capw, one below it, or far
above it; "fair1" keeps need under the winner count (fair = 1); "cap0"
zeroes cap (capw 1); "nowin" gives every odd row need and no winner;
"dead" gives every even row need 0 though nodes elect it; "unelected"
leaves nine nodes in ten with elect -1; "rand" draws need freely, a
quarter of the rows 0.

``RANK_SWEEP`` rows are (T, N, U, R, S, node_base, fill) of ``rank_top``
on [8, T, N] planes, and of ``rank_merge`` on the candidates of S shards
of N / S rows each (``rank_case``): R = 1, R = N, R above the count of
positive sel values (the val-0 slots take the lowest-index zero nodes),
N = 8, N no multiple of 32 (a ragged last chunk), 3 shards (M no power
of two), node_base > 0. The regimes of rank_select.cuh: N = 1,024, the
whole-row register sort's largest row (R = N, ties), and N = 1,025, the
smallest wide row (unaligned: staged by the per-thread loop; M = 1,025
for the merge of 5 shards); in the wide regime the tiler's 16,384-row
tile, 40,000 (still staged) and 65,536 (read from device memory); keys
equal to the threshold past one 1,024-key chunk of the ordered pass
(k_eq > 1,024: N = 8,192, R = 2,048); the list of winners above it at
1,024 and past (R = 2,048 at N = 16,384; 5,000 sorted in shared memory,
or a few hundred in registers beside a list region sized for 5,000);
R = 20,000 (a list past shared memory, in the type row's output rows:
"dense" sorted there, "sparse" sorted in registers); R = 36,000 (the
tail's positions past shared memory too, in output row 6); every type
row all padding at N = 4,096 (no sort). ``fill`` "sparse" makes a tenth of
the nodes candidates, "dense" every node, "zero" none (all-zero rows),
"pad" zeroes the upper half of the type rows (the main path's padded
types), "ties" draws arbitrary int32 keys from a small range, negatives
included (ties at every value, which sel never has), "span" 200 values
drawn across the whole int32 range (a whole row too wide for 32-bit
words: the 64-bit sort).

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

NODE_SWEEP = (
    (1021, 2, 7, 14, 1, 2, 7, "rand"),
    (1021, 2, 7, 14, 2, 4, 49, "rand"),
    (1023, 2, 7, 14, 2, 4, 49, "neg"),
    (517, 2, 2, 4, 3, 3, 7, "rand"),
    (517, 2, 8, 16, 4, 5, 13, "rand"),
    (1021, 2, 2, 4, 1, 1, 1, "rand"),
    (1021, 2, 8, 16, 3, 8, 512, "rand"),
    (99, 4, 10, 40, 2, 3, 33, "oob"),
    (257, 2, 3, 6, 3, 2, 9, "onesw"),
    (45, 5, 3, 15, 6, 7, 11, "rand"),
    (37, 1, 13000, 8, 2, 1, 3, "rand"),
)

SPEC_SWEEP = (
    (77, 2, 3, 6, ((8, 2, 3),), False, False, "rand"),
    (1021, 2, 7, 14, ((4, 2, 7), (8, 4, 49)), False, False, "rand"),
    (1021, 2, 7, 14, ((4, 2, 7), (8, 4, 49)), True, False, "rand"),
    (300, 2, 2, 4, ((2, 2, 2), (4, 4, 4), (2, 8, 8)), False, True, "rand"),
    (513, 4, 3, 12, ((8, 4, 3), (4, 16, 9)), True, True, "rand"),
    (300, 2, 7, 14, ((16, 2, 7), (16, 4, 49), (8, 2, 2)), False, False, "none"),
    (300, 2, 7, 14, ((32, 2, 7), (8, 4, 49)), False, True, "tie"),
    (333, 2, 7, 14, ((8, 2, 7), (8, 4, 49)), False, False, "none"),
    (333, 2, 3, 6, ((8, 2, 3), (4, 4, 9)), False, False, "multi"),
    (257, 4, 9, 12, ((8, 2, 9), (4, 4, 81)), False, False, "multi"),
    (257, 4, 9, 12, ((8, 2, 9),), True, True, "rand"),
    (33, 2, 3, 2000, ((4, 2, 3),), False, False, "none"),
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

FILL_SWEEP = (
    (1, 1, "every"),
    (1, 31, "hi"),
    (16, 31, "unelected"),
    (16, 255, "lo"),
    (16, 255, "nowin"),
    (16, 1023, "interleave"),
    (48, 1023, "dead"),
    (16, 1024, "exact"),
    (16, 1024, "below"),
    (48, 1024, "rand"),
    (16, 1025, "above"),
    (16, 1025, "cap0"),
    (1, 1025, "below"),
    (48, 4097, "fair1"),
    (16, 4097, "exact"),
    (1, 65537, "every"),
    (48, 65537, "interleave"),
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


def node_case(seed: int, N: int, U: int, K: int, S: int, G: int, C: int,
              A: int, fill: str = "rand") -> tuple:
    """The 6 arguments of ``nic_node_masks``: NIC counts, switch ids (some
    -1, the absent NIC), per-switch free GPUs, the combo and pick tables
    and the per-(combo, pick) NIC need."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    nic_count = rng.integers(0, K + 1, (N, U)).astype(i32)
    nic_sw = rng.integers(-1, S, (N, U, K)).astype(i32)
    if fill == "oob":
        wild = rng.random((N, U, K)) < 0.1
        nic_sw[wild] = rng.choice([S, S + 3, -S - 1, -S - 4], int(wild.sum()))
    elif fill == "onesw":
        nic_sw[nic_sw >= 0] = rng.integers(0, S)
    gpu_free_sw = rng.integers(0, G + 2, (N, S)).astype(i32)
    neg = rng.random((N, S)) < (0.2 if fill == "neg" else 0.002)
    neg[rng.integers(0, N), rng.integers(0, S)] = True
    gpu_free_sw[neg] = -1
    combo = rng.integers(0, U, (C, G)).astype(i32)
    pick = rng.integers(0, K, (A, G)).astype(i32)
    need_max = rng.integers(0, min(K, 3) + 1, (C, A, U)).astype(i32)
    return nic_count, nic_sw, gpu_free_sw, combo, pick, need_max


def spec_case(seed: int, N: int, U: int, K: int, S: int, buckets, sharing: bool,
              respect_busy: bool, fill: str = "rand") -> Dict[str, object]:
    """One megaround iteration's inputs for the claim kernels, by argument
    name, laid out as solver/speculate.py lays them out: each bucket's
    [8, Tp, N] solve planes back to back in one flat buffer (cand, pref,
    best c/m/a random, some c/m/a out of range so the kernels clamp),
    the hoisted demand tables over the global type axis padded to the
    largest C and C*A, the node state on the request grid (integer cpu,
    gpu and hugepages; NIC headroom on a 0.5 Gbps grid, -1 where absent)
    and the status vector (progress, then every type row's need, some 0).
    Also ``it``, the claim row, and ``step`` = [it + 1], the word
    ``spec_apply`` reads it from. *fill* as the ``SPEC_SWEEP`` notes say;
    "rand" draws nothing more."""
    rng = np.random.default_rng(seed)
    i32, f32 = np.int32, np.float32
    TT = sum(tp for tp, _, _ in buckets)
    CM = max(c for _, c, _ in buckets)
    CAM = max(c * a for _, c, a in buckets)
    UK = U * K
    planes, plane_off, trow = [], np.zeros((TT, 2), np.int64), np.zeros((TT, 4), i32)
    base = row = 0
    for tp, c, a in buckets:
        pl = np.zeros((8, tp, N), i32)
        pl[1] = rng.random((tp, N)) < 0.4                         # cand
        pl[2] = np.where(pl[1] != 0, rng.integers(1, 3, (tp, N)), 0)  # pref
        pl[3] = rng.integers(-1, c + 1, (tp, N))                  # best_c
        pl[4] = rng.integers(0, U + 1, (tp, N))                   # best_m
        pl[5] = rng.integers(0, a + 1, (tp, N))                   # best_a
        if fill == "tie":  # one pref per node: a node's eligible keys tie
            pl[1] = rng.random((tp, N)) < 0.7
            pl[2] = np.where(pl[1] != 0, 1 + np.arange(N) % 2, 0)
        if fill != "rand":  # nodes with no candidate row
            pl[1:3, :, :: 3 if fill == "none" else 8] = 0
        planes.append(pl.ravel())
        plane_off[row:row + tp, 0] = base + np.arange(tp) * N
        plane_off[row:row + tp, 1] = tp * N
        flags = rng.integers(0, 8, tp)
        trow[row:row + tp] = np.stack(
            [np.full(tp, a), np.full(tp, c), flags, rng.integers(0, 3, tp)], 1)
        base += 8 * tp * N
        row += tp
    need = rng.integers(0, 40, TT)
    need[rng.random(TT) < 0.25] = 0
    nic_free = (rng.integers(0, 200, (N, U, K, 2)) * 0.5).astype(f32)
    nic_free[rng.random((N, U, K)) < 0.2] = -1.0
    occ = rng.integers(0, 3, (TT, CAM, U)).astype(f32)
    case = dict(
        planes=np.concatenate(planes), plane_off=plane_off, trow=trow,
        smt=rng.random(N) < 0.7,
        cpu_free=rng.integers(-2, 40, (N, U)).astype(i32),
        gpu_free=rng.integers(0, 5, (N, U)).astype(i32),
        hp_free=rng.integers(0, 65, N).astype(i32),
        nic_free=nic_free,
        cpu_g=rng.integers(0, 6, (2, TT, CM, U)).astype(f32),
        cpu_m=rng.integers(0, 2, (2, TT, U, U)).astype(f32),
        gpu_g=rng.integers(0, 2, (TT, CM, U)).astype(f32),
        nic_occ=occ,
        gpu_uk=rng.integers(0, 2, (TT, CAM, UK)).astype(f32),
        nic_rx=(rng.integers(0, 40, (TT, CAM, UK)) * 0.5).astype(f32),
        nic_tx=(rng.integers(0, 20, (TT, CAM, UK)) * 0.5).astype(f32),
        nic_sw=rng.integers(-1, S, (N, U, K)).astype(i32),
        busy=rng.random(N) < 0.1,
        gpu_free_sw=rng.integers(0, 4, (N, S)).astype(i32),
        status=np.concatenate([[1], need]).astype(i32),
        claims=np.full((4, N), -1, i32),
        counts=np.zeros((4, N), i32),
        gate=np.ones(1, i32),
        it=int(rng.integers(0, 4)), sharing=sharing, respect_busy=respect_busy,
    )
    case["step"] = np.array([case["it"] + 1], i32)
    if fill == "tie":
        case["status"][1:] = np.where(need > 0, 17, 0)
    elif fill == "multi":
        # no single-copy flag, small cpu demand, no gpu or hugepage demand:
        # NICs bound the capacity, and half of them are absent
        trow[:, 2:] = 0
        case["status"][1:] = rng.integers(100, 400, TT)
        case["cpu_free"] += 40
        case["cpu_g"] = rng.integers(0, 2, (2, TT, CM, U)).astype(f32)
        case["gpu_g"][:] = 0.0
        nic_free[rng.random((N, U, K)) < 0.5] = -1.0
        case["nic_occ"] = rng.integers(1, 3, (TT, CAM, U)).astype(f32)
    return case


def fill_sums(cap1: np.ndarray, need: np.ndarray) -> np.ndarray:
    """sum(capw) of one row whose winners have max(cap, 1) = *cap1*, at
    each need in *need* (capw = min(max(cap, 1), ceil(need / n_win)))."""
    fair = -(-np.asarray(need) // len(cap1))
    return np.minimum(cap1[None, :], fair[:, None]).sum(1)


def _need_at(cap1: np.ndarray, above: int) -> int:
    """The largest need >= 1 with sum(capw) == need + *above* (the least
    is n_win - above, where every capw is 1). It exists for above = 0,
    and for above = 1 once the row has two winners: from need 1 (sum
    n_win) the gap sum - need falls by exactly 1 a step, or rises."""
    needs = np.arange(1, int(cap1.sum()) + 2)
    hit = np.flatnonzero(fill_sums(cap1, needs) == needs + above)
    return int(needs[hit[-1]])


def fill_case(seed: int, TT: int, N: int, fill: str = "rand") -> Tuple[np.ndarray, np.ndarray]:
    """(plan [7, N] int32, status [TT + 1] int32) of ``spec_fill``: elect
    in [-1, TT), hi, cap in [0, 8) and each row's need as *fill* says (the
    ``FILL_SWEEP`` notes), c/m/a random and the count row 0, as spec_elect
    leaves it; status[0] 0, as spec_elect clears it."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    elect = rng.integers(-1, TT, N)
    if fill == "every":
        elect[:] = 0
    elif fill == "unelected":
        elect[rng.random(N) < 0.9] = -1
    elif fill == "nowin":
        elect[(elect >= 0) & (elect % 2 == 1)] -= 1
    hi = (rng.random(N) < 0.5).astype(i32)
    if fill in ("hi", "lo"):
        hi[:] = fill == "hi"
    elif fill == "interleave":
        for t in range(TT):
            at = np.flatnonzero(elect == t)
            hi[at] = (np.arange(len(at)) + t) % 2 == 0
    cap = rng.integers(0, 8, N)
    if fill == "cap0":
        cap[:] = 0
    need = np.zeros(TT, np.int64)
    for t in range(TT):
        cap1 = np.maximum(cap[elect == t], 1)
        n_win = len(cap1)
        top = int(cap1.sum()) if n_win else 8
        need[t] = rng.integers(0, 2 * top + 6)
        if fill == "rand" and rng.random() < 0.25:
            need[t] = 0
        elif fill == "nowin" and t % 2 == 1:
            need[t] = rng.integers(1, 40)
        elif fill == "dead" and t % 2 == 0:
            need[t] = 0
        elif not n_win:
            continue
        elif fill == "exact":
            need[t] = _need_at(cap1, 0)
        elif fill == "below":
            need[t] = _need_at(cap1, 1 if n_win > 1 else 0)
        elif fill == "above":
            need[t] = 1_000_000 + top
        elif fill == "fair1":
            need[t] = rng.integers(1, n_win) if n_win > 1 else 1
    plan = np.stack([
        elect, hi, cap, rng.integers(0, 4, N), rng.integers(0, 2, N),
        rng.integers(0, 8, N), np.zeros(N, np.int64),
    ]).astype(i32)
    return plan, np.concatenate([[0], need]).astype(i32)


#: argument names of the claim kernels, in their wrappers' order
SPEC_ELECT_ARGS = ("planes", "plane_off", "trow", "smt", "cpu_free", "gpu_free",
                   "hp_free", "nic_free", "cpu_g", "cpu_m", "gpu_g", "nic_occ",
                   "status", "gate")
SPEC_APPLY_ARGS = ("trow", "smt", "nic_sw", "cpu_g", "cpu_m", "gpu_g", "nic_occ",
                   "gpu_uk", "nic_rx", "nic_tx", "busy", "hp_free", "cpu_free",
                   "gpu_free", "nic_free", "gpu_free_sw", "claims", "counts",
                   "step", "gate")

#: (TT, B, fill) of ``spec_gate``: one row and one bucket; rows that are
#: no multiple of the 256-thread block, and past it and past four of it
#: (a thread sums rows of several buckets); more buckets than rows of a
#: thread's stride, and buckets of one row. ``fill`` "rand" draws need
#: and flags, "dead" starts the loop dead (ctl[0] 0), "stalled" has no
#: progress (status[0] 0), "spent" has no need left, "one" need in the
#: last bucket only, "neg" negative entries (a bucket is live on its sum,
#: not on any row) and "big" needs near 2^31 (the sums are 64-bit).
GATE_SWEEP = (
    (1, 1, "rand"), (7, 3, "rand"), (256, 2, "rand"), (257, 5, "rand"),
    (1023, 64, "rand"), (1023, 1023, "rand"), (48, 4, "dead"),
    (48, 4, "stalled"), (48, 4, "spent"), (600, 9, "one"), (300, 6, "neg"),
    (512, 3, "big"),
)


def gate_case(seed: int, TT: int, B: int, fill: str = "rand"
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(status [TT + 1], offsets [B + 1], ctl [B + 2]) of ``spec_gate``,
    int32: B buckets of at least one row each over TT rows, need and
    flags as *fill* says (the ``GATE_SWEEP`` notes)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, TT), B - 1, replace=False)) if B > 1 else []
    offsets = np.concatenate([[0], cuts, [TT]]).astype(np.int32)
    need = rng.integers(0, 5, TT) * (rng.random(TT) < 0.3)
    progress = int(rng.random() < 0.8)
    ctl = np.concatenate([[1, rng.integers(0, 16)], rng.integers(0, 2, B)])
    if fill == "dead":
        ctl[0] = 0
    elif fill == "stalled":
        progress = 0
    elif fill == "spent":
        need[:] = 0
    elif fill == "one":
        need[:] = 0
        need[offsets[-2]:] = rng.integers(1, 3, TT - offsets[-2])
    elif fill == "neg":
        need = rng.integers(-3, 4, TT)
        progress = 1
    elif fill == "big":
        need = rng.integers(2**30, 2**31 - 1, TT)
        progress = 1
    status = np.concatenate([[progress], need]).astype(np.int32)
    return status, offsets, ctl.astype(np.int32)


#: the caps each ``GATE_SWEEP`` case runs at, against its ctl[1]: "at"
#: (the cap binds: the loop is dead whatever the need), "above" (one
#: iteration left) and "far"
GATE_CAPS = ("at", "above", "far")


def gate_iters(ctl: np.ndarray, cap: str) -> int:
    """``spec_gate``'s ``iters`` for the control tensor *ctl* at *cap*
    (``GATE_CAPS``); at least 1, as the launcher requires."""
    used = int(ctl[1])
    return {"at": max(used, 1), "above": used + 1, "far": 1 << 20}[cap]


#: (T, N, U, R, S, node_base, fill) of ``rank_top`` and ``rank_merge``
RANK_SWEEP = (
    (1, 8, 1, 1, 1, 0, "sparse"),
    (4, 8, 2, 8, 2, 0, "dense"),
    (8, 1024, 2, 512, 4, 0, "sparse"),
    (8, 1024, 2, 512, 4, 0, "dense"),
    (4, 1024, 2, 512, 1, 0, "zero"),
    (8, 1024, 2, 64, 2, 4096, "pad"),
    (3, 999, 2, 37, 3, 5, "ties"),
    (5, 3000, 3, 300, 3, 0, "ties"),
    (8, 16384, 2, 512, 4, 0, "sparse"),
    (2, 40000, 2, 512, 5, 0, "dense"),
    (2, 65536, 2, 512, 8, 0, "sparse"),
    (2, 2048, 2, 1024, 2, 0, "dense"),
    (2, 1500, 1, 1025, 3, 0, "sparse"),
    (2, 6000, 1, 5000, 2, 0, "dense"),
    (2, 1024, 2, 1024, 1, 0, "ties"),
    (3, 1025, 2, 1025, 5, 0, "dense"),
    (4, 1025, 3, 600, 1, 3, "sparse"),
    (2, 8192, 2, 2048, 2, 0, "sparse"),
    (8, 16384, 2, 2048, 4, 0, "sparse"),
    (8, 4096, 2, 512, 2, 0, "zero"),
    (2, 6000, 1, 5000, 2, 0, "sparse"),
    (1, 40000, 1, 20000, 2, 0, "sparse"),
    (1, 40000, 1, 20000, 2, 0, "dense"),
    (4, 1000, 2, 300, 2, 0, "span"),
    (1, 40000, 1, 36000, 2, 0, "sparse"),
)


#: rank_select.cuh's limits: the whole-row sort's longest row, the
#: register sort's longest list, the bytes of a list in shared memory
RANK_WHOLE_MAX, RANK_REG_SORT_MAX, RANK_LIST_BYTES = 1024, 4096, 128 * 1024


def rank_path(n: int, R: int, above: int) -> str:
    """The path of rank_select.cuh that ranks a row of *n* keys at width
    *R* with *above* keys above its threshold: "whole" (n <= 1,024), or
    in the wide regime "wide none" (no key above: nothing sorted), "wide
    registers" or "wide shared" (the list in shared memory, sorted in
    registers or in memory), "wide rows registers" or "wide rows memory"
    (the list in the type row's output rows)."""
    if n <= RANK_WHOLE_MAX:
        return "whole"
    if above == 0:
        return "wide none"
    pr = 1 << (R - 1).bit_length()
    rows = pr > RANK_REG_SORT_MAX and pr * 8 > RANK_LIST_BYTES
    if 1 << (above - 1).bit_length() <= RANK_REG_SORT_MAX:
        sort = "registers"
    else:
        sort = "memory" if rows else "shared"
    return ("wide rows " if rows else "wide ") + sort


def rank_words(n: int, span: int) -> int:
    """The word width rank_select.cuh sorts a row of *n* keys in, *span*
    being its largest key less its smallest: 32 bits where a whole row
    (n <= 1,024) leaves log2(P) bits below the key for the position (P,
    the block's words: the power of two at or above n, 64 at least), 64
    otherwise and in every wide row."""
    if n > RANK_WHOLE_MAX:
        return 64
    pbits = max(6, max(n - 1, 0).bit_length())
    return 32 if span >> (32 - pbits) == 0 else 64


def rank_case(seed: int, T: int, N: int, U: int, R: int, S: int,
              node_base: int = 0, fill: str = "sparse") -> dict:
    """``rank_top``'s inputs (planes [8, T, N], gpu_free and cpu_free
    [N, U], hp_free [N], int32), its R and node_base, and ``rank_merge``'s
    candidates: each of S shards of N / S rows ranked on its own (its top
    min(R, N / S), indices global), joined in shard order, as ``cand``
    [9, T, S * k], with the merge's R. sel is the solve's: at a candidate
    (score * 3 + pref) * (N + 1) + (N - n), else 0 (the ``RANK_SWEEP``
    notes)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    n = np.arange(N)
    if fill == "dense":
        cand = np.ones((T, N), bool)
    elif fill == "zero":
        cand = np.zeros((T, N), bool)
    else:
        cand = rng.random((T, N)) < 0.1
    if fill == "pad":
        cand[(T + 1) // 2:] = False
    pref = rng.integers(1, 3, (T, N)) + 3 * rng.integers(0, 4, (T, N))
    sel = np.where(cand, pref * (N + 1) + (N - n)[None, :], 0)
    if fill == "ties":
        sel = rng.integers(-3, 4, (T, N))
    elif fill == "span":
        sel = rng.choice(rng.integers(-2**31, 2**31 - 1, 200), (T, N))
    planes = np.stack([
        sel, cand, pref * cand, rng.integers(0, 8, (T, N)),
        rng.integers(0, 4, (T, N)), rng.integers(0, 64, (T, N)),
        rng.integers(0, 9, (T, N)), rng.integers(0, 64, (T, N)),
    ]).astype(i32)
    free = dict(
        gpu_free=rng.integers(0, 5, (N, U)).astype(i32),
        cpu_free=rng.integers(0, 65, (N, U)).astype(i32),
        hp_free=rng.integers(0, 257, N).astype(i32),
    )
    Ns = N // S
    k = min(R, Ns)
    parts = [np_rank(planes[:, :, s * Ns:(s + 1) * Ns],
                      *(f[s * Ns:(s + 1) * Ns] for f in free.values()),
                      k, s * Ns) for s in range(S)]
    return dict(planes=planes, **free, R=R, node_base=node_base,
                cand=np.concatenate(parts, axis=2), merge_R=min(R, S * k))


def np_rank(planes, gpu_free, cpu_free, hp_free, R, node_base):
    """The packed [9, T, R] rank tensor of one solve's planes and free
    arrays in numpy: a stable argsort on the negated sel keys."""
    idx = np.argsort(-planes[0].astype(np.int64), axis=1, kind="stable")[:, :R]

    def gat(p):
        return np.take_along_axis(planes[p], idx, axis=1)

    return np.stack([
        gat(0), idx + node_base, gat(3), gat(4), gat(5), gat(7),
        gpu_free.sum(1)[idx], cpu_free.sum(1)[idx], hp_free[idx],
    ]).astype(np.int32)
