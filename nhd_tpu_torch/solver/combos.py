"""Static combination tables for the batched solver.

The reference enumerates NUMA assignments with itertools.product per pod per
node per call (Matcher.py:118,203,242). Here the enumeration happens once,
as dense numpy tables indexed by a *combo axis*, shared by every pod/node of
a bucket — the solve becomes tensor algebra over that axis.

Orderings are load-bearing: combo index c encodes the per-slot NUMA digits
base-NUMA with slot 0 most significant, i.e. exactly itertools.product
order (row-major, last slot fastest). NIC pick index a does the same base
MAX_NIC. "First feasible" tie-breaks in the oracle therefore translate to
argmax/argmin over these axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class ComboTables:
    """All static tables for a (n_groups, n_numa, max_nic) bucket."""

    G: int          # groups per pod in this bucket
    U: int          # NUMA nodes (padded max)
    K: int          # max NICs per NUMA node
    C: int          # U**G NUMA combos
    A: int          # K**G NIC pick combos

    combo: np.ndarray        # [C, G] int8 — NUMA of each group
    combo_onehot: np.ndarray  # [C, G, U] float32
    combo_maxdig: np.ndarray  # [C] int8 — max NUMA digit (node-numa validity)
    skew: np.ndarray          # [C] int32 — max-min of per-NUMA group counts
    misc_onehot: np.ndarray   # [U, U] float32 — misc-slot NUMA choice
    pick: np.ndarray          # [A, G] int8 — NIC ordinal of each group
    choose_onehot: np.ndarray  # [C, A, G, U, K] float32 — 1 iff group g uses (u,k)
    chosen_cnt: np.ndarray    # [C, A, U, K] float32 — groups sharing NIC (u,k)
    need_max: np.ndarray      # [C, A, U] int32 — NICs needed per NUMA (max ordinal+1)


def _digits(n: int, base: int, width: int) -> np.ndarray:
    """[n? no: base**width, width] digit table, slot 0 most significant."""
    idx = np.arange(base**width, dtype=np.int64)
    out = np.zeros((base**width, width), dtype=np.int8)
    for slot in range(width):
        shift = base ** (width - 1 - slot)
        out[:, slot] = (idx // shift) % base
    return out


@lru_cache(maxsize=None)
def get_tables(n_groups: int, n_numa: int, max_nic: int) -> ComboTables:
    G, U, K = n_groups, n_numa, max(max_nic, 1)
    C, A = U**G, K**G

    combo = _digits(C, U, G) if G > 0 else np.zeros((1, 0), np.int8)
    pick = _digits(A, K, G) if G > 0 else np.zeros((1, 0), np.int8)

    combo_onehot = np.zeros((C, G, U), np.float32)
    for c in range(C):
        for g in range(G):
            combo_onehot[c, g, combo[c, g]] = 1.0

    combo_maxdig = (
        combo.max(axis=1).astype(np.int8) if G > 0 else np.zeros((C,), np.int8)
    )

    # packing skew of a combo: max-min of per-NUMA group counts
    # (reference node_delta, Matcher.py:428-431)
    counts = combo_onehot.sum(axis=1)  # [C, U]
    skew = (counts.max(axis=1) - counts.min(axis=1)).astype(np.int32)

    misc_onehot = np.eye(U, dtype=np.float32)

    choose_onehot = np.zeros((C, A, G, U, K), np.float32)
    for c in range(C):
        for a in range(A):
            for g in range(G):
                choose_onehot[c, a, g, combo[c, g], pick[a, g]] = 1.0
    chosen_cnt = choose_onehot.sum(axis=2)  # [C, A, U, K]

    # NICs a pick needs to exist per NUMA: max chosen ordinal + 1
    need_max = np.zeros((C, A, U), np.int32)
    for c in range(C):
        for a in range(A):
            for g in range(G):
                u = combo[c, g]
                need_max[c, a, u] = max(need_max[c, a, u], int(pick[a, g]) + 1)

    return ComboTables(
        G=G, U=U, K=K, C=C, A=A,
        combo=combo, combo_onehot=combo_onehot, combo_maxdig=combo_maxdig,
        skew=skew, misc_onehot=misc_onehot, pick=pick,
        choose_onehot=choose_onehot, chosen_cnt=chosen_cnt, need_max=need_max,
    )
