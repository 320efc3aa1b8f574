"""The oracle-compatible front door of the batched solve.

The counterpart of the reference's nhd_tpu/solver/jax_matcher.py: the
same contract as OracleMatcher.find_node, with the feasibility solve run
as the port's kernels over a whole pending batch at once. Selection
mirrors the oracle for a single pod: preferred node (CPU-only pod on a
GPU-less node) first, then the first candidate in node order; the
skew-maximal combo, first wins; the first feasible misc NUMA and NIC pick.
"""

from __future__ import annotations

from functools import lru_cache
from types import MappingProxyType
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode, PodTopology
from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.solver.combos import get_tables
from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
from nhd_tpu_torch.solver.kernel import bucket_tractable, solve_bucket
from nhd_tpu_torch.solver.oracle import MatchResult
from nhd_tpu_torch.solver.oracle import find_node as oracle_find_node


@lru_cache(maxsize=65536)
def decode_mapping(G: int, U: int, K: int, c: int, m: int, a: int):
    """(combo, misc-numa, pick) indices → the oracle's mapping, as a
    read-only view (memoized: a shared cache entry must not be mutable)."""
    tables = get_tables(G, U, K)
    combo = tuple(int(x) for x in tables.combo[c])
    pick = tuple(int(x) for x in tables.pick[a])
    return MappingProxyType({
        "gpu": combo,
        "cpu": combo + (int(m),),
        "nic": tuple(zip(combo, pick)),
    })


def find_nodes(
    nodes: Dict[str, HostNode],
    reqs: Sequence[PodRequest],
    *,
    now: Optional[float] = None,
    respect_busy: bool = True,
    device: DeviceLike = "cuda",
) -> List[Optional[MatchResult]]:
    """Evaluate a whole pending batch against the current state at once;
    every result is computed against the same snapshot (no claims are
    applied between pods — that is BatchScheduler's job)."""
    dev = resolve_device(device)
    results: List[Optional[MatchResult]] = [None] * len(reqs)
    valid_idx = [
        i for i, r in enumerate(reqs)
        if r.map_mode in (MapMode.NUMA, MapMode.PCI)
    ]
    if not valid_idx:
        return results

    cluster = encode_cluster(nodes, now=now)
    if not respect_busy:
        cluster.busy[:] = False

    # pods whose combo lattice is too large for dense enumeration take
    # the serial oracle (identical semantics)
    tractable = [
        i for i in valid_idx
        if bucket_tractable(reqs[i].n_groups, cluster.U, cluster.K)
    ]
    for i in sorted(set(valid_idx) - set(tractable)):
        results[i] = oracle_find_node(
            nodes, reqs[i], now=now, respect_busy=respect_busy
        )

    buckets = encode_pods(
        [reqs[i] for i in tractable], cluster.interner, indices=tractable
    )
    for G, pods in buckets.items():
        out = solve_bucket(cluster, pods, device=dev)
        # the one-shot oracle-parity surface: no rounds to overlap
        cand = out.cand.cpu().numpy()  # nhdlint: ignore[NHD107]
        pref = out.pref.cpu().numpy()  # nhdlint: ignore[NHD107]
        best_c = out.best_c.cpu().numpy()  # nhdlint: ignore[NHD107]
        best_m = out.best_m.cpu().numpy()  # nhdlint: ignore[NHD107]
        best_a = out.best_a.cpu().numpy()  # nhdlint: ignore[NHD107]

        N = cand.shape[1]
        # lexicographic (pref desc, node index asc) via one argmax
        sel_val = pref * (N + 1) + (N - np.arange(N))[None, :]
        sel_val = np.where(cand, sel_val, 0)
        node_pick = np.argmax(sel_val, axis=1)  # [T]
        has_node = sel_val[np.arange(len(node_pick)), node_pick] > 0

        for t, pod_i in zip(pods.pod_type, pods.pod_index):
            if not has_node[t]:
                continue
            n = int(node_pick[t])
            mapping = decode_mapping(
                G, cluster.U, cluster.K,
                int(best_c[t, n]), int(best_m[t, n]), int(best_a[t, n]),
            )
            results[int(pod_i)] = MatchResult(cluster.names[n], mapping)
    return results


def find_node(
    nodes: Dict[str, HostNode],
    req: Union[PodRequest, PodTopology],
    *,
    now: Optional[float] = None,
    respect_busy: bool = True,
    device: DeviceLike = "cuda",
) -> Optional[MatchResult]:
    """Single-pod entry point, drop-in for the oracle's find_node."""
    if isinstance(req, PodTopology):
        req = PodRequest.from_topology(req)
    return find_nodes(
        nodes, [req], now=now, respect_busy=respect_busy, device=device
    )[0]
