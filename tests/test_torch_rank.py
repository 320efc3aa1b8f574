"""Rank parity: the port's rank stage (``rank_top`` and ``rank_merge``,
their plain versions on the CPU) against the JAX reference's
``_rank_body`` (nhd_tpu/solver/kernel.py) and its node-sharded program,
on every slot of all nine RankOut rows, val 0 included.

Both sides order equal values by ascending node index (lax.top_k's
order, the plain versions' stable sort), so the whole packed tensor is a
function of the planes and the tolerance is exact equality. Inputs are
made with numpy from a seed and handed to both packages.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhd_tpu.parallel.sharding import solve_bucket_ranked_sharded as jx_sharded
from nhd_tpu.policy.scoring import set_matrix as jx_set_matrix
from nhd_tpu.solver import kernel as jk
from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import reference, sweep
from nhd_tpu_torch.parallel.sharding import solve_bucket_ranked_sharded
from nhd_tpu_torch.policy.scoring import set_matrix as pt_set_matrix
from nhd_tpu_torch.solver import kernel as pk
from tests.test_torch_kernel import CASES, jax_instance
from tests.test_torch_sharding import cpu_mesh, jax_mesh

ROOT = Path(__file__).resolve().parent.parent


def _rank_inputs(seed, T, N, U, density, pad_from=None, real=None):
    """(the port's [8, T, N] planes and [N, U] / [N] free tensors, the
    reference's _rank_body arguments after R): one solve's outcome drawn
    from a seed, cand and the policy-folded pref expressed as the sel
    plane they imply; type rows from *pad_from* on have no candidate (the
    main path's padded types), nor node rows from *real* on (padded
    nodes)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    cand = rng.random((T, N)) < density
    if pad_from is not None:
        cand[pad_from:] = False
    if real is not None:
        cand[:, real:] = False
    pref = (rng.integers(1, 3, (T, N)) + 3 * rng.integers(0, 3, (T, N))).astype(i32)
    best_c, best_m, best_a, n_combos, n_picks = rng.integers(0, 9, (5, T, N)).astype(i32)
    gpu_free = rng.integers(0, 5, (N, U)).astype(i32)
    cpu_free = rng.integers(0, 65, (N, U)).astype(i32)
    hp_free = rng.integers(0, 257, N).astype(i32)
    sel = np.where(cand, pref * (N + 1) + (N - np.arange(N))[None, :], 0)
    planes = np.stack([sel, cand, pref * cand, best_c, best_m, best_a,
                       n_combos, n_picks]).astype(i32)
    port = (torch.from_numpy(planes), torch.from_numpy(gpu_free),
            torch.from_numpy(cpu_free), torch.from_numpy(hp_free))
    ref = (cand, pref, best_c, best_m, best_a, n_picks, gpu_free, cpu_free,
           hp_free)
    return port, ref


def _width(spec, cand_counts, N):
    """R below, at or above the rows' candidate counts, or R = N."""
    lo, hi = int(cand_counts.min()), int(cand_counts.max())
    return {"below": max(1, lo - 1), "at": max(1, hi), "above": min(N, hi + 7),
            "N": N}[spec]


# (seed, T, N, U, candidate density, R, first padded type row, node_base)
BODY_CASES = [
    (0, 8, 64, 2, 0.2, "below", None, 0),
    (1, 8, 64, 2, 0.2, "at", None, 0),
    (2, 8, 64, 2, 0.2, "above", None, 0),
    (3, 4, 64, 2, 0.2, "N", None, 0),
    (4, 8, 64, 1, 0.3, "above", 3, 0),
    (5, 8, 128, 4, 0.1, "above", 5, 4096),
    (6, 2, 8, 2, 0.0, "N", None, 0),
    (7, 16, 1024, 2, 0.05, "above", 6, 0),
    (8, 8, 96, 3, 1.0, "below", None, 17),
]


@pytest.mark.parametrize("seed,T,N,U,density,spec,pad_from,node_base", BODY_CASES)
def test_rank_top_plain_equals_rank_body(seed, T, N, U, density, spec,
                                         pad_from, node_base):
    """The plain rank_top equals the reference's _rank_body on all nine
    rows and every slot; node_base moves the index row only."""
    port, ref = _rank_inputs(seed, T, N, U, density, pad_from)
    R = _width(spec, ref[0].sum(1) if pad_from is None else ref[0][:pad_from].sum(1), N)
    want = np.asarray(jk._rank_body(R, *(jnp.asarray(a) for a in ref)))
    got = reference.rank_top(*port, R=R, node_base=node_base).numpy()
    assert got.shape == want.shape == (9, T, R)
    want = want.copy()
    want[1] += node_base
    assert np.array_equal(got, want)
    if pad_from is not None:
        assert (got[0, pad_from:] == 0).all()
        assert (got[1, pad_from:] == node_base + np.arange(R)).all()
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(kernels.rank_top(*port, R=R, node_base=node_base),
                       torch.from_numpy(got))


def _check_all_slots(cluster, buckets, R=16):
    for G, pods in buckets.items():
        want = np.asarray(jk.solve_bucket_ranked(cluster, pods, R))
        got = pk.solve_bucket_ranked(cluster, pods, R, device="cpu").numpy()
        assert got.shape == want.shape, f"G={G}"
        assert np.array_equal(got, want), f"G={G}: rank tensor"


@pytest.mark.parametrize("seed,U,K,mode", CASES)
def test_solve_bucket_ranked_every_slot(seed, U, K, mode):
    """The fused solve + rank end to end: the whole packed tensor, val 0
    slots and padded type rows included."""
    cluster, buckets = jax_instance(seed, sockets=U, nics=K, map_mode=mode)
    _check_all_slots(cluster, buckets)


def test_solve_bucket_ranked_every_slot_wide_and_policy(monkeypatch):
    """R past the candidates of a 40-node cluster, and a live scoring
    matrix reordering the ranking alike on both sides."""
    cluster, buckets = jax_instance(21, n_nodes=40, n_reqs=8)
    _check_all_slots(cluster, buckets, R=64)
    monkeypatch.setenv("NHD_POLICY", "1")
    matrix = {"gpu": {"gen-a": 0.3, "gen-b": 1.0, "gen-c": 0.6},
              "cpu": {"gen-a": 1.0, "gen-b": 0.5}}
    jx_set_matrix(matrix)
    pt_set_matrix(matrix)
    try:
        cluster, buckets = jax_instance(11, n_nodes=24, classes=True)
        assert any(p.class_score.any() for p in buckets.values())
        _check_all_slots(cluster, buckets, R=32)
    finally:
        jx_set_matrix(None)
        pt_set_matrix(None)


@pytest.mark.parametrize("n_dev", [2, 3, 8])
@pytest.mark.parametrize("seed", [3, 12])
def test_mesh_rank_every_slot(seed, n_dev):
    """rank_shards (each shard's rank_top, indices global, one rank_merge)
    equals the reference's node-sharded program and the port's one-device
    rank on every slot: a shard's zero candidates are its lowest-index
    zero nodes in order, so the merge takes the global ones."""
    cluster, buckets = jax_instance(seed, n_nodes=29, n_reqs=6)
    for G, pods in buckets.items():
        for R in (4, 16, 64):
            got = solve_bucket_ranked_sharded(cluster, pods, R, cpu_mesh(n_dev))
            want = np.asarray(jx_sharded(cluster, pods, R, jax_mesh(n_dev)))
            assert got.shape == want.shape, f"G={G} R={R}"
            assert np.array_equal(got, want), f"G={G} R={R} D={n_dev}"
            Np = pk.pad_nodes(cluster.n_nodes, n_dev)
            one = reference.rank_top(
                *_padded_planes(cluster, pods, Np), R=min(R, Np)).numpy()
            assert np.array_equal(got, one), f"G={G} R={R} D={n_dev} vs one device"


def _padded_planes(cluster, pods, Np):
    """The one-device planes and free tensors over *Np* node rows."""
    from nhd_tpu_torch.solver.kernel import (
        _ARG_ORDER, _pad_pow2, padded_args, solve_planes, to_device,
        upload_pods,
    )

    Tp = _pad_pow2(pods.n_types)
    host = padded_args(cluster, pods, Tp, Np)
    node = [to_device(a, "cpu") for a in host[: len(_ARG_ORDER)]]
    pod = upload_pods(pods, Tp, cluster.U, cluster.K, "cpu")
    planes = solve_planes(pods.G, cluster.U, cluster.K, node, pod)
    a = dict(zip(_ARG_ORDER, node))
    return planes, a["gpu_free"], a["cpu_free"], a["hp_free"]


@pytest.mark.parametrize("i", range(len(sweep.RANK_SWEEP)))
def test_rank_sweep_plain_equals_numpy_oracle(i):
    """Every RANK_SWEEP case: the plain rank_top and rank_merge equal a
    stable argsort on the negated keys, and the merge of a solve's shards
    (real sel values) equals the one-device rank on every slot."""
    shape = sweep.RANK_SWEEP[i]
    c = sweep.rank_case(i, *shape)
    free = (c["gpu_free"], c["cpu_free"], c["hp_free"])
    args = [torch.from_numpy(c[k]) for k in ("planes", "gpu_free", "cpu_free", "hp_free")]
    got = reference.rank_top(*args, R=c["R"], node_base=c["node_base"]).numpy()
    assert np.array_equal(got, sweep.np_rank(c["planes"], *free, c["R"], c["node_base"]))
    cand = c["cand"]
    key = np.argsort(-cand[0].astype(np.int64), axis=1, kind="stable")[:, :c["merge_R"]]
    want = np.take_along_axis(cand, np.broadcast_to(key, (9, *key.shape)), axis=2)
    merged = reference.rank_merge(torch.from_numpy(cand), R=c["merge_R"]).numpy()
    assert np.array_equal(merged, want)
    T, N, U, R, S = shape[:5]
    Ns = N // S
    parts = [reference.rank_top(*(a[:, :, s * Ns:(s + 1) * Ns].contiguous() if j == 0
                                  else a[s * Ns:(s + 1) * Ns] for j, a in enumerate(args)),
                                R=min(R, Ns), node_base=s * Ns).numpy()
             for s in range(S)]
    assert np.array_equal(np.concatenate(parts, axis=2), cand)
    if shape[-1] not in ("ties", "span") and S * Ns == N:
        one = sweep.np_rank(c["planes"], *free, c["merge_R"], 0)
        assert np.array_equal(merged, one)


def test_rank_sweep_covers_its_notes():
    """The sweep reaches what its notes claim: R = 1, R = N, R above the
    positives, R at and past one winner a thread, 3 shards, node_base > 0,
    N past the shared-memory stage, all-zero rows and padded types."""
    rows = sweep.RANK_SWEEP
    assert any(r[3] == 1 for r in rows) and any(r[3] == r[1] for r in rows)
    assert any(r[3] == 1024 for r in rows) and any(r[3] > 1024 for r in rows)
    assert any(r[4] == 3 for r in rows)
    assert any(r[5] > 0 for r in rows) and any(r[1] * 4 > 200 * 1024 for r in rows)
    assert any(r[1] % 32 for r in rows)
    assert {"zero", "pad", "ties", "dense", "sparse"} <= {r[-1] for r in rows}
    positives = [(sweep.rank_case(i, *r)["planes"][0] > 0).sum(1)
                 for i, r in enumerate(rows) if r[-1] == "sparse"]
    assert any((p < r[3]).all() for p, r in zip(
        positives, (r for r in rows if r[-1] == "sparse")))


def _bitonic_desc(w):
    """rank_select.cuh's bitonic network on the uint64 words *w* (a power
    of two long), step by step: pair (lo, lo | j), lo with bit j clear,
    the larger word to lo in a descending run ((lo & k) == 0)."""
    w = w.copy()
    P = len(w)
    q = np.arange(P // 2)
    k = 2
    while k <= P:
        j = k // 2
        while j > 0:
            lo = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            hi = lo | j
            a, b = w[lo], w[hi]
            desc = (lo & k) == 0
            swap = np.where(desc, a < b, a > b)
            w[lo] = np.where(swap, b, a)
            w[hi] = np.where(swap, a, b)
            j //= 2
        k *= 2
    return w


def _radix_threshold(u, R, digit=9):
    """rank_select.cuh's radix select on the key images *u* (uint32):
    (thr, k_eq), passes of *digit* bits from the highest bit where the
    smallest and largest image differ down, the last one overlapping bits
    already fixed."""
    lo, hi = int(u.min()), int(u.max())
    if lo == hi:
        return lo, R
    high = int(lo ^ hi).bit_length() - 1
    shift = max(high - (digit - 1), 0)
    mask = 0 if shift + digit >= 32 else (0xFFFFFFFF << (shift + digit)) & 0xFFFFFFFF
    prefix, k, bins = lo & mask, R, 1 << digit
    while True:
        live = u[(u & mask) == prefix]
        hist = np.bincount((live >> shift) & (bins - 1), minlength=bins)
        from_top = np.cumsum(hist[::-1])
        b = bins - 1 - int(np.nonzero(from_top >= k)[0][0])
        k -= int(from_top[bins - 1 - b] - hist[b])
        prefix |= b << shift
        mask |= (bins - 1) << shift
        if shift == 0:
            return prefix, k
        shift = max(shift - digit, 0)


def _split_rank(keys, R):
    """The positions of the top R of one row of int32 *keys*, as the
    kernels now rank them: up to 1,024 keys the whole row's words sorted;
    past that the words above the radix threshold sorted, then the first
    k_eq keys equal to it in ascending position, unsorted."""
    n = len(keys)
    u = (keys.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(0x80000000)
    pos = np.arange(n, dtype=np.uint64)
    words = (u.astype(np.uint64) << np.uint64(32)) | (~pos & np.uint64(0xFFFFFFFF))
    if n <= 1024:
        P = 1 << (n - 1).bit_length()
        padded = np.zeros(P, np.uint64)
        padded[:n] = words
        top = _bitonic_desc(padded)[:R]
    else:
        thr, k_eq = _radix_threshold(u, R)
        above = words[u > thr]
        assert len(above) == R - k_eq
        eq = np.nonzero(u == thr)[0][:k_eq]
        P = 1 << max(len(above) - 1, 0).bit_length()
        padded = np.zeros(P, np.uint64)
        padded[:len(above)] = above
        sorted_above = _bitonic_desc(padded)[:len(above)]
        top = np.concatenate([sorted_above, words[eq]])
    return (~top & np.uint64(0xFFFFFFFF)).astype(np.int64)


@pytest.mark.parametrize("i", range(len(sweep.RANK_SWEEP)))
def test_split_model_equals_stable_argsort(i):
    """The decomposition rank_top and rank_merge rely on, modelled in
    numpy: the radix threshold, the sorted words above it and the tail of
    equal keys in position order (or, up to 1,024 keys, the whole row's
    bitonic sort) pick the same positions as a stable descending argsort,
    on every row of every RANK_SWEEP case (rank_top's sel rows and
    rank_merge's candidate keys)."""
    c = sweep.rank_case(i, *sweep.RANK_SWEEP[i])
    for keys, R in ((c["planes"][0], c["R"]), (c["cand"][0], c["merge_R"])):
        for row in keys:
            want = np.argsort(-row.astype(np.int64), kind="stable")[:R]
            assert np.array_equal(_split_rank(row, R), want)


# (seed, T, N, U, candidate density, R, first padded type row): the
# regimes of rank_select.cuh at sizes the reference ranks as well
REGIME_CASES = [
    (30, 4, 1024, 2, 0.2, 512, None),    # the whole-row sort's largest row
    (31, 4, 1025, 2, 0.2, 700, None),    # the smallest wide row, a long tail
    (32, 2, 8192, 2, 0.1, 2048, None),   # k_eq > 1,024: the tail spans chunks
    (33, 2, 16384, 2, 0.1, 2048, None),  # R = 2,048 at cfg5's tile width
    (34, 8, 1024, 2, 0.3, 512, 0),       # every type row padding
]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("seed,T,N,U,density,R,pad_from", REGIME_CASES)
def test_rank_regimes_equal_rank_body(seed, T, N, U, density, R, pad_from, n_dev):
    """Each new regime's plain rank against the reference's _rank_body on
    every slot: on one device, rank_top over the N rows; on n_dev shards
    of the padded node axis (pad_nodes), each shard's rank_top with its
    node_base joined in shard order and one rank_merge, as rank_shards
    does, against _rank_body over the same padded rows."""
    Np = N if n_dev == 1 else pk.pad_nodes(N, n_dev)
    (planes, *free), ref = _rank_inputs(seed, T, Np, U, density, pad_from, real=N)
    want = np.asarray(jk._rank_body(R, *(jnp.asarray(a) for a in ref)))
    if n_dev == 1:
        got = kernels.rank_top(planes, *free, R=R).numpy()
    else:
        Ns = Np // n_dev
        parts = [kernels.rank_top(planes[:, :, s * Ns:(s + 1) * Ns].contiguous(),
                                  *(f[s * Ns:(s + 1) * Ns] for f in free),
                                  R=min(R, Ns), node_base=s * Ns)
                 for s in range(n_dev)]
        got = kernels.rank_merge(torch.cat(parts, dim=2), R=R).numpy()
    assert got.shape == want.shape == (9, T, R)
    assert np.array_equal(got, want)
    if pad_from == 0:
        assert (got[0] == 0).all() and (got[1] == np.arange(R)).all()


def test_rank_width_is_checked():
    port, _ = _rank_inputs(0, 2, 8, 1, 0.5)
    for R in (0, 9):
        with pytest.raises(ValueError, match="rank width"):
            kernels.rank_top(*port, R=R)
    cand = reference.rank_top(*port, R=8)
    with pytest.raises(ValueError, match="rank width"):
        kernels.rank_merge(cand, R=9)


def test_solver_kernel_has_no_eager_rank():
    """nhd_tpu_torch/solver/kernel.py ranks only through the kernels: it
    calls no torch.topk, torch.sort or torch.gather (nor the tensor
    methods of those names)."""
    tree = ast.parse((ROOT / "nhd_tpu_torch" / "solver" / "kernel.py").read_text())
    called = {
        node.func.attr for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
    }
    assert not called & {"topk", "sort", "gather", "argsort"}


@pytest.mark.parametrize("need", [1, 3, 700])
def test_accelerator_rank_budget_over_no_node_ranks_one_slot(need):
    """A batch over no node (a federation member whose shards hold none)
    on an accelerator: the reference's rule gives R = 0, a zero-width
    top_k; the port's gives one slot, which the rank kernels take (they
    refuse 0), and which holds val 0 on the padded rows, so both place
    nothing. Before the floor the card's batch raised "rank width 0
    outside 1..8" where the CPU's placed nothing."""
    assert jk.rank_budget(need, 0, accelerator=True) == 0
    R = pk.rank_budget(need, 0, accelerator=True)
    assert R == 1
    # every padded row of an empty cluster: no candidate anywhere
    port, ref = _rank_inputs(need, 4, pk.pad_nodes(0), 2, 0.5, real=0)
    got = kernels.rank_top(*port, R=R).numpy()
    assert got.shape == (9, 4, 1) and (got[0] == 0).all()
    want = np.asarray(jk._rank_body(0, *(jnp.asarray(a) for a in ref)))
    assert want.shape == (9, 4, 0)
    # the rest of the accelerator rule is the reference's
    for n in (1, 8, 1000, 4096):
        assert pk.rank_budget(need, n, accelerator=True) == jk.rank_budget(
            need, n, accelerator=True)


def test_batch_over_no_node_with_the_accelerator_rank_places_nothing(monkeypatch):
    """``BatchScheduler.schedule`` over an empty node set with the
    accelerator's rank rule (the card's; forced here on the CPU): the
    batch completes and places nothing, as on the CPU's rule."""
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler
    from nhd_tpu_torch.solver import batch as batch_mod

    budget = batch_mod.rank_budget
    monkeypatch.setattr(batch_mod, "rank_budget",
                        lambda need, n, *, accelerator=False:
                        budget(need, n, accelerator=True))
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(3, ["default"]))]
    results, stats = BatchScheduler(device="cpu", respect_busy=False).schedule(
        {}, items, now=0.0)
    assert [r.node for r in results] == [None] * 3
