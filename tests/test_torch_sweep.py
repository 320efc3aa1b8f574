"""The kernel sweep's cases (nhd_tpu_torch/kernels/sweep.py) on the CPU.

The card holds nic_node_masks, nic_any_first, solve_planes and the claim
kernels against their plain versions on these cases (chip_smoke.py, tests/test_torch_cuda.py); here each case is
checked to be what the sweep's notes claim, and the plain versions are run
on it, so a case that cannot reach a kernel's edge fails before any card
time is spent.
"""

import numpy as np
import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import PLAN, PLANES, reference, sweep


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_nic_sweep_covers_the_edges():
    shapes = sweep.NIC_SWEEP
    assert {1, 7, 31, 32, 33, 49, 512} <= {s[5] for s in shapes}
    assert {1, 2, 4, 8} <= {s[4] for s in shapes}
    assert {"none", "all", "dense"} <= {s[6] for s in shapes}
    assert any(s[0] == 1 for s in shapes)
    # node counts no multiple of a warp's 8 nodes, hence of any node tile
    assert all(s[1] % 8 for s in shapes)
    uk = {s[2] * s[3] for s in shapes}
    assert 16 in uk and max(uk) > 32
    # a combo range that straddles a 32-lane chunk, and a pick range longer
    # than the 8 warps of a block take in one pass
    assert any(s[5] % 32 and s[4] * s[5] > 32 for s in shapes)
    assert any(s[4] * s[5] > 8 * 32 for s in shapes)


def test_plane_sweep_covers_the_edges():
    shapes = sweep.PLANE_SWEEP
    cs = {s[4] for s in shapes}
    assert {1, 2, 4, 8} <= cs
    assert any(c & (c - 1) for c in cs) and max(cs) > 32
    assert {"tie", "none"} <= {s[6] for s in shapes}
    assert any(s[0] == 1 for s in shapes)


@pytest.mark.parametrize("shape", sweep.NIC_SWEEP, ids=str)
def test_nic_case_runs_the_plain_version(shape):
    T, N, U, K, C, A, fill = shape
    args, kw = sweep.nic_case(sweep.NIC_SWEEP.index(shape), *shape)
    free_rx, _, dem_rx, _, unchosen, *_ = args
    assert dem_rx.shape == (T, C * A, U * K) and free_rx.shape == (N, U * K)
    chosen = (~unchosen).sum(1)
    if fill == "dense":
        assert (chosen == U * K).all() and U * K > 4
    else:
        assert chosen.min() >= 1 and chosen.max() <= 4
    assert (dem_rx[:, unchosen] == 0).all()
    nic_any, first_a, n_picks = reference.nic_any_first(*_t(args), **kw)
    assert nic_any.shape == (T, N, C)
    assert torch.equal(nic_any, n_picks > 0)
    assert int(first_a.max()) < A and int(n_picks.max()) <= A
    if fill == "none":
        assert not nic_any.any()
    elif fill == "all":
        assert bool((n_picks == A).all()) and not first_a.any()
    else:
        assert nic_any.any()


@pytest.mark.parametrize("shape", sweep.PLANE_SWEEP, ids=str)
def test_plane_case_runs_the_plain_version(shape):
    T, N, U, G, C, NCLS, fill = shape
    args = sweep.plane_case(sweep.PLANE_SWEEP.index(shape), *shape)
    assert len(args) == 24
    out = reference.solve_planes(*_t(args))
    assert out.shape == (len(PLANES), T, N) and out.dtype == torch.int32
    P = {name: i for i, name in enumerate(PLANES)}
    cand = out[P["cand"]] != 0
    assert int(out[P["best_c"]].max()) < C
    assert torch.equal(out[P["n_combos"]] > 0, cand)
    if fill == "none":
        assert not cand.any()
    else:
        assert cand.any()


def test_node_sweep_covers_the_edges():
    shapes = sweep.NODE_SWEEP
    assert {1, 2, 3, 4} <= {s[4] for s in shapes} and max(s[4] for s in shapes) > 4
    cas = {s[5] * s[6] for s in shapes}
    assert 1 in cas and 4096 in cas and any(ca % 4 and ca % 32 for ca in cas)
    assert max(s[1] for s in shapes) > 4                 # U past the registers
    assert max(s[1] * s[2] for s in shapes) * 4 > 48 * 1024  # unstaged row
    assert any(32 < s[1] * s[2] < 1000 for s in shapes)
    assert {"oob", "onesw", "neg"} <= {s[7] for s in shapes}
    # odd node counts: no strip of an even node count divides them
    assert all(s[0] % 2 for s in shapes)


@pytest.mark.parametrize("shape", sweep.NODE_SWEEP, ids=str)
def test_node_case_runs_the_plain_version(shape):
    N, U, K, S, G, C, A, fill = shape
    args = sweep.node_case(sweep.NODE_SWEEP.index(shape), *shape)
    nic_count, nic_sw, gpu_free_sw, combo, pick, need_max = args
    assert nic_sw.shape == (N, U, K) and combo.shape == (C, G) and pick.shape == (A, G)
    assert (nic_sw == -1).any()
    valid, pci_ok = reference.nic_node_masks(*_t(args))
    assert valid.shape == pci_ok.shape == (N, C * A)
    assert pci_ok.any() and not pci_ok.all()
    # a node with a negative switch entry fails every pick
    neg = torch.from_numpy((gpu_free_sw < 0).any(1))
    assert neg.any() and not pci_ok[neg].any()
    if fill == "oob":
        assert ((nic_sw >= S) | (nic_sw < -S)).any()
    if fill == "onesw":
        assert len(np.unique(nic_sw[nic_sw >= 0])) == 1
    # the plain version's verdict at one element, by hand
    rng = np.random.default_rng(0)
    for n, ca in zip(rng.integers(0, N, 20), rng.integers(0, C * A, 20)):
        c, a = divmod(int(ca), A)
        assert bool(valid[n, ca]) == bool((need_max[c, a] <= nic_count[n]).all())
        sw = [int(nic_sw[n, combo[c, g], pick[a, g]]) for g in range(G)]
        ok = bool((gpu_free_sw[n] >= 0).all())
        for s_g in sw:
            idx = s_g + S if s_g < 0 else s_g
            ok = ok and 0 <= idx < S and sw.count(s_g) <= gpu_free_sw[n, idx]
        assert bool(pci_ok[n, ca]) == ok


def spec_tensors(case):
    """sweep.spec_case's arrays as CPU tensors (plain ints kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
            else v for k, v in case.items()}


def test_spec_sweep_covers_the_edges():
    shapes = sweep.SPEC_SWEEP
    assert any(len(s[4]) == 1 for s in shapes) and any(len(s[4]) > 2 for s in shapes)
    # buckets of different C and C*A: the tables' padded axes
    assert any(len({b[1] for b in s[4]}) > 1 and len({b[1] * b[2] for b in s[4]}) > 1
               for s in shapes)
    assert any(s[0] < 256 for s in shapes) and any(s[0] > 512 for s in shapes)
    assert {(s[5], s[6]) for s in shapes} == {(False, False), (True, False),
                                              (False, True), (True, True)}
    # a second type row per lane of spec_elect, ties across that wrap too
    tt = {s: sum(b[0] for b in s[4]) for s in shapes}
    assert any(tt[s] > 32 and len(s[4]) > 1 and s[7] != "tie" for s in shapes)
    assert any(tt[s] > 32 and s[7] == "tie" for s in shapes)
    # a second 32-slot step per warp of spec_apply, a NUMA segment across it
    wide = [s for s in shapes if s[1] * s[2] > 32]
    assert any(s[7] == "multi" for s in wide) and any(s[5] and s[6] for s in wide)
    assert any(32 % s[2] for s in wide)
    assert {"rand", "tie", "none", "multi"} == {s[7] for s in shapes}
    # spec_apply's launcher limit: 8 warps of S float sums past 48 KB
    assert any(8 * s[3] * 4 > 48 * 1024 for s in shapes)


@pytest.mark.parametrize("shape", sweep.SPEC_SWEEP, ids=str)
def test_spec_case_runs_the_plain_versions(shape):
    """elect, fill and apply in a row on one case: each elected node's
    type has need and its cand, each type takes at most its need, the
    need falls by the takes, and row ``it`` of the claims records exactly
    the nodes that took copies."""
    N = shape[0]
    t = spec_tensors(sweep.spec_case(sweep.SPEC_SWEEP.index(shape), *shape))
    need0 = t["status"][1:].clone()
    kw = dict(sharing=t["sharing"], respect_busy=t["respect_busy"])
    plan = kernels.spec_elect(*(t[k] for k in sweep.SPEC_ELECT_ARGS), **kw)
    assert plan.shape == (len(PLAN), N) and plan.dtype == torch.int32
    assert int(t["status"][0]) == 0
    elect = plan[0]
    has = elect >= 0
    assert has.any() and not has.all()
    assert bool((need0[elect[has].long()] > 0).all())
    kernels.spec_fill(plan, t["status"])
    take = plan[6]
    assert take[~has].eq(0).all() and take.ge(0).all()
    per_type = torch.zeros_like(need0).index_add_(0, elect[has].long(), take[has])
    assert bool((per_type <= need0).all())
    assert torch.equal(t["status"][1:], need0 - per_type)
    assert int(t["status"][0]) == int(per_type.sum() > 0)
    before = t["cpu_free"].clone()
    kernels.spec_apply(plan, *(t[k] for k in sweep.SPEC_APPLY_ARGS), **kw)
    took = has & (take > 0)
    assert took.any()
    row = t["claims"][t["it"]]
    assert row[~took].eq(-1).all()
    tt = elect[took].long()
    A_t, U = t["trow"][tt, 0], t["cpu_free"].shape[1]
    word = tt * (1 << 21) + (plan[3][took] * U + plan[4][took]) * A_t + plan[5][took]
    assert torch.equal(row[took], word.to(torch.int32))
    assert torch.equal(t["counts"][t["it"]], torch.where(took, take, 0))
    assert torch.equal(t["cpu_free"][~took], before[~took])
    fill = shape[7]
    if fill == "none":
        assert bool((elect[::3] == -1).all()) and bool((plan[1:, ::3] == 0).all())
    if fill == "multi":
        assert int(take.max()) > 1


def _switch_sums(gpu_uk, nic_sw, S):
    """[N, TT*CAM, S]: each table row's GPU demand per switch at each
    node, the per-switch sums spec_apply forms before scaling by k."""
    N = nic_sw.shape[0]
    rows = gpu_uk.reshape(-1, gpu_uk.shape[-1]).astype(np.float64)
    sw = nic_sw.reshape(N, -1)
    onehot = (sw[..., None] == np.arange(S)).astype(np.float64)  # [N, UK, S]
    return np.einsum("ri,nis->nrs", rows, onehot)


def _assert_exact_switch_sums(gpu_uk, nic_sw, gpu_free_sw, k_max):
    """The premise of spec_apply's switch deltas: integer entries, and
    every per-switch sum of k * gpu_uk (k <= k_max), and the switch's
    free count beside it, below 2^24, where float32 holds every integer."""
    assert (gpu_uk >= 0).all() and (gpu_uk == np.floor(gpu_uk)).all()
    sums = _switch_sums(gpu_uk, nic_sw, gpu_free_sw.shape[1])
    assert sums.max() * k_max < 2 ** 24
    assert np.abs(gpu_free_sw).max() + sums.max() * k_max < 2 ** 24


@pytest.mark.parametrize("shape", sweep.SPEC_SWEEP, ids=str)
def test_switch_sums_exact_on_the_sweep(shape):
    """spec_apply adds k * gpu_uk per switch in another order than the
    reference's einsum; on every sweep case the premise that makes any
    order exact holds (a node takes at most its type's need)."""
    case = sweep.spec_case(sweep.SPEC_SWEEP.index(shape), *shape)
    k_max = max(int(case["status"][1:].max()), 1)
    _assert_exact_switch_sums(case["gpu_uk"], case["nic_sw"], case["gpu_free_sw"], k_max)
    if shape[7] == "multi":
        assert _switch_sums(case["gpu_uk"], case["nic_sw"], shape[3]).max() > 1


@pytest.mark.parametrize("map_mode", ["NUMA", "PCI"])
def test_switch_sums_exact_on_a_cfg4_table(map_mode):
    """The same premise on the main path's own tables: spec_tables of the
    cfg4 batch (10,000 workload_mix pods) on cap_cluster nodes, whose
    gpu_uk rows are gpu_dem * map_pci per chosen slot; no node takes more
    copies than the batch has pods. The batch maps its pods by NUMA, so
    its gpu_uk is all 0; the same batch mapped by PCI fills it."""
    import dataclasses

    from nhd_tpu_torch.core.topology import MapMode
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.speculate import spec_tables

    groups = ["default", "edge", "batch"]
    cluster = encode_cluster(cap_cluster(16, groups), now=0.0)
    state = DeviceClusterState(cluster, "cpu")
    reqs = [dataclasses.replace(r, map_mode=MapMode[map_mode])
            for r in workload_mix(10_000, groups)]
    buckets = list(encode_pods(reqs, cluster.interner).values())
    tabs = spec_tables(buckets, [state.pod_tensors(p) for p in buckets], cluster.U,
                       cluster.K, state.Np, torch.device("cpu"))
    gpu_uk = tabs.gpu_uk.numpy()
    assert gpu_uk.shape[-1] == 14                       # U*K of cap_cluster
    assert (gpu_uk.max() > 0) == (map_mode == "PCI")
    _assert_exact_switch_sums(gpu_uk, cluster.nic_sw, cluster.gpu_free_sw, 10_000)
    # why it holds on the main path: gpu_uk is nonzero only on PCI-mapped
    # rows, which spec_elect caps at one copy
    pci = (tabs.trow[:, 2].numpy() & reference.FLAG_MAP_PCI) != 0
    assert pci[(gpu_uk != 0).any(axis=(1, 2))].all()
