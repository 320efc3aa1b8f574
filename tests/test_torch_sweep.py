"""The kernel sweep's cases (nhd_tpu_torch/kernels/sweep.py) on the CPU.

The card holds nic_any_first and solve_planes against their plain versions
on these cases (chip_smoke.py, tests/test_torch_cuda.py); here each case is
checked to be what the sweep's notes claim, and the plain versions are run
on it, so a case that cannot reach a kernel's edge fails before any card
time is spent.
"""

import numpy as np
import pytest
import torch

from nhd_tpu_torch.kernels import PLANES, reference, sweep


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
