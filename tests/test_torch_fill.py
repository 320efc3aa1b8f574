"""spec_fill's plain version and the premises of its CUDA design, on the CPU.

The card holds the kernel (nhd_tpu_torch/kernels/spec_fill.cu) to the
plain version, exactly, on every ``FILL_SWEEP`` row (chip_smoke.py,
tests/test_torch_cuda.py). Here the plain version is held to an
independent serial walk of the reference's balanced fill
(nhd_tpu/solver/speculate.py:406-448: copies go to a type's pref-2
winners by node index, then its pref-1 winners, each at
min(max(cap, 1), ceil(need / n_win)) while need is left), and the two
facts the kernel's design rests on are checked where its inputs come
from:

* the takes of a row telescope, need - need_after == min(need,
  sum(capw)), so the kernel writes the need with no closing reduction;
* spec_elect elects no node for a row whose need is <= 0, so the kernel
  may leave such a row at once.

Tolerance: exact (integers).
"""

import numpy as np
import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import reference, sweep

G3 = ["default", "edge", "batch"]


def serial_fill(plan, status):
    """(count row, status) of the fill, node by node in fill order."""
    elect, hi, cap = (plan[r].astype(np.int64) for r in range(3))
    count = np.zeros(plan.shape[1], np.int64)
    need = status[1:].astype(np.int64)
    left = need.copy()
    for t in range(len(need)):
        nodes = np.flatnonzero(elect == t)
        if not len(nodes):
            continue
        fair = -(-int(need[t]) // len(nodes))
        for n in [*nodes[hi[nodes] != 0], *nodes[hi[nodes] == 0]]:
            count[n] = min(max(int(cap[n]), 1), fair, max(int(left[t]), 0))
            left[t] -= count[n]
    progress = 1 if (need - left > 0).any() else int(status[0])
    return count, np.concatenate([[progress], left])


def capw_sums(plan, need):
    """[TT] sum(capw) of each row, from the plan alone."""
    elect, cap = plan[0], plan[2]
    out = np.zeros(len(need), np.int64)
    for t in range(len(need)):
        cap1 = np.maximum(cap[elect == t], 1).astype(np.int64)
        if len(cap1):
            out[t] = sweep.fill_sums(cap1, [int(need[t])])[0]
    return out


def assert_takes_telescope(plan, status_before, status_after):
    need = status_before[1:].astype(np.int64)
    taken = need - status_after[1:].astype(np.int64)
    assert np.array_equal(taken, np.minimum(need, capw_sums(plan, need)))


def assert_elected_rows_have_need(plan, status):
    elect = plan[0]
    assert (status[1:][elect[elect >= 0]] > 0).all()


def _fill_case(shape):
    return sweep.fill_case(sweep.FILL_SWEEP.index(shape), *shape)


def test_fill_sweep_covers_the_edges():
    shapes = sweep.FILL_SWEEP
    ns = {s[1] for s in shapes}
    assert {1, 31, 255, 1023, 1024, 1025, 4097, 65537} <= ns
    assert {1, 16, 48} <= {s[0] for s in shapes}
    assert {"every", "hi", "lo", "interleave", "exact", "below", "above",
            "fair1", "cap0", "nowin", "dead", "unelected", "rand"} == {s[2] for s in shapes}
    # under one warp, ragged int4 tails, one tile, one node past it, many tiles
    assert min(ns) < 32 and any(n % 4 for n in ns) and 1024 in ns
    assert any(n > 16 * 1024 for n in ns) and any(1024 < n < 2048 for n in ns)


@pytest.mark.parametrize("shape", sweep.FILL_SWEEP, ids=str)
def test_fill_case_is_what_its_fill_says(shape):
    TT, N, fill = shape
    plan, status = _fill_case(shape)
    assert plan.shape == (7, N) and status.shape == (TT + 1,)
    assert plan.dtype == status.dtype == np.int32
    assert not plan[6].any() and status[0] == 0 and (status[1:] >= 0).all()
    elect, hi, cap = plan[0], plan[1], plan[2]
    need = status[1:].astype(np.int64)
    assert elect.min() >= -1 and elect.max() < TT
    n_win = np.bincount(elect[elect >= 0], minlength=TT)
    sums = capw_sums(plan, need)
    live = (n_win > 0) & (need > 0)
    assert live.any()
    if fill == "every":
        assert n_win[0] == N
    if fill in ("hi", "lo"):
        assert (hi[elect >= 0] == (fill == "hi")).all()
    if fill == "interleave":
        for t in np.flatnonzero(n_win > 1):
            assert len(set(hi[elect == t])) == 2
    if fill == "exact":
        assert np.array_equal(need[live], sums[live])
        assert (sums[live] > n_win[live]).any()     # not every capw is 1
    if fill == "below":
        assert (need[live] == sums[live] - 1).any()
    if fill == "above":
        assert (need[live] > 1000 * sums[live]).all()
    if fill == "fair1":
        assert (need[live] < n_win[live]).any() and (need[live] <= n_win[live]).all()
    if fill == "cap0":
        assert not cap.any()
    if fill == "nowin":
        assert ((n_win == 0) & (need > 0)).any()
    if fill == "dead":
        assert ((n_win > 0) & (need == 0)).any()
    if fill == "unelected":
        assert (elect == -1).mean() > 0.8
    if fill == "rand":
        assert (need == 0).any()


@pytest.mark.parametrize("shape", sweep.FILL_SWEEP, ids=str)
def test_plain_fill_matches_a_serial_walk(shape):
    plan, status = _fill_case(shape)
    want_count, want_status = serial_fill(plan, status)
    p, s = torch.from_numpy(plan.copy()), torch.from_numpy(status.copy())
    kernels.spec_fill(p, s)  # CPU tensors: the plain version
    assert np.array_equal(p[6].numpy(), want_count)
    assert np.array_equal(p[:6].numpy(), plan[:6])
    assert np.array_equal(s.numpy(), want_status)
    assert int(s[0]) == 1


@pytest.mark.parametrize("shape", sweep.FILL_SWEEP, ids=str)
def test_takes_telescope_on_the_fill_sweep(shape):
    plan, status = _fill_case(shape)
    after = torch.from_numpy(status.copy())
    reference.spec_fill(torch.from_numpy(plan.copy()), after)
    assert_takes_telescope(plan, status, after.numpy())


def _elected(shape):
    """(plan, status) as spec_fill finds them on a SPEC_SWEEP case."""
    case = sweep.spec_case(sweep.SPEC_SWEEP.index(shape), *shape)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])) for k in sweep.SPEC_ELECT_ARGS]
    plan = reference.spec_elect(*args, sharing=case["sharing"],
                                respect_busy=case["respect_busy"])
    return plan.numpy(), args[sweep.SPEC_ELECT_ARGS.index("status")].numpy()


@pytest.mark.parametrize("shape", sweep.SPEC_SWEEP, ids=str)
def test_takes_telescope_on_the_spec_sweep(shape):
    plan, status = _elected(shape)
    after = torch.from_numpy(status.copy())
    reference.spec_fill(torch.from_numpy(plan.copy()), after)
    assert (status[1:] - after[1:].numpy()).any()
    assert_takes_telescope(plan, status, after.numpy())


@pytest.mark.parametrize("shape", sweep.SPEC_SWEEP, ids=str)
def test_elect_skips_rows_without_need_on_the_spec_sweep(shape):
    plan, status = _elected(shape)
    assert (plan[0] >= 0).any()
    assert_elected_rows_have_need(plan, status)


@pytest.fixture(scope="module")
def cfg4_fills():
    """[(plan, status before, status after)] of every spec_fill call of
    cfg4's megaround on the CPU: 10,000 workload_mix pods on 1,000
    cap_cluster nodes (1,024 node rows, 16 global type rows)."""
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
    from nhd_tpu_torch.solver.kernel import _pad_pow2

    cluster = encode_cluster(cap_cluster(1_000, G3), now=0.0)
    cluster.busy[:] = False
    state = DeviceClusterState(cluster, "cpu")
    pods = list(encode_pods(workload_mix(10_000, G3), cluster.interner).values())
    needs = [np.bincount(p.pod_type, minlength=_pad_pow2(p.n_types)).astype(np.int32)
             for p in pods]
    calls = []
    fill = kernels.spec_fill

    def spy(plan, status, gate=None):
        # the fixed trip's dead iterations fill nothing: not recorded
        if reference._dead(gate):
            return fill(plan, status, gate)
        before = (plan.numpy().copy(), status.numpy().copy())
        fill(plan, status, gate)
        calls.append((*before, status.numpy().copy()))

    kernels.spec_fill = spy
    try:
        state.megaround(pods, needs, False)
    finally:
        kernels.spec_fill = fill
    return calls


def test_takes_telescope_on_cfg4(cfg4_fills):
    assert len(cfg4_fills) >= 2
    plan, status, _ = cfg4_fills[0]
    assert plan.shape == (7, 1024) and status.shape == (17,)
    for plan, before, after in cfg4_fills:
        assert_takes_telescope(plan, before, after)


def test_elect_skips_rows_without_need_on_cfg4(cfg4_fills):
    # the padded type rows have need 0 from the first iteration on
    assert (cfg4_fills[0][1][1:] == 0).any()
    for plan, before, _ in cfg4_fills:
        assert_elected_rows_have_need(plan, before)
