"""The traffic generator: the same seed gives the same gangs; every seed
gives each block the same sizes in another order; a mix of one size
gives every seed the same gangs."""

import numpy as np

import itertools

from bench_port import manifest as mf
from bench_port.traffic import block_sizes, gangs, mix_gangs, stream_gangs

BIG = 2 ** 31 + 12345
#: a mix of many sizes, as a later cell's file would hold
SPREAD = {"gang_pods_min": 64, "gang_pods_max": 2048, "block": 32}


def sizes(mix, seed, n, stream=0):
    return np.array([g.size for g in mix_gangs(mix, seed, n, stream)])


def test_same_seed_same_gangs():
    a = sizes(SPREAD, BIG, 500)
    b = sizes(SPREAD, BIG, 500)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, sizes(SPREAD, BIG + 1, 500))
    assert not np.array_equal(a, sizes(SPREAD, BIG, 500, stream=1))


def test_blocks_hold_the_same_sizes_for_every_seed():
    base = np.sort(block_sizes(SPREAD))
    assert base[0] >= SPREAD["gang_pods_min"] and base[-1] <= SPREAD["gang_pods_max"]
    b = SPREAD["block"]
    for seed in (0, 7, BIG, 2 ** 40):
        s = sizes(SPREAD, seed, 4 * b)
        for j in range(4):
            assert np.array_equal(np.sort(s[j * b:(j + 1) * b]), base)


def test_log_uniform_quantiles():
    s = np.sort(block_sizes(SPREAD))
    ratios = s[1:] / s[:-1]
    assert np.allclose(ratios, (2048 / 64) ** (1 / 32), rtol=0.02)


def test_the_backlog_is_the_same_for_every_seed():
    mix = mf.traffic("backlog10k")
    want = None
    for seed in (0, BIG, 2 ** 40):
        gs = mix_gangs(mix, seed, 3, stream=0)
        got = [(g.first, g.size, g.pod_types(3).tolist(), g.pod_groups(3, 3).tolist())
               for g in gs]
        assert all(g.size == 10000 and g.first == 0 for g in gs)
        want = want or got
        assert got == want
    types = gs[0].pod_types(3)
    groups = gs[0].pod_groups(3, 3)
    for t in range(3):
        for g in range(3):
            assert abs(int(((types == t) & (groups == g)).sum()) - 10000 / 9) <= 1


def test_pods_cycle_types_and_groups_across_gangs():
    gs = gangs(np.array([5, 7, 4]))
    assert [g.first for g in gs] == [0, 5, 12]
    types = np.concatenate([g.pod_types(3) for g in gs])
    groups = np.concatenate([g.pod_groups(3, 3) for g in gs])
    k = np.arange(16)
    assert np.array_equal(types, k % 3)
    assert np.array_equal(groups, (k // 3) % 3)


def test_the_window_draw_never_runs_out():
    """The window takes gangs until its clock runs out: the draw goes on
    past any count, a block at a time, numbering gangs and pods on."""
    far = next(itertools.islice(stream_gangs(SPREAD, BIG, 0), 100000, None))
    assert far.index == 100000
    assert SPREAD["gang_pods_min"] <= far.size <= SPREAD["gang_pods_max"]
    b = SPREAD["block"]
    gs = mix_gangs(SPREAD, BIG, 3 * b, stream=0)
    assert [g.first for g in gs[1:]] == np.cumsum([g.size for g in gs[:-1]]).tolist()
