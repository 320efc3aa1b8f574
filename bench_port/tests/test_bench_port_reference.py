"""The plain reference on a small seeded fleet: the placements it makes
itself judge correct, each broken guarantee is caught, and the control
(NIC sharing on where the configuration has it off) comes out not
correct."""

import copy

import numpy as np
import pytest

from bench_port import manifest as mf
from bench_port.control import run_control
from bench_port.fleet import Hardware
from bench_port.reference import MISC, PROC, Answers, Reference
from bench_port.tests.conftest import small


def _fleet(nodes=4):
    cfg, mix = small(mf.config("cap1k"), mf.traffic("backlog10k"), nodes=nodes)
    return cfg, mix, Hardware.of(cfg["fleet"], cfg["guarantees"]["nic_bw_avail"])


def _answers(placer, types, groups):
    """Place pods of *types* by the reference's own first fit and return
    them as a gang's answers."""
    node, cores, gpus, nics = [], [], [], []
    for p, (t, g) in enumerate(zip(types, groups)):
        fits = np.flatnonzero(placer.fits_anywhere(t, g))
        got = placer.place(t, g, int(fits[0]), p) if len(fits) else None
        node.append(int(fits[0]) if got else -1)
        if got:
            cores += got[0]
            gpus += got[1]
            nics += got[2]

    def col(rows, j, dt=np.int64):
        return np.asarray([r[j] for r in rows], dt)

    return Answers(np.array(node), np.array(types), np.array(groups),
                   col(cores, 0), col(cores, 1), col(cores, 2), col(cores, 3),
                   col(gpus, 0), col(gpus, 1), col(gpus, 2), col(nics, 0),
                   col(nics, 1), col(nics, 2), col(nics, 3, float), col(nics, 4, float))


def _gang(n=30):
    k = np.arange(n)
    return (k % 3).tolist(), ((k // 3) % 3).tolist()


def test_first_fit_answers_are_correct_and_rows_match():
    cfg, mix, hw = _fleet()
    placer = Reference(hw, mix["pod_types"])
    judge = Reference(hw, mix["pod_types"])
    a = _answers(placer, *_gang())
    v = judge.judge(a)
    assert v.bad_placements == 0 and v.bad_failures == 0 and v.placed == 30
    assert judge.row_mismatches(placer.rows()) == 0
    judge.release(a)
    assert judge.hp_free.tolist() == [hw.hugepages] * hw.N
    assert int(judge.free_phys().sum()) == hw.N * (hw.P - hw.reserved)


def test_fits_anywhere_follows_the_free_resources():
    cfg, mix, hw = _fleet(nodes=1)
    ref = Reference(hw, mix["pod_types"])
    assert ref.fits_anywhere(0, 0).all()
    ref.nic_pods[:] = 1  # every NIC serves a pod: nothing with a NIC fits
    assert not ref.fits_anywhere(0, 0).any()
    ref.nic_pods[:] = 0
    ref.gpu_used[:] = True  # no GPU: only the CPU-only type fits
    assert not ref.fits_anywhere(0, 0).any() and ref.fits_anywhere(1, 0).all()
    assert not ref.fits_anywhere(1, 1).any()  # node 0 is in group 0 only


def _broken(a: Answers, how: str) -> Answers:
    b = copy.deepcopy(a)
    if how == "numa":  # one proc core moved to the other NUMA node
        j = int(np.flatnonzero(b.c_part == PROC)[0])
        b.c_id[j] = (b.c_id[j] + 32) % 64
    elif how == "double_core":  # two pods name one core
        j = int(np.flatnonzero((b.c_pod == 1) & (b.c_part == MISC))[0])
        b.c_id[j] = b.c_id[int(np.flatnonzero(b.c_pod == 0)[0])]
    elif how == "gpu":
        b.g_id[1] = b.g_id[0]
        b.node[b.g_pod[1]] = b.node[b.g_pod[0]]
    elif how == "lost_pod":  # a placed pod reported unplaced
        b.node[0] = -1
    elif how == "nic":
        b.n_id[1] = b.n_id[0]
        b.node[b.n_pod[1]] = b.node[b.n_pod[0]]
    return b


@pytest.mark.parametrize("how", ["numa", "double_core", "gpu", "lost_pod", "nic"])
def test_each_broken_guarantee_is_caught(how):
    cfg, mix, hw = _fleet()
    placer = Reference(hw, mix["pod_types"])
    a = _answers(placer, *_gang())
    judge = Reference(hw, mix["pod_types"])
    v = judge.judge(_broken(a, how))
    assert v.bad_placements + v.bad_failures > 0, v.notes


def test_rows_mismatch_when_a_teardown_never_reaches_the_device():
    cfg, mix, hw = _fleet()
    placer = Reference(hw, mix["pod_types"])
    a = _answers(placer, *_gang())
    stale = placer.rows()
    placer.release(a)
    assert placer.row_mismatches(stale) > 0


@pytest.mark.parametrize("name", ["cap1k.backlog10k"])
def test_the_control_is_not_correct(name, manifest):
    cell = mf.cell(manifest, name)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]), nodes=16)
    out = run_control(manifest, cell, cfg, mix, 2 ** 35 + 1, 0.5)
    assert not out["correct"]
    assert out["checks"]["bad_placements"] > 0


def test_one_node_rule_agrees_with_the_vectorized_rule():
    cfg, mix, hw = _fleet(nodes=12)
    ref = Reference(hw, mix["pod_types"])
    rng = np.random.default_rng(3)
    ref.phys_used |= rng.random(ref.phys_used.shape) < 0.7
    ref.gpu_used |= rng.random(ref.gpu_used.shape) < 0.6
    ref.nic_pods += rng.random(ref.nic_pods.shape) < 0.8
    ref.hp_free -= rng.integers(0, hw.hugepages, hw.N)
    for ignored in (False, True):
        for ti in range(3):
            for gi in range(3):
                vec = ref.fits_anywhere(ti, gi, nic_pods_ignored=ignored)
                one = [ref.first_choice(ti, gi, n, ignored) is not None
                       for n in range(hw.N)]
                assert vec.tolist() == one
