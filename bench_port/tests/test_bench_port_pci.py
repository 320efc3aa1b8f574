"""PCI map mode and a stated PCIe-switch layout, as data alone: the
reference's switch rules on hand-built cases (a fleet of two GPUs and
two NICs a switch), the pod types it refuses, the vectorized rule
against the one-node rule, the program on the CPU through ``run.Loop``
judged correct, and the second control judged not correct."""

import copy

import numpy as np
import pytest

from bench_port import manifest as mf
from bench_port.control import run_control
from bench_port.fleet import Hardware
from bench_port.program import Program
from bench_port.reference import PodType, Reference, empty_answers
from bench_port.run import Loop, warm_up
from bench_port.tests.conftest import PCI_TYPES, pci_cell
from bench_port.tests.test_bench_port_reference import _answers
from bench_port.traffic import mix_gangs

SEED = 2 ** 33 + 17
#: PCI_TYPES, then the same one-GPU pod in NUMA map mode
GPU_PCI, CPU_PCI, TWO_PCI, GPU_NUMA = range(4)


def _one_node():
    cfg, mix = pci_cell(nodes=1)
    hw = Hardware.of(cfg["fleet"], cfg["guarantees"]["nic_bw_avail"])
    return hw, mix["pod_types"]


def test_the_fleet_states_its_switches():
    hw, _ = _one_node()
    assert (hw.gps, hw.nps) == (2, 2)
    assert hw.switches() == [0, 1, 16, 17]
    assert hw.gpu_switch().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert hw.nic_switch().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


def test_pci_pod_types_the_reference_cannot_judge_are_refused():
    two = copy.deepcopy(PCI_TYPES[GPU_PCI])
    two["groups"][0]["gpus"] = 2
    with pytest.raises(ValueError, match="asks for 2 GPUs.*NHDScheduler.py:296-299"):
        PodType.of(two)
    dark = copy.deepcopy(PCI_TYPES[GPU_PCI])
    dark["groups"][0].update(rx_gbps=0.0, tx_gbps=0.0)
    with pytest.raises(ValueError, match="no NIC bandwidth"):
        PodType.of(dark)
    with pytest.raises(ValueError, match="not 'RAW'"):
        PodType.of(dict(PCI_TYPES[GPU_PCI], map_mode="RAW"))
    two["map_mode"] = "NUMA"  # NUMA mode takes a two-GPU group as before
    assert not PodType.of(two).pci and PodType.of(PCI_TYPES[CPU_PCI]).pci


@pytest.mark.parametrize("ti,flagged", [(GPU_PCI, True), (GPU_NUMA, False)],
                         ids=["pci", "numa"])
def test_a_gpu_off_its_nics_switch_is_a_bad_placement(ti, flagged):
    """The reference's own placement is correct; the same pod with its
    GPU moved to a free GPU of the other switch of its NUMA node is a bad
    placement in PCI mode, and stays correct in NUMA mode."""
    hw, types = _one_node()
    a = _answers(Reference(hw, types), [ti], [0])
    assert Reference(hw, types).judge(a).bad_placements == 0
    assert hw.gpu_switch()[a.g_id[0]] == hw.nic_switch()[a.n_id[0]]
    moved = copy.deepcopy(a)
    moved.g_id[0] = a.g_id[0] + 2  # GPU 2 of NUMA node 0: switch 1, free
    assert hw.gpu_numa[moved.g_id[0]] == hw.gpu_numa[a.g_id[0]]
    v = Reference(hw, types).judge(moved)
    assert (v.bad_placements == 1) is flagged, v.notes
    assert any("PCIe switch" in n for n in v.notes) is flagged


def _only_gpu_free(ref: Reference, j: int) -> None:
    ref.gpu_used[:] = True
    ref.gpu_used[:, j] = False


def test_a_pod_that_admission_refuses_is_not_a_failure():
    """One free GPU on the node (switch 0). The two-group pod fits by its
    resources (its second group asks for no GPU), but upstream's admission
    counts that group's NIC against its switch's free GPUs: no choice
    passes, so leaving it unplaced is no failure. A CPU-only PCI pod with
    no free GPU anywhere is refused the same way; in NUMA mode the same
    resources admit it."""
    hw, types = _one_node()
    ref = Reference(hw, types)
    _only_gpu_free(ref, 0)
    assert not ref.fits_anywhere(TWO_PCI, 0).any()
    assert ref.fits_anywhere(TWO_PCI, 0, switch_ignored=True).all()
    assert ref.first_choice(TWO_PCI, 0, 0) is None
    assert ref.fits_anywhere(GPU_PCI, 0).all()
    v = ref.judge(empty_answers([TWO_PCI], [0]))
    assert v.bad_failures == 0
    ref.gpu_used[:] = True
    assert not ref.fits_anywhere(CPU_PCI, 0).any()
    assert ref.fits_anywhere(CPU_PCI, 0, switch_ignored=True).all()
    assert ref.judge(empty_answers([CPU_PCI], [0])).bad_failures == 0
    # the one-GPU pod that admission takes is a failure when left out
    _only_gpu_free(ref, 0)
    assert ref.judge(empty_answers([GPU_PCI], [0])).bad_failures == 1


def test_the_placer_takes_gpus_off_the_nics_switch():
    """With GPU 0 of switch 0 taken, a one-GPU PCI pod whose first NIC
    choice is on switch 0 gets GPU 1 (switch 0), never GPU 2 (switch 1);
    a two-group pod's NICs sit where its switches admit them."""
    hw, types = _one_node()
    ref = Reference(hw, types)
    ref.gpu_used[0, 0] = True
    cores, gpus, nics = ref.place(GPU_PCI, 0, 0, pod=0)
    assert [g[2] for g in gpus] == [1] and hw.nic_switch()[nics[0][2]] == 0
    cores, gpus, nics = ref.place(TWO_PCI, 0, 0, pod=1)
    gsw = hw.gpu_switch()[gpus[0][2]]
    assert gsw == hw.nic_switch()[[n for n in nics if n[1] == 0][0][2]]


@pytest.mark.parametrize("ignored", [False, True], ids=["switch", "switch_ignored"])
def test_one_node_rule_agrees_with_the_vectorized_rule_in_pci_mode(ignored):
    cfg, mix = pci_cell(nodes=12)
    hw = Hardware.of(cfg["fleet"], 0.9)
    ref = Reference(hw, mix["pod_types"])
    rng = np.random.default_rng(5)
    ref.phys_used |= rng.random(ref.phys_used.shape) < 0.5
    ref.gpu_used |= rng.random(ref.gpu_used.shape) < 0.6
    ref.nic_pods += rng.random(ref.nic_pods.shape) < 0.5
    for ti in range(len(mix["pod_types"])):
        for gi in range(3):
            vec = ref.fits_anywhere(ti, gi, switch_ignored=ignored)
            one = [ref.first_choice(ti, gi, n, switch_ignored=ignored) is not None
                   for n in range(hw.N)]
            assert vec.tolist() == one


def test_the_program_on_a_pci_fleet_is_correct(cell_env):
    """The port at ``device="cpu"`` through ``run.Loop`` on 16 GPUDirect
    servers held near full: PCI pods placed and refused, each judged by
    the reference, 0 in all three checks."""
    cfg, mix = pci_cell()
    cell_env(cfg)
    prog = Program(cfg, mix, "cpu")
    loop = Loop(prog, mix["occupancy_pods"], traced=False)
    warm_up(loop, mix, SEED)
    recs = [loop.step(g) for g in mix_gangs(mix, SEED, 12, stream=0)]
    ref = Reference(Hardware.of(cfg["fleet"], 0.9), mix["pod_types"])
    loop.replay(ref)
    v = ref.verdict
    assert (v.bad_placements, v.bad_failures) == (0, 0), v.notes
    assert ref.row_mismatches(prog.resident_rows()) == 0, v.notes
    assert v.unplaced > 0 and sum(r["placed"] for r in recs) > 50


def test_the_pci_control_is_not_correct():
    cfg, mix = pci_cell()
    cell = {"name": "pci.small", "config": "cap1k", "traffic": "pci_small", "chips": 1}
    out = run_control({}, cell, cfg, mix, 2 ** 35 + 7, 0.5, broken="pci_switch")
    assert not out["correct"]
    assert out["checks"]["bad_placements"] > 0
    assert any("PCIe switch" in n for n in out["notes"])
