"""On the card: one short run of the cell through ``run.py`` as the
benchmark's command runs it, correct, with no graph captured in the
window; and the program on a stated GPUDirect fleet through
``run.Loop``, judged correct. Skips where no card is present (decided
in a fixture)."""

import json
import subprocess
import sys

import pytest

from bench_port import manifest as mf


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cap1k.backlog10k"])
def test_a_short_run_on_the_card(name, card):
    root = mf.HERE.parent
    got = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", name,
         "--seed", str(2 ** 32 + 9), "--seconds", "3", "--trace", "1"],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    want = {m["name"] for m in mf.per_layer(mf.load(root), name)}
    assert set(out["metrics"]) == want, sorted(want - set(out["metrics"]))
    assert out["metrics"]["window_captures"]["value"] == 0


@pytest.mark.cuda
def test_the_program_on_a_pci_fleet_is_correct_on_the_card(card, cell_env):
    """As ``test_bench_port_pci``'s CPU test, with the megaround on: PCI
    types make it uncertifiable, so what it leaves goes to the classic
    ranked rounds. (The card places otherwise than the CPU, and may
    leave no pod unplaced in these gangs.)"""
    from bench_port.fleet import Hardware
    from bench_port.program import Program
    from bench_port.reference import Reference
    from bench_port.run import Loop, warm_up
    from bench_port.tests.conftest import pci_cell
    from bench_port.traffic import mix_gangs

    seed = 2 ** 33 + 17
    cfg, mix = pci_cell()
    cell_env(cfg)
    prog = Program(cfg, mix, "cuda")
    loop = Loop(prog, mix["occupancy_pods"], traced=False)
    warm_up(loop, mix, seed)
    recs = [loop.step(g) for g in mix_gangs(mix, seed, 24, stream=0)]
    ref = Reference(Hardware.of(cfg["fleet"], 0.9), mix["pod_types"])
    loop.replay(ref)
    v = ref.verdict
    print(f"pci on the card: {sum(r['placed'] for r in recs)} placed, {v.unplaced} "
          f"unplaced, rounds a gang {[r['rounds'] for r in recs]}, "
          f"megaround in {sum(r['spec_round'] for r in recs)} of {len(recs)} gangs")
    assert (v.bad_placements, v.bad_failures) == (0, 0), v.notes
    assert ref.row_mismatches(prog.resident_rows()) == 0, v.notes
    assert v.placed > 200 and any(r["spec_round"] for r in recs)
