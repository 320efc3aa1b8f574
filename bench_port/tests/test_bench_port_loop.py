"""The closed loop over the program on the CPU at a small size: the
fleet held at its occupancy after every gang, the reference finding the
program's answers correct, and the per-layer readers reading the run."""

import pytest

from bench_port import manifest as mf
from bench_port.fleet import Hardware
from bench_port.program import Program
from bench_port.reference import Reference
from bench_port.run import Loop, run_cell, warm_up
from bench_port.tests.conftest import small
from bench_port.traffic import mix_gangs

SEED = 2 ** 33 + 5
CELL = "cap1k.backlog10k"


@pytest.mark.parametrize("steady", [False, True], ids=["backlog", "steady"])
def test_occupancy_held_after_each_gang(steady, manifest, cell_env):
    cell = mf.cell(manifest, CELL)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]), steady=steady)
    occupancy = mix["occupancy_pods"]
    cell_env(cfg)
    prog = Program(cfg, mix, "cpu")
    loop = Loop(prog, occupancy, traced=False)
    warm_up(loop, mix, SEED)
    assert loop.bound <= occupancy
    live_pods = sum(len(n.pod_info) for n in prog.nodes.values())
    assert live_pods == loop.bound
    for g in mix_gangs(mix, SEED, 3 if not steady else 6, stream=0):
        rec = loop.step(g)
        assert loop.bound <= occupancy
        assert rec["placed"] == rec["pods"]
        assert sum(len(n.pod_info) for n in prog.nodes.values()) == loop.bound
    ref = Reference(Hardware.of(cfg["fleet"], 0.9), mix["pod_types"])
    loop.replay(ref)
    assert ref.verdict.bad_placements == 0 and ref.verdict.bad_failures == 0
    assert ref.row_mismatches(prog.resident_rows()) == 0
    assert int(ref.free_phys().sum()) == sum(
        sum(n.free_cpu_cores_per_numa()) for n in prog.nodes.values())


@pytest.mark.parametrize("traced", [0, 1])
def test_a_small_run_is_correct_and_reads_its_metrics(traced, manifest, cell_env):
    cell = mf.cell(manifest, CELL)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]))
    cell_env(cfg)
    out = run_cell(manifest, cell, cfg, mix, SEED, 1.0, bool(traced), device="cpu")
    assert out["correct"], out["notes"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    got = set(out["metrics"])
    if traced:
        want = {m["name"] for m in mf.per_layer(manifest, CELL)}
        # the CPU run has no device trace and, off CUDA, no megaround
        assert got <= want
        assert {"rounds_per_gang", "assign_ms", "rows_uploaded", "gc_pause_ms"} <= got
        assert "busy_s" in out["device"] and "breakdown" in out
    else:
        assert got == {"pods_per_s", "bind_mean_ms", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())


def test_the_window_leaves_out_the_reading_of_answers(manifest, cell_env, monkeypatch):
    """A slow reading of answers lengthens the wall, not the program's
    window: the pods a second stay those of the program's time."""
    import time

    from bench_port.program import Program as P

    cell = mf.cell(manifest, CELL)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]))
    cell_env(cfg)
    orig = P.answers

    def slow(self, *a):
        time.sleep(0.2)
        return orig(self, *a)

    monkeypatch.setattr(P, "answers", slow)
    out = run_cell(manifest, cell, cfg, mix, SEED, 1.0, False, device="cpu")
    assert out["correct"]
    w = out["window"]
    assert w["program_s"] >= 1.0
    assert w["wall_s"] - w["program_s"] >= 0.2 * out["gangs_in_window"]
    placed = out["attempted"] - out["failed"]
    assert abs(out["metrics"]["pods_per_s"]["value"] - placed / w["program_s"]) < 1e-9


def test_torn_down_pods_leave_the_heap(manifest, cell_env):
    """The loop keeps only the answers of a torn-down gang: the pods'
    topologies and batch items are freed as the program frees them."""
    import gc

    from nhd_tpu_torch.core.topology import PodTopology

    cell = mf.cell(manifest, CELL)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]), steady=True)
    cell_env(cfg)
    prog = Program(cfg, mix, "cpu")
    loop = Loop(prog, mix["occupancy_pods"], traced=False)
    warm_up(loop, mix, SEED)

    def topologies():
        gc.collect()
        return sum(isinstance(o, PodTopology) for o in gc.get_objects())

    before, bound = topologies(), loop.bound
    placed = 0
    for g in mix_gangs(mix, SEED, 12, stream=0):
        placed += loop.step(g)["placed"]
    assert placed > 200
    assert topologies() - before <= loop.bound - bound + 16
