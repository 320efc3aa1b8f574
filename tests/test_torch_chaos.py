"""The port's chaos engine (nhd_tpu_torch/sim/chaos.py) on the CPU: every
case of tests/test_chaos.py on ``ChaosSim(device="cpu")``, then the
slice as a whole against the reference's ChaosSim.

The mesh cases of tests/test_chaos.py (:55, :75) run twice on the
port: on one device's resident path, and on 8 CPU shards with the mesh
assertion (the port's knob counts GPUs, so there the test hands every
Scheduler the CPU mesh through the daemon's resolver).

The parity cases run one seed and profile through both packages with
the posture knobs set alike (``NHD_TPU_DEVICE_STATE=1``,
``NHD_TPU_SPECULATE=1``, ``NHD_MESH=off``, the same ``NHD_PIPELINE``,
and for the device-fault profile the every-batch full audit of
``--device-plane``) and compare the bound set, the whole ChaosStats,
the fault tallies (API faults, device faults by site, bit flips) and
the end-state device audit. Tolerance: exact equality.
"""

import collections
import dataclasses
import functools

import pytest

import nhd_tpu.sim.chaos as jx_chaos
import nhd_tpu.sim.faults as jx_faults
import nhd_tpu.solver.guard as jx_guard
import nhd_tpu_torch.sim.chaos as pt_chaos
import nhd_tpu_torch.sim.faults as pt_faults
import nhd_tpu_torch.solver.guard as pt_guard

ChaosSim = functools.partial(pt_chaos.ChaosSim, device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_chaos_soak(seed):
    sim = ChaosSim(seed=seed, n_nodes=4)
    stats = sim.run(steps=60)
    assert stats.violations == []
    # the storm actually exercised the lifecycle
    assert stats.created > 10
    assert stats.deleted + stats.cordons + stats.maint_flips > 5


def test_chaos_with_restarts_replays_consistently():
    sim = ChaosSim(seed=99, n_nodes=3)
    stats = sim.run(steps=80)
    assert stats.violations == []
    assert stats.restarts >= 1


def test_chaos_through_speculative_device_path(monkeypatch):
    """The churn storm with the speculative megaround forced on (the
    card's default, driven on the CPU): every conservation invariant
    holds."""
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "6")
    sim = ChaosSim(seed=13, n_nodes=4)
    stats = sim.run(steps=60)
    assert stats.violations == []
    assert stats.created > 10


def test_chaos_through_streaming_scheduler_path(monkeypatch):
    """Every scheduler batch routed through the port's streaming tiler
    (NHD_STREAM_NODES forced to 1)."""
    from nhd_tpu_torch.scheduler import core as core_mod

    monkeypatch.setattr(core_mod, "STREAM_NODE_THRESH", 1)
    sim = ChaosSim(seed=7, n_nodes=4)
    stats = sim.run(steps=60)
    assert stats.violations == []
    assert sim.sched._stream is not None, "streaming path never engaged"
    assert stats.created > 10


def test_chaos_churn_with_resident_path(monkeypatch):
    """The `churn` profile with the resident path active: the
    ClusterDelta.parity_errors invariant runs every step while the row
    updates maintain the resident tensors."""
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    sim = ChaosSim(seed=17, n_nodes=4, api_faults=pt_faults.PROFILES["churn"])
    stats = sim.run(steps=50)
    assert stats.violations == []
    assert stats.created > 10
    ctx = sim.sched._delta_ctx
    assert ctx is not None and ctx.dev is not None, "resident path idle"


def _cpu_mesh_daemons(monkeypatch):
    """Every Scheduler the sim builds (restarts included) shards over 8
    CPU shards, as the reference's over its 8 virtual devices."""
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.scheduler import core as core_mod

    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setattr(core_mod, "resolve_mesh_spec",
                        lambda spec: make_mesh(["cpu"] * 8))


def test_chaos_churn_with_mesh_resident_path(monkeypatch):
    """tests/test_chaos.py:55 with its mesh assertion: the churn profile
    while per-shard row updates maintain the sharded resident tensors,
    the ClusterDelta parity invariant checked every step."""
    _cpu_mesh_daemons(monkeypatch)
    sim = ChaosSim(seed=17, n_nodes=4, api_faults=pt_faults.PROFILES["churn"])
    stats = sim.run(steps=50)
    assert stats.violations == []
    assert stats.created > 10
    ctx = sim.sched._delta_ctx
    assert ctx is not None and ctx.dev is not None
    assert ctx.dev.mesh is not None, "mesh resident path never engaged"


def test_chaos_churn_mesh_negative_control(monkeypatch):
    """tests/test_chaos.py:75: injected divergence between the delta's
    packed arrays and the live mirror fires the parity invariant under
    the mesh cell."""
    _cpu_mesh_daemons(monkeypatch)
    sim = ChaosSim(seed=18, n_nodes=4, api_faults=pt_faults.PROFILES["churn"])
    sim.run(steps=12)
    assert sim.stats.violations == []
    assert sim.sched._delta_ctx.dev.mesh is not None
    sim.sched._delta.arrays.hp_free[0] += 7
    sim.check_invariants()
    assert any("parity" in v for v in sim.stats.violations), (
        sim.stats.violations
    )


def test_chaos_churn_negative_control(monkeypatch):
    """Injected divergence between the delta's packed arrays and the
    live mirror fires the parity invariant under the churn cell."""
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    sim = ChaosSim(seed=18, n_nodes=4, api_faults=pt_faults.PROFILES["churn"])
    sim.run(steps=12)
    assert sim.stats.violations == []
    delta = sim.sched._delta
    assert delta is not None
    delta.arrays.hp_free[0] += 7  # corrupt one packed row behind its back
    sim.check_invariants()
    assert any("parity" in v for v in sim.stats.violations), (
        sim.stats.violations
    )


def test_chaos_through_routed_streaming(monkeypatch):
    from nhd_tpu_torch.scheduler import core as core_mod

    monkeypatch.setattr(core_mod, "STREAM_NODE_THRESH", 1)
    monkeypatch.setattr(core_mod, "STREAM_PLACEMENT", "routed")
    sim = ChaosSim(seed=21, n_nodes=4)
    stats = sim.run(steps=60)
    assert stats.violations == []
    assert sim.sched._stream is not None, "streaming path never engaged"
    assert sim.sched._stream.placement == "routed"
    assert stats.created > 10


def test_chaos_sim_and_storm_default_to_cuda():
    import torch

    from nhd_tpu_torch.sim import storm

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        pt_chaos.ChaosSim(seed=0, n_nodes=4)
    with pytest.raises(RuntimeError, match="cuda"):
        storm.main(["--seeds", "1", "--steps", "1", "--profiles", "light"])


# ---------------------------------------------------------------------------
# the port's ChaosSim against the reference's, seed for seed
# ---------------------------------------------------------------------------


def _by_site(guard):
    """Install a tally of injected faults by site around the installed
    injector (the reference's injector counts upload and megaround
    together)."""
    inner, sites = guard._INJECTOR, collections.Counter()

    def counted(site, detail=""):
        try:
            inner(site, detail)
        except guard.InjectedDeviceFault:
            sites[site] += 1
            raise

    guard.set_fault_injector(counted)
    return sites


def _run(side, seed, profile, steps):
    chaos, faults, guard = (
        (jx_chaos, jx_faults, jx_guard) if side == "jax"
        else (pt_chaos, pt_faults, pt_guard)
    )
    kw = {} if side == "jax" else {"device": "cpu"}
    guard.GUARD.reset()
    sim = chaos.ChaosSim(seed=seed, n_nodes=4,
                         api_faults=faults.PROFILES[profile], **kw)
    sites = _by_site(guard) if sim.device_injector is not None else {}
    sim.run(steps)
    sim.quiesce()
    guard.set_fault_injector(None)
    return {
        "bound": sim.bound_set(),
        "stats": dataclasses.asdict(sim.stats),
        "faults": sim.fault_totals(),
        "sites": dict(sites),
        "audit": _audit(side, sim),
        "stuck": sim.stuck_pods(),
    }


def _audit(side, sim):
    """The end-state audit over the rows the next batch would not
    rewrite: the port's ``device_audit_errors``, and the reference's
    ``audit_device_rows`` over the same rows (its own method also audits
    the rows its delta re-packed after the last batch)."""
    if side == "port":
        return sim.device_audit_errors()
    dev = sim._resident_dev()
    if dev is None or sim.sched._delta._full:
        return []
    pending = sim.sched._delta._dirty
    return jx_guard.audit_device_rows(
        dev, [r for r in range(dev.N) if r not in pending]
    )


def test_end_state_audit_skips_rows_the_next_batch_rewrites(monkeypatch):
    """A fault-free storm whose last action after the last batch changed
    a node (here a release on node2) leaves that row re-packed on the
    host and not yet on the device. The reference's device_audit_errors
    reports it as corruption; the port's leaves it out, and syncing the
    reference's device as the next batch would clears every defect it
    reported."""
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_MESH", "off")
    monkeypatch.setenv("NHD_PIPELINE", "1")
    ref = jx_chaos.ChaosSim(seed=2, n_nodes=4)
    ref.run(30)
    ref.quiesce()
    defects = ref.device_audit_errors()
    assert defects and all("node2" in d for d in defects), defects
    assert ref.sched._delta._dirty == {2}
    port = ChaosSim(seed=2, n_nodes=4)
    port.run(30)
    port.quiesce()
    assert port.bound_set() == ref.bound_set()
    assert port.sched._delta._dirty == {2}
    assert port.device_audit_errors() == []
    ref.sched.batch.refresh_context(ref.sched._delta_ctx)
    assert ref.device_audit_errors() == []


@pytest.mark.parametrize("profile,seed,pipeline", [
    ("light", 0, "0"),
    ("storm", 1, "1"),
    ("device-faults", 0, "0"),
    ("device-faults", 2, "1"),
])
def test_chaos_matches_the_reference(profile, seed, pipeline, monkeypatch):
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_MESH", "off")
    monkeypatch.setenv("NHD_PIPELINE", pipeline)
    if profile == "device-faults":
        monkeypatch.setenv("NHD_GUARD_AUDIT_INTERVAL", "1")
        monkeypatch.setenv("NHD_GUARD_AUDIT_ROWS", "0")
    try:
        got = {side: _run(side, seed, profile, 30) for side in ("jax", "port")}
    finally:
        for g in (jx_guard, pt_guard):
            g.set_fault_injector(None)
            g.GUARD.reset()
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["stats"]["violations"] == [] and port["stuck"] == []
    if profile == "device-faults":
        assert port["audit"] == []
        assert sum(port["sites"].values()) + port["stats"]["bit_flips"] > 0
    else:
        api = ("dropped_events", "poisoned_events", "transient_binds",
               "transient_annotates")
        assert sum(port["faults"][k] for k in api) > 0


# ---------------------------------------------------------------------------
# the storm matrix (sim/storm.py) against tools/chaos_storm.py, mode by mode
# ---------------------------------------------------------------------------


def _reference_storm():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "chaos_storm.py"
    spec = importlib.util.spec_from_file_location("chaos_storm_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", [
    ["--profiles", "light,device-faults", "--device-plane", "--bind-parity"],
    ["--ha", "--profiles", "ha-storm"],
    ["--federation", "2", "--replicas", "2", "--profiles", "fed-storm"],
    ["--policy", "--profiles", "mixed-gen"],
    ["--tenant", "--profiles", "tenant-storm"],
], ids=["solo", "ha", "federation", "policy", "tenant"])
def test_storm_matrix_matches_the_reference_tool(mode, tmp_path, monkeypatch):
    """The same matrix through tools/chaos_storm.py and the port's
    ``python -m nhd_tpu_torch.sim.storm --device cpu``: every cell's
    record equal (the port's device cells add their faults by site,
    give-ups, churn restarts and bound set)."""
    import json

    from nhd_tpu_torch.sim import storm

    for knob in ("NHD_TPU_DEVICE_STATE", "NHD_GUARD_AUDIT_INTERVAL",
                 "NHD_GUARD_AUDIT_ROWS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_MESH", "off")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    common = ["--seeds", "1", "--steps", "20", *mode]
    ref_mod = _reference_storm()
    got = {}
    for side, main, extra in (("jax", ref_mod.main, []),
                              ("port", storm.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.json"
        for g in (jx_guard, pt_guard):
            g.GUARD.reset()
        assert main(common + extra + ["--json-out", str(out)]) == 0
        got[side] = json.loads(out.read_text())
    # --device-plane sets these for the rest of the process, as the
    # reference's flag does
    for knob in ("NHD_TPU_DEVICE_STATE", "NHD_GUARD_AUDIT_INTERVAL",
                 "NHD_GUARD_AUDIT_ROWS"):
        monkeypatch.delenv(knob, raising=False)
    port_only = ("faults_by_site", "guard_giveups", "restarts", "bound_set")
    for cell in got["port"]["cells"]:
        if "faults_by_site" in cell:
            assert cell["guard_giveups"] == 0 and cell["bind_parity"]
            for key in port_only:
                cell.pop(key)
    assert got["port"]["cells"] == got["jax"]["cells"]
    assert got["port"]["matrix"] == got["jax"]["matrix"]
    assert got["port"]["ok"]


@pytest.mark.parametrize("profile,seed,pipeline", [
    ("churn", 3, "0"),
    ("device-faults", 1, "1"),
])
def test_chaos_on_a_mesh_matches_the_reference(profile, seed, pipeline, monkeypatch):
    """One cell through both packages' ChaosSim with the resident path
    sharded: the port's 8 CPU shards, the reference's 8 virtual devices
    (its ``NHD_MESH`` auto). Bound sets, stats, faults by site (bit
    flips land on the owning shard), the end-state audit over the
    shards: equal."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_PIPELINE", pipeline)
    monkeypatch.delenv("NHD_MESH", raising=False)
    _cpu_mesh_daemons(monkeypatch)
    if profile == "device-faults":
        monkeypatch.setenv("NHD_GUARD_AUDIT_INTERVAL", "1")
        monkeypatch.setenv("NHD_GUARD_AUDIT_ROWS", "0")
    from nhd_tpu.obs.jitstats import JIT_STATS as jx_stats
    from nhd_tpu_torch.obs.jitstats import JIT_STATS as pt_stats

    for stats in (jx_stats, pt_stats):
        stats.reset()
    try:
        got = {side: _run(side, seed, profile, 30) for side in ("jax", "port")}
    finally:
        for g in (jx_guard, pt_guard):
            g.set_fault_injector(None)
            g.GUARD.reset()
    for stats in (jx_stats, pt_stats):   # both solved on their mesh
        assert any(k.endswith("_Mnodes8") for k in stats.snapshot()["shapes"])
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["stats"]["violations"] == [] and port["stuck"] == []
    assert port["audit"] == []
