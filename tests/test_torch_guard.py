"""The port's solver fault guard (nhd_tpu_torch/solver/guard.py) against
the JAX guard (nhd_tpu/solver/guard.py), case by case from
tests/test_guard.py.

Each ladder and audit case runs one script — the same injector, knobs
and corruption — through both packages' ``BatchScheduler`` on the CPU:
the port with ``device="cpu"``, the reference with resident state forced
on and no mesh (``device_state=True, mesh=None``), so both ladders start
at the single-device rung. The trace of each run is compared whole: the
placements, every ``on_fault`` verdict with the floor after it, the
floor after each batch, the guard's counter deltas and the audit's
defect strings. The port's own classification of CUDA errors
(``KernelLaunchError`` codes, OOM, sticky errors) is checked beside the
reference's shared cases.

The device-fault chaos cells of tests/test_guard.py (:429-589) run on
the port's ChaosSim (``device="cpu"``): faulted binds bit-identical to a
fault-free run, the ``NHD_GUARD=0`` negative control, the refused
vacuous posture, the storm matrix's cell timeout, and a hard-down device
condemned to the non-resident rung on the same device. The mesh rung
(tests/test_guard.py:226) runs both ladders from the top: the port on 8
CPU shards, the reference on its 8 virtual devices. The AOT quarantine
cases are in tests/test_torch_aot.py.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nhd_tpu.k8s.retry as jx_retry
import nhd_tpu.sim.workloads as jx_workloads
import nhd_tpu.solver.batch as jx_batch
import nhd_tpu.solver.device_state as jx_device_state
import nhd_tpu.solver.encode as jx_encode
import nhd_tpu.solver.guard as jx_guard
import nhd_tpu_torch.k8s.retry as pt_retry
import nhd_tpu_torch.sim.workloads as pt_workloads
import nhd_tpu_torch.solver.batch as pt_batch
import nhd_tpu_torch.solver.device_state as pt_device_state
import nhd_tpu_torch.solver.encode as pt_encode
import nhd_tpu_torch.solver.guard as pt_guard
from nhd_tpu_torch.kernels import build as pt_build

GUARD_COUNTERS = (
    "guard_faults_total", "guard_retries_total", "guard_giveups_total",
    "guard_degradations_total", "guard_promotions_total",
    "guard_audits_total", "guard_audit_rows_total",
    "guard_corruptions_total", "guard_repairs_total",
)


def _side(name):
    if name == "jax":
        return SimpleNamespace(
            name=name, guard=jx_guard, retry=jx_retry, wl=jx_workloads,
            batch=jx_batch, encode=jx_encode, dsm=jx_device_state,
            sched=lambda: jx_batch.BatchScheduler(
                respect_busy=False, register_pods=False,
                device_state=True, mesh=None,
            ),
        )
    return SimpleNamespace(
        name=name, guard=pt_guard, retry=pt_retry, wl=pt_workloads,
        batch=pt_batch, encode=pt_encode, dsm=pt_device_state,
        sched=lambda: pt_batch.BatchScheduler(
            device="cpu", respect_busy=False, register_pods=False,
        ),
    )


@pytest.fixture(autouse=True)
def _clean_guards(monkeypatch):
    """Both guards start at full fidelity with no injector; classic
    rounds and the reference's resident state on the CPU backend."""
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    for g in (jx_guard, pt_guard):
        g.GUARD.reset()
        g.set_fault_injector(None)
    yield
    for g in (jx_guard, pt_guard):
        g.set_fault_injector(None)
        g.GUARD.reset()


def _items(side, n):
    return [
        side.batch.BatchItem(("ns", f"p{i}"), r)
        for i, r in enumerate(side.wl.workload_mix(n, ["default"]))
    ]


def _cluster(side, n):
    return side.wl.cap_cluster(n, ["default"])


def _placements(results):
    return [r.node for r in results]


class _NShot:
    """Raise the side's InjectedDeviceFault at the first *n* calls at
    *site*, then go quiet."""

    def __init__(self, side, n, site="dispatch"):
        self.exc, self.left, self.site = side.guard.InjectedDeviceFault, n, site

    def __call__(self, site, detail=""):
        if site == self.site and self.left > 0:
            self.left -= 1
            raise self.exc(f"injected at {site} ({detail})")


class _Trace:
    """Records every on_fault verdict (with the floor after it) and the
    guard counter deltas of one side's run."""

    def __init__(self, side, monkeypatch):
        self.side, self.moves, self.floors = side, [], []
        g = side.guard.GUARD
        orig = g.on_fault

        def on_fault(exc, **kw):
            verdict = orig(exc, **kw)
            self.moves.append((verdict, kw["rung"], kw["attempt"], g.floor))
            return verdict

        monkeypatch.setattr(g, "on_fault", on_fault)
        self.base = side.retry.API_COUNTERS.snapshot()

    def batch(self, sched, nodes, items, **kw):
        out = sched.schedule(nodes, items, **kw)
        self.floors.append(self.side.guard.GUARD.floor)
        return out

    def deltas(self):
        now = self.side.retry.API_COUNTERS.snapshot()
        return {k: now[k] - self.base[k] for k in GUARD_COUNTERS}


# ---------------------------------------------------------------------------
# the ladder scripts (tests/test_guard.py :134, :155, :199, :214, :554)
# ---------------------------------------------------------------------------


def _transient_retry(side, mp):
    items = _items(side, 9)
    clean, _ = side.sched().schedule(_cluster(side, 6), items)
    side.guard.GUARD.reset()
    inj = _NShot(side, 1)
    side.guard.set_fault_injector(inj)
    tr = _Trace(side, mp)
    faulted, _ = tr.batch(side.sched(), _cluster(side, 6), items)
    assert inj.left == 0
    assert _placements(faulted) == _placements(clean)
    assert side.guard.GUARD.floor == side.guard.RUNG_MESH
    return _placements(clean), _placements(faulted), tr


def _degrade_and_repromote(side, mp):
    mp.setenv("NHD_GUARD_RETRIES", "1")
    mp.setenv("NHD_GUARD_PROBE_ROUNDS", "2")
    items = _items(side, 9)
    clean, _ = side.sched().schedule(_cluster(side, 6), items)
    side.guard.GUARD.reset()
    side.guard.set_fault_injector(_NShot(side, 1))
    tr = _Trace(side, mp)
    faulted, _ = tr.batch(side.sched(), _cluster(side, 6), items)
    assert side.guard.GUARD.floor == side.guard.RUNG_HOST
    side.guard.set_fault_injector(None)
    later = []
    for _ in range(8):
        res, _ = tr.batch(side.sched(), _cluster(side, 6), _items(side, 6))
        later.append(_placements(res))
        if side.guard.GUARD.floor == side.guard.RUNG_MESH:
            break
    assert side.guard.GUARD.floor == side.guard.RUNG_MESH
    assert side.retry.API_COUNTERS.get("guard_rung") == side.guard.RUNG_MESH
    return _placements(clean), _placements(faulted), later, tr


def _terminal_surfaces(side, mp):
    def _terminal(site, detail=""):
        if site == "dispatch":
            raise ValueError("deterministic program bug")

    side.guard.set_fault_injector(_terminal)
    tr = _Trace(side, mp)
    with pytest.raises(ValueError):
        side.sched().schedule(_cluster(side, 4), _items(side, 4))
    return tr


def _ladder_exhaustion(side, mp):
    mp.setenv("NHD_GUARD_RETRIES", "1")
    side.guard.set_fault_injector(_NShot(side, 50))
    tr = _Trace(side, mp)
    with pytest.raises(side.guard.InjectedDeviceFault):
        side.sched().schedule(_cluster(side, 4), _items(side, 4))
    assert side.guard.GUARD.floor == side.guard.RUNG_HOST
    return tr


def _hard_down_build(side, mp):
    items = _items(side, 6)
    clean, _ = side.sched().schedule(_cluster(side, 6), items)
    side.guard.GUARD.reset()
    cls = side.dsm.DeviceClusterState
    orig = cls._put

    def _dead(self, padded):
        raise side.guard.InjectedDeviceFault("device copy: card down")

    mp.setattr(cls, "_put", _dead)
    tr = _Trace(side, mp)
    faulted, _ = tr.batch(side.sched(), _cluster(side, 6), items)
    assert side.guard.GUARD.floor == side.guard.RUNG_HOST
    mp.setattr(cls, "_put", orig)
    mp.setenv("NHD_GUARD_PROBE_ROUNDS", "1")
    for _ in range(6):
        tr.batch(side.sched(), _cluster(side, 6), _items(side, 4))
        if side.guard.GUARD.floor == side.guard.RUNG_MESH:
            break
    assert side.guard.GUARD.floor == side.guard.RUNG_MESH
    return _placements(clean), _placements(faulted), tr


def _site_fault(site, speculate):
    """One fault at *site* (``megaround``: the speculative round 0;
    ``upload``: the row update a later round's dispatch flushes)."""

    def script(side, mp):
        mp.setenv("NHD_TPU_SPECULATE", speculate)
        items = _items(side, 40)   # several rounds on 4 nodes
        clean, _ = side.sched().schedule(_cluster(side, 4), items)
        side.guard.GUARD.reset()
        inj = _NShot(side, 1, site=site)
        side.guard.set_fault_injector(inj)
        tr = _Trace(side, mp)
        faulted, stats = tr.batch(side.sched(), _cluster(side, 4), items)
        assert inj.left == 0, f"no {site} call to fault"
        return (_placements(clean), _placements(faulted), stats.rounds,
                stats.counters.get("spec_iterations", 0), tr)

    return script


LADDER = {
    "megaround_fault": _site_fault("megaround", "1"),
    "upload_fault": _site_fault("upload", "0"),
    "transient_retry": _transient_retry,
    "degrade_and_repromote": _degrade_and_repromote,
    "terminal_surfaces": _terminal_surfaces,
    "ladder_exhaustion": _ladder_exhaustion,
    "hard_down_build": _hard_down_build,
}


def _observe(out):
    """The comparable part of a script's return: its values, with each
    trace replaced by its moves, floors and counter deltas."""
    out = out if isinstance(out, tuple) else (out,)
    return [
        (o.moves, o.floors, o.deltas()) if isinstance(o, _Trace) else o
        for o in out
    ]


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_matches_the_jax_guard(case, monkeypatch):
    """Same injector script → the same on_fault verdicts and floors, the
    same counter deltas and the same placements on both packages."""
    got = {}
    for name in ("jax", "port"):
        with monkeypatch.context() as mp:
            got[name] = _observe(LADDER[case](_side(name), mp))
        for g in (jx_guard, pt_guard):
            g.GUARD.reset()
            g.set_fault_injector(None)
    assert got["port"] == got["jax"]
    _moves, _floors, deltas = got["port"][-1]
    assert deltas["guard_faults_total"] > 0, "the script faulted nothing"


# ---------------------------------------------------------------------------
# the audit scripts (tests/test_guard.py :273, :301, :318)
# ---------------------------------------------------------------------------


def _delta_ctx(side, n_nodes=6):
    nodes = _cluster(side, n_nodes)
    sched = side.sched()
    delta = side.encode.ClusterDelta(nodes, now=0.0, respect_busy=False)
    ctx = sched.make_context(nodes, now=0.0, delta=delta)
    assert ctx.dev is not None
    return sched, ctx


def _flip_row(side, dev, name, row):
    if side.name == "jax":
        cur = np.asarray(dev._dev[name][row])
        bad = ~cur if cur.dtype == np.bool_ else cur + np.ones_like(cur)
        dev._dev[name] = dev._dev[name].at[row].set(bad)
        return
    t = dev._dev[name]
    t[row] = ~t[row] if t.dtype == torch.bool else t[row] + 1


def _audit_repairs_bit_flip(side, mp):
    mp.setenv("NHD_GUARD_AUDIT_INTERVAL", "1")
    mp.setenv("NHD_GUARD_AUDIT_ROWS", "0")
    s0, c0 = _delta_ctx(side)
    clean, _ = s0.schedule(c0.nodes, _items(side, 6), context=c0)
    side.guard.GUARD.reset()
    sched, ctx = _delta_ctx(side)
    _flip_row(side, ctx.dev, "smt", 1)        # a static array
    _flip_row(side, ctx.dev, "cpu_free", 3)   # a claim-mutated one
    found = side.guard.audit_device_rows(ctx.dev, range(ctx.dev.N))
    tr = _Trace(side, mp)
    faulted, stats = tr.batch(sched, ctx.nodes, _items(side, 6), context=ctx)
    assert found and "guard_audit" in stats.phases
    assert side.guard.audit_device_rows(ctx.dev, range(ctx.dev.N)) == []
    return _placements(clean), _placements(faulted), found, tr


def _guard_off_corruption_persists(side, mp):
    mp.setenv("NHD_GUARD", "0")
    mp.setenv("NHD_GUARD_AUDIT_INTERVAL", "1")
    mp.setenv("NHD_GUARD_AUDIT_ROWS", "0")
    sched, ctx = _delta_ctx(side)
    _flip_row(side, ctx.dev, "smt", 1)
    tr = _Trace(side, mp)
    res, _ = tr.batch(sched, ctx.nodes, _items(side, 6), context=ctx)
    errs = side.guard.audit_device_rows(ctx.dev, range(ctx.dev.N))
    assert errs and "smt" in errs[0]
    return _placements(res), errs, tr


def _audit_budget_rotates(side, mp):
    mp.setenv("NHD_GUARD_AUDIT_ROWS", "2")
    _sched, ctx = _delta_ctx(side)
    _flip_row(side, ctx.dev, "hp_free", 5)   # the last row
    tr = _Trace(side, mp)
    found = []
    for _ in range(4):   # ceil(6 / 2) windows cover every row
        errs = side.guard.GUARD.run_audit(ctx.dev)
        found.append(errs)
        if errs:
            ctx.dev.rebuild_resident()
    assert sum(1 for e in found if e) == 1
    assert side.guard.audit_device_rows(ctx.dev, range(ctx.dev.N)) == []
    return found, tr


AUDITS = {
    "audit_repairs_bit_flip": _audit_repairs_bit_flip,
    "guard_off_corruption_persists": _guard_off_corruption_persists,
    "audit_budget_rotates": _audit_budget_rotates,
}


@pytest.mark.parametrize("case", sorted(AUDITS))
def test_audit_matches_the_jax_guard(case, monkeypatch):
    """Same corruption → the same defect strings, repairs, counters and
    placements on both packages."""
    got = {}
    for name in ("jax", "port"):
        with monkeypatch.context() as mp:
            got[name] = _observe(AUDITS[case](_side(name), mp))
        for g in (jx_guard, pt_guard):
            g.GUARD.reset()
    assert got["port"] == got["jax"]


def test_audit_pulls_once(monkeypatch):
    """The port's audit brings every sampled row of every resident
    tensor back in ONE device-to-host copy."""
    _sched, ctx = _delta_ctx(_side("port"))
    pulls = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        pulls.append(tuple(self.shape))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    assert pt_guard.audit_device_rows(ctx.dev, range(ctx.dev.N)) == []
    assert len(pulls) == 1


# ---------------------------------------------------------------------------
# detect: classification and the rank screen (tests/test_guard.py :90, :114)
# ---------------------------------------------------------------------------

SHARED_CASES = {
    "injected": (lambda g: g.InjectedDeviceFault("x"), True),
    "corruption": (lambda g: g.DeviceCorruptionError("x"), True),
    "oserror": (lambda g: OSError("transfer reset"), True),
    "memoryerror": (lambda g: MemoryError(), True),
    "valueerror": (lambda g: ValueError("bad arg"), False),
    "typeerror": (lambda g: TypeError("bad call"), False),
    "keyerror": (lambda g: KeyError("k"), False),
}


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_classification_shared_with_the_jax_guard(case):
    make, transient = SHARED_CASES[case]
    assert jx_guard.classify_device_fault(make(jx_guard)) is transient
    assert pt_guard.classify_device_fault(make(pt_guard)) is transient


def _accel(msg, code=None):
    exc = torch.AcceleratorError(msg)
    if code is not None:
        exc.error_code = code
    return exc


CUDA_CASES = {
    # the launchers' own refusals (spec_apply at 2^31 elements, spec_fill
    # past INT_MAX - 1024 nodes) and bad launch shapes: facts about the call
    "invalid_value": (lambda: pt_build.KernelLaunchError(
        "spec_apply", 1, "invalid argument"), False),
    "invalid_configuration": (lambda: pt_build.KernelLaunchError(
        "spec_fill", 9, "invalid configuration argument"), False),
    "out_of_resources": (lambda: pt_build.KernelLaunchError(
        "solve_planes", 701, "too many resources requested for launch"),
        False),
    # device short of memory: transient
    "allocation": (lambda: pt_build.KernelLaunchError(
        "nic_any_first", 2, "out of memory"), True),
    "torch_oom": (lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    "accelerator_oom_code": (lambda: _accel("CUDA error", 2), True),
    "runtime_oom_message": (lambda: RuntimeError(
        "CUDA error: out of memory"), True),
    # sticky context errors: the context is unusable, so terminal
    "illegal_address": (lambda: pt_build.KernelLaunchError(
        "spec_elect", 700, "an illegal memory access was encountered"),
        False),
    "device_assert": (lambda: pt_build.KernelLaunchError(
        "spec_fill", 710, "device-side assert triggered"), False),
    "launch_failure": (lambda: pt_build.KernelLaunchError(
        "nic_node_masks", 719, "unspecified launch failure"), False),
    "accelerator_illegal_address": (lambda: _accel(
        "CUDA error: an illegal memory access was encountered"), False),
    "accelerator_sticky_code": (lambda: _accel("CUDA error", 710), False),
    "runtime_device_assert": (lambda: RuntimeError(
        "CUDA error: device-side assert triggered"), False),
    "runtime_plain": (lambda: RuntimeError("a plain bug"), False),
}


@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_fault_classification(case):
    make, transient = CUDA_CASES[case]
    exc = make()
    assert pt_guard.classify_device_fault(exc) is transient
    verdict = pt_guard.GUARD.on_fault(exc, rung=pt_guard.RUNG_SINGLE, attempt=1)
    assert verdict == ("retry" if transient else "raise")


def test_launch_error_carries_the_cuda_code(monkeypatch):
    """A launcher's nonzero return raises KernelLaunchError with the code,
    which the guard reads (no card needed: the library is stubbed)."""

    entry = pt_build.ABI["spec_apply"].entry
    lib = SimpleNamespace(**{
        entry: lambda *args: 1,
        entry + "_error": lambda code: b"invalid argument",
    })
    monkeypatch.setattr(pt_build, "load", lambda name: lib)
    with pytest.raises(pt_build.KernelLaunchError) as info:
        pt_build.launch("spec_apply")
    assert info.value.code == 1 and isinstance(info.value, RuntimeError)
    assert not pt_guard.classify_device_fault(info.value)


SCREENS = {
    "clean": lambda a: None,
    "negative_value": lambda a: a[0].__setitem__((0, 0), -3),
    "index_at_pad": lambda a: a[1].__setitem__((1, 1), 8),
    "index_negative": lambda a: a[1].__setitem__((0, 2), -1),
}


@pytest.mark.parametrize("case", sorted(SCREENS))
def test_screen_rank_matches_the_jax_guard(case):
    arr = np.zeros((9, 2, 4), np.int32)
    SCREENS[case](arr)
    got = pt_guard.GUARD.screen_rank(arr, 8)
    assert got == jx_guard.GUARD.screen_rank(arr, 8)
    assert (got is None) == (case == "clean")


def test_screen_rank_shape_and_float():
    for arr in (np.zeros((3, 2), np.int32), np.full((9, 2, 4), np.nan)):
        assert pt_guard.GUARD.screen_rank(arr, 8) == \
            jx_guard.GUARD.screen_rank(arr, 8)
        assert pt_guard.GUARD.screen_rank(arr, 8) is not None


# ---------------------------------------------------------------------------
# the device-faults chaos cell on the port (tests/test_guard.py :429-589)
# ---------------------------------------------------------------------------


def _device_chaos_env(monkeypatch):
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_GUARD_AUDIT_INTERVAL", "1")
    monkeypatch.setenv("NHD_GUARD_AUDIT_ROWS", "0")


def test_device_chaos_binds_bit_identical_to_fault_free(monkeypatch):
    """Injected dispatch, upload and megaround faults and bit-flipped
    resident rows end in the bound set of a fault-free run of the same
    seed: no restart, every corruption repaired in-process (end-state
    audit bit-exact), no guard give-up."""
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES

    _device_chaos_env(monkeypatch)
    total_faults = 0
    for seed in (0, 1):
        pt_guard.GUARD.reset()
        control = ChaosSim(seed=seed, api_faults=None, device="cpu")
        control.run(steps=25)
        control.quiesce()

        pt_guard.GUARD.reset()
        base_giveups = pt_retry.API_COUNTERS.get("guard_giveups_total")
        sim = ChaosSim(seed=seed, api_faults=PROFILES["device-faults"],
                       device="cpu")
        sim.run(steps=25)
        sim.quiesce()
        assert sim.stats.violations == []
        assert sim.stuck_pods() == []
        assert sim.bound_set() == control.bound_set(), seed
        assert sim.stats.restarts == control.stats.restarts
        assert sim.device_audit_errors() == []
        assert pt_retry.API_COUNTERS.get("guard_giveups_total") == base_giveups
        faults = sim.fault_totals()
        total_faults += (
            faults["device_dispatch_errors"]
            + faults["device_upload_errors"] + faults["device_bit_flips"]
        )
    assert total_faults > 0  # the storm was real, not vacuous


def test_device_chaos_negative_control_violates_parity(monkeypatch):
    """The corruption storm with the guard disabled: bit-flipped resident
    rows survive whole steps (the audit reports them) and nothing is
    repaired, proving the guard repairs in the positive cell."""
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import FaultProfile

    _device_chaos_env(monkeypatch)
    monkeypatch.setenv("NHD_GUARD", "0")
    flips = FaultProfile(name="flips-only", device_bit_flip=0.5)
    pt_guard.GUARD.reset()
    base_repairs = pt_retry.API_COUNTERS.get("guard_repairs_total")
    sim = ChaosSim(seed=0, api_faults=flips, device="cpu")
    audit_fired = 0
    for _ in range(25):
        flips_before = sim.stats.bit_flips
        sim.step()
        if sim.stats.bit_flips > flips_before and sim.device_audit_errors():
            audit_fired += 1
    sim.quiesce()
    assert sim.stats.bit_flips > 0
    assert pt_retry.API_COUNTERS.get("guard_repairs_total") == base_repairs
    assert audit_fired > 0, "the negative control is vacuous"


def test_device_profile_refuses_vacuous_posture(monkeypatch):
    """A device storm against no resident state would pass vacuously:
    the port keeps resident tensors unless NHD_TPU_DEVICE_STATE=0 asks
    for none, and then the sim refuses; device profiles run solo."""
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES

    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "0")
    with pytest.raises(ValueError, match="resident-state"):
        ChaosSim(seed=0, api_faults=PROFILES["device-faults"], device="cpu")
    monkeypatch.delenv("NHD_TPU_DEVICE_STATE")
    with pytest.raises(ValueError, match="solo"):
        ChaosSim(seed=0, api_faults=PROFILES["device-faults"], ha=True,
                 device="cpu")
    sim = ChaosSim(seed=0, api_faults=PROFILES["device-faults"], device="cpu")
    assert sim.device_injector is not None
    sim.quiesce()


def test_storm_cell_timeout_reports_and_fails(tmp_path, monkeypatch):
    import json
    import time

    from nhd_tpu_torch.sim import storm

    def _hang(args, profile, seed):
        time.sleep(5.0)
        return {"ok": True}

    monkeypatch.setattr(storm, "_run_cell", _hang)
    out = tmp_path / "matrix.json"
    rc = storm.main([
        "--seeds", "1", "--steps", "1", "--profiles", "light",
        "--cell-timeout", "0.3", "--json-out", str(out), "--device", "cpu",
    ])
    assert rc == 1
    summary = json.loads(out.read_text())
    assert summary["cells_failed"] == 1
    cell = summary["cells"][0]
    assert cell["timeout"] is True
    assert cell["profile"] == "light" and cell["seed"] == 0
    assert "timed out" in cell["violations"][0]


def test_hard_down_device_solves_on_the_same_device(monkeypatch):
    """A device whose resident copies all fail is condemned straight to
    the non-resident rung, and that rung solves on the scheduler's own
    device (it uploads from host truth every round), binding as the
    fault-free run did."""
    from nhd_tpu_torch.solver import kernel as pt_kernel

    side = _side("port")
    items = _items(side, 6)
    clean, _ = side.sched().schedule(_cluster(side, 6), items)
    pt_guard.GUARD.reset()

    def _dead(self, padded):
        raise pt_guard.InjectedDeviceFault("device copy: card down")

    seen = []
    orig = pt_kernel.dispatch_ranked

    def spy(G, U, K, R, Tp, Np, node, pod):
        seen.append(node[0].device)
        return orig(G, U, K, R, Tp, Np, node, pod)

    monkeypatch.setattr(pt_device_state.DeviceClusterState, "_put", _dead)
    monkeypatch.setattr(pt_kernel, "dispatch_ranked", spy)
    sched = side.sched()
    faulted, _ = sched.schedule(_cluster(side, 6), items)
    assert _placements(faulted) == _placements(clean)
    assert pt_guard.GUARD.floor == pt_guard.RUNG_HOST
    assert seen and set(seen) == {sched.device}


# ---------------------------------------------------------------------------
# the mesh rung (tests/test_guard.py:226): a faulting mesh dispatch or
# megaround condemns the mesh, and the round re-dispatches on one device
# ---------------------------------------------------------------------------


def _mesh_rung(side, mp, site):
    from tests.test_torch_sharding import cpu_mesh, jax_mesh

    mesh = (lambda: jax_mesh()) if side.name == "jax" else (lambda: cpu_mesh())

    def sched():
        if side.name == "jax":
            return jx_batch.BatchScheduler(respect_busy=False, register_pods=False,
                                           device_state=True, mesh=mesh())
        return pt_batch.BatchScheduler(device="cpu", respect_busy=False,
                                       register_pods=False, mesh=mesh())

    mp.setenv("NHD_GUARD_RETRIES", "1")
    items = _items(side, 9)
    # a faulted batch never speculates again, so a megaround fault's
    # batch is the fault-free classic batch
    with mp.context() as classic:
        classic.setenv("NHD_TPU_SPECULATE", "0")
        clean, _ = sched().schedule(_cluster(side, 8), items)
    side.guard.GUARD.reset()
    inj = _NShot(side, 1, site)
    side.guard.set_fault_injector(inj)
    tr = _Trace(side, mp)
    faulted, _ = tr.batch(sched(), _cluster(side, 8), items)
    assert inj.left == 0
    assert _placements(faulted) == _placements(clean)
    g = side.guard.GUARD
    assert g.floor == side.guard.RUNG_SINGLE
    assert not g.allow_mesh() and g.allow_device()
    # a persistent context built now comes up at the degraded rung
    ctx = sched().make_context(_cluster(side, 8), now=0.0)
    assert ctx.dev is not None and ctx.dev.mesh is None
    return _placements(clean), tr.moves, tr.floors, tr.deltas()


@pytest.mark.parametrize("site", ["dispatch", "megaround"])
def test_mesh_rung_degrades_to_single_device(site, monkeypatch):
    """One injected fault at the top of the ladder (a mesh solve, or the
    mesh megaround with speculation on): the mesh is condemned, the round
    re-dispatches on one device with the fault-free placements, and both
    ladders move alike."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1" if site == "megaround" else "0")
    got = {}
    for name in ("jax", "port"):
        with monkeypatch.context() as mp:
            got[name] = _mesh_rung(_side(name), mp, site)
        _side(name).guard.set_fault_injector(None)
        _side(name).guard.GUARD.reset()
    assert got["port"] == got["jax"]
    assert got["port"][1][0][:2] == ("retry", pt_guard.RUNG_MESH)
