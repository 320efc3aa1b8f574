"""The port's nhdsan and nhdrace (nhd_tpu_torch/sanitizer/), and their
install path.

Every case of tests/test_sanitizer.py, run on the port's sanitizer: a
live lock-order inversion raises DeadlockError with a wait-for-graph
witness instead of hanging, the race layer fires on the injected race
with the static pack's key, and the port's streaming tiler — four tile
workers on the CPU, launching the kernels' plain versions — runs clean
under both, placing as it does uninstrumented. Then the install path:
the pytest plugin (``-p nhd_tpu_torch.sanitizer.pytest_plugin``) on a
port test file passes with the port's module-level locks instrumented,
and fails the session under ``NHD_RACE_INJECT=1``; and the storm's
``NHD_RACE=1`` run of one device-fault cell on the CPU is clean.
"""

import contextlib
import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from nhd_tpu_torch.sanitizer import (
    DeadlockError,
    SanLock,
    Sanitizer,
    get_sanitizer,
    install,
    uninstall,
)
from tests.conftest import subprocess_env

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _installed():
    """Globally installed sanitizer for the block. When the session
    already runs under the port's plugin, reuse the session instance and
    leave it installed on exit."""
    existing = get_sanitizer()
    if existing is not None:
        yield existing
        return
    san = install()
    try:
        yield san
    finally:
        uninstall()


def _run_inversion(san: Sanitizer, a: SanLock, b: SanLock):
    """Drive a guaranteed A/B inversion; returns the DeadlockErrors the
    workers caught. Both threads must terminate (no hang)."""
    ready = threading.Barrier(2)
    errs = []

    def worker(first, second, tag):
        try:
            with first:
                ready.wait()
                with second:
                    pass
        except DeadlockError as exc:
            errs.append((tag, exc))

    t1 = threading.Thread(target=worker, args=(a, b, "ab"), name="san-ab")
    t2 = threading.Thread(target=worker, args=(b, a, "ba"), name="san-ba")
    t1.start()
    t2.start()
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive(), "sanitizer failed to " \
        "break the deadlock — threads still hung"
    return errs


def test_live_two_thread_inversion_reports_cycle():
    san = Sanitizer(poll_interval=0.01)
    lock_a = san.Lock()
    lock_b = san.Lock()    # distinct line: distinct site in the witness
    errs = _run_inversion(san, lock_a, lock_b)
    assert errs, "at least one thread must observe the cycle"
    cycles = san.witnesses("cycle")
    assert cycles
    w = cycles[0]
    waited = {hop["waits_for"] for hop in w["cycle"]}
    assert len(waited) == 2
    assert all("test_torch_sanitizer.py" in site for site in waited)
    assert w["held_by_thread"]


def test_streaming_mesh_cycle_shape_regression():
    """Two tile workers, each holding its own solve context while
    waiting on the other's: the cycle shape the reference's tiler once
    had, caught as a witness."""
    san = Sanitizer(poll_interval=0.01)
    tile0_ctx = san.Lock()
    tile1_ctx = san.Lock()
    errs = _run_inversion(san, tile0_ctx, tile1_ctx)
    assert errs and san.witnesses("cycle")
    with tile0_ctx:
        with tile1_ctx:
            pass
    assert len(san.witnesses("cycle")) >= 1


def test_same_thread_reacquire_of_lock_raises():
    san = Sanitizer(poll_interval=0.01)
    lk = san.Lock()
    with lk:
        with pytest.raises(DeadlockError, match="re-entrant"):
            lk.acquire()
        assert lk.acquire(timeout=0.05) is False
        assert lk.acquire(blocking=False) is False
    assert len(san.witnesses("cycle")) == 1
    with lk:
        pass


def test_rlock_reentrancy_is_not_a_cycle():
    san = Sanitizer(poll_interval=0.01)
    r = san.RLock()
    with r:
        with r:
            assert r._is_owned()
    assert san.witnesses() == []


def test_bounded_acquire_times_out_instead_of_raising():
    san = Sanitizer(poll_interval=0.01)
    a = san.Lock()
    got = []

    def holder():
        with a:
            time.sleep(0.5)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.1)
    got.append(a.acquire(timeout=0.05))
    t.join(5)
    assert got == [False]
    assert san.witnesses("cycle") == []


def test_condition_wait_notify_roundtrip():
    san = Sanitizer(poll_interval=0.01)
    cv = san.Condition()
    hits = []

    def waiter():
        with cv:
            if cv.wait(5):
                hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify()
    t.join(5)
    assert hits == [1]
    assert san.witnesses("cycle") == []


def test_install_patches_and_uninstall_restores():
    if get_sanitizer() is not None:
        pytest.skip("session-level install of the port's plugin active")
    orig_lock = threading.Lock
    orig_get = queue.Queue.get
    san = install()
    try:
        assert threading.Lock is not orig_lock
        lk = threading.Lock()
        assert isinstance(lk, SanLock)
        cv = threading.Condition()
        assert isinstance(cv, threading.Condition)
        with lk:
            pass
        assert get_sanitizer() is san
        assert install() is san
    finally:
        uninstall()
    assert threading.Lock is orig_lock
    assert queue.Queue.get is orig_get
    assert get_sanitizer() is None
    with lk:
        pass


def test_hold_while_blocking_witness_and_dedupe():
    with _installed() as san:
        before = {
            (w["blocking"], w["at"]): w["count"]
            for w in san.witnesses("hold_while_blocking")
        }
        lk = threading.Lock()
        q = queue.Queue()
        for _ in range(3):
            q.put(1)
            with lk:
                q.get()     # unbounded get with a lock held
    wits = [
        w for w in san.witnesses("hold_while_blocking")
        if "test_torch_sanitizer.py" in w["at"]
        and (w["blocking"], w["at"]) not in before
    ]
    assert len(wits) == 1, wits
    assert wits[0]["count"] == 3
    assert any("Lock@" in h for h in wits[0]["held"])


def test_witnesses_flow_into_flight_recorder_and_chrome_trace():
    from nhd_tpu_torch.obs import chrome, recorder

    rec = recorder.enable(capacity=256)
    try:
        san = Sanitizer(poll_interval=0.01)
        _run_inversion(san, san.Lock(), san.Lock())
        spans = [s for s in rec.spans() if s.cat == "nhdsan"]
        assert spans, "cycle witness must mirror into the recorder"
        assert spans[0].name == "nhdsan.cycle"
        trace = san.chrome_trace()
        assert chrome.validate_chrome_trace(trace) == []
        names = {
            e["name"] for e in trace["traceEvents"] if e["ph"] == "X"
        }
        assert "nhdsan.cycle" in names
    finally:
        recorder.disable()


def _port_streaming(monkeypatch, oversized=False):
    """Four tile workers on the CPU: 8 nodes in tiles of 2, routed so
    every tile stage runs from the start, 24 pods; with *oversized*, a
    3-group pod past the lattice budget first (the serial pre-pass on
    the calling thread writes the merge state before the workers)."""
    from tests.test_torch_streaming import _pkg, items, simple_request

    monkeypatch.setenv("NHD_STREAM_WORKERS", "4")
    pkg = _pkg("nhd_tpu_torch")
    nodes = pkg.sim.make_cluster(8)
    reqs = [simple_request(pkg, gpus=i % 2) for i in range(24)]
    if oversized:
        R, T = pkg.request, pkg.topology
        reqs[0] = R.PodRequest(
            groups=tuple(
                R.GroupRequest(R.CpuRequest(1, T.SmtMode.ON),
                               R.CpuRequest(0, T.SmtMode.OFF), 0, 0.0, 0.0)
                for _ in range(3)
            ),
            misc=R.CpuRequest(0, T.SmtMode.OFF), hugepages_gb=0,
            map_mode=T.MapMode.NUMA,
        )
        monkeypatch.setattr(pkg.kernel, "MAX_LATTICE", 4)
    results, stats = pkg.Streaming(
        tile_nodes=2, chunk_pods=5, respect_busy=False, placement="routed",
    ).schedule(nodes, items(pkg, reqs), now=0.0)
    return {(r.key, r.node, str(r.mapping)) for r in results}, stats


@pytest.mark.parametrize("oversized", [False, True])
def test_streaming_schedule_runs_clean_under_instrumentation(oversized,
                                                              monkeypatch):
    """End-to-end: the port's tiler with four tile workers under a
    global nhdsan + nhdrace install completes with zero cycle and zero
    race witnesses, its merge state watched (solver/streaming.py) from
    the pool's start, and places as the same input does
    uninstrumented — with a serial pre-pass too, whose writes come
    before any worker (watched from construction they read as a race)."""
    from nhd_tpu_torch.sanitizer import (
        get_race_sanitizer,
        install_races,
        uninstall_races,
    )

    monkeypatch.setenv("NHD_PIPELINE", "0")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    plain, plain_stats = _port_streaming(monkeypatch, oversized)
    assert plain_stats.scheduled == 24
    session_races = get_race_sanitizer()
    with _installed() as san:
        rs = session_races or install_races(san)
        try:
            placed, stats = _port_streaming(monkeypatch, oversized)
        finally:
            if session_races is None:
                uninstall_races()
        rep = rs.report()
    assert stats.scheduled == 24
    assert placed == plain
    assert san.witnesses("cycle") == []
    assert rep["races"] == []
    assert any(k.endswith("BatchStats.rounds") for k in rep["watched_fields"])


def test_report_shape():
    san = Sanitizer(poll_interval=0.01)
    _run_inversion(san, san.Lock(), san.Lock())
    rep = san.report()
    assert rep["version"] == 1
    assert rep["cycles"] and isinstance(rep["cycles"][0]["cycle"], list)
    assert isinstance(rep["hold_while_blocking"], list)
    assert all(
        {"site", "kind", "acquisitions", "contended"} <= set(lock)
        for lock in rep["locks"]
    )


# ---------------------------------------------------------------------------
# nhdrace: every test builds a PRIVATE Sanitizer + RaceSanitizer pair —
# never the session globals, which the plugin's session teardown judges.
# ---------------------------------------------------------------------------

from nhd_tpu_torch.sanitizer import (  # noqa: E402  (grouped with the suite below)
    RaceSanitizer,
    field_key,
    get_race_sanitizer,
    maybe_watch,
)
from nhd_tpu_torch.sanitizer.races import _InjectedRace, inject_race  # noqa: E402


def _race_pair():
    san = Sanitizer(poll_interval=0.01)
    return san, RaceSanitizer(san)


class _LockedCounter:
    def __init__(self):
        self.value = 0


def test_injected_race_fires_with_joinable_key():
    """The negative control, keyed as the port's static pack keys it
    (field_key reads analysis/lockgraph.py's _mod_label, as the
    reference's does)."""
    from nhd_tpu_torch.analysis.lockgraph import _mod_label

    san, rs = _race_pair()
    try:
        rep = inject_race(rs)
    finally:
        rs.unpatch_all()
    assert rep["races"], "injected race must be detected"
    assert len(rep["races"]) == 1, "witnesses dedupe per field key"
    race = rep["races"][0]
    assert race["key"] == field_key(_InjectedRace, "counter")
    assert race["key"] == "sanitizer/races:_InjectedRace.counter"
    assert _mod_label("nhd_tpu_torch/sanitizer/races.py") == "sanitizer/races"
    assert len(race["threads"]) == 2
    assert race["allowed"] is False
    assert rep["suppressed"] == []
    assert race["key"] in rep["watched_fields"]
    assert san.witnesses("race")
    names = {
        e["name"] for e in san.chrome_trace()["traceEvents"]
        if e["ph"] == "X"
    }
    assert "nhdsan.race" in names


def test_locked_concurrent_writes_stay_silent():
    san, rs = _race_pair()
    obj = _LockedCounter()
    rs.watch(obj, ("value",))
    lk = san.Lock()
    gate = threading.Barrier(2)

    def spin():
        gate.wait(timeout=10)
        for _ in range(200):
            with lk:
                obj.value += 1

    try:
        threads = [threading.Thread(target=spin) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        rs.unpatch_all()
    rep = rs.report()
    assert rep["races"] == [] and rep["suppressed"] == []
    assert obj.value == 400


def test_race_allow_glob_suppresses_but_records():
    san = Sanitizer(poll_interval=0.01)
    rs = RaceSanitizer(san, allow="sanitizer/races:_InjectedRace.*")
    try:
        rep = inject_race(rs)
    finally:
        rs.unpatch_all()
    assert rep["races"] == []
    assert len(rep["suppressed"]) == 1
    assert rep["suppressed"][0]["allowed"] is True
    assert rep["suppressed"][0]["key"].endswith("_InjectedRace.counter")


def test_unpatch_restores_setattr():
    class _Plain:
        def __init__(self):
            self.x = 0

    _san, rs = _race_pair()
    obj = _Plain()
    rs.watch(obj, ("x",))
    assert "__setattr__" in _Plain.__dict__
    assert getattr(_Plain.__setattr__, "_nhdrace_wrapped", False)
    obj.x = 1
    rs.unpatch_all()
    assert "__setattr__" not in _Plain.__dict__
    obj.x = 2
    assert obj.x == 2


def test_maybe_watch_is_noop_without_install():
    if get_race_sanitizer() is not None:
        pytest.skip("session-level install of the port's plugin active")
    maybe_watch(_LockedCounter(), ("value",))
    assert "__setattr__" not in _LockedCounter.__dict__


# ---------------------------------------------------------------------------
# the install path: the pytest plugin and the storm's NHD_RACE=1 run
# ---------------------------------------------------------------------------

PLUGIN = "nhd_tpu_torch.sanitizer.pytest_plugin"


def _plugin_run(tmp_path, **env):
    report = tmp_path / "san.json"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", PLUGIN, "-q",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         "tests/test_torch_abi.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=subprocess_env(NHD_SAN_REPORT=str(report), **env),
    )
    return proc, json.loads(report.read_text())


@pytest.mark.parametrize("inject", [False, True])
def test_plugin_session_under_the_port_sanitizer(inject, tmp_path):
    """A port test file under ``-p nhd_tpu_torch.sanitizer.pytest_plugin``:
    the plugin installed before collection imported the port (the
    kernel build lock and the launch-count lock were created
    instrumented), the report landed at NHD_SAN_REPORT, and the session
    passes — or, with NHD_RACE_INJECT=1, fails on the injected race."""
    env = {"NHD_RACE_INJECT": "1"} if inject else {}
    proc, report = _plugin_run(tmp_path, **env)
    sites = [lock["site"] for lock in report["report"]["locks"]]
    for where in ("nhd_tpu_torch/kernels/__init__.py",
                  "nhd_tpu_torch/kernels/build.py"):
        assert any(where in s for s in sites), (where, sites)
    assert not any("/torch/" in s for s in sites)
    assert report["report"]["cycles"] == []
    keys = [r["key"] for r in report["races"]["races"]]
    out = proc.stdout + proc.stderr
    if inject:
        assert proc.returncode == 1, out
        assert keys == ["sanitizer/races:_InjectedRace.counter"]
        assert "nhdrace observed 1 unsuppressed data race" in out
    else:
        assert proc.returncode == 0, out
        assert keys == []


def test_plugin_refuses_the_reference_sanitizer(monkeypatch):
    """Both sanitizers patch threading: with the JAX package's installed
    the plugin refuses the session before installing anything."""
    import types

    from nhd_tpu_torch.sanitizer import pytest_plugin

    ref = types.SimpleNamespace(get_sanitizer=lambda: object(),
                                get_race_sanitizer=lambda: None)
    monkeypatch.setitem(sys.modules, "nhd_tpu.sanitizer", ref)
    before = dict(pytest_plugin._ACTIVE)   # a session under the plugin
    with pytest.raises(pytest.UsageError, match="both patch threading"):
        pytest_plugin.pytest_configure(None)
    assert pytest_plugin._ACTIVE == before


def test_storm_race_run_is_clean_on_the_cpu(tmp_path):
    """The device-fault storm's ``NHD_RACE=1`` run (the reference's
    device-chaos posture) of one 4-node cell on the CPU: bound as its
    fault-free control, the race report in the summary and empty."""
    out = tmp_path / "storm.json"
    proc = subprocess.run(
        [sys.executable, "-m", "nhd_tpu_torch.sim.storm", "--device", "cpu",
         "--profiles", "device-faults", "--seeds", "1", "--steps", "40",
         "--nodes", "4", "--device-plane", "--bind-parity",
         "--json-out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=subprocess_env(NHD_RACE="1", NHD_PIPELINE="1",
                           NHDC_AOT_DIR=str(tmp_path / "aot")),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(out.read_text())
    assert summary["ok"] and summary["cells"][0]["bind_parity"]
    assert summary["races"]["races"] == []
    assert any("Scheduler.last_heartbeat" in k
               for k in summary["races"]["watched_fields"])
