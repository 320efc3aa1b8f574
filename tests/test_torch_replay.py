"""Journal replay on the port (nhd_tpu_torch/sim/replay.py) against the
JAX package's (nhd_tpu/sim/replay.py).

The golden replay pin of tests/test_journal.py on the port: the
committed churn journal re-drives the port's daemon (``device="cpu"``)
with 0 divergences, twice alike, and with the JAX replay's decisions;
its negative controls (a dropped node diverges where the JAX replay
first diverges; a flipped knob is named). Then journals cross between
the packages: one scripted churn scenario (pods of workload_mix's three
Triad shapes created, one deleted, on a fake cluster and a step clock,
driven as the chaos harness drives its stack) recorded by each daemon
replays with 0 divergences through both packages' ``replay_journal``,
and both daemons record the same decisions. Last, the port's one change
of behaviour: a journal of either package's CLI over HTTP (the pods
created on a stub API server and folded by the admission front door)
replays on the port, batch for batch as it was folded and each pod
under its recorded uid, with 0 divergences from the decisions the
recording daemon made live.

Tolerance: exact equality — decisions are outcomes, node names and
victim sets (strings and integers).
"""

from __future__ import annotations

import importlib
import json
import queue
from pathlib import Path

import pytest

from nhd_tpu_torch.sim import pending

GOLDEN = (Path(__file__).resolve().parent
          / "fixtures" / "journal" / "golden_churn.journal.jsonl")
PACKAGES = ("nhd_tpu", "nhd_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _replay(root, paths, **kw):
    if root == "nhd_tpu_torch":
        kw["device"] = "cpu"
    return _mod(root, "sim.replay").replay_journal([str(p) for p in paths], **kw)


def _sig(result):
    dsig = _mod("nhd_tpu_torch", "sim.replay")._decision_sig
    return [(d.get("ns"), d.get("pod"), dsig(d)) for d in result.replayed]


@pytest.fixture(autouse=True)
def _journals_off():
    for root in PACKAGES:
        _mod(root, "obs.journal").disable_journal(finalize=False)
    yield
    for root in PACKAGES:
        _mod(root, "obs.journal").disable_journal(finalize=False)


def test_golden_replay_pin_deterministic():
    r1 = _replay("nhd_tpu_torch", [GOLDEN])
    assert r1.recorded, "golden journal recorded no decisions"
    assert not r1.diverged, r1.first_divergence
    assert r1.knob_drift == {}, r1.knob_drift
    r2 = _replay("nhd_tpu_torch", [GOLDEN])
    assert _sig(r1) == _sig(r2)
    assert _sig(r1) == _sig(_replay("nhd_tpu", [GOLDEN]))


def test_golden_replay_drop_node_diverges_as_the_reference(tmp_path):
    got = _replay("nhd_tpu_torch", [GOLDEN], drop_nodes=["node0"])
    want = _replay("nhd_tpu", [GOLDEN], drop_nodes=["node0"])
    assert got.diverged and got.dropped_nodes == ["node0"]
    assert got.first_divergence == want.first_divergence
    assert got.divergences == want.divergences
    out = got.write_report(str(tmp_path))
    report = json.loads(Path(out).read_text())
    assert report["kind"] == "replay-divergence"
    assert report["payload"]["divergences"][0]["corr"] == got.first_divergence["corr"]


def test_golden_replay_knob_drift_named(monkeypatch):
    from nhd_tpu_torch.obs.journal import load_journal
    from nhd_tpu_torch.sim.replay import knob_drift

    genesis = next(e for e in load_journal(str(GOLDEN))[1] if e["ev"] == "genesis")
    monkeypatch.setenv("NHD_POLICY", "flipped")
    drift = knob_drift(genesis["knobs"])
    assert drift["NHD_POLICY"] == {"recorded": None, "current": "flipped"}
    monkeypatch.setenv("NHD_JOURNAL", "1")
    assert "NHD_JOURNAL" not in knob_drift(genesis["knobs"])
    assert drift == _mod("nhd_tpu", "sim.replay").knob_drift(genesis["knobs"])


# ---------------------------------------------------------------------------
# journals recorded by each daemon
# ---------------------------------------------------------------------------

def _stack(root, clock, n_nodes=4):
    """A fake cluster on *clock* with *n_nodes* synthetic nodes, and the
    package's scheduler (the port's on the CPU) and controller on it."""
    sim, core = _mod(root, "sim"), _mod(root, "scheduler.core")
    backend = _mod(root, "k8s.fake").FakeClusterBackend()
    backend.clock = clock
    for i in range(n_nodes):
        spec = sim.SynthNodeSpec(name=f"node{i}")
        backend.add_node(spec.name, sim.make_node_labels(spec),
                         hugepages_gb=spec.hugepages_gb)
    kw = {"device": "cpu"} if root == "nhd_tpu_torch" else {}
    sched = core.Scheduler(backend, _mod(root, "scheduler.events").WatchQueue(),
                           queue.Queue(), respect_busy=False, **kw)
    controller = _mod(root, "scheduler.controller").Controller(
        backend, sched.nqueue, isolate_events=True)
    return backend, sched, controller


def _record_churn(root, path):
    """Three steps of scripted churn on a step clock, recorded as the
    chaos harness records (genesis after setup, every scripted mutation
    through the backend's scenario sink), the stack driven as it drives
    it: the controller's poll, up to 8 loop turns, one scan."""
    journal = _mod(root, "obs.journal")
    cfgs = pending.pod_configs(_mod(root, "sim").make_triad_config)
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    backend, sched, controller = _stack(root, clock)
    jnl = journal.enable_journal(str(path), identity="t", seed=5, clock=clock)
    jnl.genesis(journal.genesis_nodes(backend), seed=5, mode="chaos",
                respect_busy=False)
    backend.scenario_sink = jnl.cluster_event
    sched.build_initial_node_list()
    sched.load_deployed_configs()
    n = 0

    def create(k):
        nonlocal n
        for _ in range(k):
            backend.create_pod(f"churn-{n}", cfg_text=cfgs[n % len(cfgs)])
            n += 1

    def drive():
        controller.run_once(now=now[0])
        for _ in range(8):
            if sched.nqueue.empty():
                break
            sched.run_once()
        sched.check_pending_pods()

    for step in range(3):
        now[0] += 10.0
        create(4)
        if step == 1:
            backend.delete_pod("churn-0", emit_watch=True)
        drive()
    for _ in range(2):
        now[0] += 10.0
        drive()
    return journal.disable_journal()


@pytest.mark.parametrize("recorder", PACKAGES)
def test_journals_cross_between_the_packages(recorder, tmp_path):
    path = _record_churn(recorder, tmp_path / f"{recorder}.journal.jsonl")
    results = {root: _replay(root, [path]) for root in PACKAGES}
    for root, r in results.items():
        assert len(r.recorded) >= 10, root
        assert not r.diverged, (root, r.first_divergence)
    assert _sig(results["nhd_tpu"]) == _sig(results["nhd_tpu_torch"])


def test_both_daemons_record_the_same_decisions(tmp_path):
    dsig = _mod("nhd_tpu_torch", "sim.replay")._decision_sig
    recorded = {}
    for root in PACKAGES:
        path = _record_churn(root, tmp_path / f"{root}.journal.jsonl")
        _header, events = _mod(root, "obs.journal").load_journal(path)
        recorded[root] = [(e["d"]["ns"], e["d"]["pod"], dsig(e["d"]))
                          for e in events if e["ev"] == "decision"]
    assert recorded["nhd_tpu"] == recorded["nhd_tpu_torch"]
    assert any(s[0] == "scheduled" for _ns, _pod, s in recorded["nhd_tpu"])


def _record_cli_over_http(root, tmp_path, n_nodes=30, n_pods=60):
    """A journal of the package's CLI (``python -m <root>.cli``, on the
    CPU) scheduling cfg4 nodes on the port's stub API server, the pods
    created once it is up and arriving as pod watch events through the
    admission front door: chip_smoke.py phase 10 at a small size. The
    JAX daemon runs in its accelerator posture (device-resident state,
    the speculative round), the one the port's daemon always takes."""
    import os
    import signal
    import subprocess
    import sys
    import time

    import chip_smoke as cs

    if root == "nhd_tpu_torch":
        got, _ = cs.run_cli("cpu", n_nodes, n_pods, str(tmp_path), "port",
                            log_dir=str(tmp_path))
        assert got["bound"] == n_pods
        return got["journal"]
    stub, pods = cs.stub_cluster(n_nodes, n_pods)
    port = cs.free_port()
    env = dict(os.environ, KUBERNETES_SERVICE_HOST="127.0.0.1",
               KUBERNETES_SERVICE_PORT=str(stub.port),
               KUBERNETES_SERVICE_SCHEME="http",
               NHD_K8S_TOKEN_FILE=str(tmp_path / "no-token"),
               NHD_MIN_BUSY_SECS="0", NHD_TPU_SPECULATE="1",
               NHD_TPU_DEVICE_STATE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([cs.ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "nhd_tpu.cli", "--rpc-port", "0",
         "--metrics-port", str(port), "--journal", str(tmp_path / "jax"),
         "--run-seconds", "300"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=cs.ROOT)
    try:
        deadline = time.monotonic() + 180
        while not cs.cli_ready(stub, port):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        for name, kw in pods:
            cs.create_pod(stub, name, kw)
        while len({name for _ns, name, _b in stub.bindings}) < n_pods:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(cs.CLI_SETTLE_S)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stub.stop()
    assert proc.returncode == 0, out[-3000:]
    return next(line.split("journal written to", 1)[1].strip()
                for line in out.splitlines() if "journal written to" in line)


@pytest.mark.parametrize("recorder", PACKAGES)
def test_cli_journal_over_http_replays_on_the_port(recorder, tmp_path,
                                                   monkeypatch):
    """The port's replay re-drives a CLI recording fold by fold, as its
    scheduler took each batch out of the admission queue, with each pod
    under its recorded uid: 0 divergences from the decisions the
    recording's own daemon made live, the JAX daemon's included."""
    path = _record_cli_over_http(recorder, tmp_path)
    journal = _mod("nhd_tpu_torch", "obs.journal")
    events = journal.load_journal(path)[1]
    folds = _mod("nhd_tpu_torch", "sim.replay").recorded_folds(events)
    assert len(folds) > 1 and max(len(f) for f in folds) > 1, folds
    genesis = next(e for e in events if e["ev"] == "genesis")
    assert genesis["mode"] == "cli"
    # the recording's knobs; the busy window is read once, at import
    for name, value in genesis["knobs"].items():
        if value is not None and not name.startswith("NHD_JOURNAL"):
            monkeypatch.setenv(name, value)
    monkeypatch.setattr(_mod("nhd_tpu_torch", "core.node"), "MIN_BUSY_SECS",
                        float(genesis["knobs"]["NHD_MIN_BUSY_SECS"]))
    got = _replay("nhd_tpu_torch", [path])
    assert len(got.recorded) == 60
    assert all(d["outcome"] == "scheduled" for d in got.recorded)
    assert not got.diverged, (len(got.divergences), got.first_divergence)
