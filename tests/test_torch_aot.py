"""The port's kernel cache (nhd_tpu_torch/solver/aot.py, kernels/build.py),
case by case from tests/test_aot.py where the meaning carries over.

The port compiles no per-shape program: its artifacts are the nine kernel
libraries (each with a sidecar meta naming its source fingerprint, nvcc,
the target, torch, CUDA and the card) and a manifest of the shape keys
the solver dispatched. On the CPU the manifest cases run for real
(``device="cpu"``: prewarm runs the plain versions at each recorded
shape). No CUDA library can be built here, so the library cases build
stand-ins: a fake ``nvcc`` compiles, with the host's C compiler, a stub
library that exports each kernel's entry symbols; the toolchain meta is
pinned. The real library, truncated and rebuilt, is a card test.

The cache is process-global, so every test runs against a fresh tmp
directory (the ``aot_cache`` fixture) and resets it afterwards.
Tolerance: exact equality.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from nhd_tpu_torch.k8s.retry import API_COUNTERS
from nhd_tpu_torch.kernels import build
from nhd_tpu_torch.kernels.abi import ABI, SOURCES
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.solver import aot, guard
from nhd_tpu_torch.solver.kernel import solve_bucket_ranked
from tests.conftest import subprocess_env


@pytest.fixture
def aot_cache(tmp_path):
    aot.reset()
    aot.configure(directory=str(tmp_path), save=True)
    yield str(tmp_path)
    aot.reset()


def _small_problem(n_nodes=16, n_pods=24):
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    nodes = cap_cluster(n_nodes, ["default"])
    reqs = workload_mix(n_pods, ["default"])
    cluster = encode_cluster(nodes, now=0.0)
    return cluster, encode_pods(reqs, cluster.interner)


def _solve(cluster, buckets):
    return {G: solve_bucket_ranked(cluster, pods, 64, device="cpu").numpy()
            for G, pods in sorted(buckets.items())}


def _seed_cache():
    """Solve with recording on; returns (cluster, buckets, outputs)."""
    cluster, buckets = _small_problem()
    outs = _solve(cluster, buckets)
    aot.AOT.drain()
    return cluster, buckets, outs


def _metas(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".json"))


def _fresh(directory):
    aot.reset()
    aot.configure(directory=directory, save=False)


def _quarantine_warnings(fn):
    """Run *fn*; return (its result, the cache's quarantine warnings).
    The port's loggers do not propagate to root (caplog-invisible)."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("nhd_tpu_torch.solver.aot")
    logger.addHandler(handler)
    try:
        out = fn()
    finally:
        logger.removeHandler(handler)
    return out, [r for r in records if r.levelno >= logging.WARNING
                 and "quarantined" in r.getMessage()]


# ---------------------------------------------------------------------------
# the manifest of shape keys
# ---------------------------------------------------------------------------


def test_record_on_first_dispatch_writes_versioned_manifest(aot_cache):
    _, buckets, _ = _seed_cache()
    metas = _metas(aot_cache)
    assert len(metas) == len(buckets)
    for fname in metas:
        meta = json.load(open(os.path.join(aot_cache, fname)))
        assert meta["kind"] == "ranked"
        assert meta["aot_schema"] == aot.AOT_SCHEMA_VERSION
        assert meta["fingerprint"] == aot.program_fingerprint()
        assert fname == f"ranked_{meta['key'].lower()}.json"
        for dim in ("G", "U", "K", "R", "Tp", "Np"):
            assert isinstance(meta["spec"][dim], int)
        assert len(meta["spec"]["node"]) == 15
        assert len(meta["spec"]["pod"]) == 10


def test_prewarm_serves_identical_decisions(aot_cache):
    cluster, buckets, outs = _seed_cache()
    _fresh(aot_cache)
    JIT_STATS.reset()
    summary = aot.prewarm(device="cpu")
    assert summary["loaded"] == len(outs)
    assert summary["quarantined"] == 0 and summary["libraries"] == 0
    warm = JIT_STATS.snapshot()
    got = _solve(cluster, buckets)
    for G in outs:
        assert np.array_equal(got[G], outs[G])
    steady = JIT_STATS.snapshot()
    # every dispatch of a prewarmed key counts as a hit
    assert steady["compiles_total"] == warm["compiles_total"]
    assert steady["cache_hits_total"] == warm["cache_hits_total"] + len(outs)


def test_stale_manifest_quarantined_not_deleted(aot_cache):
    cluster, buckets, outs = _seed_cache()
    metas = _metas(aot_cache)
    for fname in metas:   # an older schema wrote every entry
        path = os.path.join(aot_cache, fname)
        meta = json.load(open(path))
        meta["aot_schema"] = 0
        json.dump(meta, open(path, "w"))
    _fresh(aot_cache)
    summary, warnings = _quarantine_warnings(lambda: aot.prewarm(device="cpu"))
    assert summary["loaded"] == 0
    assert summary["quarantined"] == len(metas)
    qdir = os.path.join(aot_cache, "quarantine")
    assert sorted(os.listdir(qdir)) == metas
    assert not _metas(aot_cache)
    assert len(warnings) == 1     # ONE warning covers the whole set
    got = _solve(cluster, buckets)
    for G in outs:
        assert np.array_equal(got[G], outs[G])


def test_fingerprint_mismatch_and_corrupt_entry_quarantined(aot_cache):
    _seed_cache()
    metas = _metas(aot_cache)
    assert len(metas) >= 2
    p0 = os.path.join(aot_cache, metas[0])
    meta = json.load(open(p0))
    meta["fingerprint"] = "deadbeefdeadbeef"   # solver code changed
    json.dump(meta, open(p0, "w"))
    with open(os.path.join(aot_cache, metas[1]), "wb") as fh:
        fh.write(b"\x00\x01not-json")          # a torn write
    _fresh(aot_cache)
    summary = aot.prewarm(device="cpu")
    assert summary["loaded"] == len(metas) - 2
    assert summary["quarantined"] == 2
    assert sorted(os.listdir(os.path.join(aot_cache, "quarantine"))) == \
        sorted(metas[:2])


def test_prewarm_progress_called_per_artifact(aot_cache):
    _seed_cache()
    stale = _metas(aot_cache)[0]
    meta = json.load(open(os.path.join(aot_cache, stale)))
    meta["fingerprint"] = "0" * 16
    with open(os.path.join(aot_cache, "zz_stale.json"), "w") as fh:
        json.dump(meta, fh)
    _fresh(aot_cache)
    beats = []
    summary = aot.prewarm(progress=lambda: beats.append(1), device="cpu")
    assert summary["loaded"] >= 1 and summary["quarantined"] >= 1
    assert len(beats) == (
        summary["loaded"] + summary["quarantined"] + summary["skipped"]
    )


def test_prewarm_progress_keeps_watchdog_quiet_on_slow_compiles():
    """With per-artifact heartbeats a prewarm whose every artifact eats
    most of the stall budget never trips the port's watchdog; without
    them the same timeline fires it."""
    from nhd_tpu_torch.k8s.lease import StallWatchdog

    for with_progress, expect_fired in ((True, False), (False, True)):
        clock = {"t": 0.0}
        stamp = {"t": 0.0}
        fired = []
        dog = StallWatchdog(
            lambda: stamp["t"], stall_after=10.0,
            exit_fn=lambda code: fired.append(code),
            clock=lambda: clock["t"],
        )
        for _ in range(4):  # four artifacts, 8 s each
            clock["t"] += 8.0
            if with_progress:
                stamp["t"] = clock["t"]  # aot.prewarm(progress=_beat)
            dog.check()
        assert bool(fired) == expect_fired, (with_progress, fired)


def test_export_failure_counted_and_logged_once(aot_cache, monkeypatch):
    def _boom(path, data):
        raise OSError("injected write failure")

    monkeypatch.setattr(aot, "_write_atomic", _boom)
    base = API_COUNTERS.get("aot_export_failures_total")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("nhd_tpu_torch.solver.aot")
    logger.addHandler(handler)
    try:
        for key in ("G1_U2_K2_R8_T8_N16", "G2_U2_K2_R8_T8_N16"):
            aot.maybe_record(aot.ShapeKey("ranked", key), lambda: {"node": []})
        aot.AOT.drain()
    finally:
        logger.removeHandler(handler)
    assert API_COUNTERS.get("aot_export_failures_total") == base + 2
    assert not _metas(aot_cache)
    assert len([r for r in records if "failed" in r.getMessage()]) == 1


def test_forget_retires_key_and_quarantines_entry(aot_cache):
    _seed_cache()
    _fresh(aot_cache)
    summary = aot.prewarm(device="cpu")
    assert summary["loaded"] >= 1
    name = summary["keys"][0]
    key = next(k for k in aot.AOT._warm if k.name() == name)
    aot.forget(key)
    assert aot.lookup(key) is None
    assert os.path.exists(os.path.join(aot_cache, "quarantine", name + ".json"))
    assert not os.path.exists(os.path.join(aot_cache, name + ".json"))


def test_poisoned_shape_quarantined_end_to_end(aot_cache, monkeypatch):
    """tests/test_guard.py:338 on the port: a cached shape that faults at
    every dispatch is quarantined after NHD_GUARD_SHAPE_FAULTS faults —
    its manifest entry moves to quarantine/, the dispatch stops
    recording it, and the batch still binds as the clean run did."""
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.batch import BatchItem, BatchScheduler

    monkeypatch.setenv("NHD_GUARD_SHAPE_FAULTS", "2")
    monkeypatch.setenv("NHD_GUARD_RETRIES", "2")
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(6, ["default"]))]

    def run():
        sched = BatchScheduler(device="cpu", respect_busy=False,
                               register_pods=False)
        res, _ = sched.schedule(cap_cluster(6, ["default"]), items)
        return [r.node for r in res]

    guard.GUARD.reset()
    clean = run()
    aot.AOT.drain()
    _fresh(aot_cache)
    summary = aot.prewarm(device="cpu")
    ranked = sorted(k for k in summary["keys"] if k.startswith("ranked_"))
    assert ranked
    key = next(k for k in aot.AOT._warm if k.name() == ranked[0])

    def poisoned(site, detail=""):
        # the poison lives in the cached entry: a quarantined shape is
        # no longer served from it
        if site == "dispatch" and detail == key.key and \
                not guard.GUARD.shape_quarantined(key.key):
            raise guard.InjectedDeviceFault(f"poisoned entry {key.name()}")

    aot.configure(save=True)
    guard.GUARD.reset()
    guard.set_fault_injector(poisoned)
    try:
        assert run() == clean
        assert guard.GUARD.shape_quarantined(key.key)
        assert API_COUNTERS.get("guard_quarantined_shapes") == 1
        assert aot.lookup(key) is None
        qdir = os.path.join(aot_cache, "quarantine")
        assert os.path.exists(os.path.join(qdir, key.name() + ".json"))
        # later batches dispatch the shape without recording it again
        assert run() == clean
        aot.AOT.drain()
        assert not os.path.exists(os.path.join(aot_cache, key.name() + ".json"))
    finally:
        guard.set_fault_injector(None)
        guard.GUARD.reset()


def test_zero_recompile_invariant_under_chaos(aot_cache):
    """With prewarm on, a seeded storm dispatches only prewarmed shapes:
    the jit-stats compile count stays flat after the warm-up, and an
    escape names the shape key."""
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES

    sim = ChaosSim(seed=11, n_nodes=4, api_faults=PROFILES["light"],
                   device="cpu")
    sim.run(60)
    sim.quiesce()
    aot.AOT.drain()
    assert any(f.startswith("ranked_") for f in _metas(aot_cache))

    JIT_STATS.reset()
    _fresh(aot_cache)
    summary = aot.prewarm(device="cpu")
    assert summary["loaded"] > 0
    warm = JIT_STATS.snapshot()
    warm_shapes = set(warm["shapes"])

    sim2 = ChaosSim(seed=11, n_nodes=4, api_faults=PROFILES["light"],
                    device="cpu")
    sim2.run(60)
    sim2.quiesce()
    steady = JIT_STATS.snapshot()
    escaped = sorted(set(steady["shapes"]) - warm_shapes)
    assert steady["compiles_total"] == warm["compiles_total"], (
        f"shape-bucket escape at steady state: {escaped} "
        f"(prewarmed: {sorted(warm_shapes)})"
    )
    assert steady["cache_hits_total"] > warm["cache_hits_total"]


# ---------------------------------------------------------------------------
# the kernel libraries (stand-ins built by a fake nvcc)
# ---------------------------------------------------------------------------

_FAKE_NVCC = '''#!{python}
import os, re, subprocess, sys
args = sys.argv[1:]
if "--version" in args:
    print("Cuda compilation tools, release 0.0")
    print("Build fake_0.0")
    sys.exit(0)
if os.environ.get("FAKE_NVCC_FAIL"):
    print("fake nvcc: refused")
    sys.exit(1)
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
c = out + ".c"
with open(c, "w") as fh:
    if not os.environ.get("FAKE_NVCC_NO_ENTRY"):
        for entry in re.findall(r'extern "C" int (\\w+)', text):
            fh.write("int %s(void) {{ return 0; }}\\n" % entry)
    for entry in re.findall(r'extern "C" const char\\s*\\*\\s*(\\w+)', text):
        fh.write('const char *%s(int c) {{ return "stub"; }}\\n' % entry)
sys.exit(subprocess.call(["cc", "-shared", "-fPIC", "-o", out, c]))
'''


@pytest.fixture
def fake_toolchain(aot_cache, tmp_path_factory, monkeypatch):
    """A fake nvcc, a pinned toolchain meta and a clean library table."""
    if shutil.which("cc") is None:
        pytest.skip("needs the host C compiler for stand-in libraries")
    bindir = tmp_path_factory.mktemp("bin")
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "toolchain", lambda: {
        "nvcc_version": "Build fake_0.0", "target": build.TARGET,
        "torch_version": torch.__version__, "cuda_version": "12.4",
        "device_name": "NVIDIA H100 80GB HBM3",
    })
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "COUNTS", dict.fromkeys(build.COUNTS, 0))
    return aot_cache


def _restart(monkeypatch):
    """A new process's library table (the disk stays)."""
    monkeypatch.setattr(build, "_LIBS", {})


def test_library_meta_written_and_reused(fake_toolchain, monkeypatch):
    build.load("spec_fill")
    # every source at once: the kernels and the WHILE node's helper
    assert build.COUNTS["builds"] == len(SOURCES) == len(ABI) + 1
    for name in SOURCES:
        meta = json.loads(build.meta_path(name).read_text())
        assert meta == build.library_meta(name)
        assert meta["kind"] == "library" and meta["target"] == "sm_90a"
        assert meta["fingerprint"] == build.fingerprint(name)
    _restart(monkeypatch)
    for name in SOURCES:
        build.load(name)
    # a warm restart builds nothing and opens each library once
    assert build.COUNTS["builds"] == len(SOURCES)
    assert build.COUNTS["loads"] == 1 + len(SOURCES)
    assert build.COUNTS["quarantined"] == 0


@pytest.mark.parametrize("damage", [
    "truncated", "fingerprint", "device_name", "no_meta", "no_entry",
])
def test_broken_library_quarantined_and_rebuilt(damage, fake_toolchain,
                                                monkeypatch):
    # built, never opened here: a restart meets the damaged file first
    # (rewriting a library this process has mapped would fault it)
    build.build_all()
    so, meta = build.library_path("nic_any_first"), build.meta_path(
        "nic_any_first")
    if damage == "truncated":
        so.write_bytes(so.read_bytes()[:64])
    elif damage in ("fingerprint", "device_name"):
        m = json.loads(meta.read_text())
        m[damage] = "edited"
        meta.write_text(json.dumps(m))
    elif damage == "no_meta":
        meta.unlink()
    else:   # a library without its entry symbol, under a valid meta
        monkeypatch.setenv("FAKE_NVCC_NO_ENTRY", "1")
        so.unlink()
        build.build_all()
        monkeypatch.delenv("FAKE_NVCC_NO_ENTRY")
    before = dict(build.COUNTS)
    _restart(monkeypatch)
    (_, warnings) = _quarantine_warnings(lambda: build.load("nic_any_first"))
    qdir = os.path.join(fake_toolchain, "quarantine")
    assert so.name in os.listdir(qdir)          # moved, never deleted
    assert build.COUNTS["quarantined"] == before["quarantined"] + 1
    assert build.COUNTS["builds"] == before["builds"] + 1   # this one only
    assert build.stale_reason("nic_any_first") is None
    assert len(warnings) == 1
    _restart(monkeypatch)
    build.load("nic_any_first")   # the rebuilt library serves the restart
    assert build.COUNTS["builds"] == before["builds"] + 1


def test_failed_rebuild_raises(fake_toolchain, monkeypatch):
    build.build_all()
    so = build.library_path("spec_apply")
    so.write_bytes(b"\x7fELF-torn")
    _restart(monkeypatch)
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load("spec_apply")
    assert so.name in os.listdir(os.path.join(fake_toolchain, "quarantine"))


def test_prewarm_on_the_cpu_skips_libraries(fake_toolchain):
    build.build_all()
    _seed_cache()
    _fresh(fake_toolchain)
    summary = aot.prewarm(device="cpu")
    assert summary["skipped"] == len(SOURCES)     # no library runs on the CPU
    assert summary["libraries"] == 0 and summary["quarantined"] == 0
    assert summary["loaded"] >= 1


# ---------------------------------------------------------------------------
# the first-bind probe, a fresh process each
# ---------------------------------------------------------------------------


def _probe(*args, cache):
    return subprocess.run(
        [sys.executable, "-m", "nhd_tpu_torch.solver.aot", *args],
        capture_output=True, text=True, timeout=180,
        env=subprocess_env(NHDC_AOT_DIR=str(cache)),
    )


def test_first_bind_probe_cold_then_prewarmed(tmp_path):
    cold = _probe("--first-bind-probe", "--device", "cpu", "--save",
                  cache=tmp_path)
    assert cold.returncode == 0, cold.stderr[-2000:]
    got = json.loads(cold.stdout.strip().splitlines()[-1])
    assert got["bound"] and got["programs"] == 0
    assert _metas(tmp_path)
    warm = _probe("--first-bind-probe", "--device", "cpu", "--prewarm",
                  cache=tmp_path)
    assert warm.returncode == 0, warm.stderr[-2000:]
    got = json.loads(warm.stdout.strip().splitlines()[-1])
    assert got["bound"] and got["programs"] == len(_metas(tmp_path))
    assert got["quarantined"] == 0


def test_first_bind_probe_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = _probe("--first-bind-probe", cache=tmp_path)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr


# ---------------------------------------------------------------------------
# mesh-qualified keys (the reference's aot.py :322-395 on the port's mesh)
# ---------------------------------------------------------------------------


def test_mesh_keys_record_warm_and_retire(aot_cache, monkeypatch):
    """A mesh-resident batch (4 CPU shards, a 2-iteration megaround then
    classic rounds) records its
    ranked, megaround and row-update keys with the mesh's descriptor and
    one shard's shapes; a prewarm over the caller's mesh warms every one
    of them, and a quarantined mesh shape retires its own key."""
    from nhd_tpu.solver.kernel import parse_ranked_shape_key as jx_parse
    from nhd_tpu_torch.parallel.sharding import make_mesh
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler
    from nhd_tpu_torch.solver.kernel import parse_ranked_shape_key

    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    monkeypatch.setenv("NHD_TPU_SPEC_ITERS", "2")   # classic rounds follow
    mesh = make_mesh(["cpu"] * 4)
    sched = BatchScheduler(device="cpu", respect_busy=False, register_pods=False,
                           mesh=mesh)
    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(120, ["default"]))]
    sched.schedule(cap_cluster(16, ["default"]), items, now=0.0)
    aot.AOT.drain()
    metas = [json.load(open(os.path.join(aot_cache, f))) for f in _metas(aot_cache)]
    kinds = {m["kind"] for m in metas}
    assert {"ranked", "megaround"} <= kinds
    for m in metas:
        assert m["key"].endswith("_Mnodes4") and m["spec"]["mesh"] == "nodes4"
        assert m["spec"]["node"][0][0][0] == 16 // 4       # one shard's rows
        if m["kind"] == "ranked":
            assert parse_ranked_shape_key(m["key"]) == jx_parse(m["key"])
            assert parse_ranked_shape_key(m["key"])[-1] == "nodes4"

    _fresh(aot_cache)
    JIT_STATS.reset()
    skipped = aot.prewarm(device="cpu")          # the CPU is one device
    assert (skipped["loaded"], skipped["skipped"]) == (0, len(metas))
    _fresh(aot_cache)
    summary = aot.prewarm(device="cpu", mesh=mesh)
    assert summary["loaded"] == len(metas) and summary["quarantined"] == 0
    ranked = next(k for k in aot.AOT._warm if k.kind == "ranked")
    aot.forget(ranked)
    assert os.path.exists(os.path.join(aot_cache, "quarantine", ranked.name() + ".json"))
