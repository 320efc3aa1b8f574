"""The port's entry point, ``python -m nhd_tpu_torch.cli``, against the
JAX package's (``nhd_tpu/cli.py``).

The two cases of tests/test_cli_demo.py run on the port with
``--device cpu`` (the demo subprocess beside the JAX one, and the
watch-wake latency through ``build_threads``); then what the port adds
or refuses: without ``--device`` the CLI asks for CUDA and, on a machine
without a GPU, exits non-zero naming it; ``--prewarm`` starts, records
the shapes it dispatches and warms them at the next start; ``--mesh``
above the local GPUs raises as the port's
scheduler does; a clean exit prints the kernels' launch counts (all 0
on the CPU). ``--explain`` prints what the JAX CLI prints for the
same file, and ``--replay`` of the golden journal reports 0 divergences.

Tolerance: exact equality — every compared output is a count or text.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests.conftest import subprocess_env

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "fixtures" / "journal" / "golden_churn.journal.jsonl"


def _cli(*args, timeout=120, **env):
    return subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=subprocess_env(JAX_PLATFORMS="cpu", **env),
    )


def _summary(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-2000:]
    return [line for line in out.splitlines() if "demo summary" in line], out


def launches_printed(out):
    """The kernels' launch counts a clean exit of the port's CLI prints."""
    import json

    lines = [line for line in out.splitlines()
             if line.startswith("kernel launches: ")]
    assert len(lines) == 1, out[-2000:]
    return json.loads(lines[0].split(": ", 1)[1])


def test_fake_demo_binds_as_the_reference_cli():
    """The 6-replica TriadSet on the 4-node demo cluster: with the live
    30 s busy back-off one GPU pod binds per node inside 15 s, on the
    port as on the JAX CLI (both run at once)."""
    port = _cli("nhd_tpu_torch.cli", "--fake", "--device", "cpu",
                "--rpc-port", "0", "--run-seconds", "15")
    ref = _cli("nhd_tpu.cli", "--fake", "--rpc-port", "0",
               "--run-seconds", "15")
    (got, out), (want, _) = _summary(port), _summary(ref)
    assert got == ["demo summary: 4/6 pods bound across 4 nodes"], got
    assert got == want
    # on the CPU the wrappers run their plain versions: no launch counted
    from nhd_tpu_torch import kernels

    assert launches_printed(out) == {k: 0 for k in kernels.COUNTED}


def test_watch_event_wakes_scheduler_promptly():
    """tests/test_cli_demo.py's event-driven loop pin on the port's
    thread set: 5 create→bind round trips in well under 2 s."""
    from nhd_tpu_torch.cli import build_threads, make_fake_backend
    from nhd_tpu_torch.sim import make_triad_config

    backend = make_fake_backend()
    threads, _ = build_threads(
        backend, rpc_port=0, metrics_port=0, respect_busy=False,
        device="cpu",
    )
    for t in threads:
        t.start()
    try:
        total = 0.0
        for i in range(5):
            name = f"wake-{i}"
            t0 = time.perf_counter()
            backend.create_pod(name, cfg_text=make_triad_config())
            deadline = t0 + 10
            while time.perf_counter() < deadline:
                p = backend.pods.get(("default", name))
                if p is not None and p.node:
                    break
                time.sleep(0.002)
            else:
                raise AssertionError(f"{name} never bound")
            total += time.perf_counter() - t0
            backend.delete_pod(name, emit_watch=True)
        assert total < 2.0, f"5 binds took {total:.2f}s"
    finally:
        for t in threads:
            stop = getattr(t, "stop", None)
            if stop is not None:
                stop()


def test_default_device_is_cuda_and_exits_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = _cli("nhd_tpu_torch.cli", "--fake", "--rpc-port", "0",
                "--run-seconds", "5")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "cuda" in err
    assert "demo summary" not in out


def test_prewarm_exits_2(tmp_path):
    """Named for the refusal it replaced (``--prewarm`` exited 2 until the
    kernel cache was ported): the CLI now starts with ``--prewarm``,
    records the shapes it dispatches (saving turns on at parse time) and
    logs its prewarm line; the next start warms what the first recorded."""
    def run():
        proc = _cli("nhd_tpu_torch.cli", "--fake", "--device", "cpu",
                    "--prewarm", "--rpc-port", "0", "--run-seconds", "4",
                    NHDC_AOT_DIR=str(tmp_path))
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert "demo summary" in out
        lines = [line for line in err.splitlines() if "prewarm: " in line]
        assert len(lines) == 1, err[-2000:]
        return lines[0]

    first = run()
    assert "prewarm: 0 solver program(s) warmed" in first
    assert str(tmp_path) in first
    recorded = sorted(p.name for p in tmp_path.glob("*.json"))
    assert recorded
    second = run()
    assert f"prewarm: {len(recorded)} solver program(s) warmed" in second
    assert "0 kernel library(ies) loaded" in second  # none run on the CPU


def test_mesh_above_one_raises():
    """``--mesh 2`` on a host with fewer than two GPUs is refused with the
    reference's error (the knob counts distinct local GPUs)."""
    import torch

    from nhd_tpu_torch.cli import main

    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two GPUs")
    with pytest.raises(ValueError, match="mesh spec asks for 2 devices"):
        main(["--fake", "--device", "cpu", "--rpc-port", "0",
              "--mesh", "2", "--run-seconds", "1"])


@pytest.mark.parametrize("shape", ["fits", "hugepages", "broken"])
def test_explain_prints_what_the_reference_prints(shape, tmp_path, capsys):
    from nhd_tpu.cli import main as ref_main
    from nhd_tpu.sim import make_triad_config
    from nhd_tpu_torch.cli import main

    cfg = tmp_path / "pod.cfg"
    cfg.write_text({
        "fits": make_triad_config(gpus_per_group=1, hugepages_gb=4),
        "hugepages": make_triad_config(hugepages_gb=500),
        "broken": "this is { not libconfig",
    }[shape])
    want_rc = ref_main(["--fake", "--explain", str(cfg)])
    want = capsys.readouterr().out
    got_rc = main(["--fake", "--device", "cpu", "--explain", str(cfg)])
    got = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert want.strip()


def test_replay_of_the_golden_journal(tmp_path, capsys):
    from nhd_tpu_torch.cli import main

    rc = main(["--device", "cpu", "--replay", str(GOLDEN),
               "--journal", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "; 0 divergence(s);" in out
    assert "first divergence" not in out


def test_script_and_proto_are_packaged():
    import tomllib

    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert meta["project"]["scripts"]["nhd-tpu-torch"] == "nhd_tpu_torch.cli:main"
    assert "*.proto" in meta["tool"]["setuptools"]["package-data"]["nhd_tpu_torch.rpc"]
