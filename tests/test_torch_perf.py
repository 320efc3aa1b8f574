"""The port's copy of obs/perf.py, the schema of the bench artifact:
its host-phase rollup and config records equal the reference's (the
cases of tests/test_obs.py and tests/test_fleet.py), and
tools/bench_diff.py, which loads artifacts through the reference's
module, reads an artifact the port's copy wrote — the regression gate
fires on an injected solve regression and passes within its threshold.
"""

import json
import subprocess
import sys
from pathlib import Path

import nhd_tpu.obs.perf as ref_perf
import nhd_tpu_torch.obs.perf as port_perf

REPO = Path(__file__).resolve().parent.parent

PHASES = {"solve": 0.5, "select": 0.1, "assign": 0.2,
          "materialize": 0.05, "final_sync": 0.01}


def test_host_phase_rollup_and_config_split():
    rollup = port_perf.host_phase_rollup({
        "materialize:U2_K2_N256": 0.2,
        "final_sync:U2_K2_N256": 0.1,
        "encode:U2_K7_N512": 0.05,
        "solve:U2_K2_N256": 9.9,       # not a host phase key
    })
    assert abs(rollup["U2_K2_N256"] - 0.3) < 1e-9
    assert abs(rollup["U2_K7_N512"] - 0.05) < 1e-9

    rec = port_perf.config_record(
        wall_seconds=1.0, placed=10, speedup=2.0, phases=PHASES,
    )
    assert abs(rec["host_phases_seconds"] - 0.36) < 1e-9
    assert rec == ref_perf.config_record(
        wall_seconds=1.0, placed=10, speedup=2.0, phases=PHASES,
    )


def _artifact(perf, solve):
    return perf.build_bench_artifact(
        {
            "cfg4": perf.config_record(
                wall_seconds=1.0, placed=100, speedup=10.0, rounds=3,
                phases={"solve": solve, "select": 0.1},
            )
        },
        headline={"metric": "pods_per_sec", "value": 100.0,
                  "unit": "pods/s", "vs_baseline": 10.0},
        platform="gpu", rev="testrev", created=1.0,
    )


def test_bench_artifact_equals_the_reference():
    assert _artifact(port_perf, 0.5) == _artifact(ref_perf, 0.5)


def _mk_bench(tmp_path, name, solve):
    path = tmp_path / name
    path.write_text(json.dumps(_artifact(port_perf, solve)))
    return str(path)


def _bench_diff(*args):
    return subprocess.run(
        [sys.executable, str(REPO / "tools" / "bench_diff.py"), *args],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )


def test_bench_diff_reads_the_ports_artifacts(tmp_path):
    old = _mk_bench(tmp_path, "old.json", solve=0.50)
    new = _mk_bench(tmp_path, "new.json", solve=0.57)  # +14%
    proc = _bench_diff(old, new)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "REGRESSION" in proc.stdout
    ok = _mk_bench(tmp_path, "ok.json", solve=0.52)    # +4%
    proc = _bench_diff(old, ok)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    art = port_perf.load_bench_artifact(ok)
    assert art["payload"]["configs"]["cfg4"]["phases"] \
        == {"solve": 0.52, "select": 0.1}
