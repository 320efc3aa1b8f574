"""On the card: one short run of each cell through ``run.py`` as the
benchmark's command runs it, correct, with no graph captured in the
window. Skips where no card is present (decided in a fixture)."""

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
    if name.startswith("cap1k"):
        assert out["metrics"]["window_captures"]["value"] == 0
