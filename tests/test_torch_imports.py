"""Import hygiene of the port: nhd_tpu_torch and its scripts (chip_smoke.py,
kernel_variants.py) import neither jax nor the reference package,
statically (an AST walk over every module) and at run time (a fresh
interpreter importing the round loop, and one importing the CLI and its
planes), and a CUDA request on a machine without CUDA raises instead of
falling back."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.conftest import subprocess_env

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nhd_tpu_torch"
#: the port's scripts at the repository root
SCRIPTS = ("chip_smoke.py", "kernel_variants.py")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _reference_imports(f):
    return [f"{f.relative_to(ROOT)}: {mod}"
            for mod in _imported_roots(ast.parse(f.read_text(), str(f)))
            if mod.split(".")[0] in ("jax", "jaxlib", "nhd_tpu")]


def test_no_jax_or_reference_imports_anywhere():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    assert {"multihost.py", "sharding.py", "spmd_bench.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    bad = [b for f in files for b in _reference_imports(f)]
    assert not bad, bad


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_only_the_port(script):
    """The scripts that drive the port on the card reach nhd_tpu_torch
    (imported inside their functions) and nothing of jax or nhd_tpu."""
    f = ROOT / script
    mods = set(_imported_roots(ast.parse(f.read_text(), str(f))))
    assert any(m.split(".")[0] == "nhd_tpu_torch" for m in mods)
    assert not _reference_imports(f)


def test_round_loop_imports_without_jax():
    code = (
        "import sys\n"
        "import nhd_tpu_torch.solver.batch, nhd_tpu_torch.solver.matcher\n"
        "import nhd_tpu_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nhd_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_daemon_planes_import_without_jax():
    """The CLI and its planes (real backend, gRPC and metrics, admission,
    replay, fleet payload) import in a fresh interpreter with nothing of
    jax or nhd_tpu behind them."""
    code = (
        "import sys\n"
        "import nhd_tpu_torch.cli, nhd_tpu_torch.rpc.metrics\n"
        "import nhd_tpu_torch.rpc.server, nhd_tpu_torch.ingress\n"
        "import nhd_tpu_torch.k8s.kube, nhd_tpu_torch.k8s.restclient\n"
        "import nhd_tpu_torch.k8s.apistub, nhd_tpu_torch.sim.replay\n"
        "import nhd_tpu_torch.obs.fleet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nhd_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lint_sanitizer_and_perf_import_without_jax():
    """nhdlint for the port (every module of analysis/), the sanitizer's
    pytest plugin and the port's knob registry import in a fresh
    interpreter with nothing of jax or nhd_tpu behind them."""
    analysis = sorted(p.stem for p in (PORT / "analysis").glob("*.py")
                      if p.stem not in ("__init__", "__main__"))
    assert len(analysis) == 13
    code = (
        "import importlib, sys\n"
        f"for name in {analysis!r}:\n"
        "    importlib.import_module('nhd_tpu_torch.analysis.' + name)\n"
        "import nhd_tpu_torch.sanitizer.pytest_plugin\n"
        "import nhd_tpu_torch.config.port_knobs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nhd_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module,args", [
    ("nhd_tpu_torch.sim.storm",
     ["--device", "cpu", "--profiles", "light", "--seeds", "1",
      "--steps", "2"]),
    ("nhd_tpu_torch.solver.aot",
     ["--first-bind-probe", "--device", "cpu"]),
    ("nhd_tpu_torch.sim.soak",
     ["--device", "cpu", "--seeds", "1", "--steps", "2"]),
    ("nhd_tpu_torch.sim.trace_replay", ["--device", "cpu", "--demo"]),
    ("nhd_tpu_torch.parallel.spmd_bench",
     ["--device", "cpu", "--devices", "8", "--pods", "64", "--nodes", "32",
      "--churn-rounds", "1"]),
])
def test_module_entry_points_run_without_jax(module, args, tmp_path):
    """The storm matrix, the first-bind probe, the soak, the replay demo
    and the cfg6 mesh probe, each run as by ``python -m`` on the CPU in a
    fresh interpreter, finish with nothing of jax or nhd_tpu imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}] + {args!r}\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert not exc.code, exc.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nhd_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, env=subprocess_env(NHDC_AOT_DIR=str(tmp_path)),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def test_cuda_without_a_gpu_raises():
    from nhd_tpu_torch.solver import BatchScheduler
    from nhd_tpu_torch.solver.matcher import find_nodes

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchScheduler(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        find_nodes({}, [], device="cuda")
    with pytest.raises(ValueError):
        BatchScheduler(device="meta")
