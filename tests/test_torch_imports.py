"""Import hygiene of the port: nhd_tpu_torch and its scripts (chip_smoke.py,
kernel_variants.py) import neither jax nor the reference package,
statically (an AST walk over every module) and at run time (a fresh
interpreter importing the round loop), and a CUDA request on a machine
without CUDA raises instead of falling back."""

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
