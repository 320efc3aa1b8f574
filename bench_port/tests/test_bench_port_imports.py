"""The check that nothing the benchmark runs loads JAX or the JAX
package, by whole top-level module names, and the reference's
independence of the program."""

import subprocess
import sys

from bench_port.imports import FORBIDDEN, forbidden


def test_whole_top_level_names():
    assert forbidden(["nhd_tpu_torch", "nhd_tpu_torch.solver.batch", "numpy"]) == []
    assert forbidden(["nhd_tpu"]) == ["nhd_tpu"]
    assert forbidden(["nhd_tpu.solver.batch", "jax.numpy", "jaxlib.xla_client"]) == [
        "jax", "jaxlib", "nhd_tpu"]
    assert forbidden(["flax.linen", "jaxtyping", "nhd_tpu_torchx"]) == ["flax"]
    assert "nhd_tpu_torch" not in FORBIDDEN


def _loaded_after(stmt):
    code = (f"import sys; {stmt}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[2]))
    return out.stdout


def test_reference_and_control_import_nothing_of_the_program():
    mods = _loaded_after("import bench_port.reference, bench_port.control, "
                         "bench_port.fleet, bench_port.traffic, bench_port.roofline")
    for name in ("'nhd_tpu'", "'nhd_tpu_torch'", "'jax'", "'torch'"):
        assert name not in mods


def test_the_harness_and_program_load_no_jax():
    mods = _loaded_after("import bench_port.run, bench_port.program, "
                         "nhd_tpu_torch.solver.batch")
    assert "'nhd_tpu_torch'" in mods
    assert "'jax'" not in mods and "'nhd_tpu'" not in mods
