"""Shared helpers of the benchmark's tests: small copies of a cell's
configuration and traffic that a CPU test run can hold."""

import copy
import json

import pytest

from bench_port import manifest as mf


def small(cfg: dict, mix: dict, nodes: int = 48, steady: bool = False):
    """*cfg* and *mix* cut to *nodes* nodes (class runs in proportion).
    A mix of one gang size keeps its pods a node; with *steady*, gangs
    of 8-64 pods held at 300 bound pods instead, the generator's
    steady-occupancy loop."""
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    f = cfg["fleet"]
    scale = nodes / f["nodes"]
    f["nodes"] = nodes
    f["classes"] = [[c, int(round(n * scale))] for c, n in f["classes"]]
    if steady:
        mix.update(gang_pods_min=8, gang_pods_max=64, block=8, occupancy_pods=300,
                   warm_steady_gangs=3)
    else:
        lo = max(1, int(round(mix["gang_pods_min"] * scale)))
        hi = max(lo, int(round(mix["gang_pods_max"] * scale)))
        mix.update(gang_pods_min=lo, gang_pods_max=hi)
    return cfg, mix


@pytest.fixture
def manifest():
    return mf.load(mf.HERE.parent)


@pytest.fixture
def cell_env(monkeypatch):
    """Set a configuration's program knobs for one test."""

    def apply(cfg):
        for k, v in cfg["env"].items():
            monkeypatch.setenv(k, v if isinstance(v, str) else json.dumps(v))

    return apply


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


