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



#: GPUDirect pod types for the PCI tests: a one-GPU pod, a CPU-only pod
#: and a two-group pod whose second group has no GPU, all in PCI map mode
PCI_TYPES = [
    {"groups": [{"proc": 4, "proc_smt": True, "helpers": 1, "helper_smt": True, "gpus": 1,
                 "rx_gbps": 10.0, "tx_gbps": 5.0}],
     "misc": 1, "misc_smt": True, "hugepages_gb": 2, "map_mode": "PCI"},
    {"groups": [{"proc": 6, "proc_smt": True, "helpers": 1, "helper_smt": True, "gpus": 0,
                 "rx_gbps": 20.0, "tx_gbps": 10.0}],
     "misc": 1, "misc_smt": True, "hugepages_gb": 2, "map_mode": "PCI"},
    {"groups": [{"proc": 4, "proc_smt": True, "helpers": 0, "helper_smt": True, "gpus": 1,
                 "rx_gbps": 10.0, "tx_gbps": 5.0},
                {"proc": 2, "proc_smt": True, "helpers": 0, "helper_smt": True, "gpus": 0,
                 "rx_gbps": 5.0, "tx_gbps": 2.0}],
     "misc": 1, "misc_smt": True, "hugepages_gb": 4, "map_mode": "PCI"},
]


def pci_cell(nodes: int = 16, occupancy: int = 110):
    """cap1k's configuration cut to *nodes* GPUDirect servers (4 GPUs and
    4 NICs a NUMA node, two of each behind a PCIe switch), with gangs of
    2-16 pods of PCI_TYPES held at *occupancy* pods, a NUMA-mode pod type
    beside them: stated as data alone."""
    cfg, mix = copy.deepcopy(mf.config("cap1k")), copy.deepcopy(mf.traffic("backlog10k"))
    cfg["fleet"].update(nodes=nodes, gpus_per_numa=4, nics_per_numa=4,
                        gpus_per_switch=2, nics_per_switch=2)
    mix.update(name="pci_small", gang_pods_min=2, gang_pods_max=16, block=8,
               occupancy_pods=occupancy, warm_steady_gangs=4, same_pods_every_gang=False,
               pod_types=copy.deepcopy(PCI_TYPES) + [copy.deepcopy(mix["pod_types"][0])])
    return cfg, mix
