"""The fleet's switch layout keys change nothing where they are absent:
cap1k's labels, byte for byte, and its ``Hardware`` are those of one GPU
and one NIC a switch, GPU and NIC slot ``s`` of NUMA node ``u`` on
switch ``u * 16 + s``."""

import hashlib
import json

import numpy as np

from bench_port import fleet, manifest as mf

#: md5 of cap1k's 1,000 label dicts (``json.dumps`` each, joined) as the
#: default layout gives them
CAP1K_LABELS_MD5 = "de6c08ae2e2f7a8ae7b2a3de5bf10f7b"


def test_cap1k_labels_are_byte_for_byte_the_default_layout():
    f = mf.config("cap1k")["fleet"]
    assert "gpus_per_switch" not in f and "nics_per_switch" not in f
    text = "".join(json.dumps(fleet.node_labels(f, i)) for i in range(f["nodes"]))
    assert hashlib.md5(text.encode()).hexdigest() == CAP1K_LABELS_MD5
    ones = dict(f, gpus_per_switch=1, nics_per_switch=1)
    assert all(fleet.node_labels(ones, i) == fleet.node_labels(f, i) for i in range(8))


def test_cap1k_hardware_is_the_default_layout():
    f = mf.config("cap1k")["fleet"]
    hw = fleet.Hardware.of(f, 0.9)
    U, gpn, npn = f["sockets"], f["gpus_per_numa"], f["nics_per_numa"]
    raw = sorted({u * fleet.SW_STRIDE + s for u in range(U) for s in range(max(gpn, npn))})
    assert hw.switches() == raw
    dense = {s: j for j, s in enumerate(raw)}
    assert hw.gpu_switch().tolist() == [dense[u * 16 + s] for u in range(U) for s in range(gpn)]
    assert hw.nic_switch().tolist() == [dense[u * 16 + s] for u in range(U) for s in range(npn)]
    assert len(hw.mac_index()) == U * npn


def test_a_stated_layout_reaches_the_labels():
    f = dict(mf.config("cap1k")["fleet"], gpus_per_numa=4, nics_per_numa=4,
             gpus_per_switch=2, nics_per_switch=4)
    labels = fleet.node_labels(f, 0)
    gpu_sw = [int(k.split(".")[-1], 16) for k in labels if "nfd-extras-gpu." in k]
    nic_sw = [int(k.split(".")[-3], 16) for k in labels if "nfd-extras-nic." in k]
    assert gpu_sw == [0, 0, 1, 1, 16, 16, 17, 17]
    assert nic_sw == [0, 0, 0, 0, 16, 16, 16, 16]
    hw = fleet.Hardware.of(f, 0.9)
    assert hw.switches() == [0, 1, 16, 17]
    assert np.array_equal(hw.nic_switch(), [0, 0, 0, 0, 2, 2, 2, 2])
