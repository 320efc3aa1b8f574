"""The least time the kernels' work could take on the card: the bytes
that work needs, at the card's memory rate.

The work is counted from the shapes and the gang's solve passes, not
from what implements them, so a change that fuses or removes a kernel
cannot move the count. A solve pass (one classic round, or one
iteration of the speculative megaround) needs every real node's
schedulable state read once, in its narrowest plain form; its inputs
beside that (the pod types) and its outputs (a ranking or a claim word a
node) are left out, so the count is a lower bound and a share of the
roofline built on it cannot pass 100%.
"""

from __future__ import annotations

#: an NVIDIA H100 SXM's HBM3 rate (NVIDIA's data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12


def node_state_bytes(fleet: dict) -> int:
    """One node's schedulable state in its narrowest plain form: the
    group mask (8 B), free hugepages (4), per NUMA node the wholly free
    physical cores and the free GPUs (4 + 4), per NIC its rx and tx
    headroom (4 + 4), per PCIe switch its free GPUs (4), and the active,
    maintenance, SMT and busy flags (1 each)."""
    U = fleet["sockets"]
    nics = U * fleet["nics_per_numa"]
    switches = U * max(fleet["gpus_per_numa"], fleet["nics_per_numa"])
    return 8 + 4 + 8 * U + 8 * nics + 4 * switches + 4


def solve_passes(rounds: int, spec_round: bool, spec_iterations: int) -> int:
    """A gang's solve passes: its classic rounds and its megaround's
    iterations."""
    return (rounds - (1 if spec_round else 0)) + spec_iterations


def least_seconds(passes: int, fleet: dict) -> float:
    return passes * fleet["nodes"] * node_state_bytes(fleet) / HBM_BYTES_PER_S
