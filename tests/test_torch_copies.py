"""The port's host modules that are copies of the reference's, checked.

A module listed in ``VERBATIM`` is the reference's file with only its
imports moved from ``nhd_tpu`` to ``nhd_tpu_torch``: read with
``nhd_tpu_torch`` as ``nhd_tpu``, it equals its original byte for byte.
A module listed in ``DIFFERS`` has a counterpart of the same path in the
reference but is the port's own version, for the reason given. Every
module of the port that shares a path with the reference is in exactly
one of the two lists, so a copy that drifts, or a new copy nobody
declared, fails here.
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nhd_tpu_torch"
REF = ROOT / "nhd_tpu"

VERBATIM = (
    "config/__init__.py",
    "config/jsoncfg.py",
    "config/knobs.py",
    "config/libconfig.py",
    "config/parser.py",
    "config/paths.py",
    "config/triad.py",
    "core/__init__.py",
    "core/node.py",
    "core/request.py",
    "core/topology.py",
    "k8s/__init__.py",
    "k8s/fake.py",
    "k8s/interface.py",
    "k8s/lease.py",
    "k8s/retry.py",
    "obs/__init__.py",
    "obs/artifact.py",
    "obs/chrome.py",
    "obs/histo.py",
    "obs/jitstats.py",
    "obs/journal.py",
    "obs/recorder.py",
    "obs/slo.py",
    "policy/__init__.py",
    "policy/classes.py",
    "policy/preempt.py",
    "policy/scoring.py",
    "sanitizer/__init__.py",
    "sanitizer/runtime.py",
    "scheduler/__init__.py",
    "scheduler/commitpipe.py",
    "scheduler/controller.py",
    "scheduler/events.py",
    "sim/__init__.py",
    "sim/requests.py",
    "sim/synth.py",
    "sim/workloads.py",
    "solver/combos.py",
    "solver/encode.py",
    "solver/explain.py",
    "solver/fast_assign.py",
    "solver/oracle.py",
    "utils/logging.py",
)

DIFFERS = {
    "__init__.py": "the port's package docstring; exports resolve_device "
                   "beside NHD_SCHED_NAME",
    "native/__init__.py": "the port's own loader: builds native/nhd_assign.cc "
                          "into the port's build directory",
    "sanitizer/races.py": "keeps its own copy of analysis/lockgraph.py's "
                          "_mod_label; the static-analysis package is not "
                          "ported",
    "scheduler/core.py": "device seams: Scheduler(device=), the mesh knob, "
                         "the stream tile size, and the streaming tiler "
                         "built on the scheduler's device with no mesh",
    "solver/__init__.py": "exports the port's batched matcher, not the JAX "
                          "one",
    "solver/batch.py": "the round loop on torch tensors and HostPull; no "
                       "mesh or CPU routing",
    "solver/device_state.py": "resident torch tensors, updated in place",
    "solver/guard.py": "CUDA fault classification, one-pull audit, no AOT "
                       "retirement",
    "solver/kernel.py": "the solve through the hand-written CUDA kernels",
    "solver/speculate.py": "the megaround's loop on the host around the "
                           "claim kernels",
    "solver/streaming.py": "no JAX-CPU mesh gate; the default worker count "
                           "comes from the scheduler's device type, not a "
                           "global backend probe",
    "utils/__init__.py": "no force_cpu_backend: the port has no JAX backend "
                         "to pin",
}


def _as_reference(text: str) -> str:
    return text.replace("nhd_tpu_torch", "nhd_tpu")


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_its_original(rel):
    port = (PORT / rel).read_text()
    ref = (REF / rel).read_text()
    assert _as_reference(port) == ref, (
        f"nhd_tpu_torch/{rel} drifted from nhd_tpu/{rel}; copy it again "
        "with only its imports changed, or move it to DIFFERS with a reason"
    )


def test_every_shared_path_is_declared_once():
    shared = sorted(
        str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
        if (REF / p.relative_to(PORT)).exists()
    )
    assert not set(VERBATIM) & set(DIFFERS)
    assert sorted(set(VERBATIM) | set(DIFFERS)) == shared


@pytest.mark.parametrize("rel", sorted(DIFFERS))
def test_declared_differences_do_differ(rel):
    """A module kept in DIFFERS really is the port's own version (else it
    belongs in VERBATIM, where the byte check holds it)."""
    port = (PORT / rel).read_text()
    ref = (REF / rel).read_text()
    assert _as_reference(port) != ref
