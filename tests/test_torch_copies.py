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
    "analysis/__main__.py",
    "analysis/lockgraph.py",
    "analysis/rules_determinism.py",
    "analysis/rules_excepts.py",
    "analysis/rules_fencing.py",
    "analysis/rules_locks.py",
    "analysis/rules_metrics.py",
    "analysis/rules_races.py",
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
    "ingress/__init__.py",
    "ingress/admission.py",
    "k8s/__init__.py",
    "k8s/apistub.py",
    "k8s/fake.py",
    "k8s/interface.py",
    "k8s/kube.py",
    "k8s/lease.py",
    "k8s/restclient.py",
    "k8s/retry.py",
    "obs/__init__.py",
    "obs/artifact.py",
    "obs/chrome.py",
    "obs/fleet.py",
    "obs/histo.py",
    "obs/jitstats.py",
    "obs/journal.py",
    "obs/perf.py",
    "obs/recorder.py",
    "obs/slo.py",
    "policy/__init__.py",
    "policy/classes.py",
    "policy/preempt.py",
    "policy/scoring.py",
    "rpc/__init__.py",
    "rpc/metrics.py",
    "rpc/nhd_stats_pb2.py",
    "rpc/server.py",
    "sanitizer/__init__.py",
    "sanitizer/races.py",
    "sanitizer/runtime.py",
    "scheduler/__init__.py",
    "scheduler/commitpipe.py",
    "scheduler/controller.py",
    "scheduler/events.py",
    "sim/__init__.py",
    "sim/faults.py",
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
    "analysis/__init__.py": "the docstring names the port's packs: the "
                            "tracing pack aimed at torch, the contract "
                            "pack at the kernel ABI",
    "analysis/cli.py": "the parser's description names the port's packs",
    "analysis/contracts.py": "the port's contract facts: by-name reads of "
                             "dict(zip(_ARG_ORDER, ...)), padded_args "
                             "block spans, the abi.py rows, the plain "
                             "versions' signatures, the kernel call sites "
                             "and their argument builders, file-hash "
                             "fingerprints, NHDC_* reads and the port's "
                             "registry; no in_shardings or pod_args "
                             "stride sites (the port has neither)",
    "analysis/core.py": "the rule catalogue describes the torch-aimed "
                        "NHD1xx and the ABI-aimed NHD7xx rules",
    "analysis/ownership.py": "the port's thread roots (the CLI's entry "
                             "thread, the tile workers) and the journal "
                             "pointer's single writer",
    "analysis/rules_contract.py": "NHD701/702 over the kernel ABI's four "
                                  "layers (abi.py, .cu entry points, "
                                  "plain versions, call sites), NHD703 "
                                  "over the library fingerprint too, "
                                  "NHD710 as the host-alias hazard of "
                                  "in-place kernel arguments and "
                                  "index_copy_, NHD720 over two "
                                  "registries by prefix",
    "analysis/rules_tracing.py": "NHD101-106 over CUDA-graph captures "
                                 "(torch.cuda.graph blocks, graphed "
                                 "callables), NHD104 over library opens "
                                 "and graph construction, NHD107 over "
                                 "torch host syncs outside HostPull; "
                                 "NHD108 sanctions matcher:find_nodes",
    "cli.py": "--device (default cuda, resolved before any thread starts, "
              "non-zero exit without a GPU) passed to the scheduler, "
              "explain, replay and the prewarm; no JAX_PLATFORMS block; "
              "--prewarm warms the port's kernel cache and logs its "
              "libraries; a clean exit prints the kernels' launch counts",
    "native/__init__.py": "the port's own loader: builds native/nhd_assign.cc "
                          "into the port's build directory",
    "parallel/__init__.py": "exports the port's Mesh beside the reference's "
                            "three names",
    "parallel/multihost.py": "bootstraps torch.distributed (backend gloo or "
                             "nccl, a tcp://, file:// or env:// rendezvous), "
                             "not jax.distributed; node_slice and "
                             "region_nodes are the reference's text, "
                             "local_node_slice and local_nodes read the "
                             "process group's rank",
    "parallel/sharding.py": "the port's Mesh of shard devices (a device may "
                            "repeat; round-robin over the local devices; "
                            "an optional process group); the knob counts "
                            "distinct local GPUs; the sharded solve runs "
                            "per shard and merges the candidates, gathered "
                            "across processes over torch.distributed",
    "parallel/spmd_bench.py": "the probe on --devices shards of --device, "
                              "no virtual devices or XLA flags; the parity "
                              "leg compares val > 0 slots; prewarm passes "
                              "the probe's mesh",
    "scheduler/core.py": "device seams: Scheduler(device=), the mesh knob "
                         "resolved by the port's parallel.sharding (imported "
                         "at the top), the stream tile size, and the "
                         "streaming tiler built on the scheduler's device",
    "sim/chaos.py": "device seams: ChaosSim(device=) builds every "
                    "Scheduler on that device (default cuda); the posture "
                    "check refuses a device profile only under "
                    "NHD_TPU_DEVICE_STATE=0; bit flips corrupt the resident "
                    "torch tensor in place (on its shard); the end-state "
                    "audit leaves out "
                    "the rows the delta re-packed since the last batch",
    "sim/replay.py": "replay_journal(device=) and the replay engine build "
                     "their Scheduler on that device (default cuda); a "
                     "CLI journal replays fold by fold as its admission "
                     "queue folded it, each watched pod under its recorded "
                     "uid",
    "solver/__init__.py": "exports the port's batched matcher, not the JAX "
                          "one",
    "solver/aot.py": "the cache contract on the port's artifacts: nine "
                     "kernel libraries and the WHILE node's helper library "
                     "with toolchain metas and a manifest "
                     "of shape keys, warmed by launching the kernels on "
                     "zeros (a megaround key of one device's shards by "
                     "capturing its graph); NHDC_AOT_DIR; the probe "
                     "defaults to cuda",
    "solver/batch.py": "the round loop on torch tensors and HostPull; the "
                       "mesh is the port's Mesh and auto counts local GPUs; "
                       "no CPU routing",
    "solver/device_state.py": "resident torch tensors, updated in place, "
                              "sharded as row blocks over a mesh's devices "
                              "with per-shard index_copy_ updates; the "
                              "megaround one graph replay where the shards "
                              "share a device; new megaround and scatter "
                              "shapes recorded to the kernel cache",
    "solver/guard.py": "CUDA fault classification, one-pull audit over "
                       "the shards; a "
                       "quarantined shape retires from the kernel cache's "
                       "manifest",
    "solver/kernel.py": "the solve through the hand-written CUDA kernels; "
                        "on a mesh each shard solves with its global node "
                        "base and the shards' candidates merge by one more "
                        "top-R; the dispatch records unquarantined shapes "
                        "to the kernel cache",
    "solver/speculate.py": "the megaround through the claim kernels: on "
                           "one device, and over a mesh's shards on one "
                           "device, one CUDA graph whose loop is a WHILE "
                           "node that spec_gate ends on the card, the "
                           "shards' plans joined for one balanced fill; a "
                           "mesh over several devices keeps a host loop",
    "solver/streaming.py": "no CPU mesh gate (the port's mesh has no "
                           "in-process collective); the default worker count "
                           "comes from the scheduler's device type, not a "
                           "global backend probe",
    "utils/__init__.py": "no force_cpu_backend: the port has no JAX backend "
                         "to pin",
}


#: functions the port carries verbatim inside a module that otherwise
#: differs (the module is in DIFFERS; these are held to their originals)
VERBATIM_FUNCTIONS = (
    ("parallel/multihost.py", "node_slice"),
    ("parallel/multihost.py", "region_nodes"),
)


#: non-Python files the port carries byte for byte (the generated
#: ``nhd_stats_pb2.py`` registers this file's descriptor in protobuf's
#: default pool, so both packages' copies must be the same file)
SAME_BYTES = ("rpc/nhd_stats.proto", "rpc/nhd_stats_pb2.py")


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


@pytest.mark.parametrize("rel", SAME_BYTES)
def test_byte_identical_files(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def _function_source(path: Path, name: str) -> str:
    import ast

    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"no function {name} in {path}")


@pytest.mark.parametrize("rel,name", VERBATIM_FUNCTIONS)
def test_copied_function_equals_its_original(rel, name):
    assert rel in DIFFERS
    port = _function_source(PORT / rel, name)
    assert _as_reference(port) == _function_source(REF / rel, name)
