"""Kernel cache and prewarm for the port: warm restarts of the solver.

The counterpart of the reference's nhd_tpu/solver/aot.py, which keeps
one StableHLO program per compiled solve shape. The port compiles no
per-shape program: each of its nine CUDA kernels is one library, built
by ``nvcc`` from its source (kernels/build.py) and shape-generic, and
so is the helper that captures the megaround's WHILE node
(``graph_while``). So
its cache keeps the reference's contract on two kinds of artifact:

* **Kernel libraries** — ``lib{kernel}-{fingerprint}.so`` beside a
  sidecar meta ``lib{kernel}-{fingerprint}.json``, written at build
  time: the fingerprint over the kernel's ``.cu``, ``kernels/abi.py``
  and ``NVCC_FLAGS``, the nvcc version, the target (``sm_90a``), the
  torch and CUDA versions and the card's name. A library whose meta
  mismatches or cannot be read, that fails ``dlopen``, or that lacks an
  entry symbol is QUARANTINED (moved to ``<dir>/quarantine/``, never
  deleted) with one warning per run, and rebuilt from source; a rebuild
  that fails raises. Nothing falls back to the plain versions.
* **A manifest of shape keys** — one ``<kind>_<key>.json`` per shape
  the solver dispatched: ``ranked_g{G}_u{U}_k{K}_r{R}_t{Tp}_n{Np}`` (a
  solve + rank, kernel.dispatch_ranked), ``megaround_b...`` (one
  bucket set of the speculative megaround) and ``scatter_a{A}_n{Np}``
  (a resident row update), a dispatch on a node mesh with the mesh's
  ``_m{mesh_desc}`` after it (the reference's mesh-qualified keys;
  its shapes are one shard's), each with the shapes of its arguments and
  the program fingerprint (a hash over the port's solver/kernel.py and
  solver/combos.py). When saving is on (``NHD_AOT_SAVE=1`` or
  ``configure(save=True)``), a first-seen key is written on a
  background thread; a failed write counts
  ``aot_export_failures_total`` and logs once.

``prewarm(progress=, device=, mesh=)`` (daemon flag ``--prewarm``)
builds any missing library and loads all ten, creates the CUDA context,
and for every manifest key runs the solve kernels (for a ranked key,
then ``rank_top``, and on a mesh ``rank_merge``; for a
single-device megaround key, captures the key's graph into the
process's cache and replays it; on a mesh, the host loop's claim
kernels) once on zeros at that shape, a mesh key over the
caller's mesh when its descriptor matches, else over a mesh rebuilt on
the local devices; a mesh key that needs more devices than the host has
is skipped (left in place, neither warmed nor quarantined, as the
reference skips a bigger slice's artifact): the first real pod then
finds the libraries loaded, the kernels' modules resident, the bucket
tables on the device and the allocator sized. Each warmed key is
recorded in the jit stats, so steady-state dispatches count as hits and
the zero-recompile invariant is measured (tests/test_torch_aot.py,
chip_smoke.py phase 12). On the CPU the libraries are skipped (the
wrappers run their plain versions there) and the keys warm the plain
path.

Environment: ``NHDC_AOT_DIR`` (the port's cache directory, default
``nhd_tpu_torch/_build/``, where kernels/build.py builds; not the
reference's ``NHD_AOT_DIR``, whose prewarm would quarantine the port's
files as unreadable), ``NHD_AOT_SAVE=1`` (record new keys),
``NHD_AOT=0`` (no manifest and no prewarm; the libraries still build
and validate, since every CUDA launch needs them).

    python -m nhd_tpu_torch.solver.aot --first-bind-probe [--prewarm]
        [--save] [--device cuda|cpu]

binds one pod through the port's scheduler in a fresh process and
prints one JSON line with its timings.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from nhd_tpu_torch.utils import get_logger

AOT_SCHEMA_VERSION = 1
DEFAULT_DIR = str(Path(__file__).resolve().parents[1] / "_build")

#: manifest kinds → the jit-stats kind their dispatch records
JIT_KIND = {"ranked": "solve_ranked", "megaround": "megaround",
            "scatter": "row_scatter"}

#: fields a manifest entry's meta must match to be warmed
_VERSIONED_FIELDS = ("aot_schema", "fingerprint")


@dataclass(frozen=True)
class ShapeKey:
    """One shape the solver dispatched: its kind (``JIT_KIND``) and the
    jit-stats shape key its dispatch site records."""

    kind: str
    key: str

    def name(self) -> str:
        return f"{self.kind}_{self.key.lower()}"


_FINGERPRINT: Optional[str] = None


def program_fingerprint() -> str:
    """Hash over the solve's sources: an edit to the port's kernel.py or
    combos.py changes it and retires every manifest entry."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import hashlib

        h = hashlib.sha256()
        here = Path(__file__).resolve().parent
        for name in ("kernel.py", "combos.py"):
            h.update((here / name).read_bytes())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def arg_spec(tensors) -> list:
    """[[shape, dtype name], ...] of *tensors* (torch tensors)."""
    return [[list(t.shape), str(t.dtype).replace("torch.", "")]
            for t in tensors]


def _zeros(spec, device):
    import torch

    return [torch.zeros(shape, dtype=getattr(torch, dtype), device=device)
            for shape, dtype in spec]


class AotCache:
    """The process's kernel-cache state: configuration, the prewarmed
    keys, the background manifest writer and quarantine."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._warm: Dict[ShapeKey, dict] = {}
        self._dir: Optional[str] = None
        self._save: Optional[bool] = None
        self._recording: set = set()
        self._threads: List[threading.Thread] = []
        self._warned_quarantine = False
        self._warned_export = False
        self.logger = get_logger(__name__)

    # -- configuration -------------------------------------------------

    def configure(
        self, directory: Optional[str] = None, save: Optional[bool] = None,
    ) -> None:
        with self._lock:
            if directory is not None:
                self._dir = directory
            if save is not None:
                self._save = save

    def reset(self) -> None:
        """Drop the prewarmed keys and the configuration (test isolation)."""
        self.drain()
        with self._lock:
            self._warm.clear()
            self._recording.clear()
            self._dir = None
            self._save = None
            self._warned_quarantine = False
            self._warned_export = False

    def enabled(self) -> bool:
        return os.environ.get("NHD_AOT", "1") != "0"

    def directory(self) -> str:
        return self._dir or os.environ.get("NHDC_AOT_DIR", DEFAULT_DIR)

    def saving(self) -> bool:
        if self._save is not None:
            return self._save
        return os.environ.get("NHD_AOT_SAVE", "0") == "1"

    def _path(self, key: ShapeKey) -> str:
        return os.path.join(self.directory(), key.name() + ".json")

    # -- the dispatch-side surface ------------------------------------

    def lookup(self, key: ShapeKey) -> Optional[dict]:
        """The meta *key* was prewarmed from this run, or None."""
        return self._warm.get(key)

    def maybe_record(self, key: ShapeKey, spec_fn: Callable[[], dict]) -> None:
        """Record *key* in the manifest on a background thread, once per
        key per process, when saving is on and no entry exists yet.
        ``spec_fn`` gives the argument shapes; it runs here, on the
        dispatching thread, and only for a key that will be written."""
        if key in self._recording or not (self.enabled() and self.saving()):
            return
        path = self._path(key)
        with self._lock:
            if key in self._recording:
                return
            self._recording.add(key)
        if os.path.exists(path):
            return
        t = threading.Thread(
            target=self._export, args=(key, spec_fn(), path),
            name=f"nhdc-aot-record-{key.name()}", daemon=True,
        )
        with self._lock:
            self._threads.append(t)
        t.start()

    def drain(self) -> None:
        """Wait for queued manifest writes (probe/test determinism)."""
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join()

    def _export(self, key: ShapeKey, spec: dict, path: str) -> None:
        try:
            meta = {
                "aot_schema": AOT_SCHEMA_VERSION,
                "kind": key.kind,
                "key": key.key,
                "fingerprint": program_fingerprint(),
                "spec": spec,
                # artifact metadata stamp, not placement input
                "created_unix": time.time(),  # nhdlint: ignore[NHD402]
            }
            os.makedirs(self.directory(), exist_ok=True)
            _write_atomic(
                path, json.dumps(meta, indent=1, sort_keys=True).encode()
            )
        except Exception as exc:
            # recording is for the NEXT restart and must never break the
            # run that volunteered it; count every failure and log the
            # first, or a dead writer would read as a warm cache forever
            from nhd_tpu_torch.k8s.retry import API_COUNTERS

            API_COUNTERS.inc("aot_export_failures_total")
            with self._lock:
                warned, self._warned_export = self._warned_export, True
            if not warned:
                self.logger.warning(
                    f"aot: recording {key.name()} failed (cache skipped, "
                    f"serving unaffected): {exc}"
                )

    def forget(self, key: ShapeKey) -> None:
        """Retire *key*: drop it from the prewarmed set and quarantine its
        manifest entry (the solver guard's poisoned-shape hook): a shape
        whose dispatches keep faulting is not warmed at the next start,
        and the dispatch does not record it again while the guard holds
        it quarantined. Idempotent."""
        with self._lock:
            self._warm.pop(key, None)
        path = self._path(key)
        if os.path.exists(path):
            self.quarantine([path], "solver guard: shape faulted repeatedly")

    # -- quarantine ----------------------------------------------------

    def quarantine(self, paths, why: str) -> int:
        """Move *paths* (the files of one artifact) out of the load path
        into ``<dir>/quarantine/``, never deleting them nor clobbering an
        earlier quarantined generation. One warning per run covers every
        quarantined artifact. Returns the number of files moved."""
        qdir = os.path.join(self.directory(), "quarantine")
        os.makedirs(qdir, exist_ok=True)
        moved = 0
        for path in paths:
            path = str(path)
            if not os.path.exists(path):
                continue
            dest = os.path.join(qdir, os.path.basename(path))
            n = 1
            while os.path.exists(dest):
                dest = os.path.join(qdir, f"{os.path.basename(path)}.{n}")
                n += 1
            try:
                os.replace(path, dest)
                moved += 1
            except OSError:
                pass
        with self._lock:
            warned, self._warned_quarantine = self._warned_quarantine, True
        if not warned:
            first = os.path.basename(str(next(iter(paths), "")))
            self.logger.warning(
                f"aot: quarantined stale artifact(s) under {qdir} (first: "
                f"{first}: {why}); affected libraries rebuild from source"
            )
        return moved

    # -- prewarm -------------------------------------------------------

    def _validate(self, meta: dict) -> Optional[str]:
        if meta.get("kind") not in JIT_KIND:
            return f"kind {meta.get('kind')!r} is not a manifest kind"
        want = {"aot_schema": AOT_SCHEMA_VERSION,
                "fingerprint": program_fingerprint()}
        for field in _VERSIONED_FIELDS:
            if meta.get(field) != want[field]:
                return f"{field} {meta.get(field)!r} != {want[field]!r}"
        return None

    def prewarm(self, progress: Optional[Callable[[], None]] = None,
                device="cuda", mesh=None) -> dict:
        """Load the libraries and warm every valid manifest key on
        *device* (a mesh key over *mesh* when its descriptor matches);
        quarantine what is stale. Returns a summary: ``loaded`` (keys
        warmed), ``libraries`` (loaded), ``built`` (compiled now),
        ``quarantined``, ``skipped`` (artifacts inapplicable here: the
        libraries on the CPU, a mesh larger than the host), ``seconds``
        and ``keys``.

        ``progress`` is called (no args, exceptions swallowed) after
        every artifact: each library, each manifest entry. The CLI wires
        ``Scheduler._beat`` here so the stall watchdog never reads a
        long prewarm as a wedged loop."""
        from nhd_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        t0 = time.perf_counter()
        summary = {
            "loaded": 0, "libraries": 0, "built": 0, "quarantined": 0,
            "skipped": 0, "keys": [], "seconds": 0.0,
        }

        def _tick() -> None:
            if progress is None:
                return
            try:
                progress()
            except Exception:  # nhdlint: ignore[NHD302]
                # justified broad catch: progress is an arbitrary
                # caller-supplied callback; prewarm must finish whatever
                # it raises
                pass

        libs = set()
        if dev.type == "cuda":
            import torch

            from nhd_tpu_torch.kernels import build
            from nhd_tpu_torch.kernels.abi import SOURCES

            # the CUDA context first: every later step needs it
            torch.zeros(1, device=dev)
            before = dict(build.COUNTS)
            for name in SOURCES:
                # once per library: load memoizes the handle
                build.load(name)  # nhdlint: ignore[NHD104]
                libs.add(build.library_path(name).name[: -len(".so")])
                summary["libraries"] += 1
                _tick()
            summary["built"] = build.COUNTS["builds"] - before["builds"]
            summary["quarantined"] += (
                build.COUNTS["quarantined"] - before["quarantined"]
            )
        directory = self.directory()
        if not os.path.isdir(directory):
            summary["seconds"] = time.perf_counter() - t0
            return summary
        for fname in sorted(os.listdir(directory)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(directory, fname)
            stem = fname[: -len(".json")]
            if stem in libs:
                continue            # validated and loaded above
            try:
                with open(path) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError) as exc:
                summary["quarantined"] += 1
                self.quarantine([path], f"unreadable meta: {exc}")
                _tick()
                continue
            if meta.get("kind") == "library":
                if dev.type != "cuda":
                    summary["skipped"] += 1   # no library runs on the CPU
                else:
                    # another build of a kernel than the one this source
                    # and toolchain make: stale
                    summary["quarantined"] += 1
                    self.quarantine(
                        [path, path[: -len(".json")] + ".so"],
                        "library of another source or toolchain",
                    )
                _tick()
                continue
            if not self.enabled():
                summary["skipped"] += 1
                _tick()
                continue
            why = self._validate(meta)
            if why is None:
                try:
                    key = ShapeKey(meta["kind"], meta["key"])
                    spec = meta["spec"]
                    key_mesh = _mesh_for(spec.get("mesh", ""), dev, mesh)
                except Exception as exc:
                    why = f"unreadable entry: {exc!r}"
            if why is None and key_mesh is _TOO_BIG:
                summary["skipped"] += 1   # a bigger host's mesh: kept
                _tick()
                continue
            if why is None:
                try:
                    _WARM[key.kind](spec, dev, key_mesh)
                except Exception as exc:
                    why = f"warm-up failed: {exc!r}"
            if why is not None:
                summary["quarantined"] += 1
                self.quarantine([path], why)
                _tick()
                continue
            from nhd_tpu_torch.obs.jitstats import JIT_STATS

            with self._lock:
                self._warm[key] = meta
            # the key's first production dispatch must count as a HIT
            JIT_STATS.record_use(JIT_KIND[key.kind], key.key)
            summary["loaded"] += 1
            summary["keys"].append(key.name())
            _tick()
        if dev.type == "cuda":
            import torch

            # the prewarm's seconds include its launches finishing
            torch.cuda.synchronize(dev)  # nhdlint: ignore[NHD107]
        summary["seconds"] = time.perf_counter() - t0
        return summary


# ---------------------------------------------------------------------------
# warm-ups: each runs the key's kernels once on zeros at its shapes
# ---------------------------------------------------------------------------


def _zero_pods(G: int, spec, device):
    """A PodTypeArrays stand-in of zeros and its uploaded tensors."""
    from types import SimpleNamespace

    from nhd_tpu_torch.solver.kernel import _POD_ARG_ORDER

    arrays = {name: t.numpy() for name, t in
              zip(_POD_ARG_ORDER, _zeros(spec, "cpu"), strict=True)}
    Tp = arrays["hp"].shape[0]
    return SimpleNamespace(G=G, n_types=Tp, **arrays), Tp


#: _mesh_for's answer for a mesh key that needs more devices than the host
_TOO_BIG = object()


def _mesh_for(desc: str, device, mesh):
    """The mesh a manifest key with mesh descriptor *desc* warms over:
    None for a single-device key, the caller's *mesh* when its
    descriptor is *desc*, else *desc*'s shard count over the distinct
    local devices of *device*'s type (one shard each), or ``_TOO_BIG``
    when the host has fewer such devices."""
    from nhd_tpu_torch.parallel.sharding import _local_devices, make_mesh
    from nhd_tpu_torch.solver.kernel import mesh_desc, parse_mesh_desc

    parsed = parse_mesh_desc(desc)
    if parsed is None:
        return None
    if mesh is not None and mesh_desc(mesh) == desc:
        return mesh
    local = _local_devices(device.type)
    if parsed[1] > len(local):
        return _TOO_BIG
    return make_mesh(local[: parsed[1]], axis=parsed[0])


def _shard_zeros(spec, device, mesh):
    """Per shard (one shard without a mesh), zero tensors of *spec*'s
    shapes on the shard's device."""
    devices = (device,) if mesh is None else mesh.devices
    return devices, [_zeros(spec, d) for d in devices]


def _warm_ranked(spec: dict, device, mesh=None) -> None:
    from nhd_tpu_torch.solver.kernel import (
        rank_planes,
        rank_shards,
        solve_planes,
        upload_pods,
    )

    devices, shards = _shard_zeros(spec["node"], device, mesh)
    pods, Tp = _zero_pods(spec["G"], spec["pod"], device)
    uploads = [upload_pods(pods, Tp, spec["U"], spec["K"], d) for d in devices]
    if mesh is None:
        node = shards[0]
        rank_planes(spec["R"], solve_planes(spec["G"], spec["U"], spec["K"],
                                            node, uploads[0]), node)
    else:
        rank_shards(spec["G"], spec["U"], spec["K"], spec["R"], spec["Np"],
                    shards, uploads)


def _warm_megaround(spec: dict, device, mesh=None) -> None:
    """One dispatch of the claim loop at the bucket set's shapes: one
    pending pod of the first type row, on zero node state, so every
    solve and claim kernel launches and nothing is claimed. Where every
    shard sits on one device (one shard without a mesh) that is the
    graph path: the key's graph captured into the process's cache
    (``speculate.GRAPHS``) and replayed once over the zero state, for
    both busy rules (the daemon respects the GPU busy window, a bare
    batch need not), so the first batch of the key replays it. A mesh
    over several devices warms its host loop."""
    import numpy as np

    from nhd_tpu_torch.solver.kernel import _ARG_ORDER, upload_pods
    from nhd_tpu_torch.solver.speculate import (
        GRAPHS,
        graph_serves,
        run_megaround_shards,
        spec_iters,
    )

    devices, shards = _shard_zeros(spec["node"], device, mesh)
    shards = [dict(zip(_ARG_ORDER, node, strict=True)) for node in shards]
    bucket_pods, needs = [], []
    for b in spec["buckets"]:
        pods, Tp = _zero_pods(b["G"], b["pod"], device)
        bucket_pods.append(pods)
        need = np.zeros(Tp, np.int32)
        need[0] = 1
        needs.append(need)
    if graph_serves(devices):
        for respect_busy in (False, True):
            GRAPHS.run(shards, bucket_pods, needs, spec["U"], spec["K"],
                       spec_iters(), respect_busy)
        return
    tensors = [[upload_pods(pods, pods.n_types, spec["U"], spec["K"], d)
                for pods in bucket_pods] for d in devices]
    run_megaround_shards(shards, bucket_pods, tensors, needs, spec["U"],
                         spec["K"], spec_iters(), False)


def _warm_scatter(spec: dict, device, mesh=None) -> None:
    """A row update at the resident shapes (``index_copy_``: nothing to
    compile; recorded so the accounting sees the key as warm)."""
    import torch

    devices, shards = _shard_zeros(spec["node"], device, mesh)
    for d, node in zip(devices, shards):
        idx = torch.zeros(1, dtype=torch.int64, device=d)
        for t in node:
            t.index_copy_(0, idx, t[:1].clone())


_WARM = {"ranked": _warm_ranked, "megaround": _warm_megaround,
         "scatter": _warm_scatter}


#: process-wide cache (one kernel table per process)
AOT = AotCache()


def lookup(key: ShapeKey) -> Optional[dict]:
    return AOT.lookup(key)


def maybe_record(key: ShapeKey, spec_fn: Callable[[], dict]) -> None:
    AOT.maybe_record(key, spec_fn)


def forget(key: ShapeKey) -> None:
    AOT.forget(key)


def configure(directory: Optional[str] = None, save: Optional[bool] = None):
    AOT.configure(directory, save)


def prewarm(progress: Optional[Callable[[], None]] = None,
            device="cuda", mesh=None) -> dict:
    return AOT.prewarm(progress, device, mesh)


def reset() -> None:
    AOT.reset()


# ---------------------------------------------------------------------------
# first-bind probe: bind one pod through the port's scheduler in a FRESH
# process (the library table, the CUDA context and the caching allocator
# are process-global, so an in-process "cold" number would be a lie)
# ---------------------------------------------------------------------------


def _first_bind_probe(prewarm_first: bool, save: bool, device) -> dict:
    import queue as queue_mod

    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.kernels import build
    from nhd_tpu_torch.scheduler.core import Scheduler
    from nhd_tpu_torch.scheduler.events import WatchQueue
    from nhd_tpu_torch.sim import (
        SynthNodeSpec, make_node_labels, make_triad_config,
    )

    if save:
        configure(save=True)
    out = {"prewarm_s": 0.0, "programs": 0, "quarantined": 0,
           "libraries": 0, "built": 0}
    if prewarm_first:
        summary = prewarm(device=device)
        out["prewarm_s"] = summary["seconds"]
        out["programs"] = summary["loaded"]
        out["quarantined"] = summary["quarantined"]
        out["libraries"] = summary["libraries"]
        out["built"] = summary["built"]
    backend = FakeClusterBackend()
    for i in range(8):
        spec = SynthNodeSpec(name=f"aot-node{i:02d}")
        backend.add_node(
            spec.name, make_node_labels(spec), hugepages_gb=spec.hugepages_gb
        )
    sched = Scheduler(
        backend, WatchQueue(), queue_mod.Queue(), respect_busy=False,
        device=device,
    )
    sched.build_initial_node_list()
    backend.create_pod(
        "aot-probe-0", cfg_text=make_triad_config(gpus_per_group=1)
    )
    from nhd_tpu_torch.solver.speculate import graph_stats

    before = dict(build.COUNTS)
    captures = graph_stats()["captures"]
    t0 = time.perf_counter()
    sched.attempt_scheduling_batch([("aot-probe-0", "default", "uid-aot")])
    out["first_bind_s"] = time.perf_counter() - t0
    out["bind_builds"] = build.COUNTS["builds"] - before["builds"]
    out["bind_loads"] = build.COUNTS["loads"] - before["loads"]
    # megaround graphs captured inside the bind (0 after a prewarm)
    out["bind_captures"] = graph_stats()["captures"] - captures
    out["bound"] = backend.pods[("default", "aot-probe-0")].node
    if out["bound"] is None:
        # a failed bind is usually FASTER than a successful one
        raise RuntimeError("first-bind probe pod did not bind")
    # a second pod in the same process: the steady state the first bind
    # is measured against
    backend.create_pod(
        "aot-probe-1", cfg_text=make_triad_config(gpus_per_group=1)
    )
    t0 = time.perf_counter()
    sched.attempt_scheduling_batch([("aot-probe-1", "default", "uid-aot-1")])
    out["second_bind_s"] = time.perf_counter() - t0
    if backend.pods[("default", "aot-probe-1")].node is None:
        raise RuntimeError("first-bind probe's second pod did not bind")
    if save:
        AOT.drain()  # the seed run's whole job is leaving entries behind
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.obs.jitstats import JIT_STATS

    out["launches"] = dict(kernels.LAUNCHES)   # the whole process's
    # its classic rank dispatches (a prewarmed ranked key counts one)
    out["ranked"] = sum(n for k, n in JIT_STATS.snapshot()["shapes"].items()
                        if k.startswith("solve_ranked:"))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m nhd_tpu_torch.solver.aot", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--first-bind-probe", action="store_true",
                    help="bind one pod through the port's scheduler in "
                         "this fresh process and print timing JSON")
    ap.add_argument("--prewarm", action="store_true",
                    help="prewarm from the kernel cache (NHDC_AOT_DIR) first")
    ap.add_argument("--save", action="store_true",
                    help="record the shapes dispatched to the manifest")
    ap.add_argument("--device", default="cuda",
                    help="solve device (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    if not args.first_bind_probe:
        ap.print_help()
        return 2
    result = _first_bind_probe(args.prewarm, args.save, args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    import sys

    # run the CANONICAL module's main: under `python -m` this file is
    # `__main__`, while the dispatch imports `nhd_tpu_torch.solver.aot`
    from nhd_tpu_torch.solver.aot import main as _canonical_main

    sys.exit(_canonical_main())
