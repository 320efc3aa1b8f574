"""Device-resident cluster state for multi-round batch scheduling.

The counterpart of the reference's nhd_tpu/solver/device_state.py: the
padded node arrays live on the device (CUDA, or the CPU for parity runs)
for a whole batch, and each round's claims reach them as row updates —
an in-place ``index_copy_`` per mutable tensor over the claimed rows, on
the same stream as the next solve, so the next solve sees them. Uploads
are O(claimed rows); downloads are the packed [9, T, R] rank tensor only.

The reference padded each scatter's index vector to a power of two to
reuse compiled XLA programs; ``index_copy_`` compiles nothing, so the
rows go as they are.

With a node mesh (parallel/sharding.py) the padded node axis splits into
equal row blocks: shard s holds rows [s*Ns, (s+1)*Ns) of every node
tensor on ``mesh.devices[s]``. A row update buckets its dirty global rows
by owning shard and makes one ``index_copy_`` per shard with shard-local
indices, so churn on a mesh pays O(changed rows) as on one device; the
solve runs per shard (kernel.dispatch_ranked) and so does the megaround
(solver/speculate.py: one graph over the shards where they share one
device, else a host loop), and only the merged rank tensor and the claim
planes leave the shards.

Host ``ClusterArrays`` stay the source of truth: every upload copies
(``kernel.to_device``), because ``torch.from_numpy`` shares memory and an
in-place row update would otherwise write into the host mirror.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.obs.counters import API_COUNTERS
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.solver import aot
from nhd_tpu_torch.solver.kernel import (
    _ARG_ORDER,
    _MUTABLE,
    _POD_ARG_ORDER,
    PodTensors,
    _pad_pow2,
    _pad_rows_to,
    dispatch_ranked,
    mesh_desc,
    pad_nodes,
    to_device,
    upload_pods,
)

Tensor = torch.Tensor


def from_numpy(cluster_like, pods_like, device: DeviceLike = "cuda"
               ) -> Tuple[List[Tensor], List[Tensor]]:
    """The packed numpy state of a cluster and a pod bucket — the
    reference's ``ClusterArrays``/``PodTypeArrays`` or the port's own,
    read duck-typed by the field names of ``_ARG_ORDER`` and
    ``_POD_ARG_ORDER`` — as the port's tensors on *device*: (15 node
    tensors, 10 pod tensors), unpadded, each a copy."""
    dev = resolve_device(device)
    node = [to_device(getattr(cluster_like, n), dev) for n in _ARG_ORDER]
    pods = [to_device(getattr(pods_like, n), dev) for n in _POD_ARG_ORDER]
    return node, pods


class HostPull:
    """A rank tensor on its way to the host. On CUDA the copy goes into
    pinned memory without blocking and ``numpy()`` waits for its event
    only; on the CPU the tensor already is host memory. *into*: a pinned
    host tensor of *t*'s shape and type to copy into, reused by a caller
    that pulls the same tensor again and again."""

    def __init__(self, t: Tensor, into: Optional[Tensor] = None):
        self._event = None
        if t.device.type == "cuda":
            self._host = (into if into is not None else
                          torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class DeviceClusterState:
    """Padded node tensors living on *device* for the duration of a batch
    (or of a persistent ScheduleContext).

    ``mesh``: a node mesh of one process (parallel/sharding.py). With
    more than one shard the tensors live sharded over ``mesh.devices``
    (``shards[s]``) and the lead shard's device is ``device``; without,
    ``shards`` holds the one set of tensors, which ``_dev`` names too."""

    def __init__(self, cluster, device: DeviceLike = "cuda", mesh=None, *,
                 capacity: Optional[int] = None):
        self.cluster = cluster
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if self.mesh is not None and self.mesh.group is not None:
            raise ValueError(
                "resident state shards over this process's devices only; a "
                "mesh that spans processes serves "
                "parallel.sharding.solve_bucket_ranked_sharded"
            )
        self.device = (self.mesh.devices[0] if self.mesh is not None
                       else resolve_device(device))
        self._devices = self.mesh.devices if self.mesh is not None else (self.device,)
        n_shards = len(self._devices)
        self.N = cluster.n_nodes
        # ``capacity``: the delta layer's padded row bucket (encode.py
        # ClusterDelta) — node adds inside it stay row updates
        self.Np = pad_nodes(max(self.N, capacity or 0), n_shards)
        self.shard_rows = self.Np // n_shards
        self.shards: List[Dict[str, Tensor]] = [{} for _ in range(n_shards)]
        # the single-device tensors by name (None on a mesh: read rows
        # through select_rows / shard_of)
        self._dev: Optional[Dict[str, Tensor]] = (
            self.shards[0] if self.mesh is None else None
        )
        self._staged: bool = False
        self._staged_rows: set = set()
        # per-bucket pod uploads, keyed by the bucket's requests list, one
        # per device — shared by every round's membership view of one
        # encode (the pod-type rows never change across rounds) and by
        # the shards on one device. The list is pinned in the entry so
        # its id cannot be reused.
        self._pods: Dict[int, Tuple[list, Dict[torch.device, PodTensors]]] = {}
        if self.mesh is not None:
            # mesh posture gauges, set at build (the reference's nhd_mesh_*)
            API_COUNTERS.set("mesh_devices", n_shards)
            API_COUNTERS.set("mesh_shard_rows", self.shard_rows)
        for name in _ARG_ORDER:
            self._upload(name)

    def _put(self, a: np.ndarray) -> List[Tensor]:
        """*a* padded to Np rows, one copy per shard on its device."""
        padded = _pad_rows_to(a, self.Np)
        Ns = self.shard_rows
        return [to_device(padded[s * Ns: (s + 1) * Ns], d)
                for s, d in enumerate(self._devices)]

    def _upload(self, name: str) -> None:
        for shard, t in zip(self.shards, self._put(getattr(self.cluster, name))):
            shard[name] = t

    def tensors(self) -> List[Tensor]:
        """The 15 resident node tensors in ``_ARG_ORDER`` (one device)."""
        if self.mesh is not None:
            raise RuntimeError("mesh-resident state: read shards[s] instead")
        return [self._dev[name] for name in _ARG_ORDER]

    def shard_tensors(self) -> List[List[Tensor]]:
        """Per shard, its 15 node tensors in ``_ARG_ORDER``."""
        return [[shard[name] for name in _ARG_ORDER] for shard in self.shards]

    def _by_shard(self, rows: np.ndarray):
        """(shard, shard-local rows) for each shard that owns some of the
        sorted global *rows*."""
        Ns = self.shard_rows
        owner = rows // Ns
        for s in np.unique(owner).tolist():
            yield s, rows[owner == s] - s * Ns

    def shard_of(self, row: int) -> Tuple[Dict[str, Tensor], int]:
        """(the tensors of the shard owning global *row*, its local row)."""
        return self.shards[row // self.shard_rows], row % self.shard_rows

    def row_index(self, rows: np.ndarray) -> List[Tuple[int, Tensor]]:
        """The sorted global *rows* (int64, non-empty) as (shard, its
        local rows as an index tensor on the shard's device) per owning
        shard, for ``select_rows``."""
        return [(s, to_device(local, self._devices[s]))
                for s, local in self._by_shard(rows)]

    def select_rows(self, name: str, index: List[Tuple[int, Tensor]]) -> Tensor:
        """The rows of resident tensor *name* that *index* (``row_index``)
        names, in global row order, on the lead device."""
        parts = [self.shards[s][name].index_select(0, idx).to(self.device)
                 for s, idx in index]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def resident(self, name: str) -> Tensor:
        """The whole padded tensor *name*, shards joined on the lead
        device (a copy on a mesh; for audits and tests)."""
        if self.mesh is None:
            return self._dev[name]
        return torch.cat([shard[name].to(self.device) for shard in self.shards])

    def stage_rows(self, indices: Iterable[int]) -> None:
        """Mark claim-mutated rows dirty; they reach the device before the
        next solve."""
        for i in indices:
            self._staged = True
            self._staged_rows.add(int(i))

    def _flush_staged(self) -> None:
        if not self._staged:
            return
        self._staged = False
        rows, self._staged_rows = self._staged_rows, set()
        if rows and len(rows) < self.N:
            self._scatter(
                _MUTABLE, np.fromiter(sorted(rows), np.int64, len(rows))
            )
        else:
            self._rebuild_mutable()

    def _scatter(self, names, rows: np.ndarray) -> None:
        """Copy *rows* of the named host arrays into the resident tensors
        in place, one ``index_copy_`` per tensor (per owning shard on a
        mesh, with shard-local indices) on the current stream."""
        from nhd_tpu_torch.solver import guard

        W = len(rows)
        if self.mesh is None:
            # the reference's detail string names its padded index width
            guard.maybe_inject("upload", f"scatter_W{_pad_pow2(W)}_N{self.Np}")
            key = f"A{len(names)}_N{self.Np}"
        else:
            n_dev = self.mesh.size
            widest = int(np.bincount(rows // self.shard_rows).max())
            guard.maybe_inject(
                "upload", f"mesh_scatter_W{_pad_pow2(widest)}_N{self.Np}_D{n_dev}"
            )
            key = f"A{len(names)}_N{self.Np}_M{mesh_desc(self.mesh)}"
        for s, local in self._by_shard(rows):
            dev = self._devices[s]
            idx = to_device(local, dev)
            glob = local + s * self.shard_rows
            for name in names:
                src = getattr(self.cluster, name)[glob]
                self.shards[s][name].index_copy_(0, idx, to_device(src, dev))
        JIT_STATS.record_use("row_scatter", key)
        aot.maybe_record(aot.ShapeKey("scatter", key), lambda: {
            "node": aot.arg_spec(self.shards[0][name] for name in names),
            "mesh": mesh_desc(self.mesh)})
        API_COUNTERS.inc("device_state_rows_uploaded_total", W)
        if self.mesh is not None:
            API_COUNTERS.inc("mesh_rows_uploaded_total", W)

    def _wholesale(self, names) -> None:
        """Re-upload the named tensors from the host mirror, counted."""
        for name in names:
            self._upload(name)
        API_COUNTERS.inc("device_state_rows_uploaded_total", self.N)
        if self.mesh is not None:
            API_COUNTERS.inc("mesh_wholesale_uploads_total")

    def scatter_rows(self, rows: np.ndarray) -> None:
        """Delta-layer sync (ClusterDelta.drain_dirty → here): update the
        changed rows of ALL resident tensors; past half the rows, one
        wholesale re-upload beats gathering scattered rows."""
        self.N = self.cluster.n_nodes
        if self.N > self.Np:
            raise ValueError(
                f"cluster grew past the resident capacity bucket "
                f"({self.N} > {self.Np}); rebuild DeviceClusterState"
            )
        if rows.size == 0:
            return
        self._flush_staged()
        if rows.size >= self.N // 2:
            self._wholesale(_ARG_ORDER)
            return
        self._scatter(_ARG_ORDER, np.sort(rows.astype(np.int64)))

    def rebuild_resident(self) -> None:
        """Re-derive every resident tensor from the host mirror, dropping
        staged rows (their values are host truth already)."""
        self.N = self.cluster.n_nodes
        if self.N > self.Np:
            raise ValueError(
                f"cluster grew past the resident capacity bucket "
                f"({self.N} > {self.Np}); rebuild DeviceClusterState"
            )
        self._staged = False
        self._staged_rows.clear()
        self._wholesale(_ARG_ORDER)

    def _rebuild_mutable(self) -> None:
        self._wholesale(_MUTABLE)

    def pod_tensors(self, pods, device: Optional[torch.device] = None) -> PodTensors:
        """*pods*' padded tensors on *device* (default the lead device),
        uploaded once per encode and device."""
        dev = self.device if device is None else device
        key = id(pods.requests)
        hit = self._pods.get(key)
        if hit is None or hit[0] is not pods.requests:
            if len(self._pods) >= 64:
                self._pods.clear()  # a persistent context's old batches
            hit = self._pods[key] = (pods.requests, {})
        up = hit[1].get(dev)
        if up is None:
            up = hit[1][dev] = upload_pods(
                pods, _pad_pow2(pods.n_types), self.cluster.U,
                self.cluster.K, dev,
            )
        return up

    def shard_pod_tensors(self, pods) -> List[PodTensors]:
        """*pods*' tensors for each shard (one upload per device)."""
        return [self.pod_tensors(pods, d) for d in self._devices]

    def megaround(self, bucket_pods: list, needs: list, respect_busy: bool):
        """Run the speculative multi-round (solver/speculate.py) against
        the resident tensors: up to spec_iters() claim rounds for every
        bucket jointly, the claim kernels updating the mutable tensors in
        place (the reference donated them to its jitted loop). Where
        every shard sits on one device (no mesh, or a mesh of one
        device's shards) it is one replay of the key's graph
        (``speculate.GRAPHS``, captured at the key's first dispatch in
        the process; the loop launch by launch on the CPU), the shards'
        plans joined inside it for the balanced fill; on a mesh over
        several devices each shard's host loop, with the balanced fill
        over the plans gathered on the lead device.

        ``bucket_pods``: PodTypeArrays per bucket, in bucket-dict order;
        ``needs``: per-bucket int32 [Tp] pending-pod counts. Returns the
        device tensors (claims [iters, Np] packed int32 words, counts
        [iters, Np], need_left [TT], iterations used as a scalar), on the
        lead device. If anything raises, the mutable tensors are rebuilt
        from the host mirror (source of truth) before the error
        propagates."""
        from nhd_tpu_torch.solver.speculate import (
            GRAPHS,
            graph_serves,
            run_megaround_shards,
            spec_iters,
        )

        self._flush_staged()
        shapes = tuple(
            (pods.G, _pad_pow2(pods.n_types)) for pods in bucket_pods
        )
        desc = mesh_desc(self.mesh)
        key = ("B" + "_".join(f"G{g}T{t}" for g, t in shapes)
               + f"_U{self.cluster.U}_K{self.cluster.K}_N{self.Np}"
               + (f"_M{desc}" if desc else ""))
        JIT_STATS.record_use("megaround", key)
        from nhd_tpu_torch.solver import guard

        guard.maybe_inject("megaround", f"B{len(bucket_pods)}_N{self.Np}")
        try:
            aot.maybe_record(aot.ShapeKey("megaround", key), lambda: dict(
                U=self.cluster.U, K=self.cluster.K, mesh=desc,
                node=aot.arg_spec(self.shard_tensors()[0]),
                buckets=[dict(G=pods.G, pod=aot.arg_spec(self.pod_tensors(pods).args))
                         for pods in bucket_pods],
            ))
            if graph_serves(self._devices):
                # the graph takes the pods' host arrays in its staging
                # copy: nothing is uploaded for it here
                return GRAPHS.run(
                    self.shards, bucket_pods, needs, self.cluster.U,
                    self.cluster.K, spec_iters(), respect_busy)
            # a WHILE node's body holds one CUDA context's work only: a
            # mesh over several devices runs the host loop
            tensors = [self.shard_pod_tensors(pods) for pods in bucket_pods]
            return run_megaround_shards(
                self.shards, bucket_pods,
                [[pt[s] for pt in tensors] for s in range(len(self.shards))],
                needs, self.cluster.U, self.cluster.K, spec_iters(),
                respect_busy,
            )
        except BaseException:
            self._rebuild_mutable()
            raise

    def solve_ranked(self, pods, R: int) -> Tensor:
        """Flush staged rows, then solve + rank: the packed [9, Tp, R]
        tensor, still on the (lead) device."""
        R = min(R, self.Np)
        self._flush_staged()
        if self.mesh is None:
            return dispatch_ranked(
                pods.G, self.cluster.U, self.cluster.K, R,
                _pad_pow2(pods.n_types), self.Np, self.tensors(),
                self.pod_tensors(pods),
            )
        API_COUNTERS.inc("mesh_solves_total")
        return dispatch_ranked(
            pods.G, self.cluster.U, self.cluster.K, R,
            _pad_pow2(pods.n_types), self.Np, self.shard_tensors(),
            self.shard_pod_tensors(pods), mesh=self.mesh,
        )
