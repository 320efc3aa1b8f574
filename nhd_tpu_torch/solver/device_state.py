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
    (or of a persistent ScheduleContext)."""

    def __init__(self, cluster, device: DeviceLike = "cuda", *,
                 capacity: Optional[int] = None):
        self.cluster = cluster
        self.device = resolve_device(device)
        self.N = cluster.n_nodes
        # ``capacity``: the delta layer's padded row bucket (encode.py
        # ClusterDelta) — node adds inside it stay row updates
        self.Np = pad_nodes(max(self.N, capacity or 0))
        self._dev: Dict[str, Tensor] = {}
        self._staged: bool = False
        self._staged_rows: set = set()
        # per-bucket pod uploads, keyed by the bucket's requests list —
        # shared by every round's membership view of one encode (the
        # pod-type rows never change across rounds). The list is pinned
        # in the entry so its id cannot be reused.
        self._pods: Dict[int, Tuple[list, PodTensors]] = {}
        for name in _ARG_ORDER:
            self._dev[name] = self._put(getattr(cluster, name))

    def _put(self, a: np.ndarray) -> Tensor:
        return to_device(_pad_rows_to(a, self.Np), self.device)

    def tensors(self) -> List[Tensor]:
        """The 15 resident node tensors in ``_ARG_ORDER``."""
        return [self._dev[name] for name in _ARG_ORDER]

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
        in place, one ``index_copy_`` per tensor on the current stream."""
        from nhd_tpu_torch.solver import guard

        # the reference's detail string names its padded index width
        guard.maybe_inject(
            "upload", f"scatter_W{_pad_pow2(len(rows))}_N{self.Np}"
        )
        idx = to_device(rows.astype(np.int64), self.device)
        for name in names:
            src = getattr(self.cluster, name)[rows]
            self._dev[name].index_copy_(0, idx, to_device(src, self.device))
        key = f"A{len(names)}_N{self.Np}"
        JIT_STATS.record_use("row_scatter", key)
        aot.maybe_record(aot.ShapeKey("scatter", key), lambda: {
            "node": aot.arg_spec(self._dev[name] for name in names)})
        API_COUNTERS.inc("device_state_rows_uploaded_total", len(rows))

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
            for name in _ARG_ORDER:
                self._dev[name] = self._put(getattr(self.cluster, name))
            API_COUNTERS.inc("device_state_rows_uploaded_total", self.N)
            return
        self._scatter(_ARG_ORDER, rows.astype(np.int64))

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
        for name in _ARG_ORDER:
            self._dev[name] = self._put(getattr(self.cluster, name))
        API_COUNTERS.inc("device_state_rows_uploaded_total", self.N)

    def _rebuild_mutable(self) -> None:
        for name in _MUTABLE:
            self._dev[name] = self._put(getattr(self.cluster, name))
        API_COUNTERS.inc("device_state_rows_uploaded_total", self.N)

    def pod_tensors(self, pods) -> PodTensors:
        """*pods*' padded tensors on the device, uploaded once per encode."""
        key = id(pods.requests)
        hit = self._pods.get(key)
        if hit is None or hit[0] is not pods.requests:
            if len(self._pods) >= 64:
                self._pods.clear()  # a persistent context's old batches
            hit = (pods.requests, upload_pods(
                pods, _pad_pow2(pods.n_types), self.cluster.U,
                self.cluster.K, self.device,
            ))
            self._pods[key] = hit
        return hit[1]

    def megaround(self, bucket_pods: list, needs: list, respect_busy: bool):
        """Run the speculative multi-round (solver/speculate.py) against
        the resident tensors: up to spec_iters() claim rounds for every
        bucket jointly, the claim kernels updating the mutable tensors in
        place (the reference donated them to its jitted loop).

        ``bucket_pods``: PodTypeArrays per bucket, in bucket-dict order;
        ``needs``: per-bucket int32 [Tp] pending-pod counts. Returns the
        device tensors (claims [iters, Np] packed int32 words, counts
        [iters, Np], need_left [TT], iterations used as a scalar). If
        anything raises, the mutable tensors are rebuilt from the host
        mirror (source of truth) before the error propagates."""
        from nhd_tpu_torch.solver.speculate import run_megaround, spec_iters

        self._flush_staged()
        shapes = tuple(
            (pods.G, _pad_pow2(pods.n_types)) for pods in bucket_pods
        )
        key = ("B" + "_".join(f"G{g}T{t}" for g, t in shapes)
               + f"_U{self.cluster.U}_K{self.cluster.K}_N{self.Np}")
        JIT_STATS.record_use("megaround", key)
        from nhd_tpu_torch.solver import guard

        guard.maybe_inject("megaround", f"B{len(bucket_pods)}_N{self.Np}")
        try:
            tensors = [self.pod_tensors(pods) for pods in bucket_pods]
            aot.maybe_record(aot.ShapeKey("megaround", key), lambda: dict(
                U=self.cluster.U, K=self.cluster.K,
                node=aot.arg_spec(self.tensors()),
                buckets=[dict(G=pods.G, pod=aot.arg_spec(pt.args))
                         for pods, pt in zip(bucket_pods, tensors)],
            ))
            return run_megaround(
                self._dev, bucket_pods, tensors,
                needs, self.cluster.U, self.cluster.K, spec_iters(),
                respect_busy,
            )
        except BaseException:
            self._rebuild_mutable()
            raise

    def solve_ranked(self, pods, R: int) -> Tensor:
        """Flush staged rows, then solve + rank: the packed [9, Tp, R]
        tensor, still on the device."""
        R = min(R, self.Np)
        self._flush_staged()
        return dispatch_ranked(
            pods.G, self.cluster.U, self.cluster.K, R,
            _pad_pow2(pods.n_types), self.Np, self.tensors(),
            self.pod_tensors(pods),
        )
