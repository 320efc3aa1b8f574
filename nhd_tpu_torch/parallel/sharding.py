"""Node-axis sharding of the batched solve on PyTorch.

The counterpart of the reference's nhd_tpu/parallel/sharding.py. The
feasibility solve is embarrassingly parallel along the node axis, so the
15 node tensors split into equal row blocks, one per *shard*, and the
pod-type tensors are copied to each shard's device. Each shard runs the
solve kernels on its rows (with their global node index, so the
selection values are the unsharded solve's) and ranks them; the shards'
candidates merge into the packed [9, T, R] tensor by one more top-R
(solver/kernel.py ``rank_shards``).

The reference lays its mesh over JAX devices, virtual ones on a CPU
host. The port's mesh is a tuple of shard devices, placed round-robin
over the local devices of one type, and a device may repeat: on one GPU
every shard lives on ``cuda:0`` (the counterpart of the reference's
virtual CPU devices), on an 8-GPU host each shard gets its own GPU. A
mesh may also span processes: with a ``torch.distributed`` group each
rank holds the same number of shards, rank r's shard i is global shard
``r * local_shards + i``, and the ranks all-gather their candidates
before the merge (``solve_bucket_ranked_sharded``).

Operator knob: ``NHD_MESH`` / ``--mesh`` (auto / N / off), resolved by
``resolve_mesh_spec``; it counts distinct local GPUs only and never
builds repeated-device shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nhd_tpu_torch.device import DeviceLike
from nhd_tpu_torch.solver.kernel import (
    _ARG_ORDER,
    _pad_pow2,
    dispatch_ranked,
    pad_nodes,
    padded_args,
    to_device,
    upload_pods,
)


class Mesh:
    """A 1-D mesh of node shards over the axis ``nodes``.

    ``devices``: this process's shard devices, in shard order (a device
    may repeat). ``group``: a ``torch.distributed`` process group when
    the mesh spans processes; every rank of it must hold the same number
    of shards. ``size`` is the global shard count (the reference's
    ``mesh.devices.size``); ``first_shard`` is the global index of this
    process's first shard."""

    def __init__(self, devices: Sequence[DeviceLike], axis: str = "nodes",
                 group=None):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(
                f"mesh shards must share one device type, got {self.devices}"
            )
        self.axis_names = (axis,)
        self.group = group
        self.rank, self.world = 0, 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)

    @property
    def size(self) -> int:
        return self.world * len(self.devices)

    @property
    def first_shard(self) -> int:
        return self.rank * len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def distinct_devices(self) -> int:
        """How many distinct devices this process's shards use."""
        return len(set(self.devices))

    def __repr__(self) -> str:
        span = f", {self.world} processes" if self.group is not None else ""
        return (f"Mesh({self.axis_names[0]}={self.size} shards over "
                f"{self.distinct_devices()} local device(s){span})")


def _indexed(d: torch.device) -> torch.device:
    """*d* with its index: a bare ``cuda`` is the current GPU, so that
    two shards on one card compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _local_devices(kind: str) -> list:
    """The distinct local devices of type *kind*: every visible GPU for
    ``cuda``, the one CPU device for ``cpu``."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device {kind!r}: use 'cuda' or 'cpu'")


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None,
              n_shards: Optional[int] = None, *, device: str = "cuda",
              axis: str = "nodes", group=None) -> Mesh:
    """A 1-D node mesh. ``devices``: the shard devices themselves (a
    device may repeat); else ``n_shards`` shards (default: one per local
    device) round-robin over the distinct local devices of type
    *device*."""
    if devices is None:
        local = _local_devices(torch.device(device).type)
        if not local:
            raise ValueError(f"no local {device} device to build a mesh on")
        n = len(local) if n_shards is None else int(n_shards)
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_shards!r}")
        devices = [local[i % len(local)] for i in range(n)]
    elif n_shards is not None and n_shards != len(devices):
        raise ValueError(
            f"n_shards={n_shards} but {len(devices)} devices were given"
        )
    return Mesh(devices, axis, group)


def resolve_mesh_spec(spec):
    """Operator mesh knob (``NHD_MESH`` / ``--mesh``) → a BatchScheduler
    ``mesh`` argument, as the reference resolves it:

    * ``"auto"`` (default) — shard over every local GPU whenever more
      than one exists (BatchScheduler._resolve_mesh)
    * ``"off"`` / ``"0"`` / ``"none"`` — force the single-device path
    * ``"N"`` (an integer) — a mesh of N shards, one on each of the
      first N local GPUs; fewer GPUs is a refused misconfiguration, not
      a silent downgrade. The knob counts distinct GPUs
      (``torch.cuda.device_count()``) and never stacks shards on one.
    """
    if spec is None:
        return "auto"
    if isinstance(spec, Mesh):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "auto"):
        return "auto"
    if s in ("off", "0", "none"):
        return None
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"mesh spec must be 'auto', 'off'/'0'/'none' or a device "
            f"count, got {spec!r}"
        )
    devices = _local_devices("cuda")
    if n < 2:
        return None
    if n > len(devices):
        raise ValueError(
            f"mesh spec asks for {n} devices but only {len(devices)} are "
            f"local (CUDA_VISIBLE_DEVICES decides the device set)"
        )
    return make_mesh(devices[:n])


def shard_node_tensors(host_nodes: Sequence[np.ndarray], mesh: Mesh,
                       Np: int) -> list:
    """This process's shards of the padded host node arrays: per local
    shard, its row block of each array as a tensor on its device."""
    Ns = Np // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + i) * Ns
        out.append([to_device(a[lo: lo + Ns], dev) for a in host_nodes])
    return out


def solve_bucket_ranked_sharded(
    cluster, pods, R: Optional[int] = None, mesh: Optional[Mesh] = None,
    *, device: DeviceLike = "cuda",
) -> np.ndarray:
    """Sharded counterpart of kernel.solve_bucket_ranked: the solve and
    rank over *mesh* (default: every local device of *device*), the same
    packed [9, Tp, R] int32 contract as the reference's, as an owned
    host array. ``R`` defaults to the padded node count (every node
    ranked). Equal to the single-device rank on every val > 0 slot.

    A mesh over a process group is the reference's multi-controller
    contract: every rank holds the SAME host state, solves its own
    shards, and all ranks gather the candidates and merge them alike,
    so every rank returns the same tensor."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    T, N = pods.n_types, cluster.n_nodes
    Np = pad_nodes(N, mesh.size)
    Tp = _pad_pow2(T)
    R = min(R or Np, Np)
    host = padded_args(cluster, pods, Tp, Np)
    shards = shard_node_tensors(host[: len(_ARG_ORDER)], mesh, Np)
    uploads = {}
    for dev in mesh.devices:
        if dev not in uploads:
            uploads[dev] = upload_pods(pods, Tp, cluster.U, cluster.K, dev)
    out = dispatch_ranked(
        pods.G, cluster.U, cluster.K, R, Tp, Np, shards,
        [uploads[d] for d in mesh.devices], mesh=mesh,
    )
    return out.cpu().numpy().copy()
