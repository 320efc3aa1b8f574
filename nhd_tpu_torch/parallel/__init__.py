"""Node-sharded execution of the batched solve on PyTorch.

The counterpart of the reference's nhd_tpu/parallel/. In a scheduler the
data-parallel axis is the cluster itself: every node tensor shards along
the node axis, pod-type tensors are copied to each shard's device, and
the selection is a merge across shards.

* sharding    — the port's 1-D ``nodes`` Mesh of shards, the NHD_MESH
  operator-knob resolver and the sharded ranked solve (one process, or
  several over a ``torch.distributed`` group)
* multihost   — ``torch.distributed`` bootstrap and the per-process node
  regions of a federation
* spmd_bench  — the cfg6 probe (``python -m nhd_tpu_torch.parallel.spmd_bench``)
"""

from nhd_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    resolve_mesh_spec,
    solve_bucket_ranked_sharded,
)

__all__ = ["Mesh", "make_mesh", "resolve_mesh_spec", "solve_bucket_ranked_sharded"]
