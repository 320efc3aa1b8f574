"""Multi-process bootstrap for federation-scale scheduling, over
``torch.distributed``.

The counterpart of the reference's nhd_tpu/parallel/multihost.py, which
bootstraps ``jax.distributed``. Node state is small (KBs per row), so
several processes are about locality and throughput, not capacity: each
process owns a node region of the federation, and only the compact
per-(type, node) decisions travel.

Usage in each process of a multi-process deployment:

    from nhd_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="tcp://host0:29500", num_processes=4,
                         process_id=RANK)
    mine = multihost.local_nodes(all_nodes)   # this process's region
    StreamingScheduler(...).schedule(mine, items)

Each process's BatchScheduler shards over its own local GPUs ("auto");
a global solve over every process's shards takes an explicit mesh with
the process group (``parallel.sharding.make_mesh(group=...)`` and
``solve_bucket_ranked_sharded``).

The backend is the caller's choice: ``gloo`` by default on a host without
a GPU, ``nccl`` with one. NCCL refuses two ranks on one GPU, so several
processes sharing one card take ``gloo``, and the sharded solve then
gathers its candidates through an explicit host copy.
"""

from __future__ import annotations

from typing import Optional

from nhd_tpu_torch.utils import get_logger


def _init_method(coordinator: Optional[str]) -> str:
    """``coordinator`` as an init_method: "host:port" becomes tcp://,
    a tcp:// or file:// URL passes through, None reads the environment
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK)."""
    if coordinator is None:
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` with an explicit or
    env-provided topology. ``backend`` defaults to ``nccl`` when a GPU
    is visible and ``gloo`` otherwise. Idempotent: re-initialization is
    a no-op."""
    import torch
    import torch.distributed as dist

    logger = get_logger(__name__)
    if dist.is_initialized():
        logger.warning("torch.distributed already initialized; ignoring")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(
        backend, init_method=_init_method(coordinator), **kwargs
    )
    logger.warning(
        f"multihost: process {dist.get_rank()}/{dist.get_world_size()} "
        f"over {backend}"
    )


def node_slice(n_nodes: int, process_id: int, process_count: int) -> slice:
    """The contiguous node-index range a given process owns under a 1-D
    nodes mesh (block layout, matching the fused sharded megaround's
    padding — sharding.solve_bucket_ranked_sharded). Exposed by rank so
    a survivor can compute a DEAD rank's
    region for elastic takeover (tests/test_distributed.py failure leg)."""
    per = -(-n_nodes // process_count)  # ceil division
    start = per * process_id
    return slice(start, min(start + per, n_nodes))


def _process() -> tuple:
    """(rank, world size) of this process: (0, 1) before initialize."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_node_slice(n_nodes: int) -> slice:
    """node_slice for THIS process."""
    return node_slice(n_nodes, *_process())


def region_nodes(nodes: dict, process_id: int, process_count: int) -> dict:
    """The node shard rank *process_id* owns. Names are SORTED before
    slicing: each host builds its dict from its own API listing whose
    order is not guaranteed, and the partition must be identical on every
    host (exact cover, no node owned twice)."""
    names = sorted(nodes.keys())
    s = node_slice(len(names), process_id, process_count)
    return {n: nodes[n] for n in names[s]}


def local_nodes(nodes: dict) -> dict:
    """This process's node shard of a federation cluster — the multi-host
    streaming pattern: each host runs a StreamingScheduler over its own
    region (`StreamingScheduler.schedule(local_nodes(all), ...)`), so
    tiles stream within a host while the per-tile solve shards over that
    host's devices."""
    return region_nodes(nodes, *_process())
