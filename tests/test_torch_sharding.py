"""The port's node mesh (nhd_tpu_torch/parallel/) against the JAX
package's (nhd_tpu/parallel/).

The reference shards over the 8 virtual CPU devices of tests/conftest.py;
the port over 8 shards on the CPU device (``make_mesh(["cpu"] * 8)``),
where every kernel is its plain PyTorch version. The cases of
tests/test_sharding.py and tests/test_multihost.py, each on both sides:

* the sharded ranked solve equals the single-device one on every
  val > 0 slot (ties at val 0 may order differently under topk), on
  both sides, and the two packages agree there;
* BatchScheduler over the mesh places every pod as the single-device
  port and as the JAX package's mesh run (node, mapping, scheduled
  count, free resources);
* the NHD_MESH knob: the port counts distinct local GPUs;
* the per-process node regions of multihost.py.

Plus the one kernel ABI change of the mesh: ``solve_planes`` with a
``node_base`` and ``n_global``. Integer decisions throughout, so every
tolerance is exact equality.
"""

from __future__ import annotations

import copy
import random
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from nhd_tpu.parallel import multihost as jx_multihost
from nhd_tpu.parallel.sharding import make_mesh as jx_make_mesh
from nhd_tpu.parallel.sharding import resolve_mesh_spec as jx_resolve
from nhd_tpu.parallel.sharding import (
    solve_bucket_ranked_sharded as jx_sharded,
)
from nhd_tpu.solver import kernel as jk
from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.parallel import multihost as pt_multihost
from nhd_tpu_torch.parallel import sharding as pt_sharding
from nhd_tpu_torch.parallel.sharding import make_mesh, solve_bucket_ranked_sharded
from nhd_tpu_torch.solver import kernel as pk
from tests.test_torch_kernel import (
    JAX_PKG,
    PORT_PKG,
    jax_instance,
    random_cluster,
    random_request,
)


def cpu_mesh(n=8):
    """The port's counterpart of the conftest's 8 virtual CPU devices."""
    return make_mesh(["cpu"] * n)


def jax_mesh(n=8):
    return jx_make_mesh(jax.devices()[:n])


def assert_live_equal(got, want, msg=""):
    """Two packed [9, Tp, R] rank tensors agree on every val > 0 slot of
    *want*, and have the same val > 0 slots."""
    got, want = np.asarray(got), np.asarray(want)
    R = min(got.shape[2], want.shape[2])
    got, want = got[:, :, :R], want[:, :, :R]
    live = want[0] > 0
    assert np.array_equal(got[0] > 0, live), f"{msg}: val>0 slots"
    for row in range(9):
        assert np.array_equal(got[row][live], want[row][live]), f"{msg}: row {row}"


def test_mesh_has_8_shards():
    mesh = cpu_mesh()
    assert mesh.size == 8 and mesh.axis_names == ("nodes",)
    assert mesh.distinct_devices() == 1 and mesh.first_shard == 0
    assert pk.mesh_desc(mesh) == jk.mesh_desc(jax_mesh()) == "nodes8"
    rr = make_mesh(n_shards=5, device="cpu")
    assert rr.devices == (torch.device("cpu"),) * 5
    with pytest.raises(ValueError):
        make_mesh(["cpu", "cpu"], n_shards=3)


@pytest.mark.parametrize("n_nodes,n_dev", [(1, 1), (13, 8), (21, 8), (100, 3),
                                           (1000, 8), (1000, 4)])
def test_pad_nodes_matches_reference(n_nodes, n_dev):
    assert pk.pad_nodes(n_nodes, n_dev) == jk.pad_nodes(n_nodes, n_dev)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_ranked_matches_single_device(seed):
    rng = random.Random(seed)
    nodes = random_cluster(JAX_PKG, rng, rng.randint(3, 12))
    reqs = [random_request(JAX_PKG, rng) for _ in range(8)]
    from nhd_tpu.solver.encode import encode_cluster, encode_pods

    cluster = encode_cluster(nodes, now=1010.0)
    for G, pods in encode_pods(reqs, cluster.interner).items():
        one = pk.solve_bucket_ranked(cluster, pods, 16, device="cpu").numpy()
        got = solve_bucket_ranked_sharded(cluster, pods, 16, cpu_mesh())
        want = jx_sharded(cluster, pods, 16, jax_mesh())
        assert_live_equal(got, one, f"G={G} port mesh vs one device")
        assert_live_equal(got, want, f"G={G} port mesh vs JAX mesh")


@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_sharded_solve_with_node_count_not_divisible(n_dev):
    """N = 13 pads to a multiple of the shard count; padded rows are
    inactive and never ranked."""
    cluster, buckets = jax_instance(99, n_nodes=13, n_reqs=3)
    for G, pods in buckets.items():
        got = solve_bucket_ranked_sharded(cluster, pods, 8, cpu_mesh(n_dev))
        want = jx_sharded(cluster, pods, 8, jax_mesh(n_dev))
        assert got.shape == np.asarray(want).shape
        assert_live_equal(got, want, f"G={G} D={n_dev}")
        assert (got[1][got[0] > 0] < 13).all()


def test_solve_planes_node_base_defaults_and_shard_columns():
    """The plain solve_planes: node_base=0, n_global=N is the default
    output bit for bit, and each shard's planes (its node rows, its
    node_base) are the unsharded planes' columns, sel included."""
    from nhd_tpu_torch.kernels.sweep import plane_case

    torch.manual_seed(0)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in plane_case(3, 4, 64, 2, 2, 4, 2, 0.6)]
    full = reference.solve_planes(*args)
    assert torch.equal(full, reference.solve_planes(*args, node_base=0, n_global=64))
    node_pos = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]       # [N, ...] node rows
    nic_pos = [21, 22, 23]                              # [T, N, C] planes
    for S in (2, 4, 8):
        Ns = 64 // S
        for s in range(S):
            lo, hi = s * Ns, (s + 1) * Ns
            part = list(args)
            for i in node_pos:
                part[i] = args[i][lo:hi]
            for i in nic_pos:
                part[i] = args[i][:, lo:hi]
            got = reference.solve_planes(*part, node_base=lo, n_global=64)
            assert torch.equal(got, full[:, :, lo:hi]), (S, s)


def test_resolve_mesh_spec(monkeypatch):
    """The NHD_MESH / --mesh operator knob, as the reference resolves it
    over its 8 devices: auto passes through, off forces one device, N
    takes the first N, and more than exist is refused with the
    reference's error. The port counts distinct local GPUs."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for r in (jx_resolve, pt_sharding.resolve_mesh_spec):
        assert r("auto") == "auto" and r(None) == "auto"
        assert r("off") is None and r("0") is None and r("none") is None
        assert r("1") is None  # one device = no mesh
        with pytest.raises(ValueError, match="asks for 9999 devices but only 8"):
            r("9999")
        with pytest.raises(ValueError, match="mesh spec must be"):
            r("bogus")
    mesh = pt_sharding.resolve_mesh_spec("4")
    assert mesh.size == 4 and mesh.axis_names == ("nodes",)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.distinct_devices() == 4      # never stacked on one GPU
    assert pt_sharding.resolve_mesh_spec(mesh) is mesh
    assert jx_resolve("4").devices.size == mesh.size


def test_resolve_mesh_spec_without_a_gpu():
    """On a host with no GPU every count above one is refused, and auto
    resolves to no mesh in the scheduler."""
    from nhd_tpu_torch.solver.batch import BatchScheduler

    if torch.cuda.device_count():
        pytest.skip("counts the GPUs of a host without one")
    with pytest.raises(ValueError, match="asks for 2 devices but only 0"):
        pt_sharding.resolve_mesh_spec("2")
    assert BatchScheduler(device="cpu")._resolve_mesh() is None


def _cluster_free_state(nodes):
    return sorted(
        (
            name,
            tuple(n.free_cpu_cores_per_numa()),
            n.free_gpu_count(),
            n.mem.free_hugepages_gb,
            tuple(nic.free_bw() for nic in n.nics),
        )
        for name, n in nodes.items()
    )


def _schedule(pkg, seed, mesh, *, respect_busy=False):
    rng = random.Random(400 + seed)
    nodes = random_cluster(pkg, rng, 11)
    reqs = [random_request(pkg, rng) for _ in range(24)]
    if pkg is PORT_PKG:
        from nhd_tpu_torch.solver.batch import BatchItem, BatchScheduler

        sched = BatchScheduler(device="cpu", respect_busy=respect_busy, mesh=mesh)
    else:
        from nhd_tpu.solver.batch import BatchItem, BatchScheduler

        sched = BatchScheduler(respect_busy=respect_busy, mesh=mesh)
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    results, stats = sched.schedule(nodes, items, now=1010.0)
    return (
        [r.node for r in results],
        [None if r.mapping is None else dict(r.mapping) for r in results],
        stats.scheduled,
        _cluster_free_state(nodes),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_scheduler_mesh_equals_single_device(seed, monkeypatch):
    """The production path: BatchScheduler over the 8-shard mesh places a
    mixed contended batch (multi-bucket, NUMA+PCI, GPU and CPU-only
    pods) as the port's single device and as the JAX package's mesh."""
    monkeypatch.setenv("NHD_TPU_SPECULATE", "0")
    monkeypatch.setenv("NHD_PIPELINE", "0")
    mesh = _schedule(PORT_PKG, seed, cpu_mesh())
    assert mesh == _schedule(PORT_PKG, seed, None)
    assert mesh == _schedule(JAX_PKG, seed, jax_mesh())
    assert mesh[2] > 0


def test_batch_scheduler_refuses_a_mesh_of_another_device_type():
    from nhd_tpu_torch.solver.batch import BatchScheduler

    with pytest.raises(ValueError, match="a 'nodes' axis"):
        BatchScheduler(device="cpu", mesh=object())
    fake = mock.Mock(axis_names=("nodes",), device_type="cuda")
    with pytest.raises(ValueError, match="shards on cuda"):
        BatchScheduler(device="cpu", mesh=fake)


# ---------------------------------------------------------------------------
# multihost: per-process node regions (tests/test_multihost.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_proc,n_nodes", [(1, 5), (2, 10), (3, 10), (4, 3)])
def test_local_node_slices_partition(n_proc, n_nodes):
    nodes = PORT_PKG.sim.make_cluster(n_nodes)
    jx_nodes = JAX_PKG.sim.make_cluster(n_nodes)
    shards = []
    for rank in range(n_proc):
        with mock.patch.object(pt_multihost, "_process",
                               return_value=(rank, n_proc)):
            shards.append(pt_multihost.local_nodes(nodes))
        with mock.patch("jax.process_count", return_value=n_proc), \
             mock.patch("jax.process_index", return_value=rank):
            assert list(jx_multihost.local_nodes(jx_nodes)) == list(shards[-1])
        assert pt_multihost.node_slice(n_nodes, rank, n_proc) == (
            jx_multihost.node_slice(n_nodes, rank, n_proc))
    seen = [name for s in shards for name in s]
    assert seen == list(nodes.keys())          # exact cover, stable order
    assert len(seen) == len(set(seen))         # no node owned twice
    names = list(nodes.keys())
    at = 0
    for s in shards:
        assert list(s.keys()) == names[at:at + len(s)]
        at += len(s)


def test_local_nodes_feed_streaming():
    """The documented multi-process pattern composes: a rank's region
    goes straight into StreamingScheduler."""
    from nhd_tpu_torch.solver import BatchItem, StreamingScheduler
    from tests.test_torch_streaming import simple_request

    nodes = PORT_PKG.sim.make_cluster(6)
    with mock.patch.object(pt_multihost, "_process", return_value=(1, 2)):
        mine = pt_multihost.local_nodes(nodes)
        assert pt_multihost.local_node_slice(6) == slice(3, 6)
    assert len(mine) == 3
    items = [BatchItem(("ns", f"p{i}"), simple_request(PORT_PKG)) for i in range(4)]
    results, stats = StreamingScheduler(
        tile_nodes=2, respect_busy=False, device="cpu",
    ).schedule(mine, items, now=0.0)
    assert stats.scheduled == 4
    assert all(r.node in mine for r in results)


def test_initialize_is_idempotent(tmp_path):
    """One process, one rank, gloo over a FileStore: initialize sets the
    group up once; a second call is a no-op; local_nodes then reads the
    group's rank and size."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    store = f"file://{tmp_path / 'store'}"
    pt_multihost.initialize(store, num_processes=1, process_id=0, backend="gloo")
    try:
        pt_multihost.initialize(store, num_processes=1, process_id=0,
                                backend="gloo")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        nodes = PORT_PKG.sim.make_cluster(4)
        assert list(pt_multihost.local_nodes(nodes)) == sorted(nodes)
    finally:
        dist.destroy_process_group()
    assert pt_multihost._init_method("h:1") == "tcp://h:1"
    assert pt_multihost._init_method(None) == "env://"
