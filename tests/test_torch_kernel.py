"""Solve parity: the port's solve (nhd_tpu_torch.solver.kernel, plain
PyTorch versions of its kernels on the CPU) against the JAX reference
(nhd_tpu.solver.kernel) on the same packed numpy state.

Every output is an integer decision, so the tolerance is exact equality.
The plain solve surface is compared on ``cand`` everywhere and on the
choice planes where ``cand``; the fused solve+rank on the val > 0 slots
of all nine rows (ties at val 0 may order differently under topk).
"""

import random
import types

import numpy as np
import pytest
import torch

import nhd_tpu.core.request as jx_request
import nhd_tpu.core.topology as jx_topology
import nhd_tpu.sim as jx_sim
import nhd_tpu_torch.core.request as pt_request
import nhd_tpu_torch.core.topology as pt_topology
import nhd_tpu_torch.sim as pt_sim
from nhd_tpu.policy.scoring import set_matrix as jx_set_matrix
from nhd_tpu.solver import kernel as jk
from nhd_tpu.solver.encode import encode_cluster as jx_encode_cluster
from nhd_tpu.solver.encode import encode_pods as jx_encode_pods
from nhd_tpu_torch.policy.scoring import set_matrix as pt_set_matrix
from nhd_tpu_torch.solver import kernel as pk
from nhd_tpu_torch.solver.device_state import DeviceClusterState, from_numpy
from nhd_tpu_torch.solver.encode import encode_cluster as pt_encode_cluster

JAX_PKG = types.SimpleNamespace(
    sim=jx_sim, request=jx_request, topology=jx_topology,
)
PORT_PKG = types.SimpleNamespace(
    sim=pt_sim, request=pt_request, topology=pt_topology,
)


def random_cluster(pkg, rng: random.Random, n_nodes: int, *, sockets=2,
                   nics=None, classes=False):
    """The tests/test_jax_matcher.py generator, parameterized by package,
    NUMA count and NICs per NUMA node (bandwidths on a 0.5 Gbps grid)."""
    nodes = {}
    for i in range(n_nodes):
        spec = pkg.sim.SynthNodeSpec(
            name=f"node{i:03d}",
            sockets=sockets,
            phys_cores=sockets * rng.choice([4, 6, 8]),
            smt=rng.random() < 0.7,
            reserved_cores=rng.choice([0, 2]),
            nics_per_numa=nics if nics is not None else rng.choice([1, 2, 3]),
            nic_speed_mbps=rng.choice([25000, 100000]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            hugepages_gb=rng.choice([16, 64]),
            groups=rng.choice(["default", "default.edge", "edge"]),
            node_class=("gen-a", "gen-b", "gen-c")[i % 3] if classes else "",
        )
        node = pkg.sim.make_node(spec)
        for core in node.cores:
            if rng.random() < 0.2:
                core.used = True
        for gpu in node.gpus:
            if rng.random() < 0.3:
                gpu.used = True
        for nic in node.nics:
            if rng.random() < 0.2:
                nic.pods_used = 1
        node.mem.free_hugepages_gb -= rng.choice([0, 0, 8])
        if rng.random() < 0.1:
            node.maintenance = True
        if rng.random() < 0.1:
            node.active = False
        if rng.random() < 0.2:
            node.set_busy(now=1000.0)
        nodes[node.name] = node
    return nodes


def random_request(pkg, rng: random.Random, *, n_groups=None, map_mode=None):
    """The tests/test_jax_matcher.py request generator, per package."""
    R, T = pkg.request, pkg.topology
    G = n_groups if n_groups is not None else rng.choice([1, 1, 2, 3])

    def group():
        rx = rng.choice([0.0, 5.0, 20.0, 80.0])
        tx = rng.choice([0.0, 5.0, 20.0])
        proc_min = 2 if (rx or tx) else 1
        return R.GroupRequest(
            proc=R.CpuRequest(rng.randint(proc_min, 6), rng.choice(list(T.SmtMode))),
            misc=R.CpuRequest(rng.randint(0, 2), rng.choice(list(T.SmtMode))),
            gpus=rng.choice([0, 0, 1, 2]),
            nic_rx_gbps=rx,
            nic_tx_gbps=tx,
        )

    groups = tuple(group() for _ in range(G))
    mode = rng.choice([T.MapMode.NUMA, T.MapMode.NUMA, T.MapMode.PCI])
    if map_mode is not None:
        mode = T.MapMode[map_mode]
    return R.PodRequest(
        groups=groups,
        misc=R.CpuRequest(rng.randint(0, 3), rng.choice(list(T.SmtMode))),
        hugepages_gb=rng.choice([0, 4, 16]),
        map_mode=mode,
        node_groups=frozenset(rng.choice([["default"], ["edge"], ["default", "edge"]])),
    )


def jax_instance(seed, *, sockets=2, nics=None, n_nodes=None, n_reqs=6,
                 map_mode=None, classes=False):
    """(cluster arrays, {G: pod arrays}) from the JAX package's own
    generators and encode — the state both solves read."""
    rng = random.Random(seed)
    nodes = random_cluster(
        JAX_PKG, rng, n_nodes or rng.randint(8, 40), sockets=sockets,
        nics=nics, classes=classes,
    )
    reqs = [random_request(JAX_PKG, rng, map_mode=map_mode)
            for _ in range(n_reqs)]
    cluster = jx_encode_cluster(nodes, now=1010.0)
    return cluster, jx_encode_pods(reqs, cluster.interner)


CASES = [
    # (seed, U sockets, K NICs per NUMA or None for mixed, map mode)
    (0, 1, 1, None), (1, 1, 4, None), (2, 2, 2, None), (3, 2, 7, None),
    (4, 2, None, "PCI"), (5, 4, 2, None), (6, 4, 1, "PCI"), (7, 2, 4, None),
    (8, 2, None, None), (9, 1, 7, "PCI"),
]


def _check_solve(cluster, buckets):
    for G, pods in buckets.items():
        want = jk.solve_bucket(cluster, pods)
        got = pk.solve_bucket(cluster, pods, device="cpu")
        cand = np.asarray(want.cand)
        assert np.array_equal(got.cand.numpy(), cand), f"G={G}: cand"
        for name in ("pref", "n_combos"):
            assert np.array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name))
            ), f"G={G}: {name}"
        for name in ("best_c", "best_m", "best_a", "n_picks"):
            assert np.array_equal(
                getattr(got, name).numpy()[cand],
                np.asarray(getattr(want, name))[cand],
            ), f"G={G}: {name} where cand"


def _check_ranked(cluster, buckets, R=16):
    for G, pods in buckets.items():
        T = pods.n_types
        want = np.asarray(jk.solve_bucket_ranked(cluster, pods, R))[:, :T]
        got = pk.solve_bucket_ranked(cluster, pods, R, device="cpu").numpy()[:, :T]
        assert got.shape == want.shape
        live = want[0] > 0
        assert np.array_equal(got[0] > 0, live), f"G={G}: val>0 slots"
        for row in range(9):
            assert np.array_equal(got[row][live], want[row][live]), (
                f"G={G}: rank row {row}"
            )


@pytest.mark.parametrize("seed,U,K,mode", CASES)
def test_solve_bucket_parity(seed, U, K, mode):
    cluster, buckets = jax_instance(seed, sockets=U, nics=K, map_mode=mode)
    assert buckets
    _check_solve(cluster, buckets)


@pytest.mark.parametrize("seed,U,K,mode", CASES[::2])
def test_solve_bucket_ranked_parity(seed, U, K, mode):
    cluster, buckets = jax_instance(seed, sockets=U, nics=K, map_mode=mode)
    _check_ranked(cluster, buckets)


def test_ranked_parity_with_policy_scores(monkeypatch):
    """A non-zero class_score: the score term reorders the ranking on both
    sides alike (both packages' scoring matrices set the same)."""
    monkeypatch.setenv("NHD_POLICY", "1")
    matrix = {"gpu": {"gen-a": 0.3, "gen-b": 1.0, "gen-c": 0.6},
              "cpu": {"gen-a": 1.0, "gen-b": 0.5}}
    jx_set_matrix(matrix)
    pt_set_matrix(matrix)
    try:
        cluster, buckets = jax_instance(11, n_nodes=24, classes=True)
        assert any(p.class_score.any() for p in buckets.values())
        _check_ranked(cluster, buckets)
    finally:
        jx_set_matrix(None)
        pt_set_matrix(None)


def test_arg_order_tuples_match_reference():
    assert pk._ARG_ORDER == jk._ARG_ORDER
    assert pk._POD_ARG_ORDER == jk._POD_ARG_ORDER
    assert pk._MUTABLE == jk._MUTABLE
    assert pk._STATIC == jk._STATIC


@pytest.mark.parametrize("R,n_nodes", [(16, 24), (1024, 40)])
def test_rank_rules_match_reference(R, n_nodes):
    for acc in (False, True):
        for need in (1, 7, 300, 5000):
            assert pk.rank_budget(need, n_nodes, accelerator=acc) == (
                jk.rank_budget(need, n_nodes, accelerator=acc)
            )
    assert pk.pad_nodes(n_nodes) == jk.pad_nodes(n_nodes)
    assert pk.ranked_shape_key(2, 2, 7, R, 8, 1024) == jk.ranked_shape_key(
        2, 2, 7, R, 8, 1024
    )


def test_from_numpy_copies_reference_state():
    """from_numpy reads the reference's arrays by field name and never
    aliases them."""
    cluster, buckets = jax_instance(3, sockets=2, nics=2)
    pods = next(iter(buckets.values()))
    node, pod = from_numpy(cluster, pods, "cpu")
    for name, t in zip(pk._ARG_ORDER, node):
        a = getattr(cluster, name)
        assert t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a)
        assert t.data_ptr() != a.ctypes.data
    for name, t in zip(pk._POD_ARG_ORDER, pod):
        assert np.array_equal(t.numpy(), getattr(pods, name))


def test_port_encode_equals_reference_encode():
    """The copied host modules project the same cluster identically."""
    for seed in (1, 2):
        jn = random_cluster(JAX_PKG, random.Random(seed), 12)
        pn = random_cluster(PORT_PKG, random.Random(seed), 12)
        a, b = jx_encode_cluster(jn, now=1010.0), pt_encode_cluster(pn, now=1010.0)
        assert (a.U, a.K, a.S, a.names) == (b.U, b.K, b.S, b.names)
        for name in pk._ARG_ORDER:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_resident_rows_stay_exact_under_churn():
    """Row updates into the resident tensors track the host arrays
    exactly (the reference's delta pattern), and never write through to
    the host mirror."""
    rng = np.random.default_rng(5)
    nodes = random_cluster(PORT_PKG, random.Random(5), 20)
    cluster = pt_encode_cluster(nodes, now=1010.0)
    dev = DeviceClusterState(cluster, "cpu")
    for _ in range(6):
        rows = rng.choice(cluster.n_nodes, size=rng.integers(1, 6), replace=False)
        for r in rows.tolist():
            cluster.cpu_free[r] = rng.integers(0, 8, cluster.U)
            cluster.busy[r] = not cluster.busy[r]
            cluster.nic_free[r] = rng.integers(-1, 40, cluster.nic_free[r].shape)
        before = cluster.cpu_free.copy()
        dev.stage_rows(rows.tolist())
        dev._flush_staged()
        dev._dev["cpu_free"].add_(0)  # an in-place op must not reach the host
        assert np.array_equal(cluster.cpu_free, before)
        for name in pk._ARG_ORDER:
            t = dev._dev[name].numpy()
            assert np.array_equal(t[: cluster.n_nodes], getattr(cluster, name)), name
            assert not t[cluster.n_nodes:].any() or name in ("nic_free", "nic_sw")


def test_resident_solve_equals_host_solve():
    """The resident path pads like the host path for a fresh cluster, so
    their rankings are identical; rebuild_resident re-derives every
    tensor from the host arrays."""
    cluster, buckets = jax_instance(2, sockets=2, nics=2)
    dev = DeviceClusterState(cluster, "cpu")
    for G, pods in buckets.items():
        a = dev.solve_ranked(pods, 16)
        b = pk.solve_bucket_ranked(cluster, pods, 16, device="cpu")
        assert torch.equal(a, b)
    dev._dev["cpu_free"].zero_()
    dev.rebuild_resident()
    for name, t in zip(pk._ARG_ORDER, dev.tensors()):
        assert np.array_equal(t.numpy()[: cluster.n_nodes], getattr(cluster, name))
