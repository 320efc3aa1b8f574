"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips without CUDA (decided inside the test,
never at import). This file imports neither JAX nor the reference
package, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality — every output is a boolean verdict or an
integer choice.
"""

import random

import numpy as np
import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import reference, sweep

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _case(rng, T, N, U, K, C, A):
    """The attic parity case generator (attic/test_nic_pallas.py)."""
    UK, CA = U * K, C * A
    free_rx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    free_tx = rng.uniform(-1, 90, (N, UK)).astype(np.float32)
    dem_rx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    dem_tx = rng.uniform(0, 50, (T, CA, UK)).astype(np.float32)
    unchosen = rng.random((CA, UK)) < 0.5
    dem_rx[np.broadcast_to(unchosen, (T, CA, UK))] = 0.0
    dem_tx[np.broadcast_to(unchosen, (T, CA, UK))] = 0.0
    valid = rng.random((N, CA)) < 0.8
    pci_ok = rng.random((N, CA)) < 0.7
    map_pci = rng.random(T) < 0.5
    return (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci)


@pytest.mark.parametrize(
    "shape", [(2, 128, 2, 2, 4, 4), (3, 256, 2, 4, 4, 16), (4, 1000, 2, 7, 4, 49)]
)
def test_nic_any_first_kernel_matches_plain(shape):
    _need_cuda()
    T, N, U, K, C, A = shape
    args = [torch.from_numpy(a).cuda() for a in _case(np.random.default_rng(7), *shape)]
    dims = dict(U=U, K=K, C=C, A=A)
    before = kernels.LAUNCHES["nic_any_first"]
    got = kernels.nic_any_first(*args, **dims)
    want = reference.nic_any_first(*args, **dims)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nic_any_first"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cuda(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.parametrize("shape", sweep.NIC_SWEEP, ids=str)
def test_nic_any_first_sweep_matches_plain(shape):
    """The edge shapes of the kernel: picks per combo across 32-lane
    chunks, straddling combos, none/all fitting, T=1, ragged node tiles,
    U*K past 32, a warp with a second chunk, U*K=1000 and picks that
    choose every slot."""
    _need_cuda()
    args, kw = sweep.nic_case(sweep.NIC_SWEEP.index(shape), *shape)
    args = _cuda(args)
    got = kernels.nic_any_first(*args, **kw)
    want = reference.nic_any_first(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", sweep.PLANE_SWEEP, ids=str)
def test_solve_planes_sweep_matches_plain(shape):
    _need_cuda()
    args = _cuda(sweep.plane_case(sweep.PLANE_SWEEP.index(shape), *shape))
    before = kernels.LAUNCHES["solve_planes"]
    got = kernels.solve_planes(*args)
    want = reference.solve_planes(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["solve_planes"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("fill", ["tie", "none"])
def test_solve_planes_first_maximum_and_no_feasible_combo(fill):
    """Tied skew: the combo value still orders by c, and the first maximum
    wins; no feasible combo: cand 0, best_c 0, and best_m, best_a and
    n_picks read at combo 0 — all as the plain version has them."""
    _need_cuda()
    T, N, U, G, C, NCLS = 3, 301, 2, 2, 4, 4
    args = sweep.plane_case(11, T, N, U, G, C, NCLS, fill)
    got = kernels.solve_planes(*_cuda(args))
    want = reference.solve_planes(*[torch.from_numpy(np.ascontiguousarray(a))
                                    for a in args])
    assert torch.equal(got.cpu(), want)
    P = {name: i for i, name in enumerate(kernels.PLANES)}
    cand = want[P["cand"]] != 0
    assert torch.equal(want[P["best_c"]][~cand], torch.zeros_like(want[0][~cand]))
    if fill == "none":
        assert not cand.any()
        first_a = torch.from_numpy(args[22])
        assert torch.equal(want[P["best_a"]], first_a[..., 0])
    else:
        assert cand.any()


def _solve_instance(seed, n_nodes=40):
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    rng = random.Random(seed)
    nodes = {}
    for i in range(n_nodes):
        spec = SynthNodeSpec(
            name=f"node{i:03d}", phys_cores=rng.choice([8, 16, 24]),
            nics_per_numa=rng.choice([1, 2, 4]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            groups=rng.choice(["default", "edge", "default.edge"]),
        )
        node = make_node(spec)
        for core in node.cores:
            if rng.random() < 0.3:
                core.used = True
        nodes[node.name] = node
    cluster = encode_cluster(nodes, now=0.0)
    return cluster, encode_pods(workload_mix(60, ["default", "edge"]), cluster.interner)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_kernels_match_plain(seed):
    """All three kernels through the solve, CUDA against CPU plain."""
    _need_cuda()
    from nhd_tpu_torch.solver.kernel import solve_bucket, solve_bucket_ranked

    cluster, buckets = _solve_instance(seed)
    for G, pods in buckets.items():
        got = solve_bucket(cluster, pods, device="cuda")
        want = solve_bucket(cluster, pods, device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        gr = solve_bucket_ranked(cluster, pods, 16, device="cuda").cpu()
        wr = solve_bucket_ranked(cluster, pods, 16, device="cpu")
        live = wr[0] > 0
        assert torch.equal(gr[0] > 0, live)
        for row in range(9):
            assert torch.equal(gr[row][live], wr[row][live])


def test_schedule_cuda_equals_cpu():
    """One pipelined CUDA schedule places like the CPU plain path."""
    _need_cuda()
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    reqs = workload_mix(300, ["default", "edge"])
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    out = []
    for dev in ("cuda", "cpu"):
        res, stats = BatchScheduler(
            device=dev, respect_busy=False, register_pods=False
        ).schedule(cap_cluster(30, ["default", "edge"]), items, now=0.0)
        out.append([(r.node, None if r.mapping is None else dict(r.mapping))
                    for r in res])
    assert out[0] == out[1]
    assert sum(1 for n, _ in out[0] if n) > 0
