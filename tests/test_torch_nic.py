"""The NIC stage: the port's plain ``nic_any_first`` against the Pallas
kernel it replaces (attic/nic_pallas.py, run in interpret mode on the
CPU), and the plain ``nic_node_masks`` against the reference's own
expressions (nhd_tpu/solver/kernel.py:136-160, restated in jnp).

Tolerance: exact equality (boolean verdicts and integer picks/counts);
``first_a`` is compared where ``nic_any``, as the attic test does.

The CUDA kernels themselves build and run only on a GPU:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhd_tpu.solver.combos import get_tables
from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.solver.kernel import bucket_tables

_ATTIC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "attic", "nic_pallas.py",
)


def _pallas():
    spec = importlib.util.spec_from_file_location("nic_pallas", _ATTIC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_case(rng, T, N, U, K, C, A):
    """attic/test_nic_pallas.py make_case, verbatim."""
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
    map_pci = (rng.random(T) < 0.5).astype(np.int32)
    return (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci)


# (T, N, U, K, C, A): the attic parity shapes plus a cfg4-like G=2 bucket
SHAPES = [(2, 128, 2, 2, 4, 4), (3, 256, 2, 4, 4, 16), (4, 128, 2, 7, 4, 49)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_nic_any_first_matches_pallas_interpret(shape):
    T, N, U, K, C, A = shape
    args = make_case(np.random.default_rng(7), T, N, U, K, C, A)
    dims = dict(U=U, K=K, C=C, A=A)
    any_p, first_p, count_p = _pallas().nic_any_first(
        *args, **dims, interpret=True
    )
    any_t, first_t, count_t = reference.nic_any_first(
        *(torch.from_numpy(a) for a in args), **dims
    )
    mask = np.asarray(any_p)
    assert mask.any() and not mask.all()
    assert np.array_equal(any_t.numpy(), mask)
    assert np.array_equal(count_t.numpy(), np.asarray(count_p))
    assert np.array_equal(first_t.numpy()[mask], np.asarray(first_p)[mask])
    # the wrapper takes the plain version for CPU tensors
    any_w, first_w, count_w = kernels.nic_any_first(
        *(torch.from_numpy(a) for a in args), **dims
    )
    assert torch.equal(any_w, any_t) and torch.equal(first_w, first_t)
    assert torch.equal(count_w, count_t)


def _jax_node_masks(nic_count, nic_sw, gpu_free_sw, G, U, K):
    """nhd_tpu/solver/kernel.py:113-160 as written there (jnp)."""
    tables = get_tables(G, U, K)
    need_max = jnp.asarray(tables.need_max)
    combo_idx = jnp.asarray(tables.combo, jnp.int32)
    pick_idx = jnp.asarray(tables.pick, jnp.int32)
    u_idx = combo_idx[:, None, :]
    k_idx = pick_idx[None, :, :]
    pick_valid = jnp.all(
        need_max[None, :, :, :] <= nic_count[:, None, None, :], axis=-1
    )
    sw_at = nic_sw[:, u_idx, k_idx]
    share_sw = jnp.sum(
        (sw_at[..., :, None] == sw_at[..., None, :]).astype(jnp.float32),
        axis=-1,
    )
    free_sw_at = jnp.take_along_axis(
        gpu_free_sw, sw_at.reshape(sw_at.shape[0], -1), axis=1
    ).reshape(sw_at.shape)
    sw_nonneg = jnp.all(gpu_free_sw >= 0, axis=-1)
    pci_ok = (
        jnp.all(share_sw <= free_sw_at, axis=-1) & sw_nonneg[:, None, None]
    )
    N = nic_count.shape[0]
    return (np.asarray(pick_valid).reshape(N, -1),
            np.asarray(pci_ok).reshape(N, -1))


@pytest.mark.parametrize("G,U,K", [(1, 2, 7), (2, 2, 7), (3, 2, 2), (2, 4, 4)])
def test_plain_nic_node_masks_match_reference_expressions(G, U, K):
    rng = np.random.default_rng(100 + G * 10 + U + K)
    N, S = 64, 2 * U
    nic_count = rng.integers(0, K + 1, (N, U)).astype(np.int32)
    # absent NICs (ordinal >= count) carry switch -1, as the encode writes
    nic_sw = rng.integers(0, S, (N, U, K)).astype(np.int32)
    nic_sw[np.arange(K)[None, None, :] >= nic_count[:, :, None]] = -1
    gpu_free_sw = rng.integers(-1, 3, (N, S)).astype(np.int32)
    keep_neg = rng.random(N) < 0.2  # a few nodes over-committed on a switch
    gpu_free_sw[~keep_neg] = np.maximum(gpu_free_sw[~keep_neg], 0)
    want_v, want_p = _jax_node_masks(
        jnp.asarray(nic_count), jnp.asarray(nic_sw), jnp.asarray(gpu_free_sw),
        G, U, K,
    )
    tb = bucket_tables(G, U, K, torch.device("cpu"))
    got_v, got_p = kernels.nic_node_masks(
        torch.from_numpy(nic_count), torch.from_numpy(nic_sw),
        torch.from_numpy(gpu_free_sw), tb.combo, tb.pick, tb.need_max,
    )
    assert want_v.any() and want_p.any() and not want_p.all()
    assert np.array_equal(got_v.numpy(), want_v)
    assert np.array_equal(got_p.numpy(), want_p)
