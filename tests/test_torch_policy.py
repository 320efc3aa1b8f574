"""The policy engine on the port against the JAX package, on the CPU.

* The daemon on a 16-node cfg4 fleet in cfg8:hetero's two generations
  (``sim/pending.py`` ``hetero_class``: gen-b on the first half) with 64
  of cfg4's pending pods, under ``NHD_POLICY=1`` and cfg8's throughput
  matrix (``NHD_POLICY_TPUT``, one setting for both packages): every
  pod's node, solved config and NAD, the bound count, the ``node_class``
  column and the ``class_score`` rows equal (classes compared by name:
  each package interns its own indices, process-wide). Under
  ``NHD_POLICY=0`` both place as the pre-policy run (no class labels, the
  knob unset).
* Tiered preemption: bench.py's micro-cell (:667-692) and tier-2
  preemptors into a filled 16-node fleet (``pending.create_preemptors``,
  ``preempt_batch``): the same fenced evictions, batch by batch, and the
  same outcome for every pod, each batch within its eviction budget.
* The plain ``rank_top`` against ``_rank_body`` over ``_policy_pref`` at
  class scores 0-255, with a row past 1,024 keys (rank_select.cuh's wide
  regime, 64-bit words).

Tolerance: exact equality.
"""

from __future__ import annotations

import importlib
import json
import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhd_tpu.solver import kernel as jk
from nhd_tpu_torch.kernels import reference, sweep
from nhd_tpu_torch.sim import pending
from tests.test_torch_daemon import PACKAGES, _pkg

NODES, PODS = 16, 64
#: the fleet the preemptors meet: more GPU demand than its 128 GPUs
FULL_PODS = 200
CLASS_NAMES = ("default", "gen-a", "gen-b")


@pytest.fixture
def policy_on(monkeypatch):
    monkeypatch.setenv("NHD_POLICY", "1")
    monkeypatch.setenv("NHD_POLICY_TPUT", json.dumps(pending.HETERO_MATRIX))


def _daemon(pkg, n_pods, node_class=pending.hetero_class):
    backend = pkg.Backend()
    pending.fill_cfg4(backend, pkg.sim, NODES, n_pods, node_class=node_class)
    sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                          respect_busy=False)
    got = pending.drive(sched)
    return backend, sched, got


def _outcome(pkg, backend):
    return {key: (p.node, p.annotations.get(pkg.CFG),
                  p.annotations.get(pkg.NAD))
            for key, p in sorted(backend.pods.items())}


def _encoded(root, sched):
    """The daemon's node_class column and the class_score rows of
    workload_mix's three shapes, each class index read as its name."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    classes = mod("policy.classes").CLASSES
    enc = mod("solver.encode")
    cluster = enc.encode_cluster(sched.nodes, now=0.0)
    column = [classes.name_of(int(i))
              for i in cluster.node_class[:len(sched.nodes)]]
    reqs = mod("sim.workloads").workload_mix(9, list(pending.GROUPS))
    rows = {}
    for G, b in enc.encode_pods(reqs, cluster.interner).items():
        idx = {name: classes.index(name) for name in CLASS_NAMES}
        rows[G] = [{name: int(row[i]) for name, i in idx.items()}
                   for row in b.class_score[:b.n_types]]
    return column, rows


def test_policy_daemon_matches_the_jax_daemon(policy_on):
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        backend, sched, drive = _daemon(pkg, PODS)
        got[root] = (_outcome(pkg, backend), drive["bound"],
                     _encoded(root, sched))
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]
    outcome, bound, (column, rows) = got["nhd_tpu_torch"]
    assert bound == PODS
    assert column == [pending.hetero_class(i, NODES) for i in range(NODES)]
    # the matrix scores gen-a over gen-b for both kinds, so every row ranks
    # the fast generation first and pods leave the low-index gen-b half
    assert all(r["gen-a"] > r["gen-b"] for rs in rows.values() for r in rs)
    on_fast = sum(1 for node, _c, _n in outcome.values()
                  if node and pending.hetero_class(int(node[4:]), NODES) == "gen-a")
    assert on_fast > PODS // 2


def test_policy_off_places_as_the_pre_policy_daemon(monkeypatch):
    """``NHD_POLICY=0`` on the two-class fleet is inert: each package
    places as its own pre-policy run (no class labels, the knob unset),
    and the two packages alike; the class rows are all zero."""
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        monkeypatch.delenv("NHD_POLICY", raising=False)
        monkeypatch.delenv("NHD_POLICY_TPUT", raising=False)
        before, _, _ = _daemon(pkg, PODS, node_class=None)
        monkeypatch.setenv("NHD_POLICY", "0")
        monkeypatch.setenv("NHD_POLICY_TPUT", json.dumps(pending.HETERO_MATRIX))
        backend, sched, _ = _daemon(pkg, PODS)
        assert _outcome(pkg, backend) == _outcome(pkg, before)
        _column, rows = _encoded(root, sched)
        assert all(v == 0 for rs in rows.values() for r in rs for v in r.values())
        got[root] = _outcome(pkg, backend)
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]


def test_preempt_micro_cell_matches_the_jax_daemon(policy_on):
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        backend = pkg.Backend()
        n = pending.preempt_micro_cell(
            backend, pkg.sim, lambda b, pkg=pkg: pkg.Scheduler(
                b, pkg.WatchQueue(), queue.Queue(), respect_busy=False))
        got[root] = (n, list(backend.evict_log), _outcome(pkg, backend))
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]
    assert got["nhd_tpu_torch"][0] > 0


def test_preemptors_into_a_filled_fleet_match_the_jax_daemon(policy_on):
    """Tier-2 pods of the largest shape into a fleet filled past its GPUs:
    the same evictions batch by batch, victims and outcomes; each batch
    within its budget, the tenant's binding."""
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        backend, sched, _ = _daemon(pkg, FULL_PODS)
        pods = pending.create_preemptors(backend, pkg.sim, 4)
        per_batch = pending.preempt_batch(sched, pods)
        got[root] = (per_batch, list(backend.evict_log),
                     _outcome(pkg, backend))
    assert got["nhd_tpu_torch"] == got["nhd_tpu"]
    per_batch, evictions, _ = got["nhd_tpu_torch"]
    from nhd_tpu_torch.policy import preempt

    assert evictions
    assert all(sum(b.values()) <= preempt.round_budget()
               and max(b.values(), default=0) <= preempt.tenant_budget()
               for b in per_batch)
    assert max(sum(b.values()) for b in per_batch) == preempt.tenant_budget()


#: (seed, T, N, R): whole rows of 1,000 and 1,024 keys, and rows of
#: 2,048 keys in rank_select.cuh's wide regime
POLICY_RANK_CASES = [
    (0, 4, 1000, 512),
    (1, 8, 1024, 1024),
    (2, 3, 2048, 512),
    (3, 2, 2048, 2048),
]


@pytest.mark.parametrize("seed,T,N,R", POLICY_RANK_CASES)
def test_rank_top_plain_equals_rank_body_under_policy_scores(seed, T, N, R):
    """sel = (pref + 3·score)·(N + 1) + (N − n) at every candidate, scores
    drawn over 0-255 and node classes over all 16 (plus out-of-range
    ones, clipped as ``_policy_pref`` clips): the plain rank_top on that
    plane equals ``_rank_body`` over ``_policy_pref`` on every slot of
    the nine rows. Rows of 1,024 keys or fewer sort 32-bit words even at
    score 255; the 2,048-key rows take the wide regime's 64-bit words."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    cand = rng.random((T, N)) < 0.3
    pref = rng.integers(0, 3, (T, N)).astype(i32)
    node_class = rng.integers(0, 18, N).astype(i32)
    class_score = rng.integers(0, 256, (T, 16)).astype(i32)
    class_score[0, :] = 255
    best_c, best_m, best_a, n_combos, n_picks = rng.integers(0, 9, (5, T, N)).astype(i32)
    gpu_free = rng.integers(0, 5, (N, 2)).astype(i32)
    cpu_free = rng.integers(0, 65, (N, 2)).astype(i32)
    hp_free = rng.integers(0, 257, N).astype(i32)
    score = class_score[:, np.clip(node_class, 0, 15)]
    sel = np.where(cand, (pref + 3 * score) * (N + 1) + (N - np.arange(N))[None, :], 0)
    planes = np.stack([sel, cand, pref * cand, best_c, best_m, best_a,
                       n_combos, n_picks]).astype(i32)
    got = reference.rank_top(torch.from_numpy(planes), torch.from_numpy(gpu_free),
                             torch.from_numpy(cpu_free), torch.from_numpy(hp_free),
                             R=R).numpy()
    folded = jk._policy_pref(jnp.asarray(pref), jnp.asarray(node_class),
                             jnp.asarray(class_score))
    want = np.asarray(jk._rank_body(
        R, jnp.asarray(cand), folded, *(jnp.asarray(a) for a in (
            best_c, best_m, best_a, n_picks, gpu_free, cpu_free, hp_free))))
    assert got.shape == want.shape == (9, T, R)
    assert np.array_equal(got, want)
    words = {sweep.rank_words(N, int(row.max()) - int(row.min())) for row in sel}
    assert words == ({32} if N <= sweep.RANK_WHOLE_MAX else {64})
    # the widest span a whole row can reach under the policy still leaves
    # the position its bits: no score sends a whole row to 64-bit words
    n = sweep.RANK_WHOLE_MAX
    assert sweep.rank_words(n, (2 + 3 * 255) * (n + 1) + n) == 32
