"""Gang/batch scheduling: greedy rounds over the batched solve.

The counterpart of the reference's nhd_tpu/solver/batch.py. A 10k-pod
batch can't afford 10k serial solves, so each greedy round:

  1. runs one solve + rank per group-count bucket on the device (the
     port's kernels, solver/kernel.py) and pulls the packed [9, T, R]
     ranking;
  2. lets every pending pod take its type's best candidate node, packing
     each node up to an optimistic capacity estimate before spilling to
     the next (``_select_winners``, numpy, as in the reference);
  3. applies the claims in pod-index order through the native C++ core
     (native/nhd_assign.cc), re-verified against live state;
  4. stages the claimed rows; they reach the device tensors as an
     in-place row update before the next solve.

The node tensors stay resident on the device for the whole batch
(solver/device_state.py). With round pipelining on (``NHD_PIPELINE``;
auto means on for CUDA), round r+1's solves are launched right after
round r's native assign, so round r's result materialization runs on
the host while the card computes.

With speculation on (``NHD_TPU_SPECULATE``; auto means on for CUDA, off
while a non-uniform policy scoring matrix is live), round 0 is the
speculative megaround (solver/speculate.py): the device runs the whole
greedy claim loop and the host re-verifies its claims through the same
native apply; whatever the native core rejects retries in classic
rounds. A saturation certificate can end the batch after round 0.

With a node mesh (``mesh=``, parallel/sharding.py; "auto" shards over
every local GPU when there are several) the resident tensors shard along
the node axis and every solve, rank and megaround runs per shard
(solver/device_state.py), with placements identical to one device.

Every round's dispatch runs under the solver fault guard
(solver/guard.py), as in the reference: a batch-start audit of the
resident rows, a screen of every pulled rank tensor, and a bounded
re-dispatch of the round from host truth after a transient fault. The
ladder: the mesh-sharded resident tensors, then the resident tensors on
one device (a condemned mesh), then a non-resident solve on the SAME
device (``solve_bucket_ranked`` uploads the host arrays every round and
still launches the kernels), with no megaround. Nothing in the guard
moves work to the CPU.

Not in this slice, its gate closed: the reference's small-round CPU
routing — on the card that routing would be a hidden CPU fallback.
"""

from __future__ import annotations

import threading as _threading
import time
from collections import namedtuple
from dataclasses import dataclass, field, replace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from nhd_tpu_torch import kernels
from nhd_tpu_torch.core.node import AssignmentError, HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode, NicDir, PodTopology
from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.obs.recorder import (
    FlightRecorder,
    current_corr_id,
    get_recorder,
    new_corr_id,
)
from nhd_tpu_torch.policy.scoring import scoring_active
from nhd_tpu_torch.solver.device_state import DeviceClusterState, HostPull
from nhd_tpu_torch.solver.encode import (
    ClusterDelta,
    encode_cluster,
    encode_pods,
    refresh_node_row,
)
from nhd_tpu_torch.solver.fast_assign import (
    FastAssignError,
    FastCluster,
    apply_record_to_topology,
)
from nhd_tpu_torch.solver.guard import (
    GUARD,
    RUNG_HOST,
    RUNG_MESH,
    RUNG_SINGLE,
    DeviceCorruptionError,
    classify_device_fault,
)
from nhd_tpu_torch.solver.kernel import (
    _pad_pow2,
    bucket_tractable,
    mesh_desc,
    rank_budget,
    ranked_shape_key,
    solve_bucket_ranked,
)
from nhd_tpu_torch.solver.matcher import decode_mapping
from nhd_tpu_torch.solver.oracle import find_node as oracle_find_node
from nhd_tpu_torch.solver.speculate import (
    _T_SHIFT,
    decode_claims_grouped,
    spec_iters,
    speculate_enabled,
)
from nhd_tpu_torch.solver.topology_plan import (
    TopologyPlan,
    fill_given,
    plan_for,
)
from nhd_tpu_torch.utils import get_logger


@dataclass
class BatchItem:
    """One pod to place: its numeric request plus (optionally) the full
    topology object to fill with physical IDs."""

    key: Tuple[str, str]                 # (namespace, podname)
    request: PodRequest
    topology: Optional[PodTopology] = None


class BatchAssignment(NamedTuple):
    """One pod's placement verdict."""

    key: Tuple[str, str]
    node: Optional[str]                  # None → unschedulable
    mapping: Optional[Dict[str, tuple]] = None
    nic_list: Optional[list] = None      # (nic_index, speed, dir) consumed
    round_no: int = -1
    failed: bool = False                 # terminal assignment failure (vs
    #                                      merely no candidate node)


# host-side view of the device ranking (kernel.RankOut): all [T, R]
RankHost = namedtuple(
    "RankHost", "val idx best_c best_m best_a n_picks free_gpu free_cpu free_hp"
)

# one speculative dispatch (see _speculate_dispatch): its four result
# tensors on their way to the host (HostPulls started at dispatch);
# ``certifiable`` records the saturation-certificate preconditions
# evaluated at dispatch time; ``body`` the launches of one pass of the
# graph's WHILE node, counted once per iteration when iters_used is read;
# ``timing`` the replay's CUDA events and host stamp while the recorder
# is on (Megaround.timing), else None
SpecDispatch = namedtuple(
    "SpecDispatch",
    "bucket_keys bucket_pods claims counts need_left iters_used certifiable "
    "body timing",
)

#: time.perf_counter() to the recorder's time.monotonic(): 0 where both
#: read one clock (CLOCK_MONOTONIC on Linux), so a phase's span and its
#: BatchStats seconds come from the same two reads
_PERF_TO_MONO = (
    0.0 if time.get_clock_info("perf_counter").implementation
    == time.get_clock_info("monotonic").implementation
    else time.monotonic() - time.perf_counter()
)


def _span(rec: FlightRecorder, name: str, t0: float, **kw) -> None:
    """Record the interval from *t0* (a perf_counter read) to now."""
    rec.record(name, t0 + _PERF_TO_MONO, time.perf_counter() - t0, **kw)


@dataclass
class ScheduleContext:
    """Persistent per-cluster solve state reusable across schedule() calls:
    the cluster encode, the FastCluster allocation arrays and the
    device-resident tensors. With a ``delta`` (solver/encode.py
    ClusterDelta) the context also survives churn between calls:
    refresh_context folds noted events in as row patches and row updates.
    """

    nodes: Dict[str, "HostNode"]
    cluster: "ClusterArrays"
    fast: Optional["FastCluster"]
    dev: Optional["DeviceClusterState"]  # None = the non-resident rung
    now: float
    delta: Optional["ClusterDelta"] = None


_FC_EXECUTOR = None


def _fc_executor():
    """Single shared worker for off-thread FastCluster builds (the build
    overlaps round 1's solve; it touches numpy and ctypes only, never
    CUDA)."""
    global _FC_EXECUTOR
    if _FC_EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor

        _FC_EXECUTOR = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nhd-fastcluster"
        )
    return _FC_EXECUTOR


class GcPin:
    """Process-wide heap pin for scheduler sweeps (the reference's): the
    pre-existing heap is gc.freeze()-excluded and automatic collection is
    off for the sweep's duration; ``NHD_TPU_GC_PIN=0`` disables it."""

    active = False
    _lock = _threading.Lock()

    @classmethod
    def acquire(cls):
        import gc
        import os

        if os.environ.get("NHD_TPU_GC_PIN", "1") == "0":
            return None
        with cls._lock:
            if cls.active:
                return None
            cls.active = True
        was_enabled = gc.isenabled()
        gc.freeze()
        gc.disable()
        return (True, was_enabled)

    @classmethod
    def release(cls, token) -> None:
        if token:
            import gc

            if token[1]:
                gc.enable()
            gc.unfreeze()
            with cls._lock:
                cls.active = False


_GC_PIN_MIN_ITEMS = 4096


def _rung_of(dev) -> int:
    """The ladder rung a solve attempt runs at, read off its device
    state (solver/guard.py): mesh-sharded resident tensors, resident
    tensors on one device, or the non-resident solve on that device."""
    if dev is None:
        return RUNG_HOST
    return RUNG_MESH if dev.mesh is not None else RUNG_SINGLE


def _unique_rows(cols):
    """``np.unique(axis=0)`` over parallel int columns via one packed int64
    key (each column shifted by its minimum, so ``-1`` sentinels keep the
    key injective); the axis form when the key would overflow. Returns
    ``(rows, inverse)``."""
    bits = 0
    spans = []
    for c in cols:
        lo = int(c.min()) if len(c) else 0
        span = (int(c.max()) - lo + 1) if len(c) else 1
        spans.append((lo, span))
        bits += max(span - 1, 1).bit_length()
    if bits <= 62:
        key = np.zeros(len(cols[0]), np.int64)
        for c, (lo, span) in zip(cols, spans):
            key = key * span + (c.astype(np.int64, copy=False) - lo)
        _, first_idx, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        rows = np.stack([c[first_idx] for c in cols], axis=1)
        return rows, inv
    mat = np.stack(
        [c.astype(np.int64, copy=False) for c in cols], axis=1
    )
    return np.unique(mat, axis=0, return_inverse=True)


def _gc_pinned(fn):
    """Wrap a schedule call in GcPin acquire/release for gang-scale
    batches only."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, nodes, items, **kwargs):
        held = GcPin.acquire() if len(items) >= _GC_PIN_MIN_ITEMS else False
        try:
            return fn(self, nodes, items, **kwargs)
        finally:
            GcPin.release(held)

    return wrapper


def _pipeline_enabled(device) -> bool:
    """Round pipelining: ``NHD_PIPELINE`` ``1`` forces on, ``0`` off
    (the placement-parity control), ``auto`` (default) = on for CUDA,
    where the early launch has a device to hide under. Read per
    schedule() call."""
    import os

    val = os.environ.get("NHD_PIPELINE", "auto").lower()
    if val in ("1", "true", "on"):
        return True
    if val in ("0", "false", "off"):
        return False
    return device.type == "cuda"


@dataclass
class BatchStats:
    rounds: int = 0
    solve_seconds: float = 0.0
    select_seconds: float = 0.0
    assign_seconds: float = 0.0
    scheduled: int = 0
    failed: int = 0
    # elapsed seconds from batch start to the end of each round — a pod
    # placed in round r has bind latency <= round_end_seconds[r]
    round_end_seconds: List[float] = field(default_factory=list)
    # fine-grained wall breakdown (encode / prelaunch / native_assign /
    # materialize / ...)
    phases: Dict[str, float] = field(default_factory=dict)
    # event counts (per-round pending, claims, rejects)
    counters: Dict[str, int] = field(default_factory=dict)
    # cluster shape bucket ("U{U}_K{K}_N{n}"); while set, phases are also
    # attributed per shape in the process jit-stats table
    shape_hint: str = ""
    # the flight recorder the call records into (None: tracing off) and
    # the one correlation ID of all of the call's spans
    rec: Optional[FlightRecorder] = field(default=None, repr=False, compare=False)
    corr: Optional[str] = None

    def phase_add(self, name: str, dt: float, t0: Optional[float] = None) -> None:
        """Add *dt* seconds to phase *name*; given the phase's start *t0*
        (the perf_counter read *dt* was taken from) and a recorder, the
        phase is also a span of exactly *dt*."""
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if self.shape_hint:
            from nhd_tpu_torch.obs.jitstats import JIT_STATS

            JIT_STATS.record_phase(name, self.shape_hint, dt)
        if t0 is not None and self.rec is not None:
            self.rec.record(name, t0 + _PERF_TO_MONO, dt, cat="phase",
                            corr=self.corr)

    def count_add(self, name: str, k: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(k)

    def bind_latency_percentile(self, results, q: float) -> float:
        """p-th percentile bind latency over placed pods (seconds)."""
        lats = sorted(
            self.round_end_seconds[r.round_no]
            for r in results
            if r.node is not None and 0 <= r.round_no < len(self.round_end_seconds)
        )
        if not lats:
            return 0.0
        rank = max(0, -(-int(q * len(lats)) // 100) - 1)
        return lats[min(rank, len(lats) - 1)]


class BatchScheduler:
    """Schedules a whole pending batch against the host node mirror, with
    the solve on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
    PyTorch versions of the kernels, for tests and parity runs).

    ``use_fast`` (default) routes physical assignment through the
    vectorized FastCluster (and its native round call); with it off, every
    winner goes through HostNode.assign_physical_ids (the reference path,
    kept for cross-checking).
    """

    def __init__(
        self,
        *,
        device: DeviceLike = "cuda",
        respect_busy: bool = True,
        max_rounds: int = 10_000,
        use_fast: bool = True,
        register_pods: bool = True,
        mesh: object = "auto",
    ):
        self.logger = get_logger(__name__)
        self.device = resolve_device(device)
        self.respect_busy = respect_busy
        self.max_rounds = max_rounds
        self.use_fast = use_fast
        self.register_pods = register_pods
        # FastCluster static-topology cache, shared across schedule() calls
        self._fc_static: dict = {}
        # mesh: "auto" → shard the solve over every local GPU whenever
        # there are several (on the CPU, never); None → one device; or an
        # explicit parallel.sharding.Mesh over a "nodes" axis, whose
        # shards share this scheduler's device type
        if mesh is not None and mesh != "auto":
            if "nodes" not in getattr(mesh, "axis_names", ()):
                raise ValueError(
                    "mesh must be 'auto', None, or a parallel.sharding.Mesh "
                    f"with a 'nodes' axis, got {mesh!r}"
                )
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"mesh shards on {mesh.device_type} but the scheduler "
                    f"solves on {self.device}"
                )
        self.mesh = mesh

    def _resolve_mesh(self):
        """The mesh a fresh device-state build shards over: the explicit
        one, or for "auto" every local GPU when there are several (the
        distinct-GPU rule of parallel.sharding.resolve_mesh_spec; local
        devices only — each scheduler process shards over its own)."""
        if self.mesh != "auto":
            return self.mesh
        if self.device.type != "cuda":
            return None
        import torch

        from nhd_tpu_torch.parallel.sharding import make_mesh

        n = torch.cuda.device_count()
        return make_mesh(n_shards=n, device="cuda") if n > 1 else None

    def _select_winners(
        self, pods, out: RankHost, node_claimed: Dict[int, int], G: int
    ):
        """Vectorized capacity-aware packing for one bucket's round (the
        reference's, unchanged). Returns ``(w_pod, w_node, w_type,
        w_rank)`` sorted by pod index, or None when the bucket wins
        nothing; mutates ``node_claimed`` with this bucket's nodes."""
        cap = self._capacity_at(pods, out)            # [T, R], 0 off-prefix
        T, R = cap.shape
        if node_claimed:
            # one-bucket-per-node rule: nodes another bucket claimed this
            # round are blocked (static within a bucket)
            blocked = np.asarray(
                [n for n, g in node_claimed.items() if g != G], np.int64
            )
            if len(blocked):
                cap[np.isin(out.idx, blocked)] = 0
        # greedy fill in rank order, whole bucket at once: each type
        # takes min(cap, need left) at every rank position
        need_t = np.bincount(pods.pod_type, minlength=T)
        cap = np.minimum(cap, need_t[:, None])
        cum = np.cumsum(cap, axis=1)
        take = np.clip(need_t[:, None] - (cum - cap), 0, cap)
        k_t = take.sum(axis=1)                        # winners per type
        if not k_t.any():
            return None
        take_flat = take.ravel()
        w_node = np.repeat(out.idx.ravel(), take_flat).astype(
            np.int32, copy=False
        )
        w_rank = np.repeat(np.tile(np.arange(R, dtype=np.int32), T),
                           take_flat)
        w_type = np.repeat(np.arange(T, dtype=np.int32), k_t)
        # pods of a type consume claims in pod-index order
        order = np.argsort(pods.pod_type, kind="stable")
        podid_sorted = pods.pod_index[order]
        types_sorted = pods.pod_type[order]
        starts = np.concatenate(([0], np.cumsum(need_t)[:-1]))
        ordinal = (
            np.arange(len(types_sorted), dtype=np.int64)
            - starts[types_sorted]
        )
        w_pod = podid_sorted[ordinal < k_t[types_sorted]].astype(
            np.int64, copy=False
        )
        for n in np.unique(w_node).tolist():
            node_claimed.setdefault(int(n), G)
        o = np.argsort(w_pod, kind="stable")
        return (
            np.ascontiguousarray(w_pod[o]),
            np.ascontiguousarray(w_node[o]),
            np.ascontiguousarray(w_type[o]),
            np.ascontiguousarray(w_rank[o]),
        )

    def _capacity_at(self, pods, rank: RankHost) -> np.ndarray:
        """Optimistic copies-per-node estimate cap[T, R] over the ranked
        candidates (the reference's): feasible NIC picks at the best
        combo, free GPUs / cores / hugepages over per-pod demand; GPU pods
        cap at 1 per node under the busy back-off."""
        INF = np.int64(1 << 30)
        cand = rank.val > 0
        cap = np.where(cand, np.maximum(rank.n_picks, 1), 0).astype(np.int64)

        gpus_tot = pods.gpu_dem.sum(axis=1)
        gpu_cap = np.where(
            gpus_tot[:, None] > 0,
            rank.free_gpu // np.maximum(gpus_tot, 1)[:, None],
            INF,
        )
        cpu_tot = np.minimum(
            pods.cpu_dem_smt.sum(axis=1), pods.cpu_dem_raw.sum(axis=1)
        )
        cpu_cap = np.where(
            cpu_tot[:, None] > 0,
            rank.free_cpu // np.maximum(cpu_tot, 1)[:, None],
            INF,
        )
        hp_cap = np.where(
            pods.hp[:, None] > 0,
            rank.free_hp // np.maximum(pods.hp, 1)[:, None],
            INF,
        )
        cap = np.minimum(cap, np.minimum(gpu_cap, np.minimum(cpu_cap, hp_cap)))
        if self.respect_busy:
            cap = np.where(pods.needs_gpu[:, None], np.minimum(cap, 1), cap)
        cap = np.where(cand, np.maximum(cap, 1), 0)
        return cap

    def _speculate_dispatch(self, dev, all_buckets, is_pending):
        """Round 0 of the speculative path: the megaround
        (solver/speculate.py) for every eligible bucket jointly — PCI
        types included. Returns None when nothing is eligible."""
        bucket_keys, bucket_pods, needs = [], [], []
        t_total = 0
        need_total = 0
        for G, full in all_buckets.items():
            mask = is_pending[full.pod_index]
            # keep the FULL type rows and keep empty buckets in the
            # dispatch: absent types and dead buckets carry zero need and
            # the loop skips a bucket with no need
            pods = replace(
                full,
                pod_type=full.pod_type[mask],
                pod_index=full.pod_index[mask],
            )
            Tp = _pad_pow2(pods.n_types)
            need = np.bincount(pods.pod_type, minlength=Tp).astype(np.int32)
            U, K = dev.cluster.U, dev.cluster.K
            word_overflow = (
                (U**pods.G) * (max(K, 1) ** pods.G) * U >= (1 << _T_SHIFT)
            )
            if word_overflow or not bucket_tractable(pods.G, U, K):
                if not need.any():
                    # a zero-need bucket whose lattice is word-overflowing
                    # or intractable must not ride along: building its
                    # combo tables is the explosion the budget prevents
                    continue
                # the packed claim word's (c*U+m)*A + a field would
                # overflow: classic rounds handle any lattice
                return None
            bucket_keys.append(G)
            bucket_pods.append(pods)
            needs.append(need)
            t_total += Tp
            need_total += int(need.sum())
        if (
            not bucket_keys
            or need_total == 0
            or t_total >= (1 << (31 - _T_SHIFT))
        ):
            # nothing to speculate, or the global type axis would
            # overflow the claim word's type field
            return None
        # saturation-certificate preconditions (see the spec-round
        # consumer): with these, the loop's projected state provably
        # upper-bounds true state, so a no-candidate exit is final
        from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING

        certifiable = (
            not ENABLE_NIC_SHARING
            and dev.cluster.uniform_nic_caps
            and not any(
                need[: pods.n_types][pods.map_pci].any()
                for pods, need in zip(bucket_pods, needs)
            )
        )
        res = dev.megaround(bucket_pods, needs, self.respect_busy)
        claims, counts, need_left, it = res
        # the four copies to the host start now, each into pinned memory
        # behind an event, so the FastCluster join runs under them
        return SpecDispatch(
            bucket_keys, bucket_pods, HostPull(claims), HostPull(counts),
            HostPull(need_left), HostPull(it), certifiable, res.body,
            res.timing,
        )

    def _expand_speculative(self, spec, claims_np, counts_np, cluster):
        """Expand the megaround's packed claim tensor into per-bucket
        winner ARRAYS: pods of a type consume its claims in (iteration,
        node) order, re-sorted to pod-index order within the bucket (the
        classic apply order). Returns
        ({G: (pods, w_pod, w_node, w_type, w_c, w_m, w_a)}, node_claimed)
        with every w_* an int32 numpy array (w_pod int64)."""
        bucket_keys, bucket_pods = spec.bucket_keys, spec.bucket_pods
        shapes = tuple((p.G, _pad_pow2(p.n_types)) for p in bucket_pods)
        decoded = decode_claims_grouped(
            claims_np, shapes, tuple(bucket_keys), cluster.U, cluster.K,
            counts_np,
        )
        out = {}
        node_claimed: Dict[int, int] = {}
        for gk, pods in zip(bucket_keys, bucket_pods):
            per_type = decoded.get(gk, {})
            if not per_type:
                continue
            # pod ids per type in pod-index order: pod_index is ascending
            # within the encode, so a stable sort by type keeps it
            order = np.argsort(pods.pod_type, kind="stable")
            types_sorted = pods.pod_type[order]
            podid_sorted = pods.pod_index[order]
            t_vals, t_starts = np.unique(types_sorted, return_index=True)
            t_bounds = np.append(t_starts, len(types_sorted))
            t_slice = {
                int(t): (int(lo), int(hi))
                for t, lo, hi in zip(t_vals, t_bounds[:-1], t_bounds[1:])
            }
            cols: List[List[np.ndarray]] = [[] for _ in range(6)]
            for t, (nds, cs, ms, As) in per_type.items():
                span = t_slice.get(int(t))
                if span is None:
                    continue
                lo, hi = span
                k = min(hi - lo, len(nds))
                if k == 0:
                    continue
                cols[0].append(podid_sorted[lo : lo + k])
                cols[1].append(nds[:k])
                cols[2].append(np.full(k, int(t), np.int64))
                cols[3].append(cs[:k])
                cols[4].append(ms[:k])
                cols[5].append(As[:k])
            if not cols[0]:
                continue
            w_pod, w_node, w_type, w_c, w_m, w_a = (
                np.concatenate(c) for c in cols
            )
            o = np.argsort(w_pod, kind="stable")
            out[gk] = (
                pods,
                np.ascontiguousarray(w_pod[o], np.int64),
                np.ascontiguousarray(w_node[o], np.int32),
                np.ascontiguousarray(w_type[o], np.int32),
                np.ascontiguousarray(w_c[o], np.int32),
                np.ascontiguousarray(w_m[o], np.int32),
                np.ascontiguousarray(w_a[o], np.int32),
            )
            for n in np.unique(w_node).tolist():
                node_claimed.setdefault(int(n), gk)
        return out, node_claimed

    @staticmethod
    def _spec_tuples(expanded):
        """Adapter for the object-assignment fallback: per-bucket winner
        arrays → (claims tuples, bucket_out with a synthetic RankHost
        carrying each claim's (c, m, a) at its rank position)."""
        claims: List[Tuple[int, int, int, int, int]] = []
        bucket_out = {}
        for gk, (pods, w_pod, w_node, w_type, w_c, w_m, w_a) in (
            expanded.items()
        ):
            T = pods.n_types
            counts = np.bincount(w_type, minlength=T)
            r_spec = int(counts.max(initial=0)) or 1
            val = np.zeros((T, r_spec), np.int32)
            idx = np.zeros((T, r_spec), np.int32)
            bc = np.zeros((T, r_spec), np.int32)
            bm = np.zeros((T, r_spec), np.int32)
            ba = np.zeros((T, r_spec), np.int32)
            # rank position = per-type claim ordinal, in (iter, node) order
            seen = np.zeros(T, np.int64)
            for pod_i, n, t, c, m, a in zip(
                w_pod.tolist(), w_node.tolist(), w_type.tolist(),
                w_c.tolist(), w_m.tolist(), w_a.tolist(),
            ):
                j = int(seen[t])
                seen[t] += 1
                val[t, j] = 1
                idx[t, j] = n
                bc[t, j] = c
                bm[t, j] = m
                ba[t, j] = a
                claims.append((pod_i, n, gk, t, j))
            zeros = np.zeros((T, r_spec), np.int32)
            bucket_out[gk] = (
                pods,
                RankHost(val, idx, bc, bm, ba,
                         np.ones((T, r_spec), np.int32),
                         zeros, zeros, zeros),
            )
        claims.sort()
        return claims, bucket_out

    def _schedule_serial(
        self, nodes, items, indices, results, stats, now, apply
    ) -> set:
        """Oracle-driven sequential scheduling for combo-oversized pods.
        Returns the touched node names (winners plus busy-stamped failed
        attempts)."""
        from nhd_tpu_torch.sim.requests import request_to_topology

        touched: set = set()
        for i in indices:
            item = items[i]
            m = oracle_find_node(
                nodes, item.request, now=now, respect_busy=self.respect_busy
            )
            if m is None:
                continue
            if not apply:
                results[i] = BatchAssignment(item.key, m.node, m.mapping)
                continue
            node = nodes[m.node]
            touched.add(m.node)
            try:
                top = item.topology or request_to_topology(item.request)
                node.set_busy(now)
                nic_list = node.assign_physical_ids(m.mapping, top)
            except (AssignmentError, ValueError) as exc:
                self.logger.error(
                    f"serial assignment failed for {item.key}: {exc}"
                )
                stats.failed += 1
                continue
            node.claim_nic_pods(sorted({x[0] for x in nic_list}))
            if self.register_pods:
                node.add_scheduled_pod(item.key[1], item.key[0], top)
            results[i] = BatchAssignment(item.key, m.node, m.mapping, nic_list)
            stats.scheduled += 1
        return touched

    def make_context(
        self, nodes: Dict[str, HostNode], *, now: Optional[float] = None,
        interner=None, delta: Optional[ClusterDelta] = None,
    ) -> ScheduleContext:
        """Encode *nodes* once into a reusable ScheduleContext (encode,
        FastCluster arrays and device-resident tensors persist across
        schedule() calls). ``delta``: build over an incrementally
        maintained ClusterDelta so the context survives churn; the
        context's ``nodes`` is then the delta's row-aligned view."""
        if now is None:
            now = time.monotonic()
        if delta is not None:
            if delta.nodes is not nodes:
                raise ValueError(
                    "delta was built over a different nodes dict"
                )
            delta.refresh(now)
            delta.consume_full()
            delta.drain_dirty()  # fresh fast/dev below derive from arrays
            cluster = delta.arrays
            nodes = delta.view
        else:
            cluster = encode_cluster(nodes, now=now, interner=interner)
            if not self.respect_busy:
                cluster.busy[:] = False
        fast = (
            FastCluster(nodes, cluster.U, cluster.K, arrays=cluster,
                        static_cache=self._fc_static)
            if self.use_fast
            else None
        )
        mesh, use_dev = self._guard_posture()
        dev = (
            self._build_dev(
                cluster, mesh, delta.capacity if delta is not None else None
            )
            if use_dev else None
        )
        return ScheduleContext(nodes, cluster, fast, dev, now, delta)

    def _guard_posture(self):
        """(mesh, use_dev) for a fresh device-state build, with the
        solver guard's floor applied (solver/guard.py ladder): a condemned
        mesh strips to one device, a condemned resident plane to the
        non-resident rung. Either way the solve stays on ``self.device``
        (or the mesh's shards)."""
        mesh = self._resolve_mesh()
        if GUARD.active() and not GUARD.allow_mesh():
            mesh = None
        return mesh, not GUARD.active() or GUARD.allow_device()

    def _build_dev(self, cluster, mesh, capacity):
        """Construct resident device state under the guard's fault
        boundary: the build itself copies every node tensor to the
        device, and on a device that cannot take them it faults exactly
        like a solve would, so a transient build failure condemns the
        resident plane straight to the non-resident rung and returns
        None. With the guard off (or a terminal fault) it raises."""
        try:
            return DeviceClusterState(cluster, self.device, mesh,
                                      capacity=capacity)
        except Exception as exc:
            if not GUARD.active() or not classify_device_fault(exc):
                raise
            self.logger.error(
                "solver guard: device-state build failed; condemning to "
                f"the non-resident rung: {exc!r}"
            )
            GUARD.condemn_device(exc)
            return None

    def _reposture_dev(self, ctx: ScheduleContext) -> None:
        """Rebuild a persistent context's device state when the guard's
        floor moved between batches: degradation drops the resident
        tensors, re-promotion after clean probe rounds re-derives them
        from host truth. A no-op when the posture already matches."""
        mesh, use_dev = self._guard_posture()
        cur = ctx.dev
        if use_dev == (cur is not None) and (
            cur is None or (cur.mesh is not None) == (mesh is not None)
        ):
            return
        capacity = ctx.delta.capacity if ctx.delta is not None else None
        ctx.dev = (self._build_dev(ctx.cluster, mesh, capacity)
                   if use_dev else None)
        if ctx.dev is not None:
            GUARD.note_repair()

    def _guard_recover(self, dev, cluster, context):
        """Condemn + rebuild the resident state after a transient fault,
        at the guard's (possibly degraded) allowed rung: the resident
        tensors re-derive wholesale from the host ClusterArrays. Returns
        the replacement (None = the non-resident rung) and re-points a
        persistent context at it so later batches inherit the posture."""
        new = None
        if dev is not None and GUARD.allow_device():
            mesh = dev.mesh if GUARD.allow_mesh() else None
            capacity = (
                context.delta.capacity
                if context is not None and context.delta is not None
                else None
            )
            new = self._build_dev(cluster, mesh, capacity)
            if new is not None:
                GUARD.note_repair()
        elif dev is not None:
            self.logger.error(
                "solver guard: resident device state condemned; this "
                "batch continues on the non-resident solve path"
            )
        if context is not None:
            context.dev = new
        return new

    def _guard_audit(self, dev, cluster, context, stats):
        """Batch-start resident-state audit (solver/guard.py): flush any
        staged claim rows (the device may legitimately lag them), then
        bit-exact spot-check the budgeted row sample against the host
        mirror. Corruption repairs in place (rebuild_resident — host
        truth wins) before any solve reads the poisoned rows. A device
        fault inside the audit itself takes the same recover path as a
        round fault. Returns the (possibly replaced) device state."""
        t0 = time.perf_counter()
        try:
            dev._flush_staged()
            errs = GUARD.run_audit(dev)
            if errs:
                for e in errs[:4]:
                    self.logger.error(f"resident-state audit: {e}")
                dev.rebuild_resident()
                GUARD.note_repair()
            return dev
        except Exception as exc:
            if GUARD.on_fault(exc, rung=_rung_of(dev), attempt=1) != "retry":
                raise
            return self._guard_recover(dev, cluster, context)
        finally:
            stats.phase_add("guard_audit", time.perf_counter() - t0, t0)

    def refresh_context(
        self, ctx: ScheduleContext, *, now: Optional[float] = None,
    ) -> ScheduleContext:
        """Bring a delta-built ScheduleContext current between batches:
        busy decay and every noted event fold into the packed arrays as
        row patches, the same rows re-read into FastCluster and update the
        device tensors. A fallback rebuild inside the delta re-derives
        FastCluster and the device state wholesale."""
        delta = ctx.delta
        if delta is None:
            raise ValueError("refresh_context needs a delta-built context")
        rec = get_recorder()
        if rec is None:
            return self._refresh(ctx, delta, now, None)
        t0 = time.perf_counter()
        try:
            return self._refresh(ctx, delta, now, rec)
        finally:
            _span(rec, "refresh_context", t0, cat="refresh")

    def _refresh(self, ctx, delta, now, rec) -> ScheduleContext:
        """refresh_context's body; with a recorder, its three parts are
        spans: ``delta_refresh``, ``fast_refresh``, ``row_scatter``."""
        if now is None:
            now = time.monotonic()
        if GUARD.active():
            # guard posture drift: a degradation (or re-promotion after
            # clean probe rounds) between batches rebuilds the resident
            # plane at the allowed rung before this batch's rows land
            self._reposture_dev(ctx)
        t0 = time.perf_counter()
        delta.refresh(now)
        if rec is not None:
            _span(rec, "delta_refresh", t0, cat="refresh")
        ctx.now = now
        if delta.consume_full():
            delta.drain_dirty()
            t0 = time.perf_counter()
            ctx.fast = (
                FastCluster(
                    ctx.nodes, ctx.cluster.U, ctx.cluster.K,
                    arrays=ctx.cluster, static_cache=self._fc_static,
                )
                if self.use_fast else None
            )
            if rec is not None:
                _span(rec, "fast_refresh", t0, cat="refresh")
            if ctx.dev is not None:
                t0 = time.perf_counter()
                ctx.dev = self._build_dev(
                    ctx.cluster, ctx.dev.mesh, delta.capacity
                )
                if rec is not None:
                    _span(rec, "row_scatter", t0, cat="refresh")
            return ctx
        rows = delta.drain_dirty()
        t0 = time.perf_counter()
        if rows.size and ctx.fast is not None:
            if len(ctx.fast.names) != delta.n_rows:
                # rows appended into padded-capacity slots: FastCluster's
                # fixed-N matrices cannot grow — rebuild it
                ctx.fast = FastCluster(
                    ctx.nodes, ctx.cluster.U, ctx.cluster.K,
                    arrays=ctx.cluster, static_cache=self._fc_static,
                )
            else:
                for i in rows.tolist():
                    ctx.fast.refresh_node(i)
        if rec is not None:
            _span(rec, "fast_refresh", t0, cat="refresh")
        if ctx.dev is not None:
            t0 = time.perf_counter()
            ctx.dev.scatter_rows(rows)  # also syncs row-count growth
            if rec is not None:
                _span(rec, "row_scatter", t0, cat="refresh")
        return ctx

    @_gc_pinned
    def schedule(
        self,
        nodes: Dict[str, HostNode],
        items: Sequence[BatchItem],
        *,
        now: Optional[float] = None,
        apply: bool = True,
        context: Optional[ScheduleContext] = None,
        encoded: Optional[Dict[int, "PodTypeArrays"]] = None,
        offer: Optional[Sequence[int]] = None,
    ) -> Tuple[List[BatchAssignment], BatchStats]:
        """Place every item it can; mutates ``nodes`` when ``apply``.

        Items without a topology get a synthetic one (sim.requests), so
        physical assignment always runs. With ``context`` (from
        make_context over the same ``nodes``) the per-call encode and
        device upload are skipped.

        ``encoded``/``offer`` (the reference's): reuse a prior encode_pods
        of the FULL ``items`` list (built against the context cluster's
        interner) and restrict the schedulable set to the ``offer``
        indices — the streaming tiler (solver/streaming.py) encodes each
        pod chunk once and offers shrinking subsets of it to successive
        tiles. Every round's membership view and the megaround's per-type
        need come from the offered pending set; the type rows, and so the
        device uploads cached per requests list, stay the full encode's.
        With ``offer``, result slots outside the offer are None; the
        caller reads only the offered indices."""
        from nhd_tpu_torch.sim.requests import request_to_topology

        t_call = time.perf_counter()
        stats = BatchStats()
        trace = get_recorder()
        if trace is not None:
            stats.rec = trace
            stats.corr = current_corr_id() or new_corr_id(trace.identity)
        results: List[Optional[BatchAssignment]] = [None] * len(items)
        if now is None:
            now = context.now if context is not None else time.monotonic()

        if context is not None and context.nodes is not nodes:
            raise ValueError(
                "context was built for a different nodes dict"
            )
        node_list = list(nodes.values())
        # contextless one-shot batch: the encode routes through an
        # ephemeral ClusterDelta, so the serial oversized pre-pass below
        # folds its claims back in as row patches
        ephemeral: Optional[ClusterDelta] = None
        if context is not None:
            cluster = context.cluster
        else:
            ephemeral = ClusterDelta(
                nodes, now=now, respect_busy=self.respect_busy
            )
            cluster = ephemeral.arrays
        stats.shape_hint = f"U{cluster.U}_K{cluster.K}_N{len(node_list)}"

        # one pass collects the schedulable set and the combo-oversized
        # subset (tractability memoized per group count)
        _tract: Dict[int, bool] = {}
        pending_l: List[int] = []
        oversized: List[int] = []
        _sched_modes = (MapMode.NUMA, MapMode.PCI)
        _U, _K = cluster.U, cluster.K
        t_pre = time.perf_counter()
        for i in range(len(items)) if offer is None else offer:
            r = items[i].request
            if r.map_mode not in _sched_modes:
                continue
            pending_l.append(i)
            G = len(r.groups)
            v = _tract.get(G)
            if v is None:
                v = _tract[G] = bucket_tractable(G, _U, _K)
            if not v:
                oversized.append(i)
        pending = np.asarray(pending_l, np.int64)
        del pending_l
        stats.phase_add("prepass", time.perf_counter() - t_pre, t_pre)
        if oversized and context is not None and context.delta is None:
            raise ValueError(
                "combo-oversized pods cannot be scheduled through a "
                "persistent context; route them to the serial path first"
            )
        if oversized:
            # the pre-pass gives oversized pods their claims before any
            # greedy round (a documented exception to the lowest-index
            # conflict rule; every claim is still feasible when made)
            touched = self._schedule_serial(
                nodes, items, oversized, results, stats, now, apply
            )
            pending = pending[~np.isin(pending, oversized)]
            if apply and context is not None:
                context.delta.note_all(touched)
                self.refresh_context(context, now=now)
            elif apply:
                ephemeral.note_all(touched)
                ephemeral.refresh(now)
                ephemeral.drain_dirty()

        fast_future = None
        # FastCluster is built on a worker thread right after the first
        # solve launch, so its host work overlaps the device compute
        submit_fast = False
        if context is not None:
            fast = context.fast if apply else None
            dev = context.dev
        else:
            fast = None
            submit_fast = self.use_fast and apply
            # the guard's degradation floor applies here too
            # (_guard_posture), and a build that faults condemns to the
            # non-resident rung instead of failing the batch (_build_dev)
            mesh, use_dev = self._guard_posture()
            dev = self._build_dev(cluster, mesh, None) if use_dev else None
        guard_on = GUARD.active()
        if guard_on and dev is not None and GUARD.audit_due():
            # periodic + on-suspicion resident-state audit BEFORE any
            # solve of this batch reads the resident rows: a corrupted
            # row repairs from host truth here, so the batch's binds are
            # identical to a fault-free run
            dev = self._guard_audit(dev, cluster, context, stats)
        # pod index → its AssignRecord (per-pod path) or, from the round
        # path, (plan or None, node row, its row lists): the final sync
        # fills and registers each pod's topology from it
        records: Dict[int, object] = {}
        plans_built = 0
        busy_nodes: set = set()
        all_buckets = None
        is_pending = None
        R = None
        # round r+1's solves, launched by round r before its host phases
        prelaunched = None
        pipeline_on = apply and _pipeline_enabled(self.device)
        accelerator = self.device.type == "cuda"
        # speculative round 0 (solver/speculate.py): the device runs the
        # whole greedy claim loop and the host re-verifies its claims
        # through the normal native apply. Off under a live (non-uniform)
        # scoring matrix: its claims would bypass the policy ranking. The
        # megaround runs on resident tensors only
        spec_ok = (
            apply
            and dev is not None
            and speculate_enabled(self.device)
            and not scoring_active()
        )

        def _membership(full, mask):
            """Restrict pod membership WITHOUT shrinking the type rows:
            the padded bucket shape and its uploaded pod tensors stay the
            same across rounds."""
            return replace(
                full,
                pod_type=full.pod_type[mask],
                pod_index=full.pod_index[mask],
            )

        def _stamp(exc: BaseException, G, pods) -> None:
            """Attribute a dispatch/pull fault to its bucket's shape key
            (the dispatch's own, kernel.ranked_shape_key) for the
            guard's per-shape fault count; best effort, since some
            exception types refuse new attributes."""
            Np_k = dev.Np if dev is not None else _pad_pow2(cluster.n_nodes)
            desc = mesh_desc(dev.mesh) if dev is not None else ""
            try:
                exc._nhd_shape_key = ranked_shape_key(
                    G, cluster.U, cluster.K, min(R, Np_k),
                    _pad_pow2(pods.n_types), Np_k, desc,
                )
            except (AttributeError, TypeError):
                pass  # slotted / C-extension exception types

        def _dispatch_solves():
            launched = []
            for G, full in all_buckets.items():
                mask = is_pending[full.pod_index]
                if not mask.any():
                    continue
                pods = _membership(full, mask)
                try:
                    out = (
                        dev.solve_ranked(pods, R) if dev is not None
                        else solve_bucket_ranked(
                            cluster, pods, R, device=self.device
                        )
                    )
                except Exception as exc:
                    _stamp(exc, G, pods)
                    raise
                launched.append((G, pods, HostPull(out)))
            return launched

        def _prelaunch() -> float:
            """Launch round r+1's solves now: the staged claim rows reach
            the device first (same stream), so the host phases that
            follow overlap the next round's kernels. A prelaunch fault
            costs only the pipelining: the resident state recovers now
            and the next round dispatches fresh under its own boundary."""
            nonlocal prelaunched, spec_ok, dev
            is_pending[:] = False
            is_pending[pending] = True
            t_pl = time.perf_counter()
            try:
                prelaunched = _dispatch_solves()
                stats.count_add("prelaunched_rounds", 1)
            except Exception as exc:
                if not guard_on or GUARD.on_fault(
                    exc, rung=_rung_of(dev), attempt=1,
                    shape_key=getattr(exc, "_nhd_shape_key", ""),
                ) != "retry":
                    raise
                prelaunched = None
                spec_ok = False
                dev = self._guard_recover(dev, cluster, context)
            dt = time.perf_counter() - t_pl
            stats.phase_add("prelaunch", dt, t_pl)
            return dt

        t_batch = time.perf_counter()
        for round_no in range(self.max_rounds):
            if not len(pending):
                break
            stats.rounds = round_no + 1
            if round_no < 8:
                stats.count_add(f"pending_r{round_no}", len(pending))

            t0 = time.perf_counter()
            if all_buckets is None:
                # type-level tensors never change across rounds: encode
                # the whole pending set once (or reuse the caller's
                # chunk-wide encode), filter membership below
                pend_list = pending.tolist()
                all_buckets = encoded if encoded is not None else encode_pods(
                    [items[i].request for i in pend_list],
                    cluster.interner,
                    indices=pend_list,
                )
                stats.phase_add("encode", time.perf_counter() - t0, t0)
                # R >= the largest per-type pod count: every ranked
                # candidate carries capacity >= 1
                max_need = max(
                    (
                        int(np.bincount(b.pod_type).max())
                        for b in all_buckets.values()
                        if len(b.pod_type)
                    ),
                    default=1,
                )
                R = rank_budget(
                    max_need, cluster.n_nodes, accelerator=accelerator
                )
                is_pending = np.zeros(len(items), bool)
            is_pending[:] = False
            is_pending[pending] = True

            # ---- solve phase, under the guard's fault boundary ------
            # Any exception out of a device dispatch, a pull or the
            # rank-tensor screen is classified (solver/guard.py); a
            # transient fault condemns the device state, rebuilds it from
            # host truth at a (possibly degraded) rung, and re-dispatches
            # the whole round — none of this round's claims has been
            # applied yet, so a retried round never binds wrongly or in
            # part. Terminal faults and an exhausted ladder raise.
            guard_attempts = 0
            while True:
                # (pod index, node index, bucket G, type, rank position)
                claims: List[Tuple[int, int, int, int, int]] = []
                bucket_out = {}
                spec = None
                claims_np = counts_np = None
                try:
                    spec_round = spec_ok and round_no == 0
                    if prelaunched is not None:
                        launched = prelaunched
                        prelaunched = None
                    else:
                        if spec_round:
                            t_sp = time.perf_counter()
                            spec = self._speculate_dispatch(
                                dev, all_buckets, is_pending
                            )
                            stats.phase_add(
                                "spec_dispatch", time.perf_counter() - t_sp,
                                t_sp,
                            )
                            launched = []
                        if spec is None:
                            # nothing to speculate: classic round
                            spec_round = False
                            launched = _dispatch_solves()
                    if submit_fast:
                        submit_fast = False
                        fast_future = _fc_executor().submit(
                            FastCluster, nodes, cluster.U, cluster.K,
                            arrays=cluster, static_cache=self._fc_static,
                        )
                    if fast_future is not None:
                        t_j = time.perf_counter()
                        fast = fast_future.result()
                        fast_future = None
                        stats.phase_add(
                            "fast_join", time.perf_counter() - t_j, t_j
                        )
                    if spec_round:
                        # the megaround's results, copied since dispatch
                        t_pull = time.perf_counter()
                        # each is a HostPull: the sanctioned flush
                        claims_np = spec.claims.numpy()  # nhdlint: ignore[NHD107]
                        counts_np = spec.counts.numpy()  # nhdlint: ignore[NHD107]
                        spec_need_left = int(spec.need_left.numpy().sum())  # nhdlint: ignore[NHD107]
                        spec_it = int(spec.iters_used.numpy())  # nhdlint: ignore[NHD107]
                        # the passes the graph's WHILE node ran, as the
                        # card ran them
                        kernels.count_passes(spec.body, spec_it)
                        if spec.timing is not None and stats.rec is not None:
                            # the replay's events: complete, the copies
                            # queued after them pulled just above
                            ev0, ev1, t_replay = spec.timing
                            device_s = ev0.elapsed_time(ev1) * 1e-3
                            stats.rec.record(
                                "megaround_replay", t_replay, device_s,
                                cat="device", corr=stats.corr,
                                attrs={"device_s": device_s,
                                       "passes": spec_it},
                            )
                        stats.phase_add(
                            "spec_pull", time.perf_counter() - t_pull, t_pull
                        )
                        stats.count_add("spec_iterations", spec_it)
                    for G, pods, pull in launched:
                        try:
                            # one pull per bucket: the packed [9, Tp, R]
                            # ranking
                            arr = pull.numpy()
                            if guard_on:
                                # value-domain screen BEFORE any winner
                                # materializes (the int analog of a
                                # NaN/inf screen, solver/guard.py)
                                npad = (
                                    dev.Np if dev is not None
                                    else _pad_pow2(cluster.n_nodes)
                                )
                                defect = GUARD.screen_rank(arr, npad)
                                if defect:
                                    raise DeviceCorruptionError(
                                        f"rank-tensor screen: {defect}"
                                    )
                        except Exception as exc:
                            _stamp(exc, G, pods)
                            raise
                        bucket_out[G] = (pods, RankHost(*arr[:, : pods.n_types]))
                    break
                except Exception as exc:
                    if not guard_on:
                        raise
                    guard_attempts += 1
                    if GUARD.on_fault(
                        exc, rung=_rung_of(dev), attempt=guard_attempts,
                        shape_key=getattr(exc, "_nhd_shape_key", ""),
                    ) != "retry":
                        raise
                    # a faulted batch never speculates again: the classic
                    # round's host re-verification is the conservative
                    # posture while the device plane is suspect
                    spec_ok = False
                    prelaunched = None
                    dev = self._guard_recover(dev, cluster, context)
            if guard_on:
                GUARD.note_round_clean()
            stats.solve_seconds += time.perf_counter() - t0

            t0 = time.perf_counter()
            # node index → bucket G of its claims this round: a node
            # accepts claims from ONE bucket per round, so per-node
            # application order stays pod-index order
            node_claimed: Dict[int, int] = {}
            spec_winners = None
            if spec_round:
                # the device already ran the whole claim loop: expand its
                # packed tensor into per-bucket winner arrays (the native
                # apply's direct input); the capacity select is skipped
                spec_winners, node_claimed = self._expand_speculative(
                    spec, claims_np, counts_np, cluster
                )
            winners: Dict[int, tuple] = {}
            for G, (pods, out) in bucket_out.items():
                if not apply:
                    # dry-run: every pod reports its own snapshot match
                    n_cands = (out.val > 0).sum(axis=1)
                    for t, pod_i in zip(pods.pod_type, pods.pod_index):
                        t = int(t)
                        if n_cands[t] > 0:
                            claims.append(
                                (int(pod_i), int(out.idx[t, 0]), G, t, 0)
                            )
                    continue
                w = self._select_winners(pods, out, node_claimed, G)
                if w is not None:
                    winners[G] = (pods, *w)
            claims.sort()
            applied_on_node: set = set()
            stats.select_seconds += time.perf_counter() - t0

            if not claims and not winners and not spec_winners:
                if spec_round:
                    # an empty speculation is not a saturation verdict:
                    # fall through to a classic round
                    stats.round_end_seconds.append(
                        time.perf_counter() - t_batch
                    )
                    continue
                break  # no pod could be placed: remaining are unschedulable

            t0 = time.perf_counter()
            newly_scheduled: List[int] = []

            round_ok = (
                apply
                and fast is not None
                and fast.round_supported()
                and all(
                    fast.round_ok_for(po)
                    for po in (
                        [v[0] for v in spec_winners.values()]
                        if spec_round
                        else [bucket_out[G][0] for G in bucket_out]
                    )
                )
            )
            if spec_round and not round_ok:
                # object-assignment fallback consumes claim tuples + a
                # synthetic RankHost — materialize them from the arrays
                claims, bucket_out = self._spec_tuples(spec_winners)
            elif not round_ok and winners:
                # object-assignment fallback: pod-sorted claim tuples from
                # the vectorized winner arrays
                claims = [
                    (int(p), int(n), G, int(t), int(j))
                    for G, (_po, w_pod, w_node, w_type, w_rank) in (
                        winners.items()
                    )
                    for p, n, t, j in zip(
                        w_pod.tolist(), w_node.tolist(),
                        w_type.tolist(), w_rank.tolist(),
                    )
                ]
                claims.sort()
            if round_ok:
                # one native call per bucket places every winner of the
                # round (native/nhd_assign.cc nhd_assign_round) and
                # mutates the packed host state + solver arrays
                native_in = []
                if spec_round:
                    for G, (pods, w_pod, w_node, w_type, w_c, w_m, _a) in (
                        spec_winners.items()
                    ):
                        native_in.append(
                            (G, pods, w_pod, w_node, w_type, w_c, w_m)
                        )
                else:
                    for G, (pods, w_pod, w_node, w_type, w_rank) in (
                        winners.items()
                    ):
                        out = bucket_out[G][1]
                        w_c = np.ascontiguousarray(
                            out.best_c[w_type, w_rank], np.int32)
                        w_m = np.ascontiguousarray(
                            out.best_m[w_type, w_rank], np.int32)
                        native_in.append(
                            (G, pods, w_pod, w_node, w_type, w_c, w_m)
                        )
                native_out = []
                t_na = time.perf_counter()
                for G, pods, w_pod, w_node, w_type, w_c, w_m in native_in:
                    buffers = fast.assign_round(
                        pods, w_node, w_type, w_c, w_m,
                        set_busy=self.respect_busy,
                    )
                    native_out.append(
                        (G, pods, w_pod, w_node, w_type, buffers, w_c, w_m)
                    )
                stats.phase_add(
                    "native_assign", time.perf_counter() - t_na, t_na
                )
                # bind stamp = native-verify completion
                stats.round_end_seconds.append(time.perf_counter() - t_batch)
                if dev is not None:
                    dev.stage_rows(node_claimed)

                # a winner leaves pending when its assignment succeeded OR
                # it was the first claim its node processed (ran against
                # fresh feasibility: final); later same-node failures are
                # stale contention and retry next round. In the
                # speculative round NO failure is final: its claims were
                # solved against projected state, not a fresh snapshot
                removed: List[np.ndarray] = []
                first_masks: List[np.ndarray] = []
                seen_first: set = set()
                round_rejects = 0
                for G, pods, w_pod, w_node, w_type, buffers, w_c, w_m in (
                    native_out
                ):
                    ok = buffers[0] >= 0
                    round_rejects += int((~ok).sum())
                    if round_no < 8:
                        stats.count_add(f"claims_r{round_no}", len(w_pod))
                        stats.count_add(
                            f"rejects_r{round_no}", int((~ok).sum())
                        )
                    first = np.zeros(len(w_pod), bool)
                    if not spec_round:
                        uniq, fi = np.unique(w_node, return_index=True)
                        fresh = [
                            i for u, i in zip(uniq.tolist(), fi.tolist())
                            if u not in seen_first
                        ]
                        first[fresh] = True
                        seen_first.update(uniq.tolist())
                    first_masks.append(first)
                    removed.append(w_pod[ok | first])
                if removed:
                    pending = pending[
                        ~np.isin(pending, np.concatenate(removed))
                    ]

                # saturation certificate: the megaround exited before its
                # iteration cap with need left, i.e. its last solve found
                # no eligible (type, node) pair against the projected
                # state. With zero native rejects, no PCI type with need
                # and uniform NIC caps with sharing off, the projection
                # upper-bounds true state, so the leftovers are
                # unschedulable without a classic confirmation round
                if (
                    spec_round
                    and len(pending)
                    and spec.certifiable
                    and round_rejects == 0
                    and spec_need_left > 0
                    and spec_it < spec_iters()
                ):
                    stats.count_add(
                        "certified_unschedulable", len(pending)
                    )
                    pending = pending[:0]

                # launch round r+1's solves NOW: the materialization below
                # runs under the next round's kernels. The launch seconds
                # shift the assign-phase clock (they are solve work)
                if (
                    pipeline_on
                    and len(pending)
                    and round_no + 1 < self.max_rounds
                ):
                    t0 += _prelaunch()

                t_mat = time.perf_counter()
                U_, K_ = cluster.U, cluster.K
                names = cluster.names
                register = self.register_pods
                BA_make = BatchAssignment._make
                for bi, (G, pods, w_pod, w_node, w_type, buffers, w_c, w_m) in (
                    enumerate(native_out)
                ):
                    status = buffers[0]
                    ok = status >= 0
                    w_node_l = w_node.tolist()
                    applied_on_node.update(w_node_l)
                    if not bool(ok.all()):
                        # failure pass: a first-on-node failure is final
                        first = first_masks[bi]
                        w_pod_all = w_pod.tolist()
                        for w in np.nonzero(~ok)[0].tolist():
                            if spec_round or not first[w]:
                                continue
                            pod_i, n = w_pod_all[w], w_node_l[w]
                            item = items[pod_i]
                            self.logger.error(
                                f"assignment failed for {item.key} on "
                                f"{names[n]}: stage {int(status[w])}"
                            )
                            results[pod_i] = BatchAssignment(
                                item.key, None, failed=True
                            )
                            stats.failed += 1
                        sel = np.nonzero(ok)[0]
                        n_ok = len(sel)
                        if n_ok == 0:
                            continue
                        widx_l = sel.tolist()
                        pods_sel = w_pod[sel].tolist()
                        nodes_sel = w_node[sel].tolist()
                        types_sel = w_type[sel]
                        cc, mm = w_c[sel], w_m[sel]
                        pp, rows_sel = buffers[5][sel], buffers[3][sel]
                    else:
                        n_ok = len(w_node_l)
                        widx_l = range(n_ok)
                        pods_sel = w_pod.tolist()
                        nodes_sel = w_node_l
                        types_sel = w_type
                        cc, mm = w_c, w_m
                        pp, rows_sel = buffers[5], buffers[3]
                    busy_nodes.update(nodes_sel)
                    # the NIC pick is re-selected against live state in
                    # the native call: decode the actual choices, once
                    # per distinct (combo, misc, pick) point
                    uq, inv = _unique_rows((cc, mm, pp))
                    mappings = [
                        decode_mapping(G, U_, K_, c_, m_, a_)
                        for c_, m_, a_ in uq.tolist()
                    ]
                    maps_sel = [mappings[i] for i in inv.ravel().tolist()]
                    names_sel = [names[n] for n in nodes_sel]
                    types_l = types_sel.tolist()
                    # consumed-NIC tuples, built once per distinct
                    # (type, per-group NIC row) key
                    rows2d = np.asarray(rows_sel).reshape(n_ok, -1)
                    uqk, ninv = _unique_rows(
                        # the selected winners' types: a host array
                        (np.asarray(types_sel),)  # nhdlint: ignore[NHD107]
                        + tuple(rows2d[:, g] for g in range(rows2d.shape[1]))
                    )
                    nic_tmpl: Dict[int, list] = {
                        t: [
                            (g, bw, d)
                            for g, grp in enumerate(pods.requests[t].groups)
                            for bw, d in (
                                (grp.nic_rx_gbps, NicDir.RX),
                                (grp.nic_tx_gbps, NicDir.TX),
                            )
                            if bw > 0
                        ]
                        for t in set(uqk[:, 0].tolist())
                    }
                    nics = [
                        tuple((row[g], bw, d) for g, bw, d in nic_tmpl[t])
                        for t, *row in uqk.tolist()
                    ]
                    nic_sel = [nics[i] for i in ninv.ravel().tolist()]
                    # the rows a topology fill reads (final sync), each
                    # buffer converted once; the plan of a type at its
                    # first pod
                    rows = None
                    plan_of: Dict[int, TopologyPlan] = {}
                    for w, pod_i, nm, n, t, mp, nl in zip(
                        widx_l, pods_sel, names_sel, nodes_sel, types_l,
                        maps_sel, nic_sel,
                    ):
                        item = items[pod_i]
                        results[pod_i] = BA_make((
                            item.key, nm, mp, nl, round_no, False,
                        ))
                        if item.topology is None:
                            if not register:
                                continue
                            plan = plan_of.get(t)
                            if plan is None:
                                plan, built = plan_for(pods.requests[t])
                                plan_of[t] = plan
                                plans_built += built
                        else:
                            plan = None
                        if rows is None:
                            rows = (
                                buffers[1].tolist(), buffers[2].tolist(),
                                buffers[3].tolist(),
                                fast.gpu_devid[
                                    w_node[:, None], buffers[4]
                                ].tolist(),
                            )
                        records[pod_i] = (
                            plan, n, rows[0][w], rows[1][w], rows[2][w],
                            rows[3][w],
                        )
                    stats.scheduled += n_ok
                stats.phase_add(
                    "materialize", time.perf_counter() - t_mat, t_mat
                )
                stats.assign_seconds += time.perf_counter() - t0
                continue

            for pod_i, n, G, t, j in claims:
                pods, out = bucket_out[G]
                mapping = decode_mapping(
                    G, cluster.U, cluster.K,
                    int(out.best_c[t, j]), int(out.best_m[t, j]),
                    int(out.best_a[t, j]),
                )
                node = node_list[n]
                item = items[pod_i]
                if not apply:
                    # dry-run: snapshot match per pod
                    results[pod_i] = BatchAssignment(
                        item.key, node.name, mapping, None, round_no
                    )
                    newly_scheduled.append(pod_i)
                    continue

                if (
                    self.respect_busy
                    and item.request.needs_gpu
                    and cluster.busy[n]
                ):
                    # node took a placement earlier this round: defer
                    continue

                is_first = n not in applied_on_node
                applied_on_node.add(n)

                if fast is not None:
                    try:
                        rec = fast.assign(n, mapping, item.request)
                    except FastAssignError as exc:
                        if not is_first or spec_round:
                            continue  # stale same-node claim: retry
                        self.logger.error(
                            f"assignment failed for {item.key} on {node.name}: {exc}"
                        )
                        results[pod_i] = BatchAssignment(item.key, None, failed=True)
                        newly_scheduled.append(pod_i)
                        stats.failed += 1
                        continue
                    records[pod_i] = rec
                    busy_nodes.add(n)
                    if self.respect_busy:
                        cluster.busy[n] = True
                    # report the realized NIC picks (assign may re-select
                    # against live state under multi-claim)
                    realized = {
                        "gpu": mapping["gpu"],
                        "cpu": mapping["cpu"],
                        "nic": tuple(ga.nic_uk for ga in rec.groups),
                    }
                    results[pod_i] = BatchAssignment(
                        item.key, node.name, realized, rec.nic_list, round_no
                    )
                    newly_scheduled.append(pod_i)
                    stats.scheduled += 1
                    continue

                # object path (reference-style, for cross-checking)
                try:
                    top = item.topology or request_to_topology(item.request)
                except ValueError as exc:
                    self.logger.error(
                        f"cannot materialize topology for {item.key}: {exc}"
                    )
                    results[pod_i] = BatchAssignment(item.key, None, failed=True)
                    newly_scheduled.append(pod_i)
                    stats.failed += 1
                    continue
                node.set_busy(now)
                try:
                    nic_list = node.assign_physical_ids(mapping, top)
                except AssignmentError as exc:
                    if not is_first or spec_round:
                        continue  # stale same-node claim: retry
                    self.logger.error(
                        f"assignment failed for {item.key} on {node.name}: {exc}"
                    )
                    results[pod_i] = BatchAssignment(item.key, None, failed=True)
                    newly_scheduled.append(pod_i)
                    stats.failed += 1
                    continue
                nidx = sorted({x[0] for x in nic_list})
                node.claim_nic_pods(nidx)
                node.add_scheduled_pod(item.key[1], item.key[0], top)
                if self.respect_busy:
                    cluster.busy[n] = True
                results[pod_i] = BatchAssignment(
                    item.key, node.name, mapping, nic_list, round_no
                )
                newly_scheduled.append(pod_i)
                stats.scheduled += 1
            stats.assign_seconds += time.perf_counter() - t0

            # the fast path maintained the arrays at assign time; the
            # object path re-projects claimed rows
            t0 = time.perf_counter()
            if fast is None:
                for n in node_claimed:
                    refresh_node_row(cluster, n, node_list[n], now=now)
                    if not self.respect_busy:
                        cluster.busy[n] = False
            if dev is not None and apply:
                dev.stage_rows(node_claimed)
            stats.assign_seconds += time.perf_counter() - t0
            stats.round_end_seconds.append(time.perf_counter() - t_batch)

            if newly_scheduled:
                pending = pending[~np.isin(pending, newly_scheduled)]
            if not apply:
                break  # without claims, later rounds would repeat choices
            if pipeline_on and len(pending) and round_no + 1 < self.max_rounds:
                _prelaunch()

        if prelaunched is not None:
            # the batch ended with a launch in flight (its pods all
            # settled): wait for it so no copy outlives the call. Every
            # claim is applied by now, so a transient fault here costs
            # only the resident state, which recovers for the next batch
            try:
                for _G, _pods, pull in prelaunched:
                    pull.numpy()
            except Exception as exc:
                if not guard_on or GUARD.on_fault(
                    exc, rung=_rung_of(dev), attempt=1,
                ) != "retry":
                    raise
                self._guard_recover(dev, cluster, context)

        # fast path: one final sync of the HostNode mirror + topology fills
        if fast is not None:
            t0 = time.perf_counter()
            fast.sync_to_nodes()
            for n in busy_nodes:
                node_list[n].set_busy(now)
            t_fill = time.perf_counter()
            register = self.register_pods
            planned = given = 0
            for pod_i, rec in records.items():
                item = items[pod_i]
                if type(rec) is tuple:
                    # the round path's rows (topology_plan.py)
                    plan, n, cores, counts, nics, gpu_ids = rec
                    node = node_list[n]
                    if plan is None:
                        fill_given(item.topology, item.request, cores,
                                   counts, nics, gpu_ids, node)
                        given += 1
                        top = item.topology
                        if not register:
                            continue
                    else:
                        try:
                            top = plan.build(cores, nics, gpu_ids, node)
                        except ValueError as exc:
                            self.logger.warning(
                                f"skipping pod registration for "
                                f"{item.key}: {exc}"
                            )
                            continue
                        planned += 1
                    node.add_scheduled_pod(item.key[1], item.key[0], top)
                    continue
                node = node_list[rec.node_index]
                if item.topology is not None:
                    apply_record_to_topology(rec, item.topology)
                    if self.register_pods:
                        node.add_scheduled_pod(
                            item.key[1], item.key[0], item.topology
                        )
                elif self.register_pods:
                    try:
                        top = request_to_topology(item.request)
                    except ValueError as exc:
                        # the pod IS scheduled (claims applied); only the
                        # bookkeeping object can't be synthesized
                        self.logger.warning(
                            f"skipping pod registration for {item.key}: {exc}"
                        )
                        continue
                    apply_record_to_topology(rec, top)
                    node.add_scheduled_pod(item.key[1], item.key[0], top)
            stats.count_add("fill_planned", planned)
            stats.count_add("fill_given", given)
            stats.count_add("topology_plans_built", plans_built)
            if trace is not None:
                # final_sync's child: the per-pod topology fill
                _span(trace, "topology_fill", t_fill, cat="phase",
                      corr=stats.corr)
            stats.phase_add("final_sync", time.perf_counter() - t0, t0)
            stats.assign_seconds += time.perf_counter() - t0

        t_bf = time.perf_counter()
        for i in range(len(items)) if offer is None else offer:
            if results[i] is None:
                results[i] = BatchAssignment(items[i].key, None)
        stats.phase_add("backfill", time.perf_counter() - t_bf, t_bf)

        # flight-recorder spans: per-round intervals from the first
        # round's start, and one span of the whole call around every phase
        if trace is not None:
            prev = 0.0
            for r, end in enumerate(stats.round_end_seconds):
                trace.record(
                    f"round{r}", t_batch + _PERF_TO_MONO + prev,
                    max(end - prev, 0.0), cat="solver", corr=stats.corr,
                    attrs={
                        "claims": stats.counters.get(f"claims_r{r}"),
                        "rejects": stats.counters.get(f"rejects_r{r}"),
                    },
                )
                prev = end
            _span(trace, "schedule", t_call, cat="solver", corr=stats.corr,
                  attrs={"pods": len(items), "rounds": stats.rounds,
                         "scheduled": stats.scheduled,
                         "failed": stats.failed})
        return results, stats
