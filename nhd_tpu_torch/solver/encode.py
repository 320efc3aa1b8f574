"""Dense tensor encodings of cluster state and pod batches.

Host-side HostNode objects stay the source of truth (SURVEY §5.4 stance:
device state must always be re-derivable from host state); this module
projects them into packed numpy arrays the jitted solver consumes, and
dedupes a pod batch into *types* — identical PodRequests share one solver
row, which is what makes gang batches (a TriadSet scaling to thousands of
replicas, BASELINE config 4) cheap: feasibility is O(types × nodes), not
O(pods × nodes).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.core.request import PodRequest
from nhd_tpu_torch.core.topology import MapMode

# policy score-term inputs (node_class rows, per-type score rows):
# imported at module load, NOT lazily inside the encode functions — the
# first encode sits inside the timed first-bind window, and the lazy
# import showed up as a ~3 ms first_bind_prewarmed regression on the
# bench-smoke gate. No cycle: nhd_tpu.policy never imports the solver.
from nhd_tpu_torch.policy.classes import MAX_CLASSES, node_class_index
from nhd_tpu_torch.policy.scoring import score_row

MAX_GROUP_BITS = 63  # node-group bitmask width (int64, sign bit unused)


class GroupInterner:
    """Node-group names → bit positions, shared across cluster and pods."""

    def __init__(self) -> None:
        self._bits: Dict[str, int] = {}

    def mask(self, names) -> int:
        m = 0
        for name in names:
            bit = self._bits.get(name)
            if bit is None:
                bit = len(self._bits)
                if bit >= MAX_GROUP_BITS:
                    raise ValueError(
                        f"more than {MAX_GROUP_BITS} distinct node groups"
                    )
                self._bits[name] = bit
            m |= 1 << bit
        return m

    def known(self, names) -> bool:
        """Whether every name already has a bit — ``mask(names)`` would
        not grow the interner. The delta layer's new-group-bit fallback
        trigger (ClusterDelta) asks this before patching a row: bit
        positions depend on interning ORDER, so a bit minted by event
        order instead of node-iteration order would break the
        re-derivability contract."""
        bits = self._bits
        return all(n in bits for n in names)

    @property
    def n_bits(self) -> int:
        return len(self._bits)


@dataclass
class ClusterArrays:
    """Packed per-node state. Shapes: N nodes, U NUMA (padded), K NICs/NUMA
    (padded), S PCIe switches per node (padded)."""

    names: List[str]
    U: int
    K: int
    S: int
    numa_nodes: np.ndarray     # [N] int8
    smt: np.ndarray            # [N] bool
    active: np.ndarray         # [N] bool
    maintenance: np.ndarray    # [N] bool
    busy: np.ndarray           # [N] bool (pre-resolved against `now`)
    gpuless: np.ndarray        # [N] bool — node has zero GPUs total
    group_mask: np.ndarray     # [N] int64
    hp_free: np.ndarray        # [N] int32
    cpu_free: np.ndarray       # [N, U] int32 — fully-free physical cores
    gpu_free: np.ndarray       # [N, U] int32
    nic_count: np.ndarray      # [N, U] int32
    nic_free: np.ndarray       # [N, U, K, 2] float32 — rx/tx headroom Gbps
    nic_sw: np.ndarray         # [N, U, K] int32 — dense per-node switch id, -1 none
    gpu_free_sw: np.ndarray    # [N, S] int32 — free GPUs per dense switch id
    node_class: np.ndarray     # [N] int32 — hardware-generation class index
    #                            (policy/classes.py process-global interner;
    #                            0 = default class). Scored against the
    #                            per-type class_score rows in the fused
    #                            megaround; all-zero scoring leaves
    #                            placements bit-exact with the pre-policy
    #                            ranking.
    interner: GroupInterner = field(default_factory=GroupInterner)
    # every node's NICs share one capacity (speed): with NIC sharing off,
    # candidacy then depends only on free-NIC COUNTS per NUMA, which the
    # speculative loop tracks exactly — the precondition for its
    # saturation certificate (solver/speculate.py)
    uniform_nic_caps: bool = False

    @property
    def n_nodes(self) -> int:
        return len(self.names)


def cluster_dims(nodes) -> Tuple[int, int, int]:
    """(U, K, S) padding dims for a node collection: max NUMA nodes, max
    NICs per NUMA, max PCIe switches per node. The single source of the
    rule — streaming's oversized routing (solver/streaming.py) must judge
    tractability with exactly the dims the tile encodes will use."""
    nl = list(nodes.values()) if isinstance(nodes, dict) else list(nodes)
    U = max((n.numa_nodes for n in nl), default=1) or 1
    K = 1
    S = 1
    for node in nl:
        per_numa = [0] * node.numa_nodes
        for nic in node.nics:
            if nic.numa_node < node.numa_nodes:
                per_numa[nic.numa_node] += 1
        K = max(K, max(per_numa, default=0))
        switches = {g.pciesw for g in node.gpus} | {n.pciesw for n in node.nics}
        S = max(S, len(switches))
    return U, K, S


class EncodeStatic:
    """Cross-node index vectors for the batched cluster encode.

    Everything here depends only on hardware topology (packed by
    core/node.py _pack_state), not on allocation state, so one instance
    serves every encode over the same node set; the per-encode work
    reduces to a few concatenates, bincounts and scatters over flat
    vectors instead of ~10 small numpy calls per node."""

    def __init__(self, nl: List[HostNode], U: int, K: int, S: int):
        import numpy as np

        self.node_objs = nl  # pins the nodes (id-keyed cache safety)
        N = len(nl)
        self.U, self.K, self.S = U, K, S

        # --- cores: flat positions of every physical core + its sibling ---
        offs = np.cumsum([0] + [len(n.cores) for n in nl])
        self.core_off = offs
        phys_idx, sib_idx, cpu_code = [], [], []
        for i, n in enumerate(nl):
            phys = n.cores_per_proc * n.sockets
            base = offs[i]
            p = np.arange(phys, dtype=np.int64) + base
            phys_idx.append(p)
            # SMT sibling of physical core c is c + phys (identity layout,
            # checked by _pack_state); without SMT the "sibling" is the
            # core itself, making the pair test a no-op
            sib_idx.append(p + phys if n.smt_enabled else p)
            cpu_code.append(
                i * U + n._core_socket[:phys].astype(np.int64)
            )
        self.phys_idx = np.concatenate(phys_idx) if phys_idx else np.zeros(0, np.int64)
        self.sib_idx = np.concatenate(sib_idx) if sib_idx else np.zeros(0, np.int64)
        self.cpu_code = np.concatenate(cpu_code) if cpu_code else np.zeros(0, np.int64)

        # --- gpus ---
        self.gpu_numa_code = np.concatenate(
            [i * U + n._gpu_numa.astype(np.int64) for i, n in enumerate(nl)]
        ) if N else np.zeros(0, np.int64)
        gpu_sw_code = []
        for i, n in enumerate(nl):
            d = n._gpu_sw_dense
            # out-of-range dense ids (> S-1) are dropped from the
            # free-per-switch count, as the per-node path did
            gpu_sw_code.append(np.where(d < S, i * S + d, -1))
        self.gpu_sw_code = np.concatenate(gpu_sw_code) if gpu_sw_code else np.zeros(0, np.int64)
        self.gpuless = np.array([len(n.gpus) == 0 for n in nl], bool)

        # --- nics (pre-filtered to u < U and k < K) ---
        nic_node, nic_u, nic_k, nic_cap, nic_swd, nic_sel = [], [], [], [], [], []
        for i, n in enumerate(nl):
            nb = len(n.nics)
            if not nb:
                continue
            valid = (n._nic_u < U) & (n._nic_k < K)
            nic_sel.append((i, valid))
            nic_node.append(np.full(int(valid.sum()), i, np.int64))
            nic_u.append(n._nic_u[valid].astype(np.int64))
            nic_k.append(n._nic_k[valid].astype(np.int64))
            nic_cap.append(n._nic_cap[valid])
            nic_swd.append(n._nic_sw_dense[valid])
        z = np.zeros(0, np.int64)
        self.nic_node = np.concatenate(nic_node) if nic_node else z
        self.nic_u = np.concatenate(nic_u) if nic_u else z
        self.nic_k = np.concatenate(nic_k) if nic_k else z
        self.nic_cap = np.concatenate(nic_cap) if nic_cap else np.zeros(0)
        self.nic_sw_dense = np.concatenate(nic_swd) if nic_swd else z
        self.nic_sel = nic_sel  # (node index, valid mask) per NIC-bearing node

        # fully static matrices, copied into each ClusterArrays
        self.numa_nodes = np.array([n.numa_nodes for n in nl], np.int8)
        self.smt = np.array([n.smt_enabled for n in nl], bool)
        self.nic_count_mat = np.zeros((N, U), np.int32)
        for i, n in enumerate(nl):
            if len(n.nics):
                cnt = n._nic_cnt[:U]
                self.nic_count_mat[i, : len(cnt)] = np.minimum(cnt, K)
        self.nic_sw_mat = np.full((N, U, K), -1, np.int32)
        self.nic_sw_mat[self.nic_node, self.nic_u, self.nic_k] = self.nic_sw_dense

        # hardware-generation class indices (policy/classes.py): static
        # per pack generation (node_class only changes on a label
        # reparse, which bumps _pack_gen and misses this cache), and the
        # process-global interner never re-maps a name, so the resolved
        # indices are safe to cache
        self.node_class = np.array(
            [node_class_index(n) for n in nl], np.int32
        )


# id-keyed EncodeStatic cache. The entries pin their node lists, keeping
# the id() keys valid (same pattern as FastCluster._bucket_arrays — an
# unpinned id key can be reused by CPython and serve wrong data)
_ENC_STATIC: Dict[tuple, EncodeStatic] = {}


def _encode_static(nl: List[HostNode], U: int, K: int, S: int) -> EncodeStatic:
    from nhd_tpu_torch.core.node import pack_generation_key

    key = pack_generation_key(nl, U, K, S)
    st = _ENC_STATIC.get(key)
    if st is None:
        if len(_ENC_STATIC) >= 8:
            _ENC_STATIC.clear()
        st = EncodeStatic(nl, U, K, S)
        _ENC_STATIC[key] = st
    return st


def encode_cluster(
    nodes: Dict[str, HostNode],
    *,
    now: Optional[float] = None,
    interner: Optional[GroupInterner] = None,
    dims: Optional[Tuple[int, int, int]] = None,
) -> ClusterArrays:
    """Project HostNodes into dense arrays (one row per node, name order =
    dict insertion order = the reference's node iteration order).

    Batched across nodes: allocation state is concatenated from the
    packed per-node arrays and every output matrix is computed with a
    few global vector ops (EncodeStatic caches the index vectors). Falls
    back to the per-node refresh loop when any node lacks the identity
    core layout the packed path needs.

    ``dims``: force the (U, K, S) padding instead of deriving it from
    the node set. Must cover the nodes' natural dims (smaller would
    silently drop NICs/switches — refused loudly). The delta layer's
    parity check uses this to compare against incrementally-maintained
    arrays whose padding outlived the node that demanded it."""
    names = list(nodes.keys())
    nl = [nodes[n] for n in names]
    N = len(nl)
    nat_U, nat_K, nat_S = cluster_dims(nl)
    if dims is None:
        U, K, S = nat_U, nat_K, nat_S
    else:
        U, K, S = dims
        if U < nat_U or K < nat_K or S < nat_S:
            raise ValueError(
                f"forced dims {dims} below the node set's natural "
                f"({nat_U}, {nat_K}, {nat_S}) — NICs/switches would be "
                "silently dropped"
            )

    interner = interner or GroupInterner()
    arr = ClusterArrays(
        names=names, U=U, K=K, S=S,
        numa_nodes=np.zeros(N, np.int8),
        smt=np.zeros(N, bool),
        active=np.zeros(N, bool),
        maintenance=np.zeros(N, bool),
        busy=np.zeros(N, bool),
        gpuless=np.zeros(N, bool),
        group_mask=np.zeros(N, np.int64),
        hp_free=np.zeros(N, np.int32),
        cpu_free=np.zeros((N, U), np.int32),
        gpu_free=np.zeros((N, U), np.int32),
        nic_count=np.zeros((N, U), np.int32),
        nic_free=np.full((N, U, K, 2), -1.0, np.float32),
        nic_sw=np.full((N, U, K), -1, np.int32),
        gpu_free_sw=np.zeros((N, S), np.int32),
        node_class=np.zeros(N, np.int32),
        interner=interner,
    )
    arr.uniform_nic_caps = all(
        len({nic.speed_gbps for nic in n.nics}) <= 1 for n in nl
    )
    for node in nl:
        node._ensure_packed()
    if N == 0:
        return arr
    if any(n._core_used is None for n in nl):
        for i, node in enumerate(nl):
            refresh_node_row(arr, i, node, now=now)
        return arr

    from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING, MIN_BUSY_SECS

    st = _encode_static(nl, U, K, S)

    arr.numa_nodes[:] = st.numa_nodes
    arr.smt[:] = st.smt
    arr.gpuless[:] = st.gpuless
    arr.node_class[:] = st.node_class
    arr.nic_count[:] = st.nic_count_mat
    arr.nic_sw[:] = st.nic_sw_mat
    arr.active[:] = [n.active for n in nl]
    arr.maintenance[:] = [n.maintenance for n in nl]
    t = time.monotonic() if now is None else now
    arr.busy[:] = (
        np.array([n._busy_time for n in nl]) > t - MIN_BUSY_SECS
    )
    arr.group_mask[:] = [interner.mask(n.groups) for n in nl]
    arr.hp_free[:] = [n.mem.free_hugepages_gb for n in nl]

    # cores: one flat concat + one masked bincount for the whole cluster
    used_flat = np.concatenate([n._core_used for n in nl])
    free_phys = ~used_flat[st.phys_idx] & ~used_flat[st.sib_idx]
    arr.cpu_free[:] = np.bincount(
        st.cpu_code[free_phys], minlength=N * U
    ).reshape(N, U)

    # gpus
    gpu_used_flat = (
        np.concatenate([n._gpu_used for n in nl])
        if st.gpu_numa_code.size
        else np.zeros(0, bool)
    )
    if st.gpu_numa_code.size:
        free_g = ~gpu_used_flat
        arr.gpu_free[:] = np.bincount(
            st.gpu_numa_code[free_g], minlength=N * U
        ).reshape(N, U)
        code = st.gpu_sw_code[free_g]
        code = code[code >= 0]
        arr.gpu_free_sw[:] = np.bincount(
            code, minlength=N * S
        ).reshape(N, S)

    # nics
    if st.nic_node.size:
        bw = np.concatenate(
            [nl[i]._nic_bw[valid] for (i, valid) in st.nic_sel]
        )
        pods = np.concatenate(
            [nl[i]._nic_pods[valid] for (i, valid) in st.nic_sel]
        )
        if ENABLE_NIC_SHARING:
            free = st.nic_cap[:, None] - bw
        else:
            cap = np.where(pods > 0, 0.0, st.nic_cap)
            free = np.stack([cap, cap], axis=1)
        arr.nic_free[st.nic_node, st.nic_u, st.nic_k] = free
    return arr


def refresh_node_row(
    arr: ClusterArrays, i: int, node: HostNode, *, now: Optional[float] = None
) -> None:
    """Re-project one node into row *i* (incremental update path).

    Vector ops over the node's packed state (core/node.py _pack_state) —
    this runs once per node per batch (encode_cluster), so per-component
    Python loops here used to dominate the whole non-solve budget at
    1000-node scale. ``free_bw`` semantics are inlined vectorized
    (reference: Node.py:283-296)."""
    from nhd_tpu_torch.core.node import ENABLE_NIC_SHARING

    node._ensure_packed()
    U, K, S = arr.U, arr.K, arr.S
    arr.numa_nodes[i] = node.numa_nodes
    arr.smt[i] = node.smt_enabled
    arr.active[i] = node.active
    arr.maintenance[i] = node.maintenance
    arr.busy[i] = node.is_busy(now)
    arr.gpuless[i] = len(node.gpus) == 0
    arr.group_mask[i] = arr.interner.mask(node.groups)
    arr.hp_free[i] = node.mem.free_hugepages_gb
    arr.node_class[i] = node_class_index(node)

    arr.cpu_free[i] = 0
    cpu = node.free_cpu_cores_per_numa()
    arr.cpu_free[i, : len(cpu)] = cpu

    arr.gpu_free[i] = 0
    gpu = node.free_gpus_per_numa()
    arr.gpu_free[i, : len(gpu)] = gpu

    arr.nic_count[i] = 0
    arr.nic_free[i] = -1.0
    arr.nic_sw[i] = -1

    nb = len(node.nics)
    if nb:
        cnt = node._nic_cnt[:U]
        # per-NUMA ordinals are dense (0..count-1) so every k < K for
        # dims from cluster_dims; the clip only guards foreign dims
        arr.nic_count[i, : len(cnt)] = np.minimum(cnt, K)
        u, k = node._nic_u, node._nic_k
        valid = (u < U) & (k < K)
        uu, kk = u[valid], k[valid]
        if ENABLE_NIC_SHARING:
            free = node._nic_cap[valid, None] - node._nic_bw[valid]
        else:
            cap = np.where(node._nic_pods[valid] > 0, 0.0, node._nic_cap[valid])
            free = np.stack([cap, cap], axis=1)
        arr.nic_free[i, uu, kk, 0] = free[:, 0]
        arr.nic_free[i, uu, kk, 1] = free[:, 1]
        arr.nic_sw[i, uu, kk] = node._nic_sw_dense[valid]

    arr.gpu_free_sw[i] = 0
    if len(node.gpus):
        d = node._gpu_sw_dense[~node._gpu_used]
        d = d[d < S]
        arr.gpu_free_sw[i] = np.bincount(d, minlength=S)[:S]


# ---------------------------------------------------------------------------
# Incremental cluster state — the delta layer (docs/PERFORMANCE.md
# "Incremental device-resident state")
# ---------------------------------------------------------------------------
#
# encode_cluster re-projects all N nodes per call; at event rates the
# scheduler re-pays O(N) host work per round for a stream that touches
# O(changed) nodes. ClusterDelta keeps ONE ClusterArrays alive and patches
# it row-by-row as events arrive: watch events (cordon/maintenance/group),
# claim/release churn, and structural node add/remove — the latter through
# padded-capacity row slots (adds append inside the power-of-two capacity
# bucket; removals tombstone their row in place) with periodic compaction.
# Anything a row patch cannot express detects itself and falls back to a
# LOGGED full rebuild through encode_cluster — the one sanctioned rebuild
# chokepoint (nhdlint NHD108): host HostNode objects stay the source of
# truth and the resident arrays stay re-derivable (SURVEY §5.4), verified
# continuously by ``parity_errors``.

#: every per-row array of ClusterArrays, in _ARG_ORDER (kernel.py) order —
#: the delta layer's row patches and the device row scatter share it
DELTA_FIELDS = (
    "numa_nodes", "smt", "active", "maintenance", "busy", "gpuless",
    "group_mask", "hp_free", "cpu_free", "gpu_free", "nic_count",
    "nic_free", "nic_sw", "gpu_free_sw", "node_class",
)

#: the bounded rebuild-reason vocabulary (NHD603: the metrics label set
#: must be finite — anything novel folds into "other")
REBUILD_REASONS = (
    "init", "dims-overflow", "capacity", "new-group", "tombstone-readd",
    "compaction", "generation", "drift", "manual",
)

_REBUILD_LOCK = threading.Lock()
_REBUILD_COUNTS: Dict[str, int] = {}

# live deltas, for the resident-age gauge: one process can hold several
# (the streaming tiler keeps one per tile), and a per-instance write
# would make the gauge last-writer-wins — the operator question is "how
# stale is the OLDEST resident state", so the gauge reports the max age
# over live instances. WeakSet: a dropped context must not pin its delta
# (or hold the age forever).
import weakref

_LIVE_DELTAS: "weakref.WeakSet" = weakref.WeakSet()


def resident_age_seconds() -> float:
    """Max seconds since the last full rebuild over every live
    ClusterDelta (0.0 when none exist)."""
    now = time.monotonic()
    with _REBUILD_LOCK:
        return max(
            (now - d.last_rebuild_monotonic for d in _LIVE_DELTAS),
            default=0.0,
        )


def _count_rebuild(reason: str) -> None:
    if reason not in REBUILD_REASONS:
        reason = "other"
    with _REBUILD_LOCK:
        _REBUILD_COUNTS[reason] = _REBUILD_COUNTS.get(reason, 0) + 1


def rebuild_reasons_snapshot() -> Dict[str, int]:
    """{reason: count} of full rebuilds this process ran (rendered as
    nhd_device_state_rebuilds_total{reason=...} by rpc/metrics.py)."""
    with _REBUILD_LOCK:
        return dict(_REBUILD_COUNTS)


def reset_delta_metrics() -> None:
    """Test isolation: zero the rebuild-reason registry."""
    with _REBUILD_LOCK:
        _REBUILD_COUNTS.clear()


def _counters():
    from nhd_tpu_torch.k8s.retry import API_COUNTERS

    return API_COUNTERS


def _pad_cap(n: int, floor: int = 8) -> int:
    """Row capacity for *n* live nodes: the power-of-two bucket (same
    rule as kernel.pad_nodes on one device, duplicated here to keep
    encode free of kernel/jax imports). Capacity == the device padding,
    so adds inside the bucket are pure row scatters and crossing it is
    a rebuild — which retraces the jitted programs anyway (the node
    axis is a specializing dim)."""
    p = floor
    while p < n:
        p *= 2
    return p


class ClusterDelta:
    """Incrementally-maintained ClusterArrays over a live HostNode dict.

    ``nodes`` is the LIVE dict (the scheduler's mirror, or a streaming
    tile's slice) — callers mutate it as usual and tell the delta which
    names an event touched via ``note``; ``refresh`` folds the noted
    names into the packed arrays as row patches and returns control with
    ``drain_dirty`` carrying exactly the changed row indices (the device
    layer scatters those rows, solver/device_state.py).

    Row order: the delta's view preserves the live dict's insertion
    order (removals tombstone in place — Python dicts preserve relative
    order on deletion — and adds append), so live rows read in physical
    order are bit-exact with a from-scratch ``encode_cluster`` at the
    delta's padding dims. ``parity_errors`` checks exactly that.

    Fallbacks — events a row patch cannot express trigger a logged full
    rebuild (counted per reason, bounded vocabulary):

    * ``dims-overflow``   — a node demands more U/K/S padding
    * ``capacity``        — adds exhausted the power-of-two row bucket
    * ``new-group``       — a node brings an uninterned group name (bit
                            positions depend on interning order)
    * ``tombstone-readd`` — a removed node's name re-added while its
                            tombstone row still holds its old slot
    * ``compaction``      — tombstones crossed the occupancy threshold
    * ``generation``      — a node's packed topology was rebuilt (label
                            reparse): every static cache over it is stale
    * ``drift``           — the live dict changed shape without notes
    """

    #: tombstone fraction (of total rows) that triggers compaction
    TOMBSTONE_FRAC = 8  # 1/8

    def __init__(
        self,
        nodes: Dict[str, HostNode],
        *,
        now: Optional[float] = None,
        interner: Optional[GroupInterner] = None,
        respect_busy: bool = True,
    ):
        self.nodes = nodes
        self.interner = interner or GroupInterner()
        self.respect_busy = respect_busy
        self.logger = None  # lazy (utils.get_logger imports logging config)
        #: row-aligned view: live dict order plus in-place tombstones.
        #: Object identity is STABLE across rebuilds (cleared + refilled)
        #: so ScheduleContexts holding it stay valid.
        self.view: Dict[str, HostNode] = {}
        self._names: List[str] = []        # arrays.names IS this list
        self._index: Dict[str, int] = {}
        self._tombstones: Set[str] = set()
        self._stale: Set[str] = set()      # names awaiting a row patch
        self._dirty: Set[int] = set()      # rows changed since drain
        self._pack_gens: Dict[str, int] = {}
        self._buf: Dict[str, np.ndarray] = {}
        self.arrays: Optional[ClusterArrays] = None
        self.capacity = 0
        self.now = time.monotonic() if now is None else now
        self.rebuilds = 0
        self.last_rebuild_monotonic = time.monotonic()
        self._full = True
        with _REBUILD_LOCK:
            _LIVE_DELTAS.add(self)
        self._rebuild("init")

    # -- bookkeeping -----------------------------------------------------

    def _log(self):
        if self.logger is None:
            from nhd_tpu_torch.utils import get_logger

            self.logger = get_logger(__name__)
        return self.logger

    @property
    def n_rows(self) -> int:
        """Physical rows (live + tombstones) the arrays expose."""
        return len(self._names)

    @property
    def dims(self) -> Tuple[int, int, int]:
        a = self.arrays
        return (a.U, a.K, a.S)

    # -- the sanctioned rebuild chokepoint -------------------------------

    def _rebuild(self, reason: str) -> None:
        """Full re-encode from the live dict — the ONE place the delta
        layer pays O(N) host work, entered only by fallback triggers.
        Everything downstream re-derives: capacity buffers reallocate at
        the new power-of-two bucket, tombstones drop, and ``_full`` tells
        the device layer to re-upload wholesale (or rebuild, if the
        capacity bucket changed)."""
        nodes = self.nodes
        fresh = encode_cluster(nodes, now=self.now, interner=self.interner)
        if not self.respect_busy:
            fresh.busy[:] = False
        N = fresh.n_nodes
        cap = _pad_cap(max(N, 1))
        self._buf = {}
        for name in DELTA_FIELDS:
            src = getattr(fresh, name)
            buf = np.zeros((cap, *src.shape[1:]), src.dtype)
            if name == "nic_free":
                buf[...] = -1.0
            elif name == "nic_sw":
                buf[...] = -1
            buf[:N] = src
            self._buf[name] = buf
        self.view.clear()
        self.view.update(nodes)
        self._names[:] = fresh.names
        self._index = {n: i for i, n in enumerate(self._names)}
        self._tombstones.clear()
        self._stale.clear()
        self._dirty.clear()
        self._pack_gens = {n: nodes[n]._pack_gen for n in self._names}
        self.capacity = cap
        if self.arrays is None:
            self.arrays = ClusterArrays(
                names=self._names, U=fresh.U, K=fresh.K, S=fresh.S,
                interner=self.interner,
                **{name: self._buf[name][:N] for name in DELTA_FIELDS},
            )
        else:
            arr = self.arrays
            arr.U, arr.K, arr.S = fresh.U, fresh.K, fresh.S
            for name in DELTA_FIELDS:
                setattr(arr, name, self._buf[name][:N])
        self.arrays.uniform_nic_caps = fresh.uniform_nic_caps
        self._full = True
        self.rebuilds += 1
        self.last_rebuild_monotonic = time.monotonic()
        _count_rebuild(reason)
        c = _counters()
        if reason != "init":
            # the first build is a build, not a fallback: the counter
            # answers "how often did the delta path give up", and a
            # per-tile init storm would drown that signal
            c.inc("device_state_full_rebuilds_total")
        c.set("device_state_resident_age_seconds", resident_age_seconds())
        if reason != "init":
            self._log().warning(
                f"cluster delta: full rebuild ({reason}); {N} nodes at "
                f"capacity {cap}, dims U={fresh.U} K={fresh.K} S={fresh.S}"
            )

    def _reslice(self) -> None:
        """Re-point the ClusterArrays fields at the first n_rows rows of
        the capacity buffers (O(1) views; the object identity callers
        hold never changes)."""
        R = len(self._names)
        arr = self.arrays
        for name in DELTA_FIELDS:
            setattr(arr, name, self._buf[name][:R])

    def rebuild(self, reason: str = "manual") -> None:
        """Force the sanctioned full rebuild (drift repair, claim
        replays: every row changed, so one re-encode beats N patches)."""
        self._rebuild(reason if reason in REBUILD_REASONS else "manual")

    # -- event intake ----------------------------------------------------

    def note(self, name: str) -> None:
        """An event touched node *name* (update, claim/release churn,
        add, or remove — flush() discovers which by diffing against the
        live dict). Cheap and idempotent; safe to over-call."""
        self._stale.add(name)
        _counters().inc("device_state_events_total")

    def note_all(self, names: Iterable[str]) -> None:
        for n in names:
            self.note(n)

    # -- folding notes into the arrays -----------------------------------

    def refresh(self, now: Optional[float] = None) -> None:
        """Bring the arrays current: re-resolve busy against *now*, then
        fold every noted name in as a row patch (or fallback-rebuild).
        Called once per scheduling batch, before the arrays are solved
        against."""
        if now is not None:
            self._refresh_busy(now)
        self.flush()
        _counters().set(
            "device_state_resident_age_seconds", resident_age_seconds()
        )

    def _refresh_busy(self, now: float) -> None:
        """Busy-stamp decay, O(busy rows): only rows currently marked
        busy can decay by time passage (rows BECOME busy through claim
        paths the delta already sees), so the scan walks the busy set,
        not the cluster."""
        self.now = now
        if not self.respect_busy:
            return
        busy = self.arrays.busy
        for i in np.nonzero(busy)[0].tolist():
            name = self._names[i]
            if name in self._tombstones:
                busy[i] = False
                self._dirty.add(i)
                continue
            node = self.view[name]
            if not node.is_busy(now):
                busy[i] = False
                self._dirty.add(i)

    #: dirty-update count above which one BATCHED re-projection of the
    #: live rows beats per-row patches: refresh_node_row costs ~20 small
    #: numpy calls per row, while the EncodeStatic vector path projects
    #: the whole cluster in a handful of global ops — measured
    #: break-even ~N/4 at bench shapes. The bulk path writes the SAME
    #: values (non-noted rows re-project to themselves bit-exactly), so
    #: only the noted rows are marked device-dirty either way.
    BULK_PATCH_DIV = 4

    def flush(self) -> None:
        """Apply every noted name: row patches for updates, padded-slot
        appends for adds, in-place tombstones for removals; fallback
        rebuild for anything else. Clears the note set."""
        if not self._stale:
            return
        stale, self._stale = self._stale, set()
        nodes = self.nodes
        updates: List[str] = []
        adds: Set[str] = set()
        for name in stale:
            live = name in nodes
            idx = self._index.get(name)
            if live and idx is not None and name not in self._tombstones:
                updates.append(name)
            elif live:
                adds.add(name)
            elif idx is not None and name not in self._tombstones:
                self._remove_node(name, idx)
            # else: unknown/already-tombstoned name — nothing to express
        if adds:
            # append in LIVE-DICT order, not note order: several adds in
            # one flush must land in the same relative order a fresh
            # encode would give them (row order == dict order is the
            # parity contract)
            for name in nodes:
                if name in adds and not self._add_node(name, nodes[name]):
                    return  # fell back to a rebuild: notes are subsumed
        if updates:
            live_rows = len(self._names) - len(self._tombstones)
            if len(updates) > max(512, live_rows // self.BULK_PATCH_DIV):
                if not self._bulk_patch(updates):
                    return
            else:
                for name in updates:
                    if not self._patch_row(self._index[name], nodes[name]):
                        return
        if len(self._tombstones) > max(
            4, len(self._names) // self.TOMBSTONE_FRAC
        ):
            self._rebuild("compaction")
            return
        if len(self.view) - len(self._tombstones) != len(nodes):
            # the live dict changed shape without notes — a plumbing gap;
            # rebuild rather than solve against a silently-wrong mirror
            self._rebuild("drift")

    def _bulk_patch(self, updates: List[str]) -> bool:
        """The batched form of _patch_row for storm-sized update sets:
        ONE vectorized re-projection of every live row (EncodeStatic
        path — a handful of global numpy ops) written through the live-
        row index. Values are bit-identical to per-row patches (unpatched
        rows re-project to themselves), so only the noted rows go device-
        dirty. Fallback triggers are checked per noted node first, same
        as the per-row path."""
        nodes = self.nodes
        arr = self.arrays
        for name in updates:
            node = nodes[name]
            if node._pack_gen != self._pack_gens.get(name):
                self._rebuild("generation")
                return False
            if not self.interner.known(node.groups):
                self._rebuild("new-group")
                return False
            nU, nK, nS = cluster_dims([node])
            if nU > arr.U or nK > arr.K or nS > arr.S:
                self._rebuild("dims-overflow")
                return False
        fresh = encode_cluster(
            nodes, now=self.now, interner=self.interner, dims=self.dims
        )
        if not self.respect_busy:
            fresh.busy[:] = False
        live = np.fromiter(
            (
                i for i, n in enumerate(self._names)
                if n not in self._tombstones
            ),
            np.int64,
        )
        if len(live) != fresh.n_nodes:
            self._rebuild("drift")
            return False
        for name in DELTA_FIELDS:
            getattr(arr, name)[live] = getattr(fresh, name)
        index = self._index
        self._dirty.update(index[n] for n in updates)
        _counters().inc("device_state_deltas_total", len(updates))
        return True

    def _patch_row(self, i: int, node: HostNode) -> bool:
        """Re-project one live node into its row. Returns False when the
        event could not be expressed as a patch (rebuild ran)."""
        if node._pack_gen != self._pack_gens.get(node.name):
            # label reparse rebuilt the packed topology: dims may have
            # moved and every id-keyed static cache over this node set
            # (EncodeStatic, FastCluster._build_static) is stale
            self._rebuild("generation")
            return False
        if not self.interner.known(node.groups):
            self._rebuild("new-group")
            return False
        arr = self.arrays
        nU, nK, nS = cluster_dims([node])
        if nU > arr.U or nK > arr.K or nS > arr.S:
            self._rebuild("dims-overflow")
            return False
        refresh_node_row(arr, i, node, now=self.now)
        if not self.respect_busy:
            arr.busy[i] = False
        self._dirty.add(i)
        _counters().inc("device_state_deltas_total")
        return True

    def _add_node(self, name: str, node: HostNode) -> bool:
        """Structural add into a padded-capacity slot (append keeps row
        order == dict order: the live dict appended it too)."""
        if name in self._tombstones:
            # the old incarnation's row still holds a mid-array slot; a
            # patched resurrection there would break row order vs the
            # live dict (which re-inserted at the END)
            self._rebuild("tombstone-readd")
            return False
        if len(self._names) >= self.capacity:
            self._rebuild("capacity")
            return False
        node._ensure_packed()
        arr = self.arrays
        nU, nK, nS = cluster_dims([node])
        if nU > arr.U or nK > arr.K or nS > arr.S:
            self._rebuild("dims-overflow")
            return False
        if not self.interner.known(node.groups):
            self._rebuild("new-group")
            return False
        i = len(self._names)
        self.view[name] = node
        self._names.append(name)
        self._index[name] = i
        self._pack_gens[name] = node._pack_gen
        self._reslice()
        refresh_node_row(arr, i, node, now=self.now)
        if not self.respect_busy:
            arr.busy[i] = False
        # uniformity can only be broken by an add (recheck the newcomer),
        # never restored by one — restoration waits for the next rebuild
        if arr.uniform_nic_caps and len(
            {nic.speed_gbps for nic in node.nics}
        ) > 1:
            arr.uniform_nic_caps = False
        self._dirty.add(i)
        _counters().inc("device_state_deltas_total")
        return True

    def _remove_node(self, name: str, i: int) -> None:
        """Structural remove: tombstone the row in place. The HostNode
        object is retained (deactivated) so row-aligned consumers —
        FastCluster, the serial oracle pre-pass — keep a coherent object
        per row until compaction reclaims the slot."""
        node = self.view[name]
        node.active = False  # the delta owns the lingering object now
        self._tombstones.add(name)
        arr = self.arrays
        arr.active[i] = False
        arr.busy[i] = False
        self._dirty.add(i)
        _counters().inc("device_state_deltas_total")

    # -- device-sync handshake -------------------------------------------

    def consume_full(self) -> bool:
        """True once after a rebuild: the consumer must re-derive its
        resident state wholesale (row scatters cannot express a
        reallocation)."""
        full, self._full = self._full, False
        return full

    def drain_dirty(self) -> np.ndarray:
        """Row indices changed since the last drain (sorted int64),
        clearing the set — the device scatter's worklist."""
        if not self._dirty:
            return np.zeros(0, np.int64)
        rows = np.fromiter(sorted(self._dirty), np.int64, len(self._dirty))
        self._dirty.clear()
        return rows

    # -- re-derivability (SURVEY §5.4) -----------------------------------

    def snapshot(self) -> ClusterArrays:
        """Live rows gathered in order (tombstones dropped) — the
        projection ``parity_errors`` compares against a from-scratch
        encode. O(N); never on the hot path."""
        arr = self.arrays
        live = np.fromiter(
            (
                i for i, n in enumerate(self._names)
                if n not in self._tombstones
            ),
            np.int64,
        )
        names = [self._names[int(i)] for i in live]
        snap = ClusterArrays(
            names=names, U=arr.U, K=arr.K, S=arr.S,
            interner=self.interner,
            **{
                name: getattr(arr, name)[live].copy()
                for name in DELTA_FIELDS
            },
        )
        snap.uniform_nic_caps = arr.uniform_nic_caps
        return snap

    def parity_errors(self, now: Optional[float] = None) -> List[str]:
        """Defects between the incremental arrays and a from-scratch
        ``encode_cluster`` of the live dict at the delta's dims ([] =
        bit-exact). The continuous re-derivability check: chaos wires it
        as a sim invariant, the property test asserts it per batch."""
        self.flush()
        errs: List[str] = []
        snap = self.snapshot()
        ref = encode_cluster(
            self.nodes, now=self.now if now is None else now,
            interner=self.interner, dims=self.dims,
        )
        if not self.respect_busy:
            ref.busy[:] = False
        if snap.names != ref.names:
            errs.append(
                f"row order diverged: {snap.names[:8]}... != "
                f"{ref.names[:8]}..."
            )
            return errs
        if snap.uniform_nic_caps and not ref.uniform_nic_caps:
            # the delta may conservatively UNDER-report uniformity until
            # the next rebuild (a removal can restore it); claiming a
            # uniformity the live set lacks is the defect direction —
            # the speculative certificate would trust it
            errs.append("uniform_nic_caps claimed but the live set mixes")
        for name in DELTA_FIELDS:
            a, b = getattr(snap, name), getattr(ref, name)
            if a.shape != b.shape:
                errs.append(f"{name}: shape {a.shape} != {b.shape}")
            elif not np.array_equal(a, b):
                bad = np.nonzero(a != b)[0]
                rows = sorted({int(r) for r in np.atleast_1d(bad)[:8]})
                errs.append(
                    f"{name} diverged at rows {rows} "
                    f"(nodes {[snap.names[r] for r in rows[:4]]})"
                )
        return errs


@dataclass
class PodTypeArrays:
    """Deduped pod-type tensors for one group-count bucket (G groups)."""

    G: int
    requests: List[PodRequest]      # one exemplar per type, type order
    pod_type: np.ndarray            # [P] int32 — type index of each input pod
    pod_index: np.ndarray           # [P] int64 — original batch positions
    cpu_dem_smt: np.ndarray         # [T, G+1] int32 (node-SMT-enabled demand)
    cpu_dem_raw: np.ndarray         # [T, G+1] int32
    gpu_dem: np.ndarray             # [T, G] int32
    rx: np.ndarray                  # [T, G] float32
    tx: np.ndarray                  # [T, G] float32
    hp: np.ndarray                  # [T] int32
    needs_gpu: np.ndarray           # [T] bool
    map_pci: np.ndarray             # [T] bool
    group_mask: np.ndarray          # [T] int64
    class_score: np.ndarray         # [T, policy.classes.MAX_CLASSES] int32 —
    #                                 quantized per-node-class throughput
    #                                 scores (policy/scoring.py), gathered
    #                                 against node_class in the fused
    #                                 megaround. All-zero with NHD_POLICY=0
    #                                 (the bit-exact placement control).

    @property
    def n_types(self) -> int:
        return len(self.requests)


def encode_pods(
    pods: Sequence[PodRequest],
    interner: GroupInterner,
    indices: Optional[Sequence[int]] = None,
) -> Dict[int, PodTypeArrays]:
    """Bucket a pod batch by group count and dedupe identical requests into
    types. Returns {n_groups: PodTypeArrays}."""
    if indices is None:
        indices = range(len(pods))
    buckets: Dict[int, Tuple[List[PodRequest], List[int], List[int], Dict[PodRequest, int]]] = {}
    # gang batches arrive bucket-coherent, so the per-pod loop caches the
    # last bucket's bindings — this loop runs once per pod of a 10k gang
    # and is most of the encode phase's wall (r5)
    last_g = -1
    reqs: List[PodRequest] = []
    seen: Dict[PodRequest, int] = {}
    types_append = positions_append = None
    for pod, idx in zip(pods, indices):
        G = len(pod.groups)
        if G != last_g:
            b = buckets.get(G)
            if b is None:
                b = buckets[G] = ([], [], [], {})
            reqs, types, positions, seen = b
            types_append = types.append
            positions_append = positions.append
            last_g = G
        t = seen.get(pod)
        if t is None:
            t = len(reqs)
            seen[pod] = t
            reqs.append(pod)
        types_append(t)
        positions_append(idx)

    out: Dict[int, PodTypeArrays] = {}
    for G, (reqs, types, positions, _) in buckets.items():
        T = len(reqs)
        arr = PodTypeArrays(
            G=G,
            requests=reqs,
            pod_type=np.asarray(types, np.int32),
            pod_index=np.asarray(positions, np.int64),
            cpu_dem_smt=np.zeros((T, G + 1), np.int32),
            cpu_dem_raw=np.zeros((T, G + 1), np.int32),
            gpu_dem=np.zeros((T, G), np.int32),
            rx=np.zeros((T, G), np.float32),
            tx=np.zeros((T, G), np.float32),
            hp=np.zeros(T, np.int32),
            needs_gpu=np.zeros(T, bool),
            map_pci=np.zeros(T, bool),
            group_mask=np.zeros(T, np.int64),
            class_score=np.zeros((T, MAX_CLASSES), np.int32),
        )
        for t, r in enumerate(reqs):
            arr.cpu_dem_smt[t] = r.cpu_slot_counts(node_smt=True)
            arr.cpu_dem_raw[t] = r.cpu_slot_counts(node_smt=False)
            arr.gpu_dem[t] = r.gpu_counts()
            for g, (rx, tx) in enumerate(r.nic_bw()):
                arr.rx[t, g] = rx
                arr.tx[t, g] = tx
            arr.hp[t] = r.hugepages_gb
            arr.needs_gpu[t] = r.needs_gpu
            arr.map_pci[t] = r.map_mode == MapMode.PCI
            arr.group_mask[t] = interner.mask(r.node_groups)
            arr.class_score[t] = score_row(r)  # one cached row per kind
        out[G] = arr
    return out
