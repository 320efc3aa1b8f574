"""Streaming solver for federation-scale problems (BASELINE config 5).

The 100k-pod × 10k-node federation config must not materialize one giant
solve: this module tiles the *node axis* into fixed-size tiles (each a
region/cluster of the federation) and streams *pod chunks* through them —
the scheduler-domain analog of blockwise/ring long-axis techniques
(SURVEY §5.7: "block the node axis across devices, stream pod batches
through").

Memory is bounded by (tile_nodes × encode width) + (chunk_pods ×
bookkeeping): each tile owns a persistent ScheduleContext (packed arrays +
FastCluster + device-resident state), so a chunk visiting a
tile pays only for the rows it claims, never a re-encode.

Tiles PIPELINE (VERDICT r2 item 3 — the p99 cut): each tile is a pipeline
stage with its own FIFO of chunks; a chunk's leftover forwards to the
next tile's FIFO the moment the sub-call returns, so tile t works chunk c
while tile t+1 works chunk c-1's spill. Because one worker serves each
tile, a tile processes chunks strictly in arrival order over disjoint
node state — every per-tile claim stream is IDENTICAL to the serial
sweep's, so placement semantics are bit-for-bit unchanged; only the
wall-clock interleaving across tiles differs. Worker threads are capped
by NHD_STREAM_WORKERS (kernel launches are thread-safe and counted under
a lock, nhd_tpu_torch/kernels; the native assign calls release the GIL).

Placement semantics: pods visit tiles in name order and fill earlier
tiles first — the same first-fit shape the reference's sequential walk
produces over one big node list (Matcher.py:393-421 picks the first
candidate), realized tile-by-tile. Every claim is re-verified against
live state exactly as in BatchScheduler; serializability per node is
unchanged. One documented deviation: the gpuless-node selection
preference (Matcher.py:404-416) applies *within* a tile, not globally —
a CPU-only pod takes a feasible GPU node in an early tile rather than a
gpuless node in a later one. That is the federation-locality trade-off
(earlier tiles = nearer regions); on homogeneous clusters placement is
identical to the untiled scheduler (tests/test_streaming.py). Combo-
oversized pods (bucket_tractable=False) take the serial oracle pre-pass
against the full cluster, mirroring BatchScheduler's documented
oversized-first exception.

The port's copy of the reference's nhd_tpu/solver/streaming.py. It
differs in two places only: there is no CPU mesh gate, and the default
worker count reads the scheduler's device type, not a global backend
probe. The reference serializes the tiles' sub-calls on a CPU-backed
mesh (its _CPU_MESH_SOLVE_LOCK) because two in-flight sharded XLA
programs can deadlock in the CPU backend's in-process collectives. The
port's mesh has no in-process collective: a shard's solve is kernel
launches on its device and the merge is copies plus one top-R on the
lead device, issued by the thread that owns the tile, so tiles on a
mesh run concurrently as on one device. ``mesh=`` passes through to each
tile's BatchScheduler, as in the reference. Every tile's solve runs on
``BatchScheduler.device`` (or its mesh's shards); no tile moves to the
CPU, and the first tile error is re-raised.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from nhd_tpu_torch.core.node import HostNode
from nhd_tpu_torch.sanitizer.races import maybe_watch
from nhd_tpu_torch.core.topology import MapMode
from nhd_tpu_torch.solver.batch import (
    BatchAssignment,
    BatchItem,
    BatchScheduler,
    BatchStats,
    ScheduleContext,
)
from nhd_tpu_torch.solver.encode import cluster_dims
from nhd_tpu_torch.solver.kernel import bucket_tractable
from nhd_tpu_torch.utils import get_logger


class StreamingScheduler:
    """Tile the node axis, stream pod chunks through the tiles.

    ``tile_nodes`` bounds the per-solve node count (encode + solve memory);
    ``chunk_pods`` bounds the per-call pod bookkeeping. Remaining keyword
    arguments configure the underlying BatchScheduler (device,
    respect_busy, use_fast, mesh, ...).
    """

    def __init__(
        self,
        *,
        tile_nodes: int = 2048,
        chunk_pods: int = 16384,
        placement: str = "first-fit",
        persistent: bool = False,
        **batch_kwargs,
    ):
        if tile_nodes < 1 or chunk_pods < 1:
            raise ValueError("tile_nodes and chunk_pods must be >= 1")
        if placement not in ("first-fit", "routed"):
            raise ValueError(
                f"placement must be 'first-fit' or 'routed', got {placement!r}"
            )
        self.logger = get_logger(__name__)
        self.tile_nodes = tile_nodes
        self.chunk_pods = chunk_pods
        # ``persistent``: keep every tile's ScheduleContext (packed
        # arrays + FastCluster + device-resident state) alive ACROSS
        # schedule() calls, maintained incrementally by a per-tile
        # ClusterDelta — the scheduler routes inter-call churn in via
        # note_nodes(), and each tile's first offer of a call folds its
        # noted rows in as patches + device row scatters instead of a
        # fresh make_context (O(tile) encode per tile per call → O(
        # changed rows)). Membership or interner-budget changes drop the
        # whole state (counted as delta rebuilds). Single-caller
        # contract: note_nodes/schedule run on the scheduler thread.
        # Solver-guard posture (solver/guard.py): each persistent tile
        # context reposturues at its first offer of a call — a
        # degradation condemns its resident plane down the resident →
        # non-resident ladder, a re-promotion rebuilds it from
        # host truth at the faster rung — via the same
        # make_context/refresh_context chokepoints the solo path uses;
        # a tile whose solve trips the guard terminally fails only its
        # own call (the errored call never banks its state).
        self.persistent = persistent
        self._pstate: Optional[dict] = None
        self._pstale: set = set()
        # 'first-fit': every chunk enters at tile 0 and spills forward —
        # placement identical to the serial sweep (and, on homogeneous
        # clusters, to the untiled scheduler). 'routed': pods are
        # pre-partitioned across tiles by estimated residual capacity and
        # the tiles run CONCURRENTLY (spill still cascades to the next
        # tile) — the federation posture (a pod has no inherent preference
        # for region 0) that turns the pipeline into real parallelism;
        # placement can differ from the serial sweep when estimates err,
        # conservation is unaffected (claims are re-verified as always).
        self.placement = placement
        self.batch = BatchScheduler(**batch_kwargs)

    def note_nodes(self, names) -> None:
        """An event touched these nodes: their tiles' persistent
        contexts patch the rows in at the next schedule() call."""
        if self.persistent:
            self._pstale.update(names)

    def reset_state(self) -> None:
        """Drop the persistent tile contexts (restart-grade mirror
        events: promotion replay, drift repair)."""
        self._pstate = None
        self._pstale.clear()

    def route_notes(self) -> None:
        """Fold pending inter-call churn notes into their owning tiles'
        deltas. schedule() calls this before refreshing contexts; the
        chaos parity invariant calls it so tile state is judged net of
        the note trail, not mid-flight. Notes naming nodes outside the
        persisted membership stay pending (that membership change
        condemns the whole state at the next schedule)."""
        ps = self._pstate
        if ps is None or not self._pstale:
            return
        tile_of = ps["tile_of"]
        keep = set()
        stale, self._pstale = self._pstale, set()
        for name in stale:
            ti = tile_of.get(name)
            if ti is None:
                keep.add(name)
            elif ps["deltas"][ti] is not None:
                ps["deltas"][ti].note(name)
        self._pstale |= keep

    @staticmethod
    def _batch_demand(items, indices) -> Tuple[float, float, float]:
        """Average per-pod (cores, gpus, hugepages) demand of the batch —
        computed ONCE per schedule() (walking 100k pods per tile showed
        up at ~0.7 s in the federation profile)."""
        n = len(indices)
        if n == 0:
            # sentinel read by _tile_capacity as "no demand → no capacity"
            return (0.0, 0.0, 0.0)
        cores = gpus = hp = 0
        for i in indices:
            req = items[i].request
            cores += req.misc.count
            for g in req.groups:
                cores += g.proc.count + g.misc.count
                gpus += g.gpus
            hp += req.hugepages_gb
        return (max(cores / n, 1e-6), gpus / n, hp / n)

    @staticmethod
    def _tile_capacity(
        tile: Dict[str, HostNode], demand: Tuple[float, float, float]
    ) -> int:
        """Estimated pod count *tile* can absorb for this batch: per-
        resource free totals over the batch's average per-pod demand,
        minimized across resources. Only balance matters — errors spill
        to the next tile."""
        avg_cores, avg_gpus, avg_hp = demand
        if avg_cores <= 0:
            return 0  # empty batch: no demand, report no capacity
        free_cores = free_gpus = free_hp = 0
        for node in tile.values():
            free_cores += node.free_cpu_core_count()
            free_gpus += node.free_gpu_count()
            free_hp += node.mem.free_hugepages_gb
        cap = free_cores / avg_cores
        if avg_gpus > 1e-6:
            cap = min(cap, free_gpus / avg_gpus)
        if avg_hp > 1e-6:
            cap = min(cap, free_hp / avg_hp)
        return max(int(cap), 0)

    def schedule(
        self,
        nodes: Dict[str, HostNode],
        items: Sequence[BatchItem],
        *,
        now: Optional[float] = None,
    ) -> Tuple[List[BatchAssignment], BatchStats]:
        """Place every item it can; mutates ``nodes``. Same contract as
        BatchScheduler.schedule (apply semantics only)."""
        if now is None:
            now = time.monotonic()
        t_stream = time.perf_counter()

        # pin the heap for the sweep: a federation-scale node mirror is
        # ~10M objects, and a major gc pass mid-run traverses all of them
        # (measured as multi-second stalls inside otherwise-tiny spill
        # sub-calls). GcPin gc.freeze()s the pre-existing heap AND
        # disables automatic collection for the sweep (young-gen
        # re-scans of the sweep's own result objects were ~50% of the
        # federation materialize phase); the next natural collection
        # after release reclaims the sweep's bounded garbage. GcPin
        # holds across every per-tile sub-call (their own acquire sees
        # it active and leaves gc alone). Small sweeps skip the pin —
        # see batch._gc_pinned for why per-call pinning of small
        # batches would starve generational collection.
        from nhd_tpu_torch.solver.batch import _GC_PIN_MIN_ITEMS, GcPin

        held = (
            GcPin.acquire() if len(items) >= _GC_PIN_MIN_ITEMS else False
        )
        try:
            return self._schedule_inner(nodes, items, now, t_stream)
        finally:
            GcPin.release(held)

    def _schedule_inner(
        self,
        nodes: Dict[str, HostNode],
        items: Sequence[BatchItem],
        now: float,
        t_stream: float,
    ) -> Tuple[List[BatchAssignment], BatchStats]:
        stats = BatchStats()
        # results materialize lazily (sub-calls fill placed/verdict slots;
        # the rest back-fill before return) — building 100k placeholder
        # objects up front was measurable federation preamble
        results: List[Optional[BatchAssignment]] = [None] * len(items)
        schedulable = [
            i for i, it in enumerate(items)
            if it.request.map_mode in (MapMode.NUMA, MapMode.PCI)
        ]

        # node tiles in name-insertion order (the reference's iteration
        # order): tile boundaries never split the first-fit preference,
        # because earlier tiles are exhausted before later ones are offered.
        # (Group-sorting tiles to align with regions was tried and measured
        # WORSE on interleaved-group clusters: each pod then has exactly
        # one compatible tile of exactly-matching capacity, and the lost
        # spill alternatives cost contention-retry rounds.)
        names = list(nodes.keys())
        ps = self._pstate if self.persistent else None
        if ps is not None and (
            ps["names"] != names
            or any(
                nodes[n] is not node
                for tile in ps["tiles"]
                for n, node in tile.items()
            )
        ):
            # membership (or the node objects behind it) changed: the
            # persistent tile contexts have nothing stable to patch
            ps = self._pstate = None
            self._pstale.clear()
        if ps is not None:
            tiles: List[Dict[str, HostNode]] = ps["tiles"]
        else:
            tiles = [
                {n: nodes[n] for n in names[i : i + self.tile_nodes]}
                for i in range(0, len(names), self.tile_nodes)
            ]
        if not tiles:
            # empty node set (e.g. a multihost rank whose region slice is
            # empty): everything stays unschedulable, like the serial
            # sweep that simply had no tiles to visit
            return (
                [BatchAssignment(it.key, None) for it in items], stats
            )
        # per-tile union of node groups: a pod with no group overlap can
        # skip the tile without a solve (same predicate the solver's
        # group_mask lattice applies, hoisted to the offer). No-op on
        # interleaved-group clusters; wins on naturally region-partitioned
        # federations.
        tile_groups: List[frozenset] = [
            frozenset().union(*(set(n.groups) for n in tile.values()))
            for tile in tiles
        ]

        # oversized pre-pass against the FULL cluster (tiles would hide
        # feasible nodes from the serial oracle) — BatchScheduler's
        # oversized-first exception, applied before any tile context exists
        # so serial claims are visible in every tile's encode below.
        # Tractability is judged at the worst-case (globally maximal) U/K —
        # the same rule every tile's encode uses (encode.cluster_dims), so
        # nothing deemed tractable here can be oversized inside a tile.
        U, K, _ = cluster_dims(nodes)
        # tractability memoized per group count (one bucket verdict
        # covers a whole gang): the per-pod power computation was 0.26 s
        # of serial preamble at the 100k federation scale
        _tract: Dict[int, bool] = {}
        oversized = []
        for i in schedulable:
            G = items[i].request.n_groups
            v = _tract.get(G)
            if v is None:
                v = _tract[G] = bucket_tractable(G, U, K)
            if not v:
                oversized.append(i)
        if oversized:
            touched = self.batch._schedule_serial(
                nodes, items, oversized, results, stats, now, True
            )
            ov = set(oversized)
            schedulable = [i for i in schedulable if i not in ov]
            # persistent tile contexts may already exist (prior calls):
            # their touched rows (winners + busy-stamped failures) fold
            # in as deltas at the context refresh below, exactly like
            # any other inter-batch churn
            self.note_nodes(touched)
            stats.round_end_seconds.append(time.perf_counter() - t_stream)
            for i in oversized:
                if results[i] is not None and results[i].node is not None:
                    results[i] = results[i]._replace(
                        round_no=len(stats.round_end_seconds) - 1
                    )

        # one interner shared by every tile context so a chunk's pod
        # encode (group_mask bit positions) is valid against all of them
        # — each chunk is encoded ONCE and re-offered to successive tiles
        # via schedule(encoded=..., offer=...) instead of re-encoding
        # (and re-hashing) the leftovers per tile. Sharing turns the
        # 63-bit group-mask budget federation-wide, so it only engages
        # when the whole batch's distinct groups fit with margin;
        # otherwise every sub-call encodes per tile exactly as before.
        # Eligible groups are pre-interned here, SORTED, so worker-side
        # encodes never mutate the interner (no lock; deterministic bits).
        from nhd_tpu_torch.solver.encode import GroupInterner, encode_pods

        all_groups = set().union(frozenset(), *tile_groups)
        for i in schedulable:
            all_groups |= items[i].request.node_groups
        share_enc = len(all_groups) <= 48
        interner = None
        if ps is not None and (
            ps["share_enc"] != share_enc
            or (
                share_enc
                and not ps["interner"].known(all_groups)
                and ps["interner"].n_bits + len(all_groups) > 56
            )
        ):
            # encode-sharing mode flipped, or the persisted interner
            # would overflow its bit budget absorbing this batch's new
            # groups — rebuild the tile state from scratch
            ps = self._pstate = None
            self._pstale.clear()
        if share_enc and ps is not None:
            # reuse the persisted interner (tile arrays bake its bit
            # positions); new groups intern HERE, sorted, on the main
            # thread — workers still never mutate it
            interner = ps["interner"]
            interner.mask(sorted(all_groups))
        elif share_enc:
            interner = GroupInterner()
            interner.mask(sorted(all_groups))
        # per-chunk encode cache: cid -> (items, buckets, global->local);
        # a chunk lives in exactly one tile queue at a time, so per-cid
        # calls never race
        chunk_enc: Dict[int, tuple] = {}

        def chunk_encoded(cid: int, global_ids: List[int]):
            """First call (the chunk's first tile offer) encodes the full
            chunk; later offers are shrinking subsets of the same ids and
            hit the cache."""
            got = chunk_enc.get(cid)
            if got is None:
                sub_items = [items[g] for g in global_ids]
                buckets = encode_pods(
                    [it.request for it in sub_items], interner
                )
                got = chunk_enc[cid] = (
                    sub_items,
                    buckets,
                    {g: j for j, g in enumerate(global_ids)},
                )
            return got

        if ps is not None:
            contexts: List[Optional[ScheduleContext]] = ps["ctxs"]
            deltas = ps["deltas"]
            # route inter-call churn notes to their owning tiles' deltas
            # (a tile with no built context yet has nothing to patch —
            # its eventual make_context reads live nodes)
            self.route_notes()
        else:
            contexts = [None] * len(tiles)
            deltas = [None] * len(tiles)
            self._pstale.clear()
        # persistent contexts refresh ONCE per call, at their first
        # offer (busy decay + noted rows fold in); within-call reuse
        # needs none — claims maintain the arrays as they apply. Each
        # slot is only touched by its tile's single worker.
        refreshed = [False] * len(tiles)
        # per-tile saturation certificates: a request type that came back
        # unschedulable from a tile stays unschedulable there for the rest
        # of this call (resources only shrink within one schedule()), so
        # later chunks skip the futile solve. Terminal assignment failures
        # (r.failed) are NOT certified — they had a candidate.
        exhausted: List[set] = [set() for _ in tiles]

        # ---- tile pipeline ----
        # Each tile is a stage with a FIFO of (chunk id, pending pods);
        # one worker serves a tile at a time, so per-tile claim streams
        # are identical to the serial sweep's (see module docstring).
        lock = threading.Lock()
        done = threading.Condition(lock)
        tile_q: List[deque] = [deque() for _ in tiles]
        tile_busy = [False] * len(tiles)
        outstanding = 0          # queued + running work items
        errors: List[BaseException] = []

        def process(ti: int, chunk_id: int, pending: List[int]) -> List[int]:
            """One (tile, chunk) sub-call; returns the leftover pods."""
            offer = []
            tg = tile_groups[ti]
            for i in pending:
                req = items[i].request
                if not (req.node_groups & tg):
                    # no node in this tile shares a group with the pod:
                    # skip the solve entirely (stays pending, forwards on)
                    continue
                if req in exhausted[ti]:
                    # the certificate stands in for the tile's verdict
                    # ("no candidate", not a hard failure) so a stale
                    # failed=True from an earlier tile can't leak into
                    # the final stats
                    results[i] = BatchAssignment(items[i].key, None)
                else:
                    offer.append(i)
            if not offer:
                return pending
            if contexts[ti] is None:
                if self.persistent:
                    from nhd_tpu_torch.solver.encode import ClusterDelta

                    deltas[ti] = ClusterDelta(
                        tiles[ti], now=now, interner=interner,
                        respect_busy=self.batch.respect_busy,
                    )
                    contexts[ti] = self.batch.make_context(
                        tiles[ti], now=now, delta=deltas[ti]
                    )
                else:
                    contexts[ti] = self.batch.make_context(
                        tiles[ti], now=now, interner=interner
                    )
                refreshed[ti] = True
            elif not refreshed[ti]:
                # a persistent context from an earlier call: fold the
                # inter-call churn in (row patches + device row updates)
                self.batch.refresh_context(contexts[ti], now=now)
                refreshed[ti] = True
            # delta-built contexts solve over their row-aligned view
            # dict; plain contexts' nodes IS tiles[ti]
            sub_nodes = contexts[ti].nodes
            t_sub = time.perf_counter()
            if share_enc:
                sub_items, encoded, local_of = chunk_encoded(
                    chunk_id, pending
                )
                # the chunk's FIRST full offer has identity locals
                # (local_of maps the same global_ids in order) — skip the
                # two 100k-element remap comprehensions for it
                identity = len(offer) == len(sub_items)
                sub_results, sub_stats = self.batch.schedule(
                    sub_nodes, sub_items, now=now, context=contexts[ti],
                    encoded=encoded,
                    offer=(
                        None if identity
                        else [local_of[i] for i in offer]
                    ),
                )
                if not identity:
                    sub_results = [sub_results[local_of[i]] for i in offer]
            else:
                # >48 distinct groups: per-tile interners, per-offer
                # encode (the pre-sharing behavior)
                sub_items = [items[i] for i in offer]
                sub_results, sub_stats = self.batch.schedule(
                    sub_nodes, sub_items, now=now, context=contexts[ti]
                )
            # merge: remap round numbers into the streaming timeline
            with lock:
                offset = len(stats.round_end_seconds)
                shift = t_sub - t_stream
                stats.round_end_seconds.extend(
                    t + shift for t in sub_stats.round_end_seconds
                )
                stats.rounds += sub_stats.rounds
                stats.solve_seconds += sub_stats.solve_seconds
                stats.select_seconds += sub_stats.select_seconds
                stats.assign_seconds += sub_stats.assign_seconds
                stats.scheduled += sub_stats.scheduled
                for name, dt in sub_stats.phases.items():
                    stats.phase_add(name, dt)
                for name, k in sub_stats.counters.items():
                    stats.count_add(name, k)
                # NOT sub_stats.failed: a pod failing its first-on-node
                # claim in one tile is re-offered to later tiles, so
                # per-tile failure counts would double-book; terminal
                # failures are recounted from result flags at the end

            # a no-candidate verdict is only a saturation certificate
            # when the batch loop ended by exhausting candidates, not
            # by hitting the round cap (a capped run can leave feasible
            # pods unplaced mid-retry)
            certify = sub_stats.rounds < self.batch.max_rounds
            placed_here: set = set()
            for pod_i, r in zip(offer, sub_results):
                if r.node is None:
                    # carry the latest tile's verdict (failed flag) so
                    # the final stats can distinguish assignment
                    # failure from plain unschedulability
                    results[pod_i] = r
                    if certify and not r.failed:
                        exhausted[ti].add(items[pod_i].request)
                    continue
                if r.round_no >= 0 and offset:
                    # remap the sub-call round into the streaming timeline;
                    # the first sub-call (offset 0) needs no remap, and at
                    # federation scale 100k reconstructions are real wall
                    r = BatchAssignment(
                        r.key, r.node, r.mapping, r.nic_list,
                        r.round_no + offset,
                    )
                results[pod_i] = r
                placed_here.add(pod_i)
            if len(placed_here) == len(pending):
                return []  # common case: whole chunk landed in this tile
            return [i for i in pending if i not in placed_here]

        def run_tile(ti: int) -> None:
            nonlocal outstanding
            while True:
                with lock:
                    if errors or not tile_q[ti]:
                        tile_busy[ti] = False
                        if errors:
                            outstanding -= len(tile_q[ti])
                            tile_q[ti].clear()
                        done.notify_all()
                        return
                    chunk_id, pending, hops = tile_q[ti].popleft()
                try:
                    leftover = process(ti, chunk_id, pending)
                except BaseException as exc:
                    with lock:
                        errors.append(exc)
                        outstanding -= 1
                        tile_busy[ti] = False
                        done.notify_all()
                    return
                submit_next = False
                with lock:
                    outstanding -= 1
                    # spill forwarding: first-fit stops at the last tile;
                    # routed wraps so a mis-routed pod still visits every
                    # tile exactly once (hops counts tiles seen)
                    nxt = ti + 1
                    if self.placement == "routed":
                        nxt = (ti + 1) % len(tiles)
                    if leftover and hops + 1 < len(tiles) and nxt < len(tiles):
                        outstanding += 1
                        tile_q[nxt].append((chunk_id, leftover, hops + 1))
                        if not tile_busy[nxt]:
                            # reserve the wake-up under the lock, submit
                            # outside it: Executor.submit can block in
                            # Thread.start() while spinning up a worker,
                            # and holding the pipeline lock across that
                            # wait stalls every other stage (nhdsan
                            # hold-while-blocking witness)
                            tile_busy[nxt] = True
                            submit_next = True
                    elif leftover:
                        self.logger.info(
                            f"streaming: {len(leftover)} pods of chunk "
                            f"{chunk_id} unschedulable after "
                            f"{len(tiles)} tiles"
                        )
                    if outstanding == 0:
                        done.notify_all()
                if submit_next:
                    pool.submit(run_tile, nxt)

        # default workers (the reference's, tuned on its accelerator and
        # kept until the card is measured): on an accelerator, 4
        # regardless of core count — tile stages spend much of their wall
        # blocked on device waits (GIL released), so concurrent stages
        # overlap those waits. On the CPU the host-side spans dominate and
        # extra pipeline workers buy GIL contention, not overlap: one
        # worker per two cores, floor 1. The accelerator is the
        # scheduler's own device, not a process-wide backend.
        accel = self.batch.device.type == "cuda"
        default_workers = (
            4 if accel else min(4, max(1, (os.cpu_count() or 2) // 2))
        )
        n_workers = max(
            1,
            min(
                len(tiles),
                int(os.environ.get("NHD_STREAM_WORKERS", default_workers)),
            ),
        )
        # initial work distribution: first-fit feeds every chunk to tile 0
        # (strict spill order); routed pre-partitions pods across tiles in
        # proportion to estimated residual capacity so the tiles run
        # concurrently from t=0
        start_blocks: List[Tuple[int, List[int]]] = []  # (tile, pod indices)
        if self.placement == "routed" and len(tiles) > 1:
            demand = self._batch_demand(items, schedulable)
            caps = [
                self._tile_capacity(tile, demand) for tile in tiles
            ]
            # group-aware routing: each pod only goes to tiles whose node
            # groups intersect its own, split by capacity share within
            # those; mis-splits spill through the wrap-around cascade
            from collections import defaultdict

            by_gkey: Dict[frozenset, List[int]] = defaultdict(list)
            for i in schedulable:
                by_gkey[items[i].request.node_groups].append(i)
            blocks: List[List[int]] = [[] for _ in tiles]
            for gkey, idxs in by_gkey.items():
                comp = [
                    t for t in range(len(tiles)) if gkey & tile_groups[t]
                ] or list(range(len(tiles)))
                w = [max(caps[t], 1) for t in comp]
                total = sum(w)
                acc = 0
                lo = 0
                for pos, t in enumerate(comp):
                    acc += w[pos]
                    hi = (
                        len(idxs) if pos == len(comp) - 1
                        else min(len(idxs), round(len(idxs) * acc / total))
                    )
                    blocks[t].extend(idxs[lo:hi])
                    lo = hi
            for ti, block in enumerate(blocks):
                if block:
                    block.sort()  # keep pod-index claim order per tile
                    start_blocks.append((ti, block))
        else:
            start_blocks.append((0, schedulable))

        # from here the tile workers merge their sub-calls into these under
        # the pipeline lock (nhdrace watches them when installed; the
        # serial pre-pass above wrote them before any worker started)
        maybe_watch(stats, ("rounds", "solve_seconds", "select_seconds",
                            "assign_seconds", "scheduled"))
        with ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="nhd-stream"
        ) as pool:
            to_start: List[int] = []
            with lock:
                cid = 0
                for ti, block in start_blocks:
                    for lo in range(0, len(block), self.chunk_pods):
                        tile_q[ti].append(
                            (cid, list(block[lo : lo + self.chunk_pods]), 0)
                        )
                        outstanding += 1
                        cid += 1
                    if tile_q[ti] and not tile_busy[ti]:
                        tile_busy[ti] = True
                        to_start.append(ti)
            # submit outside the lock (same reasoning as run_tile's spill
            # forwarding): tile_busy reserved the wake-ups, so no other
            # thread can double-submit these tiles
            for ti in to_start:
                pool.submit(run_tile, ti)
            with lock:
                while outstanding > 0 and not errors:
                    done.wait()
        if errors:
            raise errors[0]
        if self.persistent and self._pstate is None:
            # bank this call's tile contexts for the next one (an errored
            # call never saves — it rebuilds from the live mirror)
            self._pstate = {
                "names": names,
                "tiles": tiles,
                "tile_of": {
                    n: ti for ti, tile in enumerate(tiles) for n in tile
                },
                "ctxs": contexts,
                "deltas": deltas,
                "share_enc": share_enc,
                "interner": interner,
            }
        # back-fill the lazy result slots (never-offered / unplaced pods)
        for i, it in enumerate(items):
            if results[i] is None:
                results[i] = BatchAssignment(it.key, None)
        # stats.failed so far counts only the serial pre-pass (never
        # retried); add pods whose final tile verdict was a hard failure
        stats.failed += sum(
            1 for i in schedulable
            if results[i].node is None and results[i].failed
        )
        return results, stats
