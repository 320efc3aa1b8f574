"""Lease-based leader election with monotonic fencing epochs.

The reference NHD is a single replica whose whole availability story is
"crash-only + Deployment restart" (bin/nhd:43-56): a wedged or restarting
scheduler means NO scheduler until the kubelet notices. This module lets
two or more replicas run safely:

* :class:`LeaderElector` — acquire/renew/step-down over the
  ``ClusterBackend`` lease seam (interface.py). Backed by
  ``FakeClusterBackend`` state for tests and chaos, by
  coordination.k8s.io/v1 Lease objects through ``kube.py`` (under the
  retry layer) on a real cluster. Every acquisition bumps a monotonic
  **fencing epoch**; the scheduler stamps it onto every mutating commit
  (scheduler/core.py ``_commit_write``) and backends reject stale epochs
  atomically, so a deposed leader's in-flight batch cannot land.
* :class:`LeaseKeeper` — the daemon thread that ticks an elector at the
  renew cadence (the production driver; tests tick by hand).
* :class:`StallWatchdog` — observes the scheduling loop's heartbeat
  (``Scheduler.last_heartbeat``, the same loop the flight-recorder spans
  are emitted from). A loop wedged past the stall budget voluntarily
  releases the lease and exits crash-only, so a standby replica takes
  over in one renew interval instead of a liveness-probe eternity.

Renewal semantics (the client-go shape): a renewal that *errors*
(TransientBackendError — the API server is unreachable) is tolerated
while the last successful renewal is younger than the TTL — the lease
can't have expired yet, so leadership is still provably ours. Past the
TTL the elector demotes itself WITHOUT waiting for proof: it can no
longer distinguish "server down" from "deposed", and acting without a
live lease is exactly the split-brain this module exists to prevent. A
renewal that *returns False* (the compare-and-swap lost: someone else
holds the lease, or the epoch moved) demotes immediately.

Everything is injectable (clock, counters) so election is unit-tested
without a single real sleep (tests/test_ha.py, same pattern as
tests/test_retry.py).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set

from nhd_tpu_torch.k8s.interface import LEASE_NAME, ClusterBackend, TransientBackendError
from nhd_tpu_torch.k8s.retry import API_COUNTERS, ApiCounters
from nhd_tpu_torch.utils import get_logger

# production cadence knobs (docs/OPERATIONS.md "High availability"):
# renew several times per TTL so one flaky renewal never costs leadership
LEASE_TTL_SEC = float(os.environ.get("NHD_LEASE_TTL", "15"))
LEASE_RENEW_SEC = float(os.environ.get("NHD_LEASE_RENEW_SEC", "4"))
# the stall budget: how long the scheduling loop may go without a
# heartbeat before the watchdog releases the lease and exits crash-only.
# The loop beats at least every Q_BLOCK_TIME_SEC (0.5 s) when healthy,
# plus however long one batch solve+commit legitimately takes — size the
# budget for the worst legitimate batch, not the idle cadence.
WATCHDOG_STALL_SEC = float(os.environ.get("NHD_WATCHDOG_STALL_SEC", "120"))
WATCHDOG_POLL_SEC = float(os.environ.get("NHD_WATCHDOG_POLL_SEC", "5"))


class LeaderElector:
    """One replica's view of the election: FOLLOWER until an acquisition
    wins, LEADER until a renewal proves otherwise.

    ``tick()`` is the whole protocol — call it every ``renew_interval``
    (LeaseKeeper does, chaos/tests do it by hand). ``is_leader`` /
    ``fencing_epoch()`` are thread-safe snapshots for the scheduler and
    its commit-pool threads; state only CHANGES inside ``tick()`` and
    ``step_down()``, so a replica that believes it leads keeps believing
    so between ticks — which is precisely the split-brain window the
    fencing epochs exist to make harmless.
    """

    def __init__(
        self,
        backend: ClusterBackend,
        *,
        identity: str,
        lease_name: str = LEASE_NAME,
        ttl: float = LEASE_TTL_SEC,
        clock: Callable[[], float] = time.monotonic,
        counters: ApiCounters = API_COUNTERS,
        on_demote: Optional[Callable[[str], None]] = None,
    ):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.backend = backend
        self.identity = identity
        self.lease_name = lease_name
        self.ttl = ttl
        self.logger = get_logger(__name__)
        self._clock = clock
        self._counters = counters
        # fires once per leader→follower transition (with the reason),
        # AFTER the state flip — the flight-recorder demotion dump rides
        # this (cli.py): a deposed leader's final batch stays
        # investigable instead of only surviving clean exits
        self._on_demote = on_demote
        self._lock = threading.Lock()
        self._leader = False
        self._epoch = 0           # last epoch we led under (never rewinds)
        self._last_renew_ok = 0.0

    # -- thread-safe snapshots -----------------------------------------

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._leader

    @property
    def epoch(self) -> int:
        """The last epoch this replica led under (0 = never led)."""
        with self._lock:
            return self._epoch

    def fencing_epoch(self) -> Optional[int]:
        """The epoch to stamp on a fenced write, or None when this
        replica is not (or no longer) the leader."""
        with self._lock:
            return self._epoch if self._leader else None

    # -- the protocol ---------------------------------------------------

    def tick(self) -> bool:
        """One election step: leaders renew, followers try to acquire.
        Returns the post-tick leadership. Backend faults never escape —
        an unreachable API server is an election outcome (grace, then
        demotion), not an exception for the caller."""
        if self.is_leader:
            self._tick_leader()
        else:
            self._tick_follower()
        return self.is_leader

    def _tick_leader(self) -> None:
        now = self._clock()
        try:
            ok = self.backend.lease_renew(
                self.lease_name, self.identity, self._epoch, self.ttl
            )
        except TransientBackendError as exc:
            # server health, not a verdict: leadership is provably ours
            # while the lease we last renewed cannot have expired yet
            self._counters.inc("ha_renewal_failures_total")
            with self._lock:
                grace_spent = now - self._last_renew_ok > self.ttl
            if grace_spent:
                self._demote(f"renew grace expired ({exc})")
            else:
                self.logger.warning(
                    f"lease renew errored (within grace): {exc}"
                )
            return
        if ok:
            self._counters.inc("ha_renewals_total")
            with self._lock:
                self._last_renew_ok = now
        else:
            # CAS lost: the lease is no longer ours — no grace applies
            self._counters.inc("ha_renewal_failures_total")
            self._demote("lease lost (renew CAS failed)")

    def _tick_follower(self) -> None:
        try:
            view = self.backend.lease_try_acquire(
                self.lease_name, self.identity, self.ttl
            )
        except TransientBackendError as exc:
            self.logger.warning(f"lease acquire errored: {exc}")
            return
        if view.holder == self.identity:
            self._promote(view.epoch)

    def step_down(self) -> None:
        """Voluntary release (watchdog demotion, clean shutdown): clears
        the holder so a standby acquires on its next tick instead of
        waiting out the TTL."""
        with self._lock:
            if not self._leader:
                return
            epoch = self._epoch
        try:
            self.backend.lease_release(self.lease_name, self.identity, epoch)
        except TransientBackendError as exc:
            # the release is an optimization (faster handover); expiry
            # still bounds the gap if it never lands
            self.logger.warning(f"lease release failed: {exc}")
        self._demote("voluntary step-down")

    # -- transitions ----------------------------------------------------

    def _promote(self, epoch: int) -> None:
        with self._lock:
            self._leader = True
            self._epoch = epoch
            self._last_renew_ok = self._clock()
        self._counters.inc("ha_transitions_total")
        self._counters.set("ha_is_leader", 1)
        self._counters.set("ha_epoch", epoch)
        self.logger.warning(
            f"{self.identity}: elected leader (epoch {epoch})"
        )

    def _demote(self, why: str) -> None:
        with self._lock:
            if not self._leader:
                return
            self._leader = False
        self._counters.inc("ha_transitions_total")
        self._counters.set("ha_is_leader", 0)
        self.logger.warning(f"{self.identity}: stepping down — {why}")
        if self._on_demote is not None:
            # outside the lock: the callback may do I/O (trace dump) and
            # must never wedge the election; its failure is loggable, not
            # demotable — the state flip above already happened
            try:
                self._on_demote(why)
            except Exception:
                self.logger.exception("on_demote callback failed")


class LeaseKeeper(threading.Thread):
    """Daemon thread ticking an elector at the renew cadence (the
    production driver behind ``nhd-tpu --ha``)."""

    def __init__(
        self, elector: LeaderElector, *, interval: float = LEASE_RENEW_SEC
    ):
        super().__init__(name="nhd-lease-keeper", daemon=True)
        self.elector = elector
        self.interval = interval
        self.logger = get_logger(__name__)
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.elector.tick()
            except Exception:
                # tick() absorbs backend faults itself; anything else is
                # a bug worth logging, but the keeper dying would freeze
                # the election at whatever state it last reached
                self.logger.exception("election tick failed")
            self._stop_event.wait(self.interval)

    def stop(self) -> None:
        self._stop_event.set()


class StallWatchdog(threading.Thread):
    """Crash-only stall detection for the scheduling loop.

    ``beat`` returns the loop's last-heartbeat stamp (monotonic; the
    scheduler refreshes it at the top of every ``run_once``, the same
    turn of the loop the flight-recorder spans and histograms are fed
    from). When the heartbeat goes stale past ``stall_after``, the
    watchdog releases the lease (so a standby promotes within one renew
    interval) and invokes ``exit_fn`` — ``os._exit`` by default, the
    same crash-only exit the cli liveness loop uses for a *dead* thread.
    This covers the case that loop cannot: a thread that is alive but
    wedged (stuck solve, hung uninstrumented call) still holds the lease
    and silently stalls the queue.
    """

    def __init__(
        self,
        beat: Callable[[], float],
        *,
        stall_after: float = WATCHDOG_STALL_SEC,
        interval: float = WATCHDOG_POLL_SEC,
        elector: Optional[LeaderElector] = None,
        exit_fn: Callable[[int], None] = os._exit,
        clock: Callable[[], float] = time.monotonic,
        counters: ApiCounters = API_COUNTERS,
    ):
        super().__init__(name="nhd-stall-watchdog", daemon=True)
        if stall_after <= 0:
            raise ValueError(f"stall_after must be > 0, got {stall_after}")
        self.logger = get_logger(__name__)
        self._beat = beat
        self.stall_after = stall_after
        self.interval = interval
        self.elector = elector
        self._exit_fn = exit_fn
        self._clock = clock
        self._counters = counters
        self._stop_event = threading.Event()
        self.fired = False

    def check(self, now: Optional[float] = None) -> bool:
        """One watchdog pass; returns True when the stall tripped.
        Public so tests drive it with an injected clock, no thread."""
        now = self._clock() if now is None else now
        age = max(now - self._beat(), 0.0)
        self._counters.set("ha_watchdog_loop_age_seconds", age)
        if age <= self.stall_after or self.fired:
            return self.fired
        self.fired = True
        self._counters.inc("ha_watchdog_stalls_total")
        self.logger.error(
            f"scheduling loop stalled ({age:.1f}s since last heartbeat, "
            f"budget {self.stall_after:.1f}s); releasing lease and "
            "exiting crash-only"
        )
        if self.elector is not None:
            self.elector.step_down()
        self._exit_fn(2)
        return True

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.check()
            except Exception:
                # a broken beat source must not kill the watchdog quietly
                self.logger.exception("watchdog check failed")
            self._stop_event.wait(self.interval)

    def stop(self) -> None:
        self._stop_event.set()


# ---------------------------------------------------------------------------
# Sharded federation: the single LEASE_NAME generalized to a shard table
# ---------------------------------------------------------------------------
#
# PR 5's machinery supports exactly one active leader for the whole fleet:
# one wedged or partitioned replica stalls every node group at once. The
# federation splits the node-group set into S **shards**, each backed by
# its own coordination Lease with an independent fencing epoch, so N
# replicas share the control plane: a replica may hold several shards,
# every fenced write carries the epoch OF THE SHARD OWNING THE TARGET
# NODE, and losing one replica costs only its shards' node groups for one
# handoff — not the fleet (docs/RESILIENCE.md "Federation").

#: how many ticks a non-preferred replica waits on an unheld shard lease
#: before acquiring it anyway (the rendezvous-preferred owner is wedged,
#: partitioned, or gone); bounds the per-shard leadership gap at
#: TTL + patience ticks
SHARD_PATIENCE_TICKS = int(os.environ.get("NHD_SHARD_PATIENCE_TICKS", "2"))


def shard_lease_name(shard: int, n_shards: int) -> str:
    """The coordination Lease backing one shard. S=1 degenerates to the
    PR 5 single lease — a one-shard federation is byte-identical on the
    wire to `--ha` (the regression pin in tests/test_ha.py)."""
    if n_shards == 1:
        return LEASE_NAME
    return f"{LEASE_NAME}-s{shard}"


def presence_lease_name(identity: str) -> str:
    """Per-replica liveness beacon: each federation member renews its own
    presence lease every tick, and peers treat a member as live while the
    beacon is unexpired. This is what lets the current holder of a shard
    notice a freshly joined preferred owner and hand the shard over —
    a replica that holds no shard yet would otherwise be invisible."""
    return f"nhd-scheduler-presence-{identity}"


def _hrw(*parts: object) -> int:
    """Deterministic 64-bit weight for rendezvous hashing — hashlib, not
    hash(): assignments must agree across processes and PYTHONHASHSEED."""
    h = hashlib.blake2s(
        "|".join(str(p) for p in parts).encode(), digest_size=8
    )
    return int.from_bytes(h.digest(), "big")


def shard_for_group(group: str, n_shards: int) -> int:
    """group → shard via highest-random-weight over shard ids: resizing
    the federation moves only ~1/S of the groups."""
    if n_shards <= 1:
        return 0
    return max(range(n_shards), key=lambda s: (_hrw("grp", group, s), s))


def shard_for_groups(groups: Iterable[str], n_shards: int) -> int:
    """A node's (or pod request's) home shard. Nodes can carry several
    groups and a pod can request several; the lexicographic minimum is
    the deterministic tiebreak both sides agree on — a pod whose groups
    straddle shards lands in ONE home shard and reaches the others
    through the spillover queue."""
    groups = sorted(groups)
    return shard_for_group(groups[0] if groups else "default", n_shards)


def rendezvous_owner(shard: int, identities: Iterable[str]) -> Optional[str]:
    """The replica that SHOULD hold this shard among the live members —
    highest-random-weight, so membership changes reassign only the dead
    member's shards and every replica computes the same answer with no
    coordinator."""
    ids = sorted(set(identities))
    if not ids:
        return None
    return max(ids, key=lambda i: (_hrw("own", shard, i), i))


# replica-local shard ownership snapshot for the metrics plane
# (rpc/metrics.py renders nhd_shard_epoch{shard=...}); one process runs
# one replica in production, so module state is the right scope
_SHARD_STATUS_LOCK = threading.Lock()
_SHARD_STATUS: Dict[str, object] = {"identity": "", "n_shards": 0, "owned": {}}


def publish_shard_status(
    identity: str, n_shards: int, owned: Dict[int, int]
) -> None:
    with _SHARD_STATUS_LOCK:
        _SHARD_STATUS["identity"] = identity
        _SHARD_STATUS["n_shards"] = n_shards
        _SHARD_STATUS["owned"] = dict(owned)


def shard_status_snapshot() -> Dict[str, object]:
    with _SHARD_STATUS_LOCK:
        return {
            "identity": _SHARD_STATUS["identity"],
            "n_shards": _SHARD_STATUS["n_shards"],
            "owned": dict(_SHARD_STATUS["owned"]),  # type: ignore[arg-type]
        }


class _MonotonicOnly:
    """Counter surface handed to a :class:`ShardedElector`'s inner
    electors: monotonic renewal counters forward to the replica's shared
    registry (S leases' renewals/failures sum meaningfully on /metrics),
    everything else is dropped — S electors would thrash the
    ha_is_leader/ha_epoch gauges, and per-lease acquire/step-down
    transitions would double-count against the replica-level
    ha_transitions_total that ``_publish()`` maintains."""

    _FORWARD = frozenset({"ha_renewals_total", "ha_renewal_failures_total"})

    def __init__(self, registry: ApiCounters):
        self._registry = registry

    def inc(self, name: str, by: float = 1) -> None:
        if name in self._FORWARD:
            self._registry.inc(name, by)

    def set(self, name: str, value: float) -> None:
        pass

    def get(self, name: str) -> float:
        return self._registry.get(name)


class ShardedElector:
    """One replica's membership in the shard federation: a presence
    beacon plus one :class:`LeaderElector` per shard lease.

    ``tick()`` runs the whole protocol:

    1. renew the presence beacon (peer-visible liveness);
    2. compute the live member set from the peers' beacons;
    3. per shard — owners renew (the PR 5 grace/CAS semantics,
       unchanged, via the inner elector); the rendezvous-preferred
       member acquires unheld/expired shards immediately; everyone else
       waits out a small **patience** budget before grabbing an orphaned
       shard (so the preferred owner wins the common case but a wedged
       one never strands a shard past TTL + patience ticks);
    4. **bounded handoff**: a holder that sees a live better-ranked
       member releases AT MOST ONE shard per tick to it — rebalance
       converges in a few ticks without a thundering mass-release, and
       each handed-off shard goes through the new owner's scoped
       promotion replay before any write (scheduler/core.py).

    Fencing is per shard: ``fencing_epoch_for(shard)`` is the token a
    write targeting that shard's nodes must carry, and a replica holds
    several tokens at once. ``is_leader`` reports shard 0 — the
    federation's **coordinator shard**, which owns the cluster-scoped
    duties exactly one replica may run (TriadSet reconciliation).
    """

    def __init__(
        self,
        backend: ClusterBackend,
        *,
        identity: str,
        peers: Iterable[str],
        n_shards: int,
        ttl: float = LEASE_TTL_SEC,
        clock: Callable[[], float] = time.monotonic,
        counters: ApiCounters = API_COUNTERS,
        patience: int = SHARD_PATIENCE_TICKS,
        on_demote: Optional[Callable[[str], None]] = None,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.backend = backend
        self.identity = identity
        self.peers: List[str] = sorted(set(peers) | {identity})
        self.n_shards = n_shards
        self.ttl = ttl
        self.patience = patience
        self.logger = get_logger(__name__)
        self._counters = counters
        # inner electors write through a forwarding surface: monotonic
        # inc()s (renewals, renewal failures, transitions) land in the
        # replica's shared registry — S leases' renewal traffic SUMS
        # meaningfully, and operators alerting on
        # nhd_ha_renewal_failures_total keep their signal under
        # federation — while gauge set()s are dropped (S electors would
        # thrash ha_is_leader/ha_epoch; _publish() writes the
        # replica-level truth for those instead)
        inner_counters = _MonotonicOnly(counters)
        # shard-qualified demotion callback: every lost shard is a
        # demotion event for the dump hook (the presence beacon is NOT —
        # losing it costs rendezvous preference, not leadership)
        self._electors: Dict[int, LeaderElector] = {
            s: LeaderElector(
                backend, identity=identity,
                lease_name=shard_lease_name(s, n_shards),
                ttl=ttl, clock=clock, counters=inner_counters,
                on_demote=(
                    None if on_demote is None
                    else (lambda why, _s=s: on_demote(f"shard {_s}: {why}"))
                ),
            )
            for s in range(n_shards)
        }
        self._presence = LeaderElector(
            backend, identity=identity,
            lease_name=presence_lease_name(identity),
            ttl=ttl, clock=clock, counters=inner_counters,
        )
        self._patience_count: Dict[int, int] = {s: 0 for s in range(n_shards)}
        self._last_live: Set[str] = {identity}

    # -- thread-safe snapshots (inner electors own the locking) ---------

    def owned_shards(self) -> Dict[int, int]:
        """{shard: fencing epoch} for every shard this replica holds."""
        out: Dict[int, int] = {}
        for s, el in self._electors.items():
            epoch = el.fencing_epoch()
            if epoch is not None:
                out[s] = epoch
        return out

    def fencing_epoch_for(self, shard: int) -> Optional[int]:
        return self._electors[shard].fencing_epoch()

    def fencing_epoch(self) -> Optional[int]:
        """Single-lease compatibility surface (S=1 callers)."""
        return self._electors[0].fencing_epoch()

    def lease_name_of(self, shard: int) -> str:
        return shard_lease_name(shard, self.n_shards)

    @property
    def is_leader(self) -> bool:
        """Coordinator duties (TriadSet reconciliation) follow shard 0:
        cluster-scoped writes still need exactly one author."""
        return self._electors[0].is_leader

    @property
    def epoch(self) -> int:
        """Highest epoch among owned shards (logging/metrics figure; the
        per-shard tokens are what fencing actually uses)."""
        return max(self.owned_shards().values(), default=0)

    # -- the protocol ---------------------------------------------------

    def tick(self) -> bool:
        """One federation step; returns True when any shard is held.
        Backend faults never escape — an unreachable API server degrades
        to the inner electors' grace/expiry outcomes."""
        owned_before = set(self.owned_shards())
        self._presence.tick()
        live = self._live_members()
        handed_off = False
        for s in range(self.n_shards):
            el = self._electors[s]
            preferred = rendezvous_owner(s, live)
            if el.is_leader:
                el.tick()
                if (
                    el.is_leader
                    and preferred != self.identity
                    and not handed_off
                ):
                    # bounded handoff: a live better-ranked member exists;
                    # release at most one shard per tick so rebalance
                    # never dumps a replica's whole shard set at once
                    self.logger.warning(
                        f"{self.identity}: handing shard {s} to {preferred}"
                    )
                    el.step_down()
                    handed_off = True
                    self._counters.inc("shard_handoffs_total")
                self._patience_count[s] = 0
                continue
            if preferred == self.identity:
                if el.tick():
                    self._counters.inc("shard_acquisitions_total")
                self._patience_count[s] = 0
                continue
            # not ours by preference: grab it only once it has sat
            # unheld past the patience budget (the preferred member is
            # wedged, partitioned, or its beacon hasn't expired yet)
            try:
                held = bool(
                    self.backend.lease_live(self.lease_name_of(s))
                )
            except TransientBackendError:
                held = True  # unverifiable: don't spend patience on it
            if held:
                self._patience_count[s] = 0
            else:
                self._patience_count[s] += 1
                if self._patience_count[s] > self.patience and el.tick():
                    self._counters.inc("shard_acquisitions_total")
                    self._patience_count[s] = 0
        self._publish(owned_before)
        return bool(self.owned_shards())

    def _live_members(self) -> Set[str]:
        """Members with an unexpired presence beacon (plus ourselves).
        An unverifiable peer counts as absent: wrongly absent costs a
        bounded patience delay, wrongly live could strand a shard on a
        dead member forever."""
        live: Set[str] = {self.identity}
        for peer in self.peers:
            if peer == self.identity:
                continue
            try:
                if self.backend.lease_live(presence_lease_name(peer)) == peer:
                    live.add(peer)
            except TransientBackendError:
                pass
        self._last_live = live
        return live

    def release_shard(self, shard: int) -> None:
        """Give one shard back (failed scoped promotion replay: leading a
        shard without replayed state violates the crash-only contract)."""
        self._electors[shard].step_down()
        self._publish(set(self.owned_shards()) | {shard})

    def step_down(self) -> None:
        """Clean exit: release every shard and the presence beacon so
        peers rebalance in one tick instead of waiting out the TTL."""
        owned_before = set(self.owned_shards())
        for el in self._electors.values():
            el.step_down()
        self._presence.step_down()
        self._publish(owned_before)

    def _publish(self, owned_before: Set[int]) -> None:
        owned = self.owned_shards()
        if set(owned) != owned_before:
            self._counters.inc("ha_transitions_total")
        # the replica-level generalization of the single-leader gauges:
        # "leader" now means "holds at least one shard", and the epoch
        # gauge reports the highest held token (per-shard epochs are on
        # nhd_shard_epoch{shard=...})
        self._counters.set("shard_owned_count", len(owned))
        self._counters.set("ha_is_leader", 1 if owned else 0)
        self._counters.set("ha_epoch", max(owned.values(), default=0))
        publish_shard_status(self.identity, self.n_shards, owned)
