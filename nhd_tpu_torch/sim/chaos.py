"""Chaos simulation: randomized cluster churn against the full scheduler.

The reference has no fault injection of any kind (SURVEY §5.3); its
resilience claims rest on the crash-only design being exercised in
production. This module drives the controller+scheduler stack on the fake
backend through randomized event storms — pod creates/deletes, cordons,
maintenance flips, group moves, bind failures, scheduler restarts — while
checking conservation invariants after every step.

With ``api_faults`` set, the same storm also hits the API layer
(sim/faults.py): dropped and poisoned watch events, transient bind and
annotate failures. ``quiesce()`` then proves crash-only recovery: faults
stop, the control loops drain, and the run must end with zero invariant
violations and no pod stranded by an API fault (``stuck_pods()``).

With ``ha=True`` the sim becomes a **split-brain harness**: TWO complete
scheduler replicas (each with its own elector, controller and watch
queue) share one fake cluster, lease-renewal faults (the ``ha-*``
profiles) force leadership churn, and every replica that *believes* it
leads is driven every step — including deposed leaders that haven't
noticed yet, which is exactly the overlap window fencing must make
harmless. Two invariants join the standing set: **no pod is ever bound
by two epochs** (the backend's bind log proves every landed write came
from exactly one leadership), and **leadership gaps are bounded** (the
cluster is never headless for longer than lease expiry + a few ticks).
Restarts additionally assert **state equivalence**: the re-replayed
claims must equal the pre-restart claims (and the cluster's own bound
set), not merely satisfy the invariants.

With ``federation=S`` the sim becomes the **shard-federation harness**
(docs/RESILIENCE.md "Federation"): ``n_replicas`` complete replicas,
each with a ShardedElector over S shard leases, share one fake cluster.
Each replica sees the watch stream through its own vantage (the single
stream fans out, with per-replica drop/poison faults), the ``fed-*``
profiles add per-shard lease faults plus ASYMMETRIC partitions (one
replica's API calls all fail and its watch goes silent while the rest
keep working), and kill/restart waves take whole replicas down for
steps at a time. Three federation invariants join the standing set:
**no pod uid is ever bound under two shard epochs** (the bind log
records the fencing lease of every landed bind), **per-shard
leadership gaps are bounded** (no shard is ownerless past lease expiry
plus rendezvous patience plus the fault windows), and **no spilled pod
outlives the orphan window** (every cross-shard spillover pod is
placed or explicitly declared unschedulable within a bounded age).

The port's copy of the reference's nhd_tpu/sim/chaos.py. Everything is
the reference's text but its device seams:

* ``ChaosSim(device="cuda")`` resolves the solve device once
  (``nhd_tpu_torch.device.resolve_device``, which raises without a GPU)
  and hands it to every ``Scheduler`` the sim builds; tests pass
  ``"cpu"``.
* The device-fault posture check refuses a device profile only when
  ``NHD_TPU_DEVICE_STATE=0`` asks for no resident state: the port keeps
  its node tensors resident on every device.
* ``_act_bit_flip`` corrupts one row of a resident torch tensor in
  place on its device (logical not for bool, +1 otherwise), drawing the
  reference's choices from the same seeded stream in the same order, so
  a seed's fault timing is the same in both packages.
* ``device_audit_errors`` leaves out the rows the delta re-packed since
  the last batch (the device is legitimately behind there until the
  next batch writes them); the reference audits them too and reports a
  cordon or a release after the last batch as corruption (ROADMAP
  Queue 3).
"""

from __future__ import annotations

import json
import math
import os
import queue
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from nhd_tpu_torch.device import DeviceLike, resolve_device
from nhd_tpu_torch.k8s.fake import FakeClusterBackend
from nhd_tpu_torch.k8s.interface import (
    LEASE_NAME,
    SPILLOVER_ANNOTATION,
    TransientBackendError,
    WatchEvent,
    parse_spill_record,
)
from nhd_tpu_torch.k8s.lease import (
    SHARD_PATIENCE_TICKS,
    LeaderElector,
    ShardedElector,
    shard_for_group,
    shard_lease_name,
)
from nhd_tpu_torch.k8s.retry import API_COUNTERS, ApiCounters
from nhd_tpu_torch.obs.chrome import chrome_trace, merge_chrome_traces
from nhd_tpu_torch.obs.recorder import FlightRecorder
from nhd_tpu_torch.obs.slo import SloTracker
from nhd_tpu_torch.scheduler.controller import Controller
from nhd_tpu_torch.scheduler.core import SPILLOVER_MAX_AGE_SEC, Scheduler
from nhd_tpu_torch.scheduler.events import WatchQueue
from nhd_tpu_torch.sim.faults import FaultProfile, FaultyBackend
from nhd_tpu_torch.sim.synth import SynthNodeSpec, make_node_labels, make_triad_config

# one chaos step advances the sim clock this much (the controller's
# TriadSet cadence and, in HA mode, lease expiry both run off it)
STEP_SEC = 10.0

# ---------------------------------------------------------------------------
# policy-chaos profiles (ISSUE 15: the scheduling-policy engine's scenario
# machinery — mixed-generation fleets, tenant quota storms, maintenance
# waves, each with invariants). Solo mode only: the policy counters and
# the scoring matrix are process-global like the device plane.
# ---------------------------------------------------------------------------

#: node hardware generations a policy storm spreads the fleet over
POLICY_CLASSES = ("gen-a", "gen-b", "gen-c")

#: the storm's throughput matrix: gen-a is the fast generation — the
#: scoring invariously prefers it, creating exactly the contention that
#: makes preemption and budgets earn their keep
POLICY_TPUT = {
    "gpu": {"gen-a": 1.0, "gen-b": 0.6, "gen-c": 0.35},
    "cpu": {"gen-a": 1.0, "gen-b": 0.8, "gen-c": 0.6},
}

#: tenant namespaces the quota-storm profile spreads pods over
POLICY_TENANTS = ("default", "tenant-a", "tenant-b")

#: per-pod lifetime eviction ceiling — the no-preemption-cascade /
#: no-livelock invariant: budgets and the per-pod attempts cap mean no
#: pod should ever be evicted more than a handful of times in a storm
POLICY_CASCADE_BOUND = 4

#: scheduling passes one chaos step can drive (controller + up to 8
#: queue drains + the periodic scan) — the per-step eviction bound is
#: round_budget × this
POLICY_PASSES_PER_STEP = 10

#: the three policy storm profiles (make policy-chaos sweeps them):
#: mixed-gen  — tiered pods on a mixed-generation fleet (the baseline
#:              heterogeneity scenario)
#: quota-storm — multi-tenant bursts of high-tier pods (the per-tenant
#:              budget's scenario)
#: maint-wave — periodic cordon/maintenance waves shrink the fleet and
#:              force rebinds under preemption pressure
POLICY_PROFILES = ("mixed-gen", "quota-storm", "maint-wave")

# ---------------------------------------------------------------------------
# tenant-storm profile (ISSUE 20: the ingress admission plane's scenario —
# one abusive tenant floods creates while a victim tenant trickles; the
# per-tenant lanes, DRR dequeue and shed ladder must keep the victim's
# time-to-bind flat). Solo mode only: the admission counters ride the
# process-global API_COUNTERS bank, like the policy counters.
# ---------------------------------------------------------------------------

#: the tenant-storm profile names (make tenant-chaos sweeps the seeds)
TENANT_PROFILES = ("tenant-storm",)

#: the well-behaved tenant: one pod per step, always in-rate — its p99
#: time-to-bind is the isolation invariant's measured quantity
TENANT_VICTIM = "tenant-victim"

#: the flooding tenant: ``abuse_rate`` pods per step
TENANT_ABUSER = "tenant-abuser"

#: CREATE-drain passes one tenant step drives — deliberately scarce
#: (the generic storm drives 8): the front door only sheds when
#: arrivals outpace the drain, so the drive is throttled to make
#: overload real rather than letting the sim drain everything
TENANT_PASSES_PER_STEP = 3

#: periodic-scan cadence in tenant mode (steps). The reconcile scan
#: reads pending pods straight off the cluster, BYPASSING the front
#: door — run every step (the generic storm's cadence) it would
#: quietly re-admit everything the ladder shed and the isolation test
#: would measure nothing. Every TENANT_SCAN_EVERY steps matches the
#: production run loop's occasional-scan posture and doubles as the
#: shed pods' documented recovery path.
TENANT_SCAN_EVERY = 10

# kill/restart waves leave a federation replica down for at most this
# many steps before its fresh incarnation rejoins (crash-only restart)
KILL_DOWN_MAX_STEPS = 2


@dataclass
class ChaosStats:
    steps: int = 0
    created: int = 0
    deleted: int = 0
    cordons: int = 0
    maint_flips: int = 0
    bind_failures: int = 0
    restarts: int = 0
    group_moves: int = 0
    silent_deletes: int = 0
    # structural node churn (NODE_ADD/NODE_REMOVE through the live watch
    # path — the incremental cluster state absorbs these as padded-slot
    # rows / tombstones, or falls back to a logged rebuild)
    node_flaps: int = 0
    # incremental-state rebuilds observed across the run (the
    # delta/rebuild invariant: faults may COST rebuilds, never parity)
    delta_rebuilds: int = 0
    # solver data-plane storm (device-faults profile): resident device
    # rows corrupted in place by the sim — the guard's audit must find
    # and repair every one before it can influence a bind
    bit_flips: int = 0
    # HA mode: lease epoch high-water mark (== total acquisitions) and
    # the longest stretch of steps with no replica believing it leads
    lease_epoch: int = 0
    max_leader_gap: int = 0
    # federation mode (federation=S): per-shard epoch high-water marks,
    # the longest ownerless stretch of any one shard, fault/chaos action
    # tallies, and the spillover lifecycle counters
    shard_epochs: Dict[int, int] = field(default_factory=dict)
    max_shard_gap: int = 0
    partitions: int = 0
    kill_waves: int = 0
    spilled: int = 0
    spillover_exhausted: int = 0
    max_spill_age_sec: float = 0.0
    violations: List[str] = field(default_factory=list)


def _fed_group_pool(n_shards: int) -> List[str]:
    """Deterministic node-group names whose rendezvous shards cover every
    shard id, so a federation storm exercises ALL S shard leases (with
    only 'default'/'edge' and small S, whole shards would sit empty)."""
    pool: List[str] = ["default", "edge"]
    covered = {shard_for_group(g, n_shards) for g in pool}
    i = 0
    while len(covered) < n_shards and i < 512:
        name = f"g{i}"
        i += 1
        s = shard_for_group(name, n_shards)
        if s not in covered:
            pool.append(name)
            covered.add(s)
    return pool


class _FedVantage:
    """One replica's view of the shared cluster under federation chaos:
    a private watch-event feed (the sim fans the single stream out to
    every replica, like each replica owning its own watch connection)
    and an asymmetric-partition switch — while ``partition_left`` > 0,
    every API call this replica issues raises TransientBackendError and
    its watch stream is silent, while the rest of the federation keeps
    working against the same cluster."""

    def __init__(self, inner):
        self._inner = inner
        self._feed: List[WatchEvent] = []
        self.partition_left = 0

    def feed(self, events: List[WatchEvent]) -> None:
        self._feed.extend(events)

    def poll_watch_events(self, timeout: float = 0.0) -> List[WatchEvent]:
        if self.partition_left > 0:
            return []
        out, self._feed = self._feed, []
        return out

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if callable(attr) and self.partition_left > 0:
            def _partitioned(*args, **kwargs):
                raise TransientBackendError(
                    f"asymmetric partition: {name} unreachable"
                )

            return _partitioned
        return attr


class _FedReplica:
    """One federation member: ShardedElector + scheduler + controller
    behind a partitionable vantage, with its own seeded fault stream —
    what one pod of the N-replica/S-shard Deployment recipe runs
    (docs/OPERATIONS.md)."""

    def __init__(self, sim: "ChaosSim", ident: str, peers: List[str],
                 incarnation: int):
        self.ident = ident
        self.dead_for = 0
        if sim.fed_profile is not None:
            # per-replica fault stream, reseeded per incarnation so a
            # restarted replica doesn't replay its predecessor's rolls
            self.faulty: Optional[FaultyBackend] = FaultyBackend(
                sim.base, sim.fed_profile,
                random.Random(sim.seed * 1000003 + 7919 * incarnation),
            )
        else:
            self.faulty = None
        self.vantage = _FedVantage(self.faulty or sim.base)
        self.counters = ApiCounters()
        self.elector = ShardedElector(
            self.vantage, identity=ident, peers=peers,
            n_shards=sim.n_shards, ttl=sim.lease_ttl,
            clock=sim.sim_clock, counters=self.counters,
        )
        if sim.tracing:
            # per-replica observability plane: N replicas in ONE process
            # must each own their span ring and SLO tracker, or the
            # cross-replica journey merge (obs/chrome.py) would see one
            # indistinguishable blob instead of N attributable dumps
            self.recorder: Optional[FlightRecorder] = FlightRecorder(
                capacity=4096, identity=ident
            )
            self.slo: Optional[SloTracker] = SloTracker(clock=sim.sim_clock)
        else:
            self.recorder = None
            self.slo = None
        self.sched = Scheduler(
            self.vantage, WatchQueue(), queue.Queue(),
            respect_busy=False, sharded=self.elector, clock=sim.sim_clock,
            recorder=self.recorder, slo=self.slo, device=sim.device,
        )
        self.controller = Controller(
            self.vantage, self.sched.nqueue,
            isolate_events=sim.hardened, elector=self.elector,
            recorder=self.recorder,
        )
        self.sched.build_initial_node_list()
        self.sched.load_deployed_configs()

    def truly_owned(self, sim: "ChaosSim") -> Set[int]:
        """The shards this replica believes it holds AND the lease
        agrees (not a stale believer) — the scope within which its
        mirror must agree with the cluster."""
        out: Set[int] = set()
        for s, epoch in self.elector.owned_shards().items():
            view = sim.base.lease_read(shard_lease_name(s, sim.n_shards))
            if (
                view is not None and view.holder == self.ident
                and view.epoch == epoch
            ):
                out.add(s)
        return out


class _Replica:
    """One complete scheduler replica: elector + scheduler + controller,
    with its own watch queue — what one pod of the 2-replica Deployment
    recipe runs (docs/OPERATIONS.md)."""

    def __init__(self, sim: "ChaosSim", ident: str):
        self.ident = ident
        # per-replica counters: two replicas in one process must not
        # fight over the process-wide ha_is_leader/ha_epoch gauges
        self.counters = ApiCounters()
        self.elector = LeaderElector(
            sim.backend, identity=ident, ttl=sim.lease_ttl,
            clock=sim.sim_clock, counters=self.counters,
        )
        self.sched = Scheduler(
            sim.backend, WatchQueue(), queue.Queue(),
            respect_busy=False, elector=self.elector, device=sim.device,
        )
        self.controller = Controller(
            sim.backend, self.sched.nqueue,
            isolate_events=sim.hardened, elector=self.elector,
        )
        self.sched.build_initial_node_list()
        self.sched.load_deployed_configs()

    def is_true_leader(self, sim: "ChaosSim") -> bool:
        """Believes it leads AND the lease agrees (not a stale believer)."""
        epoch = self.elector.fencing_epoch()
        if epoch is None:
            return False
        view = sim.backend.lease_read(LEASE_NAME)
        return view is not None and view.epoch == epoch


class ChaosSim:
    """One reproducible chaos run (seeded).

    ``api_faults`` layers API-level fault injection (sim/faults.py) over
    the cluster churn; ``hardened=False`` strips the controller's
    per-event isolation, restoring the reference's crash-only stance so
    tests can demonstrate that the same storm kills an unhardened stack.
    ``ha=True`` runs TWO replicas against the shared backend under
    leader election (split-brain mode; see the module docstring).
    ``federation=S`` runs ``n_replicas`` replicas over S shard leases
    (the shard-federation harness; see the module docstring) — S=1 is
    the single-lease degenerate case, behavior-equivalent on the wire
    to ``ha=True`` (the regression pin in tests/test_ha.py).
    """

    def __init__(
        self,
        seed: int = 0,
        n_nodes: int = 4,
        *,
        api_faults: Optional[FaultProfile] = None,
        hardened: bool = True,
        ha: bool = False,
        federation: int = 0,
        n_replicas: int = 3,
        lease_ttl: float = 3 * STEP_SEC,
        tracing: Optional[bool] = None,
        policy: Optional[str] = None,
        policy_off: bool = False,
        journey: Optional[str] = None,
        tenant: Optional[str] = None,
        admit_off: bool = False,
        abuse_rate: int = 10,
        device: DeviceLike = "cuda",
    ):
        # the solve device of every scheduler this sim builds, resolved
        # once (a CUDA request without a GPU raises here)
        self.device = resolve_device(device)
        if ha and federation:
            raise ValueError("ha=True and federation=S are exclusive modes")
        # policy storms (POLICY_PROFILES): mixed-generation fleet, tiered
        # pods, the scoring matrix installed — solo mode only (the policy
        # counters and scoring matrix are process-global, like the device
        # plane). ``policy_off`` runs the SAME storm (same rng draws:
        # tiers are still annotated, classes still labeled) as the
        # negative/bit-exactness control — the scheduler must behave
        # exactly like the pre-policy one: zero evictions.
        if policy is not None:
            if policy not in POLICY_PROFILES:
                raise ValueError(
                    f"unknown policy profile {policy!r}; "
                    f"have {POLICY_PROFILES}"
                )
            if ha or federation:
                raise ValueError("policy profiles run solo mode only")
            from nhd_tpu_torch import policy as _policy
            from nhd_tpu_torch.policy import scoring as _scoring

            if _policy.enabled() == policy_off:
                raise ValueError(
                    "policy storm needs NHD_POLICY="
                    + ("0 for the control run" if policy_off else
                       "1 (make policy-chaos sets it)")
                )
            _policy.reset_policy_metrics()
            _scoring.set_matrix(dict(POLICY_TPUT))
        # tenant storms (TENANT_PROFILES): the ingress admission plane's
        # overload scenario — solo mode only (the admission counters are
        # process-global). ``admit_off`` runs the SAME storm with
        # NHD_ADMIT=0 as the negative control: without the front door
        # the abusive tenant's backlog must demonstrably starve the
        # victim (chaos_storm --tenant asserts the violation happens —
        # an isolation invariant that can't fail proves nothing).
        if tenant is not None:
            if tenant not in TENANT_PROFILES:
                raise ValueError(
                    f"unknown tenant profile {tenant!r}; "
                    f"have {TENANT_PROFILES}"
                )
            if ha or federation:
                raise ValueError("tenant storms run solo mode only")
            if policy is not None or journey is not None:
                raise ValueError(
                    "tenant storms are exclusive with policy/journey modes"
                )
            admit_env = os.environ.get("NHD_ADMIT", "").lower()
            if (admit_env in ("1", "true", "on", "")) == admit_off:
                raise ValueError(
                    "tenant storm needs NHD_ADMIT="
                    + ("0 for the control cell" if admit_off else
                       "1 (make tenant-chaos sets it)")
                )
        self.tenant = tenant
        self.admit_off = admit_off
        self.abuse_rate = int(abuse_rate)
        self._tenant_deletes = 0       # control passes owed this step
        # per-run SLO tracker + flight recorder on the sim clock: the
        # victim/abuser p99s and the shed-accounting invariant (every
        # refusal has its decision record) both read from these. Created
        # ONCE here, not in _fresh_scheduler, so a mid-storm restart
        # keeps the run's history.
        self.slo: Optional[SloTracker] = None
        self.recorder: Optional[FlightRecorder] = None
        if tenant is not None:
            self.slo = SloTracker(clock=self.sim_clock)
            # a deep decision ring: the accounting invariant counts
            # admission-shed decisions across the WHOLE run, so the ring
            # must outlast the storm's worst shed tally
            self.recorder = FlightRecorder(
                decision_capacity=65536, identity="tenant-chaos"
            )
        self.policy = policy
        self.policy_off = policy_off
        self._evicts_seen = 0          # per-step eviction-bound cursor
        self._maint_wave_left = 0      # maint-wave profile state
        self._maint_wave_nodes: List[str] = []
        self.seed = seed
        self.rng = random.Random(seed)
        self.hardened = hardened
        self.ha = ha
        self.federation = int(federation or 0)
        self.n_shards = self.federation
        self.lease_ttl = lease_ttl
        # federation runs trace by default: the fleet artifact + journey
        # merge ARE the mode's observability deliverable (ISSUE 7), and a
        # 4096-span per-replica ring costs microseconds per step
        self.tracing = bool(federation) if tracing is None else tracing
        # views banked from replicas killed/restarted mid-storm, so a
        # journey leg recorded by a dead incarnation still merges
        self._retired_views: List[dict] = []
        # monotonic counter totals banked from dead incarnations' private
        # elector registries (handoffs, renewal failures) — see
        # fleet_artifact for why these live outside API_COUNTERS
        self._retired_counters: Dict[str, int] = {}
        # the one-shot fleet artifact written around the FIRST invariant
        # violation (path, or None until then)
        self.violation_artifact_path: Optional[str] = None
        self._now = 0.0
        base = FakeClusterBackend()
        # lease expiry runs off the sim's step clock, not wall time —
        # a failing seed replays exactly
        base.clock = self.sim_clock
        self.base = base
        self.fed_profile = api_faults if self.federation else None
        # solver data-plane storm (device-faults profile): the guard and
        # the device plane are process-global, so device profiles run
        # SOLO mode only. The injector rides its own seeded RNG stream
        # (like the flap rng) and the profile's API-fault fields are all
        # zero, so the cell's churn/action sequence stays bit-identical
        # to a fault-free run of the same seed — that equality is the
        # bind-parity invariant the device-chaos matrix checks.
        self.device_profile = None
        self.device_injector = None
        if api_faults is not None and api_faults.has_device_faults():
            if ha or federation:
                raise ValueError(
                    "device-fault profiles run solo mode only (the "
                    "solver guard and device plane are process-global)"
                )
            if os.environ.get("NHD_TPU_DEVICE_STATE") == "0":
                # the port keeps resident node tensors on every device;
                # only an explicit NHD_TPU_DEVICE_STATE=0 asks for none,
                # and a device storm against no device state would pass
                # vacuously. Fail loud instead.
                raise ValueError(
                    "device-fault profiles need the resident-state path "
                    "active: unset NHD_TPU_DEVICE_STATE or set it to 1 "
                    "(sim/storm.py --device-plane does)"
                )
            from nhd_tpu_torch.sim.faults import DeviceFaultInjector
            from nhd_tpu_torch.solver import guard

            self.device_profile = api_faults
            self._dev_rng = random.Random(seed + 424243)
            self.device_injector = DeviceFaultInjector(
                api_faults, self._dev_rng
            )
            guard.GUARD.reset()
            guard.set_fault_injector(self.device_injector)
        if api_faults is not None and not self.federation:
            # the fault RNG is its own seeded stream: fault timing stays
            # reproducible without perturbing the churn sequence
            self.backend = FaultyBackend(
                base, api_faults, random.Random(seed + 7919)
            )
        else:
            # federation: faults are PER REPLICA (each member has its own
            # seeded FaultyBackend behind its vantage); the sim's own
            # handle stays the bare cluster
            self.backend = base
        if self.federation:
            self.group_pool = _fed_group_pool(self.federation)
        # journey input mode (record/replay, obs/journal.py): a recorded
        # journal replaces the synthetic genesis AND the rng action draw
        # — recorded traffic shapes run under this cell's fault profile
        # with every existing invariant. Solo mode only (journals are
        # per-process, like the recorder).
        self.journey = journey
        self._journey_steps: Dict[int, List[dict]] = {}
        journey_genesis: Optional[dict] = None
        if journey is not None:
            if ha or federation:
                raise ValueError("journey input mode runs solo mode only")
            from nhd_tpu_torch.obs.journal import load_journal

            _header, j_events = load_journal(journey)
            journey_genesis = next(
                (e for e in j_events if e["ev"] == "genesis"), None
            )
            if journey_genesis is None:
                raise ValueError(f"{journey}: journal has no genesis event")
            t0 = j_events[0]["t"]
            for e in j_events:
                if e["ev"] != "cluster":
                    continue
                # events landing in ((k-1)·STEP, k·STEP] apply at step k
                rel = max(e["t"] - t0, 0.0)
                step_bin = max(int(math.ceil(rel / STEP_SEC - 1e-9)), 1)
                self._journey_steps.setdefault(step_bin, []).append(e)
        if journey_genesis is not None:
            for nd in journey_genesis["nodes"]:
                self.backend.add_node(
                    nd["name"], dict(nd["labels"]),
                    hugepages_gb=int(nd.get("hugepages_gb") or 64),
                    addr=nd.get("addr", ""),
                )
        else:
            for i in range(n_nodes):
                spec = SynthNodeSpec(name=f"node{i}")
                if self.federation:
                    # spread node groups so every shard lease fronts nodes
                    spec.groups = self.group_pool[i % len(self.group_pool)]
                if self.policy:
                    # mixed-generation fleet: classes cycle so every storm
                    # exercises scoring across generations — and nodes are
                    # SMALL (a couple of pods each), so the storm actually
                    # saturates and preemption pressure is real, not
                    # vacuous (a fleet that never fills never preempts)
                    spec.node_class = POLICY_CLASSES[i % len(POLICY_CLASSES)]
                    spec.phys_cores = 8
                    spec.gpus_per_numa = 1
                    spec.hugepages_gb = 8
                self.backend.add_node(
                    spec.name, make_node_labels(spec),
                    hugepages_gb=spec.hugepages_gb,
                )
        self.stats = ChaosStats()
        self._pod_seq = 0
        self._node_seq = 0
        # structural node churn rides its OWN seeded stream so adding it
        # (PR 9) left every existing seed's action sequence — and the
        # regressions pinned against them — bit-identical
        self._flap_rng = random.Random(seed + 104729)
        self._leader_gap = 0
        if self.federation:
            self._peers = [f"fed-{chr(ord('a') + i)}" for i in range(n_replicas)]
            self._shard_gap = {s: 0 for s in range(self.n_shards)}
            self._incarnations = 0
            self._retired_faults: Dict[str, int] = {}
            self.replicas = [
                _FedReplica(self, ident, self._peers, self._next_incarnation())
                for ident in self._peers
            ]
        elif self.ha:
            self.replicas = [
                _Replica(self, "sched-a"), _Replica(self, "sched-b")
            ]
        else:
            self._fresh_scheduler()
        # record/replay capture (obs/journal.py): when a process-global
        # journal is active, solo storms record into it — the sim clock
        # stamps events, genesis snapshots the post-setup inventory, and
        # the scenario/fault sinks script every later cluster mutation.
        # Wired AFTER the initial add_node loop so the genesis inventory
        # is not double-recorded as cluster events.
        if not self.ha and not self.federation:
            from nhd_tpu_torch.obs.journal import genesis_nodes, get_journal

            jnl = get_journal()
            if jnl is not None:
                jnl.clock = self.sim_clock
                jnl.genesis(
                    genesis_nodes(self.base), seed=seed, mode="chaos",
                    respect_busy=False,
                )
                self.base.scenario_sink = jnl.cluster_event
                if isinstance(self.backend, FaultyBackend):
                    self.backend.fault_sink = jnl.fault_event

    def sim_clock(self) -> float:
        return self._now

    def _next_incarnation(self) -> int:
        self._incarnations += 1
        return self._incarnations

    def _replace_replica(self, idx: int) -> None:
        """Crash-only replacement: bank the dead incarnation's fault
        tallies, then rejoin under the same identity with a fresh
        elector (re-acquisitions bump every shard epoch, fencing the old
        incarnation's in-flight writes)."""
        old = self.replicas[idx]
        self._bank_counters(old.counters)
        if old.faulty is not None:
            for k, n in old.faulty.fault_stats.items():
                self._retired_faults[k] = self._retired_faults.get(k, 0) + n
        if old.recorder is not None:
            # bank the dead incarnation's view: its spans are legs of
            # journeys that continue on the survivors, and the merge
            # keys on the span-level replica stamp (same ident), so the
            # view label only needs to stay unique
            from nhd_tpu_torch.obs.fleet import replica_view

            self._retired_views.append(replica_view(
                f"{old.ident}#retired{len(self._retired_views) + 1}",
                recorder=old.recorder, slo=old.slo,
                decisions=old.recorder.recent_decisions(200),
            ))
        self.replicas[idx] = _FedReplica(
            self, old.ident, self._peers, self._next_incarnation()
        )

    def fault_totals(self) -> Dict[str, int]:
        """Injected-fault tallies across the whole run (federation mode
        sums every replica incarnation's stream)."""
        if self.federation:
            tot = dict(self._retired_faults)
            for r in self.replicas:
                if r.faulty is None:
                    continue
                for k, n in r.faulty.fault_stats.items():
                    tot[k] = tot.get(k, 0) + n
            return tot
        tot = (
            dict(self.backend.fault_stats)
            if isinstance(self.backend, FaultyBackend) else {}
        )
        if self.device_injector is not None:
            tot.update({
                f"device_{k}": n
                for k, n in self.device_injector.stats.items()
            })
            tot["device_bit_flips"] = self.stats.bit_flips
        return tot

    # ------------------------------------------------------------------
    # fleet observability producers (federation mode with tracing on):
    # the in-process twins of tools/fleet_top.py's scrape path
    # ------------------------------------------------------------------

    def fleet_views(self) -> List[dict]:
        """One replica_view per live member plus the banked views of
        killed incarnations — the input shape obs/fleet.py aggregates.
        Degrades rather than crashes outside federation: ha-mode
        _Replicas carry no recorder/SLO plane and their LeaderElector
        has no shard table, so their views are identity + empty shards."""
        from nhd_tpu_torch.obs.fleet import replica_view

        views = list(self._retired_views)
        for r in getattr(self, "replicas", []):
            rec = getattr(r, "recorder", None)
            owned = getattr(r.elector, "owned_shards", None)
            views.append(replica_view(
                r.ident,
                recorder=rec, slo=getattr(r, "slo", None),
                shards=owned() if owned is not None else {},
                decisions=(rec.recent_decisions(200)
                           if rec is not None else None),
            ))
        return views

    def merged_trace(self) -> dict:
        """All replicas' span rings (dead incarnations included) merged
        into one Chrome trace — the per-pod journey view."""
        traces = [
            v["trace"] for v in self._retired_views if v.get("trace")
        ]
        traces += [
            chrome_trace(r.recorder)
            for r in getattr(self, "replicas", [])
            if getattr(r, "recorder", None) is not None
        ]
        return merge_chrome_traces(traces)

    def fleet_artifact(self) -> dict:
        """The schema-versioned fleet artifact for this run's current
        state (obs/fleet.py; validated by the writer)."""
        from nhd_tpu_torch.obs.fleet import build_fleet_artifact

        leadership = {
            "max_shard_gap_steps": self.stats.max_shard_gap,
            "max_leader_gap_steps": self.stats.max_leader_gap,
            "shard_epochs": {
                str(s): e for s, e in sorted(self.stats.shard_epochs.items())
            },
            "lease_ttl_sec": self.lease_ttl,
            "steps": self.stats.steps,
        }
        return build_fleet_artifact(
            self.fleet_views(), seed=self.seed, leadership=leadership,
            counters=self._counter_totals(),
            violations=list(self.stats.violations),
        )

    def _bank_counters(self, counters: ApiCounters) -> None:
        """Bank a dead incarnation's monotonic totals before its private
        registry is dropped with it."""
        for k, v in counters.snapshot().items():
            if v and ApiCounters.KNOWN.get(k, ("", ""))[0] == "counter":
                self._retired_counters[k] = self._retired_counters.get(k, 0) + v

    def _counter_totals(self) -> Dict[str, int]:
        """API_COUNTERS plus every replica's private elector registry
        (live and banked). The electors count handoffs/renewal failures
        into per-replica ApiCounters (N replicas in one process must not
        fight over the leader gauges) — without folding those monotonic
        totals back in, the fleet artifact reports 0 handoffs through a
        storm full of them. Counter kinds only: summing gauges like
        ha_is_leader across replicas is meaningless."""
        totals = dict(API_COUNTERS.snapshot())
        tallies = dict(self._retired_counters)
        for r in getattr(self, "replicas", []):
            rc = getattr(r, "counters", None)
            if rc is None:
                continue
            for k, v in rc.snapshot().items():
                if v and ApiCounters.KNOWN.get(k, ("", ""))[0] == "counter":
                    tallies[k] = tallies.get(k, 0) + v
        for k, v in tallies.items():
            totals[k] = totals.get(k, 0) + v
        return totals

    def write_fleet_artifact(self, out_dir: Optional[str] = None) -> str:
        from nhd_tpu_torch.obs import fleet as obs_fleet

        out_dir = out_dir or os.environ.get("NHD_FLEET_DIR", "artifacts/fleet")
        return obs_fleet.write_fleet_artifact(
            self.fleet_artifact(), out_dir,
            name=f"fleet-seed{self.seed}-step{self.stats.steps}.json",
        )

    def _maybe_capture_violation(self) -> None:
        """First invariant violation → fleet artifact on disk, so a
        failed storm leaves the federation's full observable state next
        to the assertion message (one-shot; capture is best-effort —
        a broken artifact writer must not mask the violation itself)."""
        if (
            not self.stats.violations
            or not self.tracing
            or not self.federation
            or self.violation_artifact_path is not None
        ):
            return
        try:
            self.violation_artifact_path = self.write_fleet_artifact()
        except Exception as exc:  # pragma: no cover - diagnostic path
            self.violation_artifact_path = f"capture failed: {exc}"

    def _fresh_scheduler(self) -> None:
        if self.tenant is not None:
            # tenant storms put the REAL front door in the loop: the
            # AdmissionQueue (on the sim clock, so bucket refills and
            # shed stamps replay exactly) instead of the plain FIFO,
            # plus the run's persistent SLO tracker and recorder
            from nhd_tpu_torch.ingress import AdmissionQueue

            self.sched = Scheduler(
                self.backend, AdmissionQueue(clock=self.sim_clock),
                queue.Queue(), respect_busy=False,
                recorder=self.recorder, slo=self.slo, device=self.device,
            )
        else:
            self.sched = Scheduler(
                self.backend, WatchQueue(), queue.Queue(), respect_busy=False,
                device=self.device,
            )
        self.controller = Controller(
            self.backend, self.sched.nqueue, isolate_events=self.hardened
        )
        self.sched.build_initial_node_list()
        self.sched.load_deployed_configs()

    # ------------------------------------------------------------------
    # chaos actions
    # ------------------------------------------------------------------

    def _act_create(self) -> None:
        self._pod_seq += 1
        if self.federation:
            # draw from the shard-covering pool so pods home to (and
            # spill across) every shard, not just default/edge's
            groups = self.rng.choice([None] + self.group_pool)
        else:
            groups = self.rng.choice([None, None, "default", "edge"])
        if self.rng.random() < 0.25:
            # exercise the second config format through the same storm
            cfg_type = "json"
            cfg = json.dumps({
                "map_mode": self.rng.choice(["NUMA", "NUMA", "PCI"]),
                "hugepages_gb": self.rng.choice([2, 4]),
                "misc_cores": {"count": 1, "smt": True},
                "groups": [{
                    "proc_cores": {"count": self.rng.choice([3, 4]),
                                   "smt": True},
                    "helper_cores": {"count": 1, "smt": True},
                    "gpus": self.rng.choice([0, 1]),
                    "nic": {"rx_gbps": 10.0, "tx_gbps": 5.0},
                }],
            })
        else:
            cfg_type = "triad"
            cfg = make_triad_config(
                n_groups=self.rng.choice([1, 1, 2]),
                gpus_per_group=self.rng.choice([0, 1]),
                cpu_workers=self.rng.choice([1, 2]),
                hugepages_gb=self.rng.choice([2, 4]),
                map_type=self.rng.choice(["NUMA", "NUMA", "PCI"]),
            )
        tier = 0
        ns = "default"
        if self.policy:
            # tiered workloads: the quota-storm profile spreads tenants
            # and leans high-tier (the per-tenant budget's scenario);
            # the other profiles keep a best-effort-heavy mix. The draws
            # run in BOTH the policy-on and the policy_off control run
            # (same rng stream → same churn sequence; the control's
            # scheduler just ignores the tiers).
            if self.policy == "quota-storm":
                ns = self.rng.choice(POLICY_TENANTS)
                tier = self.rng.choices((0, 1, 2), weights=(4, 3, 3))[0]
            else:
                tier = self.rng.choices((0, 1, 2), weights=(6, 3, 1))[0]
        self.backend.create_pod(
            f"chaos-{self._pod_seq}", ns, cfg_text=cfg, cfg_type=cfg_type,
            groups=groups, tier=tier,
        )
        self.stats.created += 1

    # ------------------------------------------------------------------
    # tenant-storm traffic (ISSUE 20): deterministic, no rng — the
    # storm's shape IS the scenario (victim trickle vs abuser flood),
    # and bit-identical cells are what make the calm/storm/control
    # comparison meaningful
    # ------------------------------------------------------------------

    def _tenant_create(self, ns: str, tier: int = 0) -> None:
        self._pod_seq += 1
        cfg = make_triad_config(
            n_groups=1, gpus_per_group=0, cpu_workers=1,
            hugepages_gb=2, map_type="NUMA",
        )
        self.backend.create_pod(
            f"chaos-{self._pod_seq}", ns, cfg_text=cfg, cfg_type="triad",
            tier=tier,
        )
        self.stats.created += 1

    def _tenant_step(self) -> None:
        # short jobs: last step's bound pods complete first, freeing
        # capacity — the storm must measure QUEUE delay, not cluster
        # saturation (a full fleet would starve the victim in every
        # cell and prove nothing about the front door)
        bound = [p for p in self.backend.pods.values() if p.node]
        self._tenant_deletes += len(bound)
        for p in bound:
            self.backend.delete_pod(p.name, p.namespace)
            self.stats.deleted += 1
        self._tenant_create(TENANT_VICTIM)
        for _ in range(self.abuse_rate):
            self._tenant_create(TENANT_ABUSER)

    def _act_group_move(self) -> None:
        from nhd_tpu_torch.scheduler.controller import NHD_GROUP_LABEL

        name = self.rng.choice(list(self.backend.nodes))
        if self.federation:
            # group moves RE-HOME a node across shards mid-storm — the
            # handoff/fencing machinery must survive the node-set of a
            # shard changing under it
            dotted = ".".join(self.rng.sample(self.group_pool, 2))
            value = self.rng.choice(self.group_pool + [dotted, None])
        else:
            value = self.rng.choice(["default", "edge", "default.edge", None])
        self.backend.update_node_labels(name, {NHD_GROUP_LABEL: value})
        self.stats.group_moves += 1

    def _act_delete(self) -> None:
        bound = [p for p in self.backend.pods.values() if p.node]
        if bound:
            victim = self.rng.choice(bound)
            self.backend.delete_pod(victim.name, victim.namespace)
            self.stats.deleted += 1

    def _act_silent_delete(self) -> None:
        """Controller-down deletion: the pod vanishes with NO watch event;
        only the periodic mirror-vs-live diff
        (Scheduler.reconcile_deleted_pods) can release its claims."""
        bound = [p for p in self.backend.pods.values() if p.node]
        if bound:
            victim = self.rng.choice(bound)
            self.backend.delete_pod(
                victim.name, victim.namespace, emit_watch=False
            )
            self.stats.deleted += 1
            self.stats.silent_deletes += 1

    def _act_cordon(self) -> None:
        name = self.rng.choice(list(self.backend.nodes))
        self.backend.cordon_node(name, self.rng.random() < 0.5)
        self.stats.cordons += 1

    def _act_maintenance(self) -> None:
        name = self.rng.choice(list(self.backend.nodes))
        # include clearing states, or long soaks would monotonically drain
        # every node and stop exercising scheduling
        value = self.rng.choice(["draining", "not_scheduled", None])
        self.backend.update_node_labels(
            name, {"sigproc.viasat.io/maintenance": value}
        )
        self.stats.maint_flips += 1

    def _act_bind_failure(self) -> None:
        # next unbound pod's bind will fail once
        pending = [p for p in self.backend.pods.values() if p.node is None]
        if pending:
            victim = self.rng.choice(pending)
            # route through the backend method (not the raw set) so the
            # journal's scenario sink scripts the armed failure for replay
            self.backend.arm_bind_failure(victim.namespace, victim.name)
            self.stats.bind_failures += 1

    # -- restart + state-equivalence ------------------------------------

    def _claims_map(self, sched: Scheduler) -> Dict[Tuple[str, str], str]:
        return {
            (ns, pod): name
            for name, node in sched.nodes.items()
            for (pod, ns) in node.pod_info
        }

    def _mirror_snapshot(self, sched: Scheduler) -> Dict[str, tuple]:
        """Per-node resource accounting, for claim-replay equivalence:
        which pods, how many hugepages free, how many non-reserved cores
        in use."""
        out = {}
        for name, node in sched.nodes.items():
            used = sum(
                1 for c in node.cores
                if c.used and c.core not in node.reserved_cores
            )
            out[name] = (
                frozenset((ns, pod) for (pod, ns) in node.pod_info),
                node.mem.free_hugepages_gb,
                used,
            )
        return out

    def _backend_bound(self) -> Dict[Tuple[str, str], str]:
        return {
            (p.namespace, p.name): p.node
            for p in self.backend.pods.values() if p.node
        }

    def _check_restart_equivalence(
        self,
        pre_claims: Optional[Dict[Tuple[str, str], str]],
        pre_snapshot: Optional[Dict[str, tuple]],
        sched: Scheduler,
    ) -> None:
        """A restarted replica's replay must reconstruct the SAME state,
        not merely an invariant-satisfying one: its claims equal the
        cluster's bound set, and — when the pre-restart mirror was itself
        current — the full per-node accounting matches too (pods that
        silently vanished from the cluster are excluded: the old mirror
        legitimately still carries them until the reconcile net runs)."""
        expected = self._backend_bound()
        post = self._claims_map(sched)
        if post != expected:
            self.stats.violations.append(
                f"step {self.stats.steps}: restart replay diverged from "
                f"cluster (replayed {sorted(post)} != bound "
                f"{sorted(expected)})"
            )
            return
        if pre_claims is None:
            return
        filtered = {k: v for k, v in pre_claims.items() if k in expected}
        if filtered != post:
            self.stats.violations.append(
                f"step {self.stats.steps}: post-restart claims differ "
                f"from pre-restart claims ({sorted(filtered)} -> "
                f"{sorted(post)})"
            )
        elif pre_claims == expected and pre_snapshot is not None:
            if self._mirror_snapshot(sched) != pre_snapshot:
                self.stats.violations.append(
                    f"step {self.stats.steps}: post-restart resource "
                    "accounting differs from pre-restart accounting"
                )

    def _act_restart(self) -> None:
        """Scheduler crash + restart: state must replay from annotations
        to EQUIVALENT claims (not just invariant-clean ones). Federation
        restarts rejoin with a fresh elector — epochs bump on every
        shard the new incarnation re-acquires, and its scoped promotion
        replays are vetted by the per-shard mirror invariants."""
        if self.federation:
            alive = [i for i, r in enumerate(self.replicas) if r.dead_for == 0]
            if alive:
                self._replace_replica(self.rng.choice(alive))
                self.stats.restarts += 1
            return
        if self.ha:
            idx = self.rng.randrange(len(self.replicas))
            old = self.replicas[idx]
            # the pre-restart mirror is only a sound comparison baseline
            # when this replica was the TRUE leader (a stale believer's
            # mirror legitimately lags the cluster)
            sound = old.is_true_leader(self)
            pre_claims = self._claims_map(old.sched) if sound else None
            pre_snap = self._mirror_snapshot(old.sched) if sound else None
            self._bank_counters(old.counters)
            self.replicas[idx] = _Replica(self, old.ident)
            self._check_restart_equivalence(
                pre_claims, pre_snap, self.replicas[idx].sched
            )
        else:
            pre_claims = self._claims_map(self.sched)
            pre_snap = self._mirror_snapshot(self.sched)
            if self.base.scenario_sink is not None:
                # the restart is a scenario input (not derivable from any
                # watch event) — script it so replay rebuilds its stack
                # at the same point in the storm
                self.base.scenario_sink("sched_restart", {})
            self._fresh_scheduler()
            self._check_restart_equivalence(pre_claims, pre_snap, self.sched)
        self.stats.restarts += 1

    def _act_node_flap(self) -> None:
        """Structural churn (solo mode): add a fresh node, or
        decommission one, through the live NODE_ADD/NODE_REMOVE watch
        path. The incremental cluster state absorbs adds as padded-slot
        row appends and removals as in-place tombstones — or falls back
        to a logged rebuild (capacity/compaction/re-add) — and the
        parity invariant vets the result either way. Removal only fires
        when nothing is pending and the victim holds no bound pods, so
        a pod can never race a vanishing node mid-step (a real cluster
        hazard, but not the invariant under test here)."""
        rng = self._flap_rng
        bound_nodes = {p.node for p in self.backend.pods.values() if p.node}
        pending = any(p.node is None for p in self.backend.pods.values())
        removable = [
            n for n in self.backend.nodes
            if n not in bound_nodes and not n.startswith("node")
        ]
        if (
            removable and not pending
            and len(self.backend.nodes) > 2
            and rng.random() < 0.5
        ):
            self.backend.remove_node(rng.choice(removable))
        else:
            self._node_seq += 1
            spec = SynthNodeSpec(name=f"flap{self._node_seq}")
            if self.policy:
                spec.node_class = POLICY_CLASSES[
                    self._node_seq % len(POLICY_CLASSES)
                ]
            self.backend.add_node(
                spec.name, make_node_labels(spec),
                hugepages_gb=spec.hugepages_gb, emit_watch=True,
            )
        self.stats.node_flaps += 1

    def _policy_wave_step(self) -> None:
        """maint-wave profile: periodically cordon ~a third of the fleet
        for a few steps, then uncordon — bound pods survive (cordon only
        blocks NEW placements) but the shrunken fleet forces rebinds and
        preemption pressure onto the remaining generations."""
        if self._maint_wave_left > 0:
            self._maint_wave_left -= 1
            if self._maint_wave_left == 0:
                for name in self._maint_wave_nodes:
                    if name in self.backend.nodes:
                        self.backend.cordon_node(name, False)
                self._maint_wave_nodes = []
            return
        if self.rng.random() < 0.15:
            names = list(self.backend.nodes)
            k = max(1, len(names) // 3)
            self._maint_wave_nodes = self.rng.sample(names, k)
            for name in self._maint_wave_nodes:
                self.backend.cordon_node(name, True)
            self._maint_wave_left = self.rng.randint(2, 3)
            self.stats.cordons += k

    def _check_policy_invariants(self) -> None:
        """The policy storm's standing invariants (ISSUE 15):

        * preemption bounded per step — evictions this step can never
          exceed the per-batch round budget times the passes one step
          can drive (POLICY_PASSES_PER_STEP);
        * no preemption cascade/livelock — no pod is ever evicted more
          than POLICY_CASCADE_BOUND times across the run;
        * no tier inversion — every executed eviction's victim was
          strictly lower-tier than its preemptor;
        * policy-off control — the ``policy_off`` run of the same storm
          must execute ZERO evictions (the scheduler with NHD_POLICY=0
          is the pre-policy scheduler, bit-exactly).
        """
        if self.policy is None:
            return
        log = self.base.evict_log
        new = len(log) - self._evicts_seen
        self._evicts_seen = len(log)
        v = self.stats.violations
        if self.policy_off:
            if log:
                v.append(
                    f"step {self.stats.steps}: policy-off control "
                    f"executed {len(log)} eviction(s)"
                )
            return
        from nhd_tpu_torch.policy import preempt as _preempt
        from nhd_tpu_torch.policy import preempt_pairs

        bound = _preempt.round_budget() * POLICY_PASSES_PER_STEP
        if new > bound:
            v.append(
                f"step {self.stats.steps}: {new} evictions in one step "
                f"exceed the per-step bound {bound}"
            )
        per_pod: Dict[Tuple[str, str], int] = {}
        for ns, pod, _uid, _node, _e, _l in log:
            per_pod[(ns, pod)] = per_pod.get((ns, pod), 0) + 1
        for key, n in per_pod.items():
            if n > POLICY_CASCADE_BOUND:
                v.append(
                    f"step {self.stats.steps}: pod {key[0]}/{key[1]} "
                    f"evicted {n} times (cascade bound "
                    f"{POLICY_CASCADE_BOUND})"
                )
        for p_tier, v_tier in preempt_pairs():
            if v_tier >= p_tier:
                v.append(
                    f"step {self.stats.steps}: tier inversion — victim "
                    f"tier {v_tier} >= preemptor tier {p_tier}"
                )

    def policy_victims_unresolved(self) -> List[Tuple[str, str]]:
        """Evicted pods that neither rebound nor reached an explicit
        verdict (unschedulable event, or deletion) — must be empty after
        quiesce: the victim-rebind invariant."""
        evicted = {
            (ns, pod) for ns, pod, _uid, _node, _e, _l in self.base.evict_log
        }
        no_candidate = {
            (e.namespace, e.pod)
            for e in self.base.events
            if e.reason == "FailedScheduling"
            and "No valid candidate" in e.message
        }
        out = []
        for ns, pod in sorted(evicted):
            p = self.base.pods.get((ns, pod))
            if p is None:
                continue  # deleted mid-storm: resolved
            if p.node is None and (ns, pod) not in no_candidate:
                out.append((ns, pod))
        return out

    def _resident_dev(self):
        """The solo scheduler's live device-resident state, or None
        (no batch has built the delta context yet)."""
        ctx = getattr(self.sched, "_delta_ctx", None)
        return ctx.dev if ctx is not None else None

    def _act_bit_flip(self) -> None:
        """Corrupt one resident device row in place (its OWN seeded
        stream, like the flap rng, so fault timing never perturbs the
        churn sequence): the guard's batch-start audit must detect and
        repair it from host truth before any solve reads the row. With
        the guard disabled (NHD_GUARD=0 — the negative control),
        the corruption persists and device_audit_errors() proves the
        parity invariant fires."""
        if self._dev_rng.random() >= self.device_profile.device_bit_flip:
            return
        dev = self._resident_dev()
        if dev is None or dev.N <= 0:
            return
        import torch

        from nhd_tpu_torch.solver.encode import DELTA_FIELDS

        name = self._dev_rng.choice(DELTA_FIELDS)
        shard, row = dev.shard_of(self._dev_rng.randrange(dev.N))
        t = shard[name]
        # in place, on the tensor's own device: the resident row itself
        # is what the guard's audit must find
        if t.dtype == torch.bool:
            t[row] = torch.logical_not(t[row])
        else:
            t[row] += 1
        self.stats.bit_flips += 1

    def device_audit_errors(self) -> List[str]:
        """Full-coverage audit of the live resident state against the
        host mirror ([] = bit-exact) — the device-faults acceptance
        check, and the negative control's tripwire: a bit-flipped run
        with the guard DISABLED must end with defects here."""
        dev = self._resident_dev()
        if dev is None:
            return []
        from nhd_tpu_torch.solver.guard import audit_device_rows

        # rows the delta re-packed since the last batch: the device is
        # legitimately behind there, and the next batch's refresh writes
        # every tensor of those rows (all rows, after a full rebuild)
        # before any solve reads them — the reference audits them too,
        # and reports a live cordon or release as corruption
        delta = getattr(self.sched, "_delta", None)
        if delta is not None and delta._full:
            return []
        pending = set(delta._dirty) if delta is not None else set()
        return audit_device_rows(
            dev, [r for r in range(dev.N) if r not in pending]
        )

    def bound_set(self) -> List[Tuple[str, str, str]]:
        """Sorted (ns, pod, node) of every bound pod — the bind-parity
        invariant compares a faulted run's end state against a
        fault-free run of the same seed with this."""
        return sorted(
            (p.namespace, p.name, p.node)
            for p in self.base.pods.values() if p.node
        )

    def _act_kill_wave(self) -> None:
        """Federation-only: take 1..N-1 replicas down simultaneously for
        a couple of steps — their shards must expire, rebalance onto the
        survivors (scoped replays included), and hand back when the
        fresh incarnations rejoin."""
        alive = [i for i, r in enumerate(self.replicas) if r.dead_for == 0]
        if len(alive) <= 1:
            return
        k = self.rng.randint(1, len(alive) - 1)
        for i in self.rng.sample(alive, k):
            self.replicas[i].dead_for = self.rng.randint(
                1, KILL_DOWN_MAX_STEPS
            )
        self.stats.kill_waves += 1

    # ------------------------------------------------------------------

    def _fed_pre_step(self) -> None:
        """Federation housekeeping at the top of a step: revive expired
        corpses as fresh incarnations, age/roll asymmetric partitions,
        then tick every live member's elector in jittered order."""
        for i, r in enumerate(self.replicas):
            if r.dead_for > 0:
                r.dead_for -= 1
                if r.dead_for == 0:
                    self._replace_replica(i)
                    self.stats.restarts += 1
        p = self.fed_profile.partition if self.fed_profile else 0.0
        steps_max = self.fed_profile.partition_steps if self.fed_profile else 0
        for r in self.replicas:
            if r.dead_for > 0:
                continue
            if r.vantage.partition_left > 0:
                r.vantage.partition_left -= 1
            elif p > 0 and self.rng.random() < p:
                r.vantage.partition_left = self.rng.randint(1, steps_max)
                self.stats.partitions += 1
        for r in self.rng.sample(self.replicas, len(self.replicas)):
            if r.dead_for == 0:
                r.elector.tick()

    def _apply_journey_op(self, event: dict) -> None:
        """Re-apply one recorded cluster mutation (journey input mode).

        Ops mirror the scenario-sink chokepoints in FakeClusterBackend
        plus the storm-level ``sched_restart`` marker. A malformed event
        (missing field, unknown node) becomes a recorded violation, not
        a crash — journey journals are user-supplied input."""
        op = event.get("op", "")
        p = event.get("args") or {}
        try:
            if op == "create_pod":
                self.backend.create_pod(
                    p["name"], p.get("ns", "default"),
                    cfg_text=p.get("cfg_text"),
                    cfg_type=p.get("cfg_type", "triad"),
                    groups=p.get("groups"),
                    resources=p.get("resources") or None,
                    scheduler_name=p.get(
                        "scheduler_name", "nhd-scheduler"
                    ),
                    emit_watch=bool(p.get("emit_watch", True)),
                    tier=int(p.get("tier", 0)),
                )
                self.stats.created += 1
            elif op == "delete_pod":
                silent = not p.get("emit_watch", True)
                self.backend.delete_pod(
                    p["name"], p.get("ns", "default"),
                    emit_watch=not silent,
                )
                if silent:
                    self.stats.silent_deletes += 1
                else:
                    self.stats.deleted += 1
            elif op == "add_node":
                self.backend.add_node(
                    p["name"], dict(p.get("labels") or {}),
                    hugepages_gb=int(p.get("hugepages_gb") or 64),
                    addr=p.get("addr", ""),
                    emit_watch=bool(p.get("emit_watch", False)),
                )
                self.stats.node_flaps += 1
            elif op == "remove_node":
                bound_nodes = {
                    pd.node for pd in self.backend.pods.values() if pd.node
                }
                if p["name"] in bound_nodes:
                    # the recorded removal targeted an empty node; if the
                    # replayed schedule placed pods there, skip rather
                    # than orphan them (divergence shows up in the diff)
                    return
                self.backend.remove_node(
                    p["name"],
                    emit_watch=bool(p.get("emit_watch", True)),
                )
                self.stats.node_flaps += 1
            elif op == "cordon_node":
                self.backend.cordon_node(
                    p["name"], bool(p.get("cordon", True))
                )
                self.stats.cordons += 1
            elif op == "update_node_labels":
                labels = dict(p.get("new_labels") or {})
                self.backend.update_node_labels(p["name"], labels)
                if "sigproc.viasat.io/maintenance" in labels:
                    self.stats.maint_flips += 1
                else:
                    self.stats.group_moves += 1
            elif op == "arm_bind_failure":
                self.backend.arm_bind_failure(p["ns"], p["pod"])
                self.stats.bind_failures += 1
            elif op == "sched_restart":
                pre_claims = self._claims_map(self.sched)
                pre_snap = self._mirror_snapshot(self.sched)
                self._fresh_scheduler()
                self._check_restart_equivalence(
                    pre_claims, pre_snap, self.sched
                )
                self.stats.restarts += 1
        except KeyError as exc:
            self.stats.violations.append(
                f"step {self.stats.steps}: journey op {op!r} missing {exc}"
            )

    def step(self) -> None:
        self.stats.steps += 1
        self._now += STEP_SEC
        if self.federation:
            self._fed_pre_step()
        elif self.ha:
            # jittered tick order: sometimes a standby acquires an
            # expired lease BEFORE the stale leader's tick notices —
            # the split-brain overlap fencing exists for
            for r in self.rng.sample(self.replicas, len(self.replicas)):
                r.elector.tick()
        if self.device_injector is not None:
            # refill the step's injection budget, then maybe corrupt a
            # resident row — BEFORE the control plane drives, so the
            # guard's batch-start audit is what stands between the
            # corruption and the step's solves
            self.device_injector.begin_step()
            self._act_bit_flip()
        actions = [
            self._act_create, self._act_delete, self._act_cordon,
            self._act_maintenance, self._act_bind_failure, self._act_restart,
            self._act_group_move, self._act_silent_delete,
        ]
        weights = [40, 15, 10, 10, 10, 5, 8, 8]
        if self.federation:
            actions.append(self._act_kill_wave)
            weights.append(4)
        if self.journey is not None:
            # journey replay: the recorded scenario script IS the action
            # source — no rng draws, no flap roll; every cluster mutation
            # the recorded storm made at this step is re-applied verbatim
            for e in self._journey_steps.get(self.stats.steps, []):
                self._apply_journey_op(e)
        elif self.tenant is not None:
            # tenant storm: deterministic victim-trickle/abuser-flood
            # traffic — no rng action draw, no structural churn; the
            # overload itself is the fault being injected
            self._tenant_step()
        else:
            action = self.rng.choices(actions, weights=weights)[0]
            action()
        if self.policy == "maint-wave":
            self._policy_wave_step()
        if self.journey is None and self.tenant is None and (
            not self.federation and not self.ha
        ) and (
            self._flap_rng.random() < 0.08
        ):
            # solo mode drives the incremental-state path: structural
            # node churn exercises its padded-slot/tombstone machinery
            self._act_node_flap()
        self._drive_control_plane()
        # clear one-shot bind failures so pods eventually land
        self.backend.fail_bind_for.clear()
        if self.federation:
            self._track_shard_leadership()
        elif self.ha:
            self._track_leadership()
        self.check_invariants()
        self._maybe_capture_violation()

    def _drive_control_plane(self, extra_drain: bool = False) -> None:
        """Let the control plane catch up on this step's churn."""
        if self.federation:
            # fan the single watch stream out to every live, unpartitioned
            # replica through its own faulted vantage (a partitioned
            # replica's events are simply lost to it — the resync-shaped
            # periodic scans repair whatever it missed)
            events = list(self.base.poll_watch_events())
            for r in self.replicas:
                if r.dead_for > 0 or r.vantage.partition_left > 0:
                    continue
                if r.faulty is not None:
                    r.vantage.feed(r.faulty.filter_watch_events(events))
                else:
                    r.vantage.feed(events)
                r.controller.run_once(now=self._now)
            for r in self.replicas:
                if r.dead_for > 0:
                    continue
                acting = r.sched.poll_leadership()
                for _ in range(8):
                    if r.sched.nqueue.empty():
                        break
                    r.sched.run_once()
                if acting:
                    # guarded like the run loop's periodic scan: a scan
                    # hitting a partition is isolated, and the mirror
                    # rebuilds on the next successful pass
                    r.sched._guarded("chaos scan", r.sched.check_pending_pods)
                    if extra_drain:
                        while not r.sched.nqueue.empty():
                            r.sched.run_once()
            return
        if not self.ha:
            if self.tenant is not None:
                self._drive_tenant(extra_drain)
                return
            self.controller.run_once(now=self._now)
            for _ in range(8):
                if self.sched.nqueue.empty():
                    break
                self.sched.run_once()
            self.sched.check_pending_pods()
            if extra_drain:
                # drain requeues raised by the reconcile pass itself
                while not self.sched.nqueue.empty():
                    self.sched.run_once()
            return
        # HA: every believer translates nothing — watch events are a
        # single drained stream on the fake backend, so ONE believer
        # (rng-picked under split-brain) polls them, like one replica
        # owning a watch connection; the others' periodic scans repair
        # whatever they never saw
        believers = [r for r in self.replicas if r.elector.is_leader]
        if believers:
            self.rng.choice(believers).controller.run_once(now=self._now)
        for r in self.replicas:
            acting = r.sched.poll_leadership()
            for _ in range(8):
                if r.sched.nqueue.empty():
                    break
                r.sched.run_once()
            if acting:
                r.sched.check_pending_pods()
                if extra_drain:
                    while not r.sched.nqueue.empty():
                        r.sched.run_once()

    def _drive_tenant(self, extra_drain: bool = False) -> None:
        """The tenant storm's deliberately scarce drive: the front door
        only earns its keep when arrivals outpace the drain, so the
        CREATE budget is TENANT_PASSES_PER_STEP (vs the generic storm's
        8) and the reconcile scan runs every TENANT_SCAN_EVERY steps
        (every step it would re-admit what the ladder shed, bypassing
        the front door entirely). Control traffic (the short jobs'
        deletes) gets exactly its own passes — it is never shed and in
        the admission cells always drains first, so the scarcity lands
        on creates alone."""
        self.controller.run_once(now=self._now)
        for _ in range(self._tenant_deletes + TENANT_PASSES_PER_STEP):
            if self.sched.nqueue.empty():
                break
            self.sched.run_once()
        self._tenant_deletes = 0
        # a real daemon turn publishes shed verdicts even when its get
        # idles out; the sim's bounded drive skips empty turns, so drain
        # explicitly — the accounting invariant (every refusal has its
        # event + decision) is checked after every step
        self.sched._guarded(
            "shed verdicts", self.sched._publish_shed_verdicts
        )
        if extra_drain or self.stats.steps % TENANT_SCAN_EVERY == 0:
            self.sched._guarded("chaos scan", self.sched.check_pending_pods)
        if extra_drain:
            while not self.sched.nqueue.empty():
                self.sched.run_once()
            self.sched._guarded(
                "shed verdicts", self.sched._publish_shed_verdicts
            )

    def _track_leadership(self) -> None:
        """The bounded-leadership-gap invariant: the cluster must never
        be headless for longer than lease expiry plus a few ticks (a
        fault can delay an election, but not indefinitely)."""
        if any(r.elector.is_leader for r in self.replicas):
            self._leader_gap = 0
        else:
            self._leader_gap += 1
            self.stats.max_leader_gap = max(
                self.stats.max_leader_gap, self._leader_gap
            )
            bound = int(self.lease_ttl / STEP_SEC) + 8
            if self._leader_gap > bound:
                self.stats.violations.append(
                    f"step {self.stats.steps}: no leader for "
                    f"{self._leader_gap} steps (bound {bound})"
                )
        view = self.backend.lease_read(LEASE_NAME)
        if view is not None:
            self.stats.lease_epoch = view.epoch

    def _track_shard_leadership(self) -> None:
        """The per-shard bounded-gap invariant: no shard may sit without
        a live owner longer than lease expiry + rendezvous patience +
        the fault windows the storm is allowed to open (a partition or
        kill wave can delay one handoff, never stall a shard forever)."""
        bound = (
            int(self.lease_ttl / STEP_SEC) + SHARD_PATIENCE_TICKS
            + (self.fed_profile.partition_steps if self.fed_profile else 0)
            + KILL_DOWN_MAX_STEPS + 6
        )
        for s in range(self.n_shards):
            # lease truth, not believed ownership: a partitioned replica
            # inside its renew grace still REPORTS the shard in
            # owned_shards() after its lease expired — counting that as
            # held would reset the gap and the bound would never be
            # measured. A shard counts as held only while its lease is
            # unexpired AND the holder is a live replica that knows it
            holder = self.base.lease_live(shard_lease_name(s, self.n_shards))
            held = bool(holder) and any(
                r.dead_for == 0 and r.ident == holder
                and s in r.elector.owned_shards()
                for r in self.replicas
            )
            if held:
                self._shard_gap[s] = 0
            else:
                self._shard_gap[s] += 1
                self.stats.max_shard_gap = max(
                    self.stats.max_shard_gap, self._shard_gap[s]
                )
                if self._shard_gap[s] > bound:
                    self.stats.violations.append(
                        f"step {self.stats.steps}: shard {s} ownerless "
                        f"for {self._shard_gap[s]} steps (bound {bound})"
                    )
            view = self.base.lease_read(shard_lease_name(s, self.n_shards))
            if view is not None:
                self.stats.shard_epochs[s] = view.epoch
        self.stats.lease_epoch = max(
            self.stats.shard_epochs.values(), default=0
        )

    # ------------------------------------------------------------------
    # invariants
    # ------------------------------------------------------------------

    def _check_scheduler_invariants(
        self, sched: Scheduler, only_nodes: Optional[Set[str]] = None
    ) -> None:
        """Conservation laws for one scheduler's mirror. ``only_nodes``
        scopes the check to a shard's node slice under federation —
        a member's mirror for shards it does NOT own is a warm standby
        view that legitimately lags the cluster."""
        v = self.stats.violations
        for name, node in sched.nodes.items():
            if only_nodes is not None and name not in only_nodes:
                continue
            if node.mem.free_hugepages_gb < 0:
                v.append(f"step {self.stats.steps}: {name} negative hugepages")
            for nic in node.nics:
                if nic.pods_used < 0:
                    v.append(f"step {self.stats.steps}: {name} negative pods_used")
                if nic.speed_used[0] < -1e-9 or nic.speed_used[1] < -1e-9:
                    v.append(f"step {self.stats.steps}: {name} negative NIC bw")
            # every bound pod's claims replayable: cores used >= pods' demand
            used = sum(
                1 for c in node.cores
                if c.used and c.core not in node.reserved_cores
            )
            if node.pod_info and used == 0:
                v.append(f"step {self.stats.steps}: {name} has pods but no cores")
            if not node.pod_info and used > 0:
                v.append(
                    f"step {self.stats.steps}: {name} leaked {used} cores "
                    f"with no pods"
                )

        # the delta/rebuild invariant (ISSUE 9): whatever this step's
        # faults cost — a dropped event, a poisoned one, a forced full
        # rebuild — the incremental cluster state must remain bit-exact
        # re-derivable from the live mirror. A fault may buy a rebuild;
        # it may never buy divergence.
        delta = getattr(sched, "_delta", None)
        if delta is not None and only_nodes is None:
            for err in delta.parity_errors():
                v.append(
                    f"step {self.stats.steps}: resident-state parity: {err}"
                )
            self.stats.delta_rebuilds = max(
                self.stats.delta_rebuilds, delta.rebuilds
            )
        # streaming path: every persistent tile context carries its own
        # delta — same invariant, per tile, judged net of the pending
        # note trail. A membership change condemns the whole state (it
        # resets at the next schedule), so there is nothing to judge.
        stream = getattr(sched, "_stream", None)
        pstate = getattr(stream, "_pstate", None) if stream else None
        if (
            pstate is not None
            and only_nodes is None
            and pstate["names"] == list(sched.nodes.keys())
        ):
            stream.route_notes()
            for ti, tile_delta in enumerate(pstate["deltas"]):
                if tile_delta is None:
                    continue
                for err in tile_delta.parity_errors():
                    v.append(
                        f"step {self.stats.steps}: tile {ti} "
                        f"resident-state parity: {err}"
                    )

        # backend and mirror agree on placements
        bound = self._backend_bound()
        for key, node_name in self._claims_map(sched).items():
            if only_nodes is not None and node_name not in only_nodes:
                continue
            if key not in bound:
                # a vanished pod is released only after missing on two
                # consecutive scans (reconcile_deleted_pods); a claim in
                # the suspect set is awaiting its confirmation, not leaked
                if key in sched._missing_once:
                    continue
                v.append(f"step {self.stats.steps}: mirror has unbound {key}")
            elif bound[key] != node_name:
                v.append(f"step {self.stats.steps}: {key} mirror/backend differ")

    def check_invariants(self) -> None:
        """Conservation laws that must hold after every step."""
        if self.federation:
            # each live member's mirror must agree with the cluster on
            # the shards the LEASE says it truly owns (a stale believer's
            # slice is fenced off and repairs at its next scoped replay)
            for r in self.replicas:
                if r.dead_for > 0 or r.vantage.partition_left > 0:
                    # a partitioned member cannot see the cluster, so its
                    # mirror legitimately lags until the heal-time scan
                    # rebuilds it; quiesce re-checks with partitions off
                    continue
                owned_true = r.truly_owned(self)
                if not owned_true:
                    continue
                only = {
                    name for name, node in r.sched.nodes.items()
                    if r.sched._node_shard(node) in owned_true
                }
                self._check_scheduler_invariants(r.sched, only_nodes=only)
            self._check_spillover_orphans()
            self._check_slo_plane()
        elif self.ha:
            # a stale believer's mirror legitimately lags (its writes are
            # fenced off; its view repairs at the next promotion replay) —
            # the TRUE leader's mirror is the one that must agree with the
            # cluster
            for r in self.replicas:
                if r.is_true_leader(self):
                    self._check_scheduler_invariants(r.sched)
        else:
            self._check_scheduler_invariants(self.sched)
            self._check_policy_invariants()
            self._check_tenant_invariants()
        self._check_single_epoch_binds()

    def _check_single_epoch_binds(self) -> None:
        """The split-brain acceptance invariant: every pod incarnation is
        bound by AT MOST one leadership. Two successful binds for one uid
        — same epoch or different, same shard lease or different — mean
        a deposed owner's write landed past the fence.

        Policy preemption (ISSUE 15) legitimately re-binds a uid: the
        victim is evicted (through the same fenced chokepoint) and
        requeued, so the allowance is 1 + that uid's evictions — an
        unmatched extra bind still fires exactly as before."""
        evicts_per_uid: Dict[str, int] = {}
        for _ns, _pod, uid, _node, _e, _l in self.base.evict_log:
            evicts_per_uid[uid] = evicts_per_uid.get(uid, 0) + 1
        per_uid: Dict[str, List] = {}
        for ns, pod, uid, node, epoch, lease in self.backend.bind_log:
            per_uid.setdefault(uid, []).append((ns, pod, node, epoch, lease))
        for uid, binds in per_uid.items():
            if len(binds) > 1 + evicts_per_uid.get(uid, 0):
                self.stats.violations.append(
                    f"step {self.stats.steps}: pod uid {uid} bound "
                    f"{len(binds)} times "
                    f"({evicts_per_uid.get(uid, 0)} evictions): {binds}"
                )

    def _check_slo_plane(self) -> None:
        """Physical laws of the SLO clock (obs/slo.py): time-to-bind is
        measured creation→bind on the CLUSTER's clock, so no replica —
        fresh incarnation or not — can ever report a figure exceeding
        the sim's total elapsed time, and breaches can't outnumber
        observations. A violation here means a tracker mixed clock
        domains (exactly the bug the creationTimestamp origin exists to
        rule out)."""
        if not self.tracing:
            return
        for r in self.replicas:
            slo = getattr(r, "slo", None)
            if slo is None:
                continue
            snap = slo.snapshot(now=self._now)
            if snap["breaches_total"] > snap["observations_total"]:
                self.stats.violations.append(
                    f"step {self.stats.steps}: {r.ident} SLO breaches "
                    f"{snap['breaches_total']} > observations "
                    f"{snap['observations_total']}"
                )
            if snap["max_seconds"] > self._now + STEP_SEC:
                self.stats.violations.append(
                    f"step {self.stats.steps}: {r.ident} time-to-bind "
                    f"{snap['max_seconds']:.0f}s exceeds sim elapsed "
                    f"{self._now:.0f}s (clock-domain mix)"
                )

    def _check_tenant_invariants(self) -> None:
        """The tenant storm's standing laws, checked after every step:

        **Shed accounting** — never silent, never double-issued: the
        queue's refusal tally, the cluster's AdmissionShed pod events
        and the recorder's admission-shed decision records must agree
        exactly. A lag means a verdict was lost (a shed pod's owner
        would see nothing); an excess means one refusal was verdicted
        twice.

        **SLO clock domain** — the per-run tracker rides the sim clock,
        so no tenant figure can exceed the sim's elapsed time and
        breaches can't outnumber observations (the same physical law
        _check_slo_plane holds the HA/federation trackers to).

        The ISOLATION judgment (victim p99 flat under the flood) is
        deliberately NOT here: it is a cross-cell comparison — storm
        vs calm, and the admit-off control must FAIL it — made by
        chaos_storm --tenant over tenant_report()."""
        if self.tenant is None:
            return
        q = self.sched.nqueue
        stats = getattr(q, "stats", None)
        if stats is None or self.recorder is None:
            return
        shed = stats["shed"]
        events = sum(
            1 for e in self.base.events if e.reason == "AdmissionShed"
        )
        decisions = sum(
            1
            for d in self.recorder.recent_decisions(1 << 30)
            if d.get("outcome") == "admission-shed"
        )
        if not (shed == events == decisions):
            self.stats.violations.append(
                f"step {self.stats.steps}: shed accounting diverged — "
                f"queue refused {shed}, AdmissionShed events {events}, "
                f"admission-shed decisions {decisions} (a refusal was "
                "lost or double-verdicted)"
            )
        if self.slo is not None:
            snap = self.slo.snapshot(now=self._now)
            if snap["breaches_total"] > snap["observations_total"]:
                self.stats.violations.append(
                    f"step {self.stats.steps}: tenant SLO breaches "
                    f"{snap['breaches_total']} > observations "
                    f"{snap['observations_total']}"
                )
            if snap["max_seconds"] > self._now + STEP_SEC:
                self.stats.violations.append(
                    f"step {self.stats.steps}: tenant time-to-bind "
                    f"{snap['max_seconds']:.0f}s exceeds sim elapsed "
                    f"{self._now:.0f}s (clock-domain mix)"
                )

    def tenant_report(self) -> dict:
        """The tenant cell's verdict surface for chaos_storm --tenant:
        per-tenant p99 time-to-bind plus the front door's ladder tallies
        and final depths."""
        if self.tenant is None or self.slo is None:
            raise ValueError("tenant_report() needs a tenant storm")
        q = self.sched.nqueue
        snap = self.slo.snapshot(now=self._now)
        tenants = snap.get("tenants", {})
        report = {
            "victim_p99_seconds": self.slo.tenant_p99(TENANT_VICTIM),
            "abuser_p99_seconds": self.slo.tenant_p99(TENANT_ABUSER),
            "victim_observations": tenants.get(TENANT_VICTIM, {}).get(
                "observations_total", 0
            ),
            "abuser_observations": tenants.get(TENANT_ABUSER, {}).get(
                "observations_total", 0
            ),
            "violations": len(self.stats.violations),
        }
        stats = getattr(q, "stats", None)
        if stats is not None:
            report.update(stats)
            report["depths"] = q.depths()
        return report

    def _check_spillover_orphans(self) -> None:
        """The bounded-orphan-window invariant: a pod carrying a spill
        record either places or gets its explicit unschedulable verdict
        (which resets the record) within the orphan window — no spilled
        pod ages past the bound while still Pending. Also refreshes the
        spillover lifecycle tallies from the cluster's event trail."""
        bound_sec = SPILLOVER_MAX_AGE_SEC + 15 * STEP_SEC
        for p in self.base.pods.values():
            if p.node is not None:
                continue
            rec = parse_spill_record(p.annotations.get(SPILLOVER_ANNOTATION))
            if rec["since"] is None:
                continue
            age = self._now - rec["since"]
            self.stats.max_spill_age_sec = max(
                self.stats.max_spill_age_sec, age
            )
            if age > bound_sec:
                self.stats.violations.append(
                    f"step {self.stats.steps}: spilled pod "
                    f"{p.namespace}/{p.name} orphaned for {age:.0f}s "
                    f"(bound {bound_sec:.0f}s)"
                )
        self.stats.spilled = sum(
            1 for e in self.base.events if e.reason == "SpilloverScheduling"
        )
        self.stats.spillover_exhausted = sum(
            1 for e in self.base.events
            if e.reason == "FailedScheduling" and "in any shard" in e.message
        )

    def run(self, steps: int) -> ChaosStats:
        for _ in range(steps):
            self.step()
        return self.stats

    # ------------------------------------------------------------------
    # post-storm convergence
    # ------------------------------------------------------------------

    def quiesce(self, rounds: int = 12) -> List[Tuple[str, str]]:
        """Stop injecting faults and drive the control loops until the
        cluster settles; returns the still-unplaced pods.

        This is the crash-only recovery claim made testable: after the
        fault storm ends, the retry/requeue/reconcile nets must converge
        the cluster — every invariant holds and nothing stays stranded
        because of an API fault (``stuck_pods()`` empty). In HA mode the
        election must also converge: one replica ends up leading and its
        scans place whatever the churn left pending. In federation mode
        partitions heal, corpses rejoin, every shard converges onto one
        owner, and the spillover queue drains — each spilled pod ends
        placed or explicitly unschedulable."""
        if self.federation:
            for i, r in enumerate(self.replicas):
                if r.dead_for > 0:
                    r.dead_for = 0
                    self._replace_replica(i)
                r = self.replicas[i]
                r.vantage.partition_left = 0
                if r.faulty is not None:
                    r.faulty.enabled = False
        elif isinstance(self.backend, FaultyBackend):
            self.backend.enabled = False
        if self.device_injector is not None:
            self.device_injector.enabled = False
        for _ in range(rounds):
            self._now += STEP_SEC
            if self.federation:
                for r in self.rng.sample(self.replicas, len(self.replicas)):
                    r.elector.tick()
            elif self.ha:
                for r in self.rng.sample(self.replicas, len(self.replicas)):
                    r.elector.tick()
            self._drive_control_plane(extra_drain=True)
            if self.federation:
                self._track_shard_leadership()
            elif self.ha:
                self._track_leadership()
            self.check_invariants()
        # the chaos-profile SLO invariant: a profile that promises a
        # burn-rate bound must have met it once the storm quiesced
        limit = getattr(self.fed_profile, "slo_burn_limit", None)
        if limit is not None and self.tracing:
            worst = self.worst_burn_rates()
            for window, rate in sorted(worst.items()):
                if rate > limit:
                    self.stats.violations.append(
                        f"quiesce: SLO burn rate {rate:.1f} over the "
                        f"{window} window exceeds the profile's limit "
                        f"{limit:.1f}"
                    )
        if self.policy is not None:
            # the victim-rebind invariant, judged once the storm settled:
            # every evicted pod rebound, was deleted, or holds its
            # explicit unschedulable verdict
            for ns, pod in self.policy_victims_unresolved():
                self.stats.violations.append(
                    f"quiesce: evicted pod {ns}/{pod} neither rebound "
                    "nor reached a verdict"
                )
            from nhd_tpu_torch.policy import scoring as _scoring

            _scoring.set_matrix(None)  # re-arm env for the next cell
        self._maybe_capture_violation()
        if self.device_injector is not None:
            # leave the process-global seam clean for the next cell
            from nhd_tpu_torch.solver import guard

            guard.set_fault_injector(None)
        return self.unplaced_pods()

    def worst_burn_rates(self) -> Dict[str, float]:
        """Fleet-worst SLO burn rate per window — one replica's budget
        on fire IS the fleet's page (obs/fleet.py uses the same rule)."""
        worst: Dict[str, float] = {}
        for r in self.replicas:
            slo = getattr(r, "slo", None)
            if slo is None:
                continue
            snap = slo.snapshot(now=self._now)
            for window, rate in snap["burn_rates"].items():
                worst[window] = max(worst.get(window, 0.0), rate)
        return worst

    def unplaced_pods(self) -> List[Tuple[str, str]]:
        return [
            (p.namespace, p.name)
            for p in self.backend.pods.values() if p.node is None
        ]

    def stuck_pods(self) -> List[Tuple[str, str]]:
        """Unplaced pods with no 'no valid candidate' verdict — i.e. pods
        the fault storm lost rather than pods the cluster can't fit."""
        no_candidate = {
            (e.namespace, e.pod)
            for e in self.backend.events
            if e.reason == "FailedScheduling"
            and "No valid candidate" in e.message
        }
        return [k for k in self.unplaced_pods() if k not in no_candidate]
