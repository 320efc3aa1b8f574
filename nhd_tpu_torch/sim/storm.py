"""Fault-storm matrix on the port: N seeds x fault profiles of chaos with
fault injection (sim/faults.py) on the fake backend, solving on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

The port's counterpart of the reference's tools/chaos_storm.py, inside
the package. Every cell runs the full churn storm under the chosen fault
profile, then quiesces and checks the crash-only recovery claim: zero
conservation-invariant violations and no pod left stranded by a fault
(ChaosSim.stuck_pods()). A device-fault cell (``device-faults``, with
``--device-plane``) also requires the end-state resident tensors to
equal the host mirror bit for bit, and records its injected faults by
site (``dispatch``, ``upload``, ``megaround``), the guard's give-ups and
its bound set; with ``--bind-parity`` a fault-free control of the same
seed runs first and the faulted bound set must equal it.

    python -m nhd_tpu_torch.sim.storm --profiles device-faults \
        --seeds 3 --steps 40 --device-plane --bind-parity
    python -m nhd_tpu_torch.sim.storm --device cpu --ha \
        --profiles ha-light,ha-storm
    python -m nhd_tpu_torch.sim.storm --federation 3 --replicas 3 \
        --profiles fed-light,fed-storm --json-out fed.json

``--json-out`` writes one record per (profile, seed) cell, written even
when cells fail; the exit status says whether any cell failed. A failing
cell replays with ``ChaosSim(seed=<seed>, n_nodes=<n>,
api_faults=PROFILES[<profile>], device=<device>, ...)`` and the mode
flags printed beside it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def count_sites(sim) -> collections.Counter:
    """Wrap *sim*'s installed device-fault injector so each fault it
    raises is tallied by site; returns the live tally."""
    from nhd_tpu_torch.solver import guard

    inner, sites = sim.device_injector, collections.Counter()

    def counted(site: str, detail: str = "") -> None:
        try:
            inner(site, detail)
        except guard.InjectedDeviceFault:
            sites[site] += 1
            raise

    guard.set_fault_injector(counted)
    return sites


def _run_policy_cell(args, profile: str, seed: int) -> dict:
    """One policy-storm cell (``--policy``): the CONTROL run first —
    the same storm (same rng draws, same tier annotations, same mixed
    fleet) with NHD_POLICY=0, which must behave exactly like the
    pre-policy scheduler (zero evictions, zero violations — the
    bit-exactness control at storm scale) — then the policy run under
    NHD_POLICY=1 with the preemption-bound / no-cascade / tier-inversion
    / victim-rebind invariants live (sim/chaos.py)."""
    from nhd_tpu_torch import policy as pol
    from nhd_tpu_torch.sim.chaos import ChaosSim

    # main() is test-callable: the policy toggles must not leak into the
    # calling process (policy.enabled() is re-read per call everywhere,
    # so a leaked NHD_POLICY=1 would silently flip every later test)
    prior = os.environ.get("NHD_POLICY")
    try:
        return _run_policy_cell_inner(args, profile, seed, pol, ChaosSim)
    finally:
        if prior is None:
            os.environ.pop("NHD_POLICY", None)
        else:
            os.environ["NHD_POLICY"] = prior


def _run_policy_cell_inner(args, profile: str, seed: int, pol, ChaosSim):
    os.environ["NHD_POLICY"] = "0"
    pol.reset_policy_metrics()
    control = ChaosSim(
        seed=seed, n_nodes=args.nodes, policy=profile, policy_off=True,
        device=args.device,
    )
    control.run(steps=args.steps)
    control.quiesce()
    control_violations = [
        f"policy-off control: {v}" for v in control.stats.violations
    ]
    if control.base.evict_log:
        control_violations.append(
            f"policy-off control executed {len(control.base.evict_log)} "
            "eviction(s)"
        )
    if control.stuck_pods():
        control_violations.append(
            f"policy-off control stuck pods: {control.stuck_pods()}"
        )

    os.environ["NHD_POLICY"] = "1"
    pol.reset_policy_metrics()
    sim = ChaosSim(seed=seed, n_nodes=args.nodes, policy=profile,
                   device=args.device)
    stats = sim.run(steps=args.steps)
    sim.quiesce()
    stuck = sim.stuck_pods()
    violations = list(stats.violations) + control_violations
    return {
        "profile": profile,
        "seed": seed,
        "nodes": args.nodes,
        "steps": args.steps,
        "mode": "policy",
        "ok": not violations and not stuck,
        "violations": violations,
        "stuck_pods": [list(k) for k in stuck],
        "faults_injected": {},
        "lease_epoch": 0,
        "max_leader_gap": 0,
        "evictions": len(sim.base.evict_log),
        "preempt_by_tier": {
            str(t): n for t, n in sorted(pol.preempt_tier_snapshot().items())
        },
        "victims_unresolved": [
            list(k) for k in sim.policy_victims_unresolved()
        ],
    }


#: the tenant-storm cells' overload posture: a scarce drain (small
#: batches), shallow lanes and a low sustained rate, so the ladder
#: actually escalates inside a 60-step storm — with the defaults (256
#: deep lanes, unlimited rate) the front door would never be tested
_TENANT_CELL_ENV = {
    "NHD_ADMIT_BATCH": "2",
    "NHD_ADMIT_TENANT_CAP": "16",
    "NHD_ADMIT_RATE": "0.2",
}

#: the isolation invariant's margin: the flooded victim p99 may move at
#: most this factor over the calm cell's
_TENANT_P99_MARGIN = 1.10


def _run_tenant_cell(args, profile: str, seed: int) -> dict:
    """One tenant-storm cell (``--tenant``): three runs of the SAME
    deterministic traffic shape —

    * **calm** (admission on, abuse rate 0): the victim tenant alone;
      its p99 time-to-bind is the baseline.
    * **storm** (admission on, abusive tenant at ``--abuse-rate`` x):
      the isolation invariant — the victim's p99 must stay within
      10% of calm — plus the in-sim shed-accounting invariant (every
      refusal has its decision record + pod event) and a non-vacuity
      check (the ladder must actually have shed).
    * **control** (NHD_ADMIT=0, same flood): the negative control —
      the victim MUST starve (isolation demonstrably violated), or the
      storm cell's pass proves nothing about the front door.
    """
    from nhd_tpu_torch.sim.chaos import ChaosSim

    # main() is test-callable: the per-cell admission knobs must not
    # leak into the calling process (they are read at AdmissionQueue
    # construction, so a leaked NHD_ADMIT=0 would silently disable the
    # ladder for every later harness in this process)
    prior = {
        k: os.environ.get(k)
        for k in ("NHD_ADMIT", *_TENANT_CELL_ENV)
    }
    try:
        return _run_tenant_cell_inner(args, profile, seed, ChaosSim)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_tenant_cell_inner(args, profile: str, seed: int, ChaosSim) -> dict:
    os.environ.update(_TENANT_CELL_ENV)

    def one(admit: bool, abuse: int):
        os.environ["NHD_ADMIT"] = "1" if admit else "0"
        sim = ChaosSim(
            seed=seed, n_nodes=args.nodes, tenant=profile,
            admit_off=not admit, abuse_rate=abuse, device=args.device,
        )
        sim.run(steps=args.steps)
        sim.quiesce()
        rep = sim.tenant_report()
        # the control cell legitimately diverges in bulk (that is the
        # point); cap the sample so --json-out stays readable — the
        # full count is in rep["violations"]
        rep["violations_list"] = list(sim.stats.violations)[:8]
        return rep

    calm = one(True, 0)
    storm = one(True, args.abuse_rate)
    control = one(False, args.abuse_rate)

    violations: list = []
    for name, rep in (("calm", calm), ("storm", storm)):
        # the standing invariants (shed accounting, SLO clock domain,
        # mirror conservation) must hold in every admission-on cell
        violations += [f"{name}: {v}" for v in rep["violations_list"]]
    bound = calm["victim_p99_seconds"] * _TENANT_P99_MARGIN + 1e-9
    if storm["victim_p99_seconds"] > bound:
        violations.append(
            f"isolation: victim p99 {storm['victim_p99_seconds']:.3f}s "
            f"under a {args.abuse_rate}x flood exceeds "
            f"{_TENANT_P99_MARGIN:.2f} x calm "
            f"({calm['victim_p99_seconds']:.3f}s)"
        )
    if storm.get("shed", 0) <= 0:
        violations.append(
            "vacuous storm: the flood never pushed the ladder to shed — "
            "the isolation pass proves nothing (retune the cell knobs)"
        )
    if storm.get("readmitted", 0) <= 0:
        violations.append(
            "vacuous storm: nothing was deferred and re-admitted — the "
            "ladder's recovery half went unexercised"
        )
    if control["victim_p99_seconds"] <= bound:
        violations.append(
            f"negative control: with NHD_ADMIT=0 the victim p99 "
            f"({control['victim_p99_seconds']:.3f}s) stayed within the "
            f"isolation bound — the invariant cannot fire, so the storm "
            f"cell's pass is unfalsifiable"
        )
    return {
        "profile": profile,
        "seed": seed,
        "nodes": args.nodes,
        "steps": args.steps,
        "mode": "tenant",
        "ok": not violations,
        "violations": violations,
        "stuck_pods": [],
        "faults_injected": {},
        "lease_epoch": 0,
        "max_leader_gap": 0,
        "abuse_rate": args.abuse_rate,
        "cells": {"calm": calm, "storm": storm, "control": control},
    }


def _run_cell(args, profile: str, seed: int) -> dict:
    """One (profile, seed) cell → its machine-readable summary record."""
    if getattr(args, "policy", False):
        return _run_policy_cell(args, profile, seed)
    if getattr(args, "tenant", False):
        return _run_tenant_cell(args, profile, seed)
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES

    faults = PROFILES[profile] if profile != "none" else None
    device_cell = faults is not None and faults.has_device_faults()
    control_bound = None
    if args.bind_parity and faults is not None:
        # fault-free control run FIRST (same seed, no profile): device
        # faults ride their own rng streams and the device profiles
        # carry zero API-fault probabilities, so the two runs' churn
        # sequences are bit-identical and their end states comparable
        from nhd_tpu_torch.solver.guard import GUARD

        GUARD.reset()
        control = ChaosSim(
            seed=seed, n_nodes=args.nodes, api_faults=None,
            ha=args.ha, federation=args.federation,
            n_replicas=args.replicas, device=args.device,
        )
        control.run(steps=args.steps)
        control.quiesce()
        control_bound = control.bound_set()
    if device_cell:
        from nhd_tpu_torch.solver.guard import GUARD

        GUARD.reset()
    sim = ChaosSim(
        seed=seed, n_nodes=args.nodes, api_faults=faults,
        ha=args.ha, federation=args.federation, n_replicas=args.replicas,
        device=args.device,
    )
    if device_cell:
        from nhd_tpu_torch.k8s.retry import API_COUNTERS

        sites = count_sites(sim)
        giveups = API_COUNTERS.get("guard_giveups_total")
    stats = sim.run(steps=args.steps)
    sim.quiesce()
    stuck = sim.stuck_pods()
    if device_cell:
        # the device-faults acceptance invariants: the resident state
        # ends bit-exact with the host mirror (every corruption found
        # and repaired in-process — zero restarts by construction, the
        # sim never replaced the scheduler object for a device fault)
        audit = sim.device_audit_errors()
        for err in audit:
            stats.violations.append(f"end-state device audit: {err}")
    if control_bound is not None and sim.bound_set() != control_bound:
        stats.violations.append(
            "bind parity: faulted end state differs from the fault-free "
            "run of the same seed"
        )
    fleet_artifact = None
    if args.federation and args.fleet_out:
        # one schema-validated fleet artifact per federation cell: the
        # spillover-hop counts, SLO burn summary and leadership
        # high-waters of exactly this (profile, seed) storm
        from nhd_tpu_torch.obs.fleet import write_fleet_artifact

        # the artifact is a byproduct: a write failure in one cell must
        # not abort the matrix — the --json-out summary is promised even
        # when cells fail
        try:
            fleet_artifact = write_fleet_artifact(
                sim.fleet_artifact(), args.fleet_out,
                name=f"fleet-{profile}-seed{seed}.json",
            )
        except (OSError, ValueError) as exc:
            fleet_artifact = f"WRITE FAILED: {exc}"
    record = {
        "profile": profile,
        "seed": seed,
        "nodes": args.nodes,
        "steps": args.steps,
        "mode": (
            "federation" if args.federation
            else "ha" if args.ha else "single"
        ),
        "ok": not stats.violations and not stuck,
        "violations": list(stats.violations),
        "stuck_pods": [list(k) for k in stuck],
        "faults_injected": sim.fault_totals(),
        "lease_epoch": stats.lease_epoch,
        "max_leader_gap": stats.max_leader_gap,
    }
    if args.bind_parity and control_bound is not None:
        record["bind_parity"] = sim.bound_set() == control_bound
    if device_cell:
        from nhd_tpu_torch.solver.guard import GUARD

        record["guard_rung_end"] = GUARD.floor
        record["bit_flips"] = stats.bit_flips
        record["faults_by_site"] = dict(sites)
        record["guard_giveups"] = (
            API_COUNTERS.get("guard_giveups_total") - giveups
        )
        record["restarts"] = stats.restarts
        record["bound_set"] = [list(b) for b in sim.bound_set()]
    if args.federation:
        record.update({
            "shards": args.federation,
            "replicas": args.replicas,
            "shard_epochs": {str(s): e for s, e in stats.shard_epochs.items()},
            "max_shard_gap": stats.max_shard_gap,
            "partitions": stats.partitions,
            "kill_waves": stats.kill_waves,
            "restarts": stats.restarts,
            "spilled": stats.spilled,
            "spillover_exhausted": stats.spillover_exhausted,
            "max_spill_age_sec": round(stats.max_spill_age_sec, 1),
            "fleet_artifact": fleet_artifact,
            "violation_capture": sim.violation_artifact_path,
        })
    return record


def _run_cell_timed(args, profile: str, seed: int) -> dict:
    """_run_cell under a per-cell wall-clock budget: one hung cell (a
    wedged solve, a deadlocked drive) must not eat the whole matrix.
    The cell runs on a daemon thread; on timeout the record reports the
    cell BY NAME as failed and the matrix moves on (the leaked thread
    dies with the process — this is a tool, not a daemon)."""
    import threading

    if not args.cell_timeout or args.cell_timeout <= 0:
        return _run_cell(args, profile, seed)
    box: dict = {}

    def _target() -> None:
        try:
            box["record"] = _run_cell(args, profile, seed)
        except BaseException as exc:  # the matrix must see cell crashes
            box["error"] = exc

    t = threading.Thread(
        target=_target, name=f"chaos-cell-{profile}-{seed}", daemon=True
    )
    t.start()
    t.join(args.cell_timeout)
    if t.is_alive():
        # the leaked thread keeps mutating PROCESS-GLOBAL solver-guard
        # state (floor, counters, the injector seam) while later cells
        # run: quiet the injector best-effort and stamp every later
        # cell `after_timeout` so its verdict is read as suspect — the
        # timed-out cell already fails the whole matrix either way
        try:
            from nhd_tpu_torch.solver import guard

            guard.set_fault_injector(None)
        except Exception as exc:  # best-effort hygiene on a failing run
            print(f"  (could not quiet the fault injector: {exc})")
        _TIMED_OUT.append(f"{profile}/seed{seed}")
        return {
            "profile": profile, "seed": seed, "nodes": args.nodes,
            "steps": args.steps,
            "mode": ("federation" if args.federation
                     else "ha" if args.ha else "single"),
            "ok": False, "timeout": True,
            "violations": [
                f"cell {profile}/seed{seed} timed out after "
                f"{args.cell_timeout:.0f}s (still running; matrix "
                "continued without it — later cells marked "
                "after_timeout share its leaked thread's process)"
            ],
            "stuck_pods": [], "faults_injected": {},
            "lease_epoch": 0, "max_leader_gap": 0,
        }
    err = box.get("error")
    if err is not None:
        raise err
    record = box["record"]
    if _TIMED_OUT:
        record["after_timeout"] = list(_TIMED_OUT)
    return record


#: cells that timed out so far this run (their daemon threads may still
#: be mutating process-global state under later cells)
_TIMED_OUT: list = []


def main(argv=None) -> int:
    del _TIMED_OUT[:]  # fresh run (main is re-entrant under tests)
    race_san = None
    if os.environ.get("NHD_RACE") == "1":
        # race-instrument the whole matrix (nhdrace): install BEFORE any
        # sim import constructs schedulers/pipelines so their
        # maybe_watch() registrations land in the live registry.
        # install_races() pulls in nhdsan too — locksets come from its
        # instrumented locks — and honours NHD_RACE_INJECT/NHD_RACE_ALLOW.
        from nhd_tpu_torch.sanitizer import install_races

        race_san = install_races()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=6,
                    help="seeds per profile (default 6)")
    ap.add_argument("--steps", type=int, default=60,
                    help="churn steps per run (default 60)")
    ap.add_argument("--nodes", type=int, default=4,
                    help="cluster size per run (default 4)")
    ap.add_argument("--profiles", default="light,storm,heavy,churn",
                    help="comma-separated profile names (sim/faults.py "
                         "PROFILES; default light,storm,heavy,churn)")
    ap.add_argument("--ha", action="store_true",
                    help="split-brain mode: two scheduler replicas under "
                         "leader election share each cell's cluster; adds "
                         "the double-epoch-bind and bounded-leadership-gap "
                         "invariants (pair with the ha-* profiles)")
    ap.add_argument("--federation", type=int, default=0, metavar="S",
                    help="shard-federation mode: --replicas full replicas "
                         "over S shard leases share each cell's cluster, "
                         "under per-shard lease faults, asymmetric "
                         "partitions and kill/restart waves; adds the "
                         "no-double-shard-epoch-bind, bounded-per-shard-"
                         "gap and bounded-spillover-orphan invariants "
                         "(pair with the fed-* profiles)")
    ap.add_argument("--replicas", type=int, default=3,
                    help="federation members per cell (default 3; "
                         "requires --federation)")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="write the machine-readable matrix summary here "
                         "(one record per cell; written even when cells "
                         "fail, so CI diffs results instead of logs)")
    ap.add_argument("--fleet-out", default=None, metavar="DIR",
                    help="federation cells: write one schema-validated "
                         "fleet artifact per (profile, seed) cell here "
                         "(obs/fleet.py; spillover-hop + SLO burn "
                         "summaries)")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--cell-timeout", type=float, default=600.0,
                    metavar="SEC",
                    help="wall-clock budget per (profile, seed) cell: a "
                         "cell still running past this is reported by "
                         "name as failed (timeout: true in --json-out) "
                         "and the matrix continues — one hung cell "
                         "can't eat the whole run (default 600; 0 "
                         "disables)")
    ap.add_argument("--device-plane", action="store_true",
                    help="solver data-plane posture for device-fault "
                         "profiles: the resident-state path on "
                         "(NHD_TPU_DEVICE_STATE=1, as the reference's "
                         "flag sets it) and an every-batch full-coverage "
                         "guard audit (NHD_GUARD_AUDIT_INTERVAL=1, "
                         "NHD_GUARD_AUDIT_ROWS=0) — the posture under "
                         "which faulted binds are provably bit-identical "
                         "to fault-free ones")
    ap.add_argument("--policy", action="store_true",
                    help="policy-storm mode: "
                         "profiles are the scheduling-policy scenarios "
                         "(sim/chaos.py POLICY_PROFILES: mixed-gen, "
                         "quota-storm, maint-wave); each cell runs a "
                         "NHD_POLICY=0 control (must behave exactly like "
                         "the pre-policy scheduler: zero evictions) then "
                         "the NHD_POLICY=1 storm under the preemption-"
                         "bound / no-cascade / tier-inversion / victim-"
                         "rebind invariants")
    ap.add_argument("--tenant", action="store_true",
                    help="tenant-storm mode: each "
                         "cell runs the deterministic victim-trickle/"
                         "abuser-flood scenario three ways — calm "
                         "baseline, flooded with the admission ladder "
                         "on (victim p99 must stay within 10%% of calm, "
                         "every shed pod must carry its verdict), and "
                         "the NHD_ADMIT=0 negative control (the victim "
                         "MUST starve, proving the invariant can fire)")
    ap.add_argument("--abuse-rate", type=int, default=10,
                    help="tenant mode: abusive tenant's creates per "
                         "step; the victim stays at 1 (default 10)")
    ap.add_argument("--device", default="cuda",
                    help="solve device of every scheduler in the matrix "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--bind-parity", action="store_true",
                    help="run a fault-free CONTROL sim per cell (same "
                         "seed, no profile) and fail the cell unless the "
                         "faulted end state's bound set is bit-identical "
                         "to the control's")
    args = ap.parse_args(argv)

    if args.device_plane:
        # before any ChaosSim import builds a scheduler: these are read
        # at context/batch build time
        os.environ["NHD_TPU_DEVICE_STATE"] = "1"
        os.environ.setdefault("NHD_GUARD_AUDIT_INTERVAL", "1")
        os.environ.setdefault("NHD_GUARD_AUDIT_ROWS", "0")

    from nhd_tpu_torch.sim.faults import PROFILES

    if args.ha and args.federation:
        print("--ha and --federation are exclusive modes")
        return 2
    if args.policy and (args.ha or args.federation):
        print("--policy runs solo mode only")
        return 2
    if args.tenant and (args.ha or args.federation or args.policy):
        print("--tenant runs solo mode only (and not with --policy)")
        return 2
    if args.tenant:
        from nhd_tpu_torch.sim.chaos import TENANT_PROFILES

        if args.profiles == "light,storm,heavy,churn":  # the default
            args.profiles = ",".join(TENANT_PROFILES)
        profiles = [p.strip() for p in args.profiles.split(",") if p.strip()]
        for p in profiles:
            if p not in TENANT_PROFILES:
                print(f"unknown tenant profile {p!r}; "
                      f"have {sorted(TENANT_PROFILES)}")
                return 2
    elif args.policy:
        from nhd_tpu_torch.sim.chaos import POLICY_PROFILES

        if args.profiles == "light,storm,heavy,churn":  # the default
            args.profiles = ",".join(POLICY_PROFILES)
        profiles = [p.strip() for p in args.profiles.split(",") if p.strip()]
        for p in profiles:
            if p not in POLICY_PROFILES:
                print(f"unknown policy profile {p!r}; "
                      f"have {sorted(POLICY_PROFILES)}")
                return 2
    else:
        profiles = [p.strip() for p in args.profiles.split(",") if p.strip()]
        for p in profiles:
            if p not in PROFILES:
                print(f"unknown profile {p!r}; have {sorted(PROFILES)}")
                return 2

    t0 = time.time()
    cells = []
    for profile in profiles:
        totals: dict = {}
        epochs, gaps, shard_gaps = 0, 0, 0
        for seed in range(args.start_seed, args.start_seed + args.seeds):
            rec = _run_cell_timed(args, profile, seed)
            cells.append(rec)
            if not rec["ok"]:
                mode_flags = (
                    f" --federation {args.federation} "
                    f"--replicas {args.replicas}" if args.federation
                    else " --ha" if args.ha else ""
                )
                print(f"CHAOS FAIL profile={profile} seed={seed} "
                      f"nodes={args.nodes} steps={args.steps}{mode_flags}:")
                for v in rec["violations"]:
                    print(f"  violation: {v}")
                for key in rec["stuck_pods"]:
                    print(f"  stuck pod: {tuple(key)}")
                continue
            for k, n in rec["faults_injected"].items():
                totals[k] = totals.get(k, 0) + n
            epochs = max(epochs, rec["lease_epoch"])
            gaps = max(gaps, rec["max_leader_gap"])
            shard_gaps = max(shard_gaps, rec.get("max_shard_gap", 0))
        if args.federation:
            extra = (f", max shard epoch {epochs}, max shard gap "
                     f"{shard_gaps} steps")
        elif args.ha:
            extra = f", max lease epoch {epochs}, max leader gap {gaps}"
        else:
            extra = ""
        clean = sum(1 for c in cells if c["profile"] == profile and c["ok"])
        print(f"profile {profile:>9}: {clean}/{args.seeds} seeds clean "
              f"(faults injected: {totals}{extra})")

    race_report = None
    if race_san is not None:
        from nhd_tpu_torch.sanitizer import uninstall_races

        uninstall_races()  # main is re-entrant: next call reinstalls fresh
        race_report = race_san.report()

    failed = [c for c in cells if not c["ok"]]
    summary = {
        "matrix": {
            "profiles": profiles,
            "seeds": args.seeds,
            "start_seed": args.start_seed,
            "steps": args.steps,
            "nodes": args.nodes,
            "mode": ("tenant" if args.tenant
                     else "policy" if args.policy
                     else "federation" if args.federation
                     else "ha" if args.ha else "single"),
            "federation_shards": args.federation,
            "federation_replicas": args.replicas if args.federation else 0,
        },
        "ok": not failed,
        "cells_total": len(cells),
        "cells_failed": len(failed),
        "wall_seconds": round(time.time() - t0, 1),
        "races": race_report,
        "cells": cells,
    }
    if args.json_out:
        out_dir = os.path.dirname(os.path.abspath(args.json_out))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"matrix summary -> {args.json_out}")

    if failed:
        print(f"chaos matrix FAILED: {len(failed)}/{len(cells)} cells")
        return 1
    if race_report is not None and race_report["races"]:
        print(f"chaos matrix FAILED: {len(race_report['races'])} "
              f"unsuppressed data race(s) on watched shared state: "
              f"{[r['key'] for r in race_report['races']]} "
              f"(fix the race or allowlist via NHD_RACE_ALLOW with a "
              f"written justification)")
        return 1
    mode = (
        f", federation {args.federation} shards x {args.replicas} replicas"
        if args.federation else ", split-brain" if args.ha else ""
    )
    print(f"chaos matrix OK: {len(cells)} cells "
          f"({len(profiles)} profiles x {args.seeds} seeds, "
          f"{args.steps} steps{mode}) in {summary['wall_seconds']}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
