"""Fleet-observability demo on the port: 3 replicas, 3 shards, one merged
journey, solving on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).

The port's counterpart of the reference's tools/fleet_demo.py, inside
the package. Drives a 3-replica/3-shard federation on the fake cluster
(the ChaosSim harness with tracing on, no injected API faults — the
churn itself produces spillover), then checks, end to end:

1. at least one pod's journey crosses >= 2 replicas under ONE corr ID
   (the cluster-held trace annotation, k8s/interface.py
   TRACE_ANNOTATION);
2. the N span rings merge into one schema-valid Chrome trace
   (obs/chrome.py merge_chrome_traces + validate_chrome_trace);
3. the fleet artifact (obs/fleet.py) validates and carries the
   spillover-hop and SLO burn summaries.

Artifacts land under --out-dir (default artifacts/fleet): the merged
journey trace (one process row per replica in a Chrome trace viewer) and
the fleet JSON. Reproducible per seed; if the default seed gives no
cross-replica journey, the demo searches the next few seeds and prints
which one it settled on (the same seed on every device: a different one
is a parity fault).

    python -m nhd_tpu_torch.sim.fleet_demo --device cpu
    python -m nhd_tpu_torch.sim.fleet_demo --seed 3 --steps 40

A CUDA request without a GPU exits non-zero before any run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def run_demo(args, device) -> int:
    from nhd_tpu_torch.obs.chrome import (
        journey_replicas,
        pod_journeys,
        scheduled_journeys,
        validate_chrome_trace,
    )
    from nhd_tpu_torch.obs.fleet import write_fleet_artifact
    from nhd_tpu_torch.sim.chaos import ChaosSim

    for seed in range(args.seed, args.seed + args.seed_search):
        sim = ChaosSim(
            seed=seed, n_nodes=args.nodes, federation=args.shards,
            n_replicas=args.replicas, device=device,
        )
        sim.run(args.steps)
        sim.quiesce()
        if sim.stats.violations:
            print("fleet-demo: FAILED — invariant violations "
                  f"(seed {seed}):")
            for v in sim.stats.violations:
                print(f"  {v}")
            return 1
        merged = sim.merged_trace()
        journeys = scheduled_journeys(pod_journeys(merged))
        cross = {}
        for corr in journeys:
            reps = journey_replicas(merged, corr, journeys)
            if len(reps) >= 2:
                cross[corr] = reps
        if cross:
            break
        print(f"fleet-demo: seed {seed} produced no cross-replica "
              "journey; trying the next seed")
    else:
        print(f"fleet-demo: FAILED — no cross-replica journey in "
              f"{args.seed_search} seeds from {args.seed}")
        return 1

    errs = validate_chrome_trace(merged)
    if errs:
        print("fleet-demo: FAILED — merged trace schema errors:")
        for e in errs[:10]:
            print(f"  {e}")
        return 1

    os.makedirs(args.out_dir, exist_ok=True)
    journey_path = os.path.join(args.out_dir, f"journey-seed{seed}.json")
    with open(journey_path, "w") as fh:
        json.dump(merged, fh, indent=2, sort_keys=True)
        fh.write("\n")
    # the writer schema-validates; a demo publishing an invalid fleet
    # artifact must fail here, not in whatever reads it next
    artifact = sim.fleet_artifact()
    artifact_path = write_fleet_artifact(
        artifact, args.out_dir,
        name=f"fleet-seed{seed}-step{sim.stats.steps}.json",
    )

    corr, replicas = sorted(cross.items())[0]
    shards = sorted({
        ev["args"]["shard"]
        for ev in journeys[corr]
        if (ev.get("args") or {}).get("shard") is not None
    })
    payload = artifact["payload"]
    print(f"fleet-demo: seed {seed}: {len(journeys)} pod journeys, "
          f"{len(cross)} cross-replica")
    print(f"  example journey {corr}: {len(journeys[corr])} spans over "
          f"replicas {replicas}, shards {shards}")
    print(f"  spillover: {payload['spillover']['spill_events_total']} "
          f"spill events, max {payload['spillover']['max_hops_per_pod']} "
          f"hops for one pod")
    print(f"  slo: {payload['slo']['observations_total']} binds observed, "
          f"worst burn {payload['slo']['worst_burn_rates']}")
    print(f"  merged journey trace -> {journey_path}")
    print(f"  fleet artifact       -> {artifact_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--seed-search", type=int, default=8,
                    help="seeds to try (from --seed) for a cross-replica "
                         "journey before giving up (default 8)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--out-dir", default="artifacts/fleet")
    ap.add_argument("--device", default="cuda",
                    help="solve device of every replica (default cuda; cpu "
                         "runs the plain versions)")
    args = ap.parse_args(argv)

    from nhd_tpu_torch.device import resolve_for_tool

    device = resolve_for_tool(args.device, "fleet-demo")
    if device is None:
        return 1
    return run_demo(args, device)


if __name__ == "__main__":
    sys.exit(main())
