"""Chaos soak on the port: N seeds x M steps of randomized cluster churn,
every run checked against the conservation invariants (sim/chaos.py),
solving on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).

The port's counterpart of the reference's tools/soak.py, inside the
package:

    python -m nhd_tpu_torch.sim.soak                        # 100 x 120
    python -m nhd_tpu_torch.sim.soak --seeds 8 --steps 60 --device cpu

Exit status is non-zero on the first invariant violation; the offending
seed is printed so the failure reproduces with
``ChaosSim(seed=<seed>, n_nodes=<n>, device=<device>).run(steps=<steps>)``.
A CUDA request without a GPU exits non-zero before any run.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the ChaosStats fields the totals line sums over the seeds
TOTALS = ("created", "deleted", "cordons", "maint_flips", "restarts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=100,
                    help="number of seeds to soak (default 100)")
    ap.add_argument("--steps", type=int, default=120,
                    help="churn steps per seed (default 120)")
    ap.add_argument("--nodes", type=int, default=4,
                    help="cluster size per run (default 4)")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="solve device (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from nhd_tpu_torch.device import resolve_for_tool

    device = resolve_for_tool(args.device, "soak")
    if device is None:
        return 1

    from nhd_tpu_torch.sim.chaos import ChaosSim

    t0 = time.time()
    totals = dict.fromkeys(TOTALS, 0)
    for seed in range(args.start_seed, args.start_seed + args.seeds):
        sim = ChaosSim(seed=seed, n_nodes=args.nodes, device=device)
        stats = sim.run(steps=args.steps)
        if stats.violations:
            print(f"SOAK FAIL seed={seed} nodes={args.nodes} "
                  f"steps={args.steps}:")
            for v in stats.violations:
                print(f"  {v}")
            return 1
        for k in totals:
            totals[k] += getattr(stats, k, 0)
        done = seed - args.start_seed + 1
        if done % 10 == 0 or done == args.seeds:
            rate = done / (time.time() - t0)
            print(f"soak: {done}/{args.seeds} seeds clean "
                  f"({rate:.1f} seeds/s)", flush=True)
    dt = time.time() - t0
    print(f"SOAK OK: {args.seeds} seeds x {args.steps} steps in {dt:.0f}s — "
          + ", ".join(f"{k}={v}" for k, v in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
