"""Fleet top on the port: scrape N replicas' /metrics + /decisions into
one view.

The port's counterpart of the reference's tools/fleet_top.py, inside the
package and host-only (it runs no solve, so it takes no device): the
scrape-path producer of the fleet aggregator (obs/fleet.py). Point it
at every replica's metrics port and it prints the federation summary —
per-replica shard ownership + fencing epochs, the SLO plane's worst-of
burn rates, spillover and fencing counters — and optionally writes the
schema-versioned fleet artifact.

    python -m nhd_tpu_torch.obs.fleet_top http://r1:9464 http://r2:9464
    python -m nhd_tpu_torch.obs.fleet_top --json-out fleet.json URLS...
    python -m nhd_tpu_torch.obs.fleet_top --watch 5 URLS...  # every 5 s
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from nhd_tpu_torch.obs.fleet import (
    build_fleet_artifact,
    scrape_replica,
    write_fleet_artifact,
)


def _fmt_burn(burn: dict) -> str:
    return " ".join(
        f"{w}={r:.2f}" for w, r in sorted(burn.items())
    ) or "n/a"


def render_once(urls, timeout: float) -> tuple:
    """(views, lines) for one scrape pass; unreachable replicas are
    reported, not fatal — a partitioned member is exactly when the
    operator runs this."""
    views, lines = [], []
    for url in urls:
        try:
            views.append(scrape_replica(url, timeout=timeout))
        except (OSError, ValueError) as exc:
            lines.append(f"  {url:<32} UNREACHABLE ({exc})")
    artifact = build_fleet_artifact(views) if views else None
    for v in views:
        shards = v.get("shards") or {}
        shard_txt = (
            " ".join(f"{s}@e{e}" for s, e in sorted(shards.items()))
            or "none"
        )
        slo = v.get("slo")
        slo_txt = (
            f"slo {slo['observations_total']} obs / "
            f"{slo['breaches_total']} breach, "
            f"burn {_fmt_burn(slo.get('burn_rates', {}))}"
            if slo else "slo n/a"
        )
        lines.append(
            f"  {v['replica']:<32} shards [{shard_txt}]  {slo_txt}  "
            f"({len(v.get('decisions') or [])} recent decisions)"
        )
    if artifact is not None:
        p = artifact["payload"]
        lines.append(
            f"  fleet: worst burn {_fmt_burn(p['slo']['worst_burn_rates'])}"
            f" | spillover claims {p['spillover']['claims_total']}"
            f" exhausted {p['spillover']['exhausted_total']}"
            f" | stale writes rejected "
            f"{p['fencing']['stale_writes_rejected_total']}"
            f" | handoffs {p['fencing']['handoffs_total']}"
        )
    return views, artifact, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("urls", nargs="+", metavar="URL",
                    help="replica metrics base URLs (http://host:port)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="also write the fleet artifact here "
                         "(schema-validated; obs/fleet.py)")
    ap.add_argument("--watch", type=float, default=0, metavar="SEC",
                    help="refresh every SEC seconds (0 = one shot)")
    args = ap.parse_args(argv)

    while True:
        views, artifact, lines = render_once(args.urls, args.timeout)
        stamp = time.strftime("%H:%M:%S")
        print(f"fleet @ {stamp} — {len(views)}/{len(args.urls)} replicas:")
        for line in lines:
            print(line)
        if args.json_out and artifact is not None:
            out_dir = os.path.dirname(os.path.abspath(args.json_out))
            path = write_fleet_artifact(
                artifact, out_dir or ".",
                name=os.path.basename(args.json_out),
            )
            print(f"  fleet artifact -> {path}")
        if not args.watch:
            return 0 if views else 1
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
