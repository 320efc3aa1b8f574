"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place, first fit in pod order, with one
guarantee the configuration states broken. The reference that judges a
run must find its answers not correct.

- ``nic_sharing`` (the default): it treats a NIC that already serves a
  pod as free wherever its bandwidth still fits (NIC sharing on, where
  the configuration has it off);
- ``pci_switch``: it places a PCI pod as a NUMA one, its GPUs the first
  free on its group's NUMA node whatever their PCIe switch, and admits
  it without upstream's switch rule. A cell with no PCI pod type cannot
  break it.

Run on the card at a cell's own size, one process a seed:

    python3 bench_port/control.py --workload cap1k.backlog10k --seeds 1,2,3 --seconds 10

It prints one JSON line a seed with the numbers compared. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import manifest as mf  # noqa: E402
from bench_port.fleet import Hardware  # noqa: E402
from bench_port.reference import Answers, Reference, empty_answers  # noqa: E402


#: each control's broken guarantee, as the reference's placer takes it
BROKEN = {"nic_sharing": {"nic_pods_ignored": True},
          "pci_switch": {"switch_ignored": True}}


class Control:
    """The reference as a placer, with the interface ``run.Loop`` drives."""

    def __init__(self, cfg: dict, mix: dict, broken: str = "nic_sharing"):
        self.broken = BROKEN[broken]
        g = cfg["guarantees"]
        self.state = Reference(Hardware.of(cfg["fleet"], g["nic_bw_avail"]),
                               mix["pod_types"], nic_sharing=g["nic_sharing"])
        self.n_types = len(mix["pod_types"])
        self.n_groups = len(cfg["fleet"]["groups"])
        self._fits = {}
        self._answers = {}

    def items(self, gang):
        ptype = gang.pod_types(self.n_types)
        pgroup = gang.pod_groups(self.n_types, self.n_groups)
        return list(zip(ptype.tolist(), pgroup.tolist())), ptype, pgroup

    def _fit(self, ti, gi):
        key = (ti, gi)
        if key not in self._fits:
            self._fits[key] = self.state.fits_anywhere(ti, gi, **self.broken)
        return self._fits[key]

    def schedule(self, items):
        t0 = time.perf_counter()
        node = np.full(len(items), -1, np.int64)
        cores: List[tuple] = []
        gpus: List[tuple] = []
        nics: List[tuple] = []
        for p, (ti, gi) in enumerate(items):
            fits = self._fit(ti, gi)
            cand = np.flatnonzero(fits)
            if not len(cand):
                continue
            n = int(cand[0])
            got = self.state.place(ti, gi, n, p, **self.broken)
            if got is None:
                continue
            node[p] = n
            cores += got[0]
            gpus += got[1]
            nics += got[2]
            for (kt, kg), f in self._fits.items():
                if f[n]:
                    f[n] = self.state.first_choice(kt, kg, n, **self.broken) is not None

        def col(rows, j, dtype=np.int64):
            return np.asarray([r[j] for r in rows], dtype)

        ptype = np.array([t for t, _ in items], np.int64)
        pgroup = np.array([g for _, g in items], np.int64)
        ans = Answers(node, ptype, pgroup, col(cores, 0), col(cores, 1), col(cores, 2),
                      col(cores, 3), col(gpus, 0), col(gpus, 1), col(gpus, 2),
                      col(nics, 0), col(nics, 1), col(nics, 2), col(nics, 3, float),
                      col(nics, 4, float))
        key = id(ans)
        self._answers[key] = ans
        results = [SimpleNamespace(node=int(n) if n >= 0 else None, round_no=0)
                   for n in node.tolist()]
        for r in results:
            r.gang = key
        stats = SimpleNamespace(phases={}, round_end_seconds=[time.perf_counter() - t0],
                                rounds=1, counters={}, select_seconds=0.0,
                                assign_seconds=0.0)
        return results, stats

    def held(self, results):
        return [None if r.node is None else r.gang for r in results]

    def teardown(self, items, held):
        keys = {h for h in held if h is not None}
        for k in keys:
            self.state.release(self._answers[k])
        self._fits.clear()

    def refresh(self):
        pass

    def answers(self, held, ptype, pgroup):
        key = next((h for h in held if h is not None), None)
        if key is None:
            return empty_answers(ptype, pgroup)
        return self._answers[key]

    def resident_rows(self):
        return self.state.rows()


def run_control(manifest: dict, cell: dict, cfg: dict, mix: dict, seed: int,
                seconds: float, broken: str = "nic_sharing") -> dict:
    """The cell's loop with the control in the program's place, judged
    as a run is; returns the numbers compared."""
    from bench_port.run import LIMITS, Loop, warm_up
    from bench_port.traffic import mix_gangs

    ctl = Control(cfg, mix, broken)
    loop = Loop(ctl, mix["occupancy_pods"], traced=False)
    warm_up(loop, mix, seed)
    t_end = time.perf_counter() + seconds
    n = 0
    for g in mix_gangs(mix, seed, 4096, stream=0):
        loop.step(g)
        n += 1
        if time.perf_counter() >= t_end:
            break
    hw = Hardware.of(cfg["fleet"], cfg["guarantees"]["nic_bw_avail"])
    ref = Reference(hw, mix["pod_types"], nic_sharing=cfg["guarantees"]["nic_sharing"])
    loop.replay(ref)
    checks = {"bad_placements": ref.verdict.bad_placements,
              "bad_failures": ref.verdict.bad_failures,
              "row_mismatches": ref.row_mismatches(ctl.resident_rows())}
    return {"workload": cell["name"], "seed": seed, "gangs": n,
            "correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
            "checks": checks, "notes": ref.verdict.notes[:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", choices=sorted(BROKEN), default="nic_sharing")
    args = ap.parse_args(argv)
    manifest = mf.load(ROOT)
    cell = mf.cell(manifest, args.workload)
    cfg, mix = mf.config(cell["config"]), mf.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run_control(manifest, cell, cfg, mix, seed, args.seconds,
                                     args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
