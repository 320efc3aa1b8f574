#!/usr/bin/env python3
"""Run one cell of the port's benchmark once:

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the configuration's fleet in the port's node mirror, a
delta-built ``ScheduleContext`` over it and the traffic from the seed,
warms every shape the traffic reaches with throwaway gangs and brings
the fleet to the mix's occupancy. The window then runs the closed loop
for ``--seconds`` of the program's time: each gang is one
``BatchScheduler.schedule`` call, after which the oldest gangs are torn
down the daemon's way until the bound pods are at or under the
occupancy; the harness's reading of each gang's answers for the
reference is left out of the window's time. Once the window has closed the plain
reference (``reference.py``) replays every gang and judges the answers
and the resident device rows. The last line of standard output is the
result as one JSON object; the numbers compared, each beside its limit,
end standard error.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read under ``torch.profiler`` with
the program's flight recorder on (``nhd_tpu_torch.obs``): its spans and
tallies go to the readers, laid on the profiler's clock to name the
device's idle gaps. Each gang's record carries the program's own
counters (``BatchStats.counters``) in both.
Exits non-zero with no result when no CUDA device is present (or fewer
than the cell asks for), when the program is not beside the benchmark,
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_LOADED = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import manifest as mf  # noqa: E402
from bench_port import roofline, trace as trace_mod  # noqa: E402
from bench_port.fleet import Hardware  # noqa: E402
from bench_port.imports import loaded_forbidden  # noqa: E402
from bench_port.reference import Reference  # noqa: E402
from bench_port.traffic import gangs, mix_gangs, stream_gangs  # noqa: E402

#: the harness's own spans, around its calls into the program
SPANS = ("schedule", "teardown", "refresh", "answers", "items")
#: the numbers compared, each with its limit: every one an exact count
LIMITS = {"bad_placements": 0, "bad_failures": 0, "row_mismatches": 0}
WARM_INDEX = 1 << 30
#: the recorder's ring in a traced window: a gang records some tens of
#: spans, and a window of small gangs holds thousands of gangs
RECORDER_SPANS = 1 << 21


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), or
    since this module loaded where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_LOADED


def posture(cfg: dict) -> None:
    """The program's knobs as the configuration states them, set before
    the program is imported. (The deployment's CPU limit is a quota,
    not a pin: ``main`` holds torch to its thread count and pins no
    core.)"""
    for k, v in cfg["env"].items():
        os.environ[k] = v if isinstance(v, str) else json.dumps(v)


class Loop:
    """The closed loop of gangs over the program, with the event log the
    reference replays."""

    def __init__(self, program, occupancy: int, traced: bool):
        self.p = program
        self.occupancy = occupancy
        self.live: deque = deque()
        self.bound = 0
        self.log: List[tuple] = []
        self.traced = traced

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def step(self, gang, throwaway: bool = False) -> dict:
        """One gang: schedule, tear down the oldest to the occupancy,
        refresh the context; then read its answers (``answers_s``, the
        harness's own time)."""
        p = self.p
        with self.span("items"):
            items, ptype, pgroup = p.items(gang)
        t0 = time.perf_counter()
        with self.span("schedule"):
            results, stats = p.schedule(items)
        t1 = time.perf_counter()
        held = p.held(results)
        placed = sum(h is not None for h in held)
        entry = [items, held, None, placed]
        self.live.append(entry)
        self.bound += placed
        released = []
        with self.span("teardown"):
            while self.live and (self.bound > self.occupancy or throwaway):
                old = self.live.popleft()
                p.teardown(old[0], old[1])
                self.bound -= old[3]
                # keep only what the reference needs (the answers, filled
                # in below for this gang): a torn-down gang's pods must
                # leave the heap as they leave the program
                old[0] = old[1] = None
                released.append(old)
                throwaway = False
        with self.span("refresh"):
            p.refresh()
        t2 = time.perf_counter()
        with self.span("answers"):
            entry[2] = p.answers(held, ptype, pgroup)
        answers_s = time.perf_counter() - t2
        self.log.append(("place", entry[2]))
        self.log.extend(("release", old) for old in released)
        # the daemon binds a gang's pods once the schedule call returns
        # them; BatchStats.round_end_seconds stamps the round that placed
        # each pod, inside the call
        pre = stats.phases.get("prepass", 0.0) + stats.phases.get("guard_audit", 0.0)
        ends = stats.round_end_seconds
        round_binds = [pre + ends[r.round_no] for r in results
                       if r.node is not None and 0 <= r.round_no < len(ends)]
        spec = "spec_dispatch" in stats.phases
        return {
            "wall_s": t2 - t0, "schedule_s": t1 - t0, "teardown_s": t2 - t1,
            "answers_s": answers_s, "pods": len(items), "placed": placed,
            "bind_sum_s": placed * (t1 - t0), "binds": placed,
            "round_bind_sum_s": sum(round_binds),
            "rounds": stats.rounds, "spec_round": spec,
            "spec_iterations": stats.counters.get("spec_iterations", 0),
            "encode_s": stats.phases.get("encode", 0.0),
            "spec_dispatch_s": stats.phases.get("spec_dispatch") if spec else None,
            "select_s": stats.select_seconds, "assign_s": stats.assign_seconds,
            "teardowns": len(released), "counters": dict(stats.counters),
        }

    def replay(self, ref: Reference) -> None:
        for kind, what in self.log:
            if kind == "place":
                ref.judge(what)
            else:
                ref.release(what[2])


def warm_up(loop: Loop, mix: dict, seed: int) -> int:
    """Throwaway gangs of the largest and the smallest size (placed and
    torn down), then the seed's warm-up stream until the fleet has held
    its occupancy for ``warm_steady_gangs`` gangs. Returns the gangs run."""
    lo, hi = mix["gang_pods_min"], mix["gang_pods_max"]
    stream = mix_gangs(mix, seed, 4096, stream=1, first_index=WARM_INDEX)
    throw = gangs(np.array(sorted({hi, lo}, reverse=True)), first_pod=0,
                  first_index=2 * WARM_INDEX,
                  restart=bool(mix.get("same_pods_every_gang")))
    n = 0
    for g in throw:
        loop.step(g, throwaway=True)
        n += 1
    steady = 0
    for g in stream:
        rec = loop.step(g)
        n += 1
        if rec["teardowns"]:
            steady += 1
        if steady >= mix["warm_steady_gangs"]:
            return n
    raise RuntimeError("warm-up stream ran out before the fleet held its occupancy")


def run_cell(manifest: dict, cell: dict, cfg: dict, mix: dict, seed: int,
             seconds: float, traced: bool, device: str = "cuda") -> dict:
    """Set up, warm up, run the window, judge. Returns the result object
    (the line ``main`` prints), its ``checks`` key last."""
    import torch

    from bench_port.program import Program
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.solver import speculate

    cuda = device == "cuda"
    t_prog = time.perf_counter()
    prog = Program(cfg, mix, device)
    loop = Loop(prog, mix["occupancy_pods"], traced=False)
    t_warm = time.perf_counter()
    warm_gangs = warm_up(loop, mix, seed)
    t_warmed = time.perf_counter()
    window = stream_gangs(mix, seed, 0)

    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    rows0 = API_COUNTERS.get("device_state_rows_uploaded_total")
    caps0 = speculate.graph_stats()["captures"]
    gc_pause = {"t": None, "s": 0.0, "full": 0, "full_s": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gc_pause["t"] = time.perf_counter()
        elif gc_pause["t"] is not None:
            dt = time.perf_counter() - gc_pause["t"]
            gc_pause["s"] += dt
            if info.get("generation") == 2:
                gc_pause["full"] += 1
                gc_pause["full_s"] += dt
            gc_pause["t"] = None

    prof = rec = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        from nhd_tpu_torch import obs
        from nhd_tpu_torch.obs import chrome

        rec = obs.enable(capacity=RECORDER_SPANS)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        anchors = [chrome.clock_anchor()]
    loop.traced = traced
    recs: List[dict] = []
    gc.callbacks.append(on_gc)
    t_open = time.perf_counter()
    setup_s = process_age()
    answers_s = 0.0
    try:
        for g in window:
            recs.append(loop.step(g))
            answers_s += recs[-1]["answers_s"]
            if time.perf_counter() - answers_s >= t_open + seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        t_close = time.perf_counter()
    finally:
        gc.callbacks.remove(on_gc)
    loop.traced = False
    spans = tallies = None
    dropped = 0
    if rec is not None:
        anchors.append(chrome.clock_anchor())
        spans, tallies, dropped = rec.spans(), rec.tallies(), rec.dropped()
        obs.disable()
    # the traced window is the whole wall; the program's window leaves
    # out the harness's reading of answers
    window_s = t_close - t_open
    program_s = window_s - answers_s
    summary = laid = None
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = trace_mod.read_export(path)
        del prof
        laid = chrome.lay_on_profile(events, spans, anchors)
        kernels = trace_mod.port_kernels(ROOT / "nhd_tpu_torch" / "kernels")
        summary = trace_mod.summarize(events, kernels, SPANS)
        del events
    rows_up = API_COUNTERS.get("device_state_rows_uploaded_total") - rows0
    captures = speculate.graph_stats()["captures"] - caps0

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    resident = prog.resident_rows()
    del prog

    t_ref = time.perf_counter()
    hw = Hardware.of(cfg["fleet"], cfg["guarantees"]["nic_bw_avail"])
    ref = Reference(hw, mix["pod_types"], nic_sharing=cfg["guarantees"]["nic_sharing"])
    loop.replay(ref)
    v = ref.verdict
    checks = {"bad_placements": v.bad_placements, "bad_failures": v.bad_failures,
              "row_mismatches": ref.row_mismatches(resident)}
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)
    tot = {k: sum(r[k] for r in recs) for k in ("schedule_s", "teardown_s", "answers_s")}
    print(f"bench_port: setup {setup_s:.3f} s (to the program {setup_s - (t_open - t_prog):.3f}, "
          f"fleet and context {t_warm - t_prog:.3f}, warm-up {t_warmed - t_warm:.3f}), "
          f"{warm_gangs} warm-up gangs, window {window_s:.3f} s ({program_s:.3f} s "
          f"the program's), {len(recs)} gangs (schedule {tot['schedule_s']:.3f} s, "
          f"teardown and refresh {tot['teardown_s']:.3f} s, answers "
          f"{tot['answers_s']:.3f} s; collector {gc_pause['s']:.3f} s, "
          f"{gc_pause['full']} full collections {gc_pause['full_s']:.3f} s; "
          f"{captures} graph captures), reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if laid is not None:
        print(f"bench_port: recorder {laid['spans']} spans, {dropped} dropped, "
              f"{sum(c for c, _ in tallies.values())} tallied calls; laid on the "
              f"profiler's clock at {laid['us_per_s']:.3f} us/s", file=sys.stderr)

    pods = sum(r["pods"] for r in recs)
    placed = sum(r["placed"] for r in recs)
    run = {
        "gangs": recs, "window_s": window_s,
        "rows_uploaded": rows_up, "captures": captures,
        "gc_pause_s": gc_pause["s"], "trace": summary, "fleet": cfg["fleet"],
        "spans": None if spans is None else [sp.to_dict() for sp in spans],
        "tallies": tallies, "dropped": dropped,
        "least_s": sum(roofline.least_seconds(
            roofline.solve_passes(r["rounds"], r["spec_round"], r["spec_iterations"]),
            cfg["fleet"]) for r in recs),
    }
    if traced:
        readers = mf.readers(mf.per_layer(manifest, cell["name"]))
        metrics = {}
        for m in mf.per_layer(manifest, cell["name"]):
            val = readers[m["name"]](run)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        e2e = {
            "pods_per_s": placed / program_s,
            "bind_mean_ms": 1e3 * sum(r["bind_sum_s"] for r in recs)
            / max(1, sum(r["binds"] for r in recs)),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in mf.end_to_end(manifest, cell["name"])}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": pods, "failed": pods - placed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = window_s
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["gangs_in_window"] = len(recs)
    out["window"] = {"wall_s": window_s, "program_s": program_s}
    out["notes"] = v.notes
    out["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return out


def power_limit() -> Optional[str]:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout else None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = mf.load(ROOT)
    cell = mf.cell(manifest, args.workload)
    cfg = mf.config(cell["config"])
    mix = mf.traffic(cell["traffic"])
    posture(cfg)
    if importlib.util.find_spec("nhd_tpu_torch") is None:
        print("bench_port: the program (nhd_tpu_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(cfg["process"]["torch_threads"])
    out = run_cell(manifest, cell, cfg, mix, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.trace:
        out["device"]["card"] = power_limit()
    for note in out["notes"]:
        print(f"reference: {note}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
