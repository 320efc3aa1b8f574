"""Reading the window's ``torch.profiler`` trace (its Chrome-trace
export): the device's busy seconds, the port's kernel time, the
megaround graph's replays, the device operations that took the most
time and the longest idle gaps, named by what the harness was doing.

A replay of the megaround's CUDA graph is one ``cudaGraphLaunch``; the
device work it starts carries the launch's correlation id, so a
replay's device time is the span from the first to the last of that
work. The profiler records 0, 1 or every pass of the graph's WHILE node,
so that span is what the trace shows of a replay, not a count of its
passes.

Where the program's flight recorder ran, its spans are laid on the
trace's clock as complete events of category ``nhd``
(``nhd_tpu_torch.obs.chrome.lay_on_profile``); an idle gap is then named
by the innermost program span it fell in (the collector's ``gc`` spans
among them), and by the harness's span where no program span holds it.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GRAPH_OP = "megaround_graph"
#: the category of the program's recorded spans once laid on the trace
PROGRAM_CAT = "nhd"
#: recorded spans that time the device, not the host: they name no gap
DEVICE_SPAN_CATS = ("device",)

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def port_kernels(kernel_dir: Path) -> List[str]:
    """The names of the port's hand-written kernels, from its sources."""
    names = []
    for src in sorted(kernel_dir.glob("*.cu")):
        names.extend(_GLOBAL.findall(src.read_text()))
    return sorted(set(names))


def short(name: str) -> str:
    """A device op's name without its return type, anonymous namespace,
    argument list or template arguments."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", n, maxsplit=1)[0].strip() or name


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events: List[dict], kernels: List[str], spans: Iterable[str]) -> Dict:
    """Reduce the trace's events (``ts``/``dur`` in microseconds) to
    seconds: ``busy_s`` (union of device activity), ``kernel_s`` (the
    port's kernels outside graphs plus each replay's span), ``device_ops``
    and ``idle_gaps`` (each at most 10, longest first; a gap is named by the
    innermost span it fell in, the program's or else the harness's, and
    the device op before it)."""
    spans = set(spans)
    graph_corr = set()
    device = []
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat.startswith("cuda_") and "GraphLaunch" in e.get("name", ""):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                graph_corr.add(corr)
        elif cat in DEVICE_CATS:
            s = float(e["ts"])
            d = float(e.get("dur", 0.0))
            device.append((s, s + d, e.get("name", cat), cat,
                           (e.get("args") or {}).get("correlation")))
        elif ((cat == "user_annotation" and e.get("name") in spans)
              or (cat == PROGRAM_CAT
                  and (e.get("args") or {}).get("cat") not in DEVICE_SPAN_CATS)):
            s = float(e["ts"])
            host.append((s, s + float(e.get("dur", 0.0)), e["name"]))

    kset = set(kernels)
    ops: Dict[str, float] = defaultdict(float)
    replays: Dict[object, List[float]] = {}
    kernel_us = 0.0
    for s, e, name, cat, corr in device:
        if corr in graph_corr:
            r = replays.setdefault(corr, [s, e])
            r[0] = min(r[0], s)
            r[1] = max(r[1], e)
            continue
        nm = short(name) if cat == "kernel" else cat
        ops[nm] += e - s
        if cat == "kernel" and short(name) in kset:
            kernel_us += e - s
    graph_us = sum(e - s for s, e in replays.values())
    if replays:
        ops[GRAPH_OP] += graph_us
    busy = union((s, e) for s, e, *_ in device)
    busy_us = sum(e - s for s, e in busy)

    # by start, the outer of two spans that start together first: the
    # innermost span holding an instant is the last one that started
    host.sort(key=lambda h: (h[0], -h[1]))
    hs = [h[0] for h in host]

    def doing(t: float) -> str:
        j = bisect.bisect_right(hs, t) - 1
        while j >= 0:
            if host[j][1] >= t:
                return host[j][2]
            j -= 1
        return "harness"

    last_name = {}
    for s, e, name, cat, corr in device:
        last_name[e] = GRAPH_OP if corr in graph_corr else (
            short(name) if cat == "kernel" else cat)
    longest = sorted(((s1 - e0, e0, s1) for (s0, e0), (s1, _e1) in zip(busy, busy[1:])),
                     reverse=True)[:10]
    gaps = [(g, f"{doing((e0 + s1) / 2)}_after_{last_name.get(e0, 'device')}")
            for g, e0, s1 in longest]
    return {
        "busy_s": busy_us * 1e-6,
        "kernel_s": (kernel_us + graph_us) * 1e-6,
        "device_ops": [[n, t * 1e-6] for n, t in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, g * 1e-6] for g, n in gaps[:10]],
    }


def read_export(path: Path) -> List[dict]:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data
