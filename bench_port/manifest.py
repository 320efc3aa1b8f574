"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a per-layer metric's reader
``metrics/<name>.py`` (a function ``read(run)`` that returns a number,
or None where the run holds nothing to read). A later change adds a
cell or a metric by adding such files and entries, never by editing
one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    with open(base / "configs" / f"{name}.json") as fh:
        return json.load(fh)


def traffic(name: str, base: Path = HERE) -> dict:
    with open(base / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def _covers(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def end_to_end(manifest: dict, workload: str) -> List[dict]:
    return [m for m in manifest["end_to_end"] if _covers(m, workload)]


def per_layer(manifest: dict, workload: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, workload)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def reader(name: str, base: Path = HERE) -> Callable[[dict], Optional[float]]:
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(metrics: List[dict], base: Path = HERE) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], base) for m in metrics}
