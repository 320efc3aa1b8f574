"""BENCHMARK.json against the contract's shape, and the harness finding
configurations, traffic mixes and metric readers by name: a new cell
comes from new files and entries alone."""

import json
import re
import shutil

from bench_port import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_units_and_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_finds_its_files(manifest):
    for w in manifest["workloads"]:
        cfg = mf.config(w["config"])
        mix = mf.traffic(w["traffic"])
        assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
        assert mf.end_to_end(manifest, w["name"])
        for m in mf.per_layer(manifest, w["name"]):
            assert callable(mf.reader(m["name"]))
    for c in manifest["configs"]:
        assert (mf.HERE.parent / c["file"]).is_file()
        assert mf.config(c["name"])["reduced"] == c["reduced"]


#: the per-layer metrics that read the program's recorder
RECORDED = {"native_assign_ms", "materialize_ms", "topology_fill_ms", "refresh_ms",
            "release_ms", "megaround_device_ms"}


def test_spec_metrics_belong_to_the_megaround_cell(manifest):
    """Every per-layer metric lists its cells: the backlog keeps its
    thirteen and gains the recorder's six, and a cell added later gets
    none it does not list."""
    assert all("workloads" in m for m in manifest["per_layer"])
    per = {m["name"] for m in mf.per_layer(manifest, "cap1k.backlog10k")}
    assert {"spec_dispatch_ms", "window_captures", "kernel_ms"} <= per
    assert RECORDED <= per and len(per) == 13 + len(RECORDED)
    other = json.loads(json.dumps(manifest))
    other["workloads"].append({"name": "cap1k.other", "config": "cap1k",
                               "traffic": "backlog10k", "chips": 1, "why": "test"})
    per = {m["name"] for m in mf.per_layer(other, "cap1k.other")}
    assert "spec_dispatch_ms" not in per and "window_captures" not in per
    assert per == set()


def test_a_new_cell_is_files_and_entries(manifest, tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix and a
    metric as files plus entries, and the lookups find them with no
    code edited."""
    base = tmp_path / "bench"
    shutil.copytree(mf.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = mf.config("cap1k", base)
    cfg["name"] = "cap1k_b"
    cfg["fleet"]["nodes"] = 2000
    (base / "configs" / "cap1k_b.json").write_text(json.dumps(cfg))
    mix = mf.traffic("backlog10k", base)
    mix.update(name="smallsets", gang_pods_min=1, gang_pods_max=32, block=32,
               occupancy_pods=8000)
    (base / "traffic" / "smallsets.json").write_text(json.dumps(mix))
    (base / "metrics" / "pods_per_gang.py").write_text(
        "def read(run):\n    g = run['gangs']\n"
        "    return sum(x['pods'] for x in g) / len(g) if g else None\n")
    man = json.loads(json.dumps(manifest))
    man["workloads"].append({"name": "cap1k_b.smallsets", "config": "cap1k_b",
                             "traffic": "smallsets", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "pods_per_gang", "unit": "pods", "better": "higher",
                             "source": "program_counter", "layer": "schedule call",
                             "moves": "pods_per_s", "workloads": ["cap1k_b.smallsets"]})
    cell = mf.cell(man, "cap1k_b.smallsets")
    assert mf.config(cell["config"], base)["fleet"]["nodes"] == 2000
    assert mf.traffic(cell["traffic"], base)["gang_pods_max"] == 32
    assert mf.traffic(cell["traffic"], base)["occupancy_pods"] == 8000
    per = mf.per_layer(man, cell["name"])
    assert "pods_per_gang" in {m["name"] for m in per}
    assert "spec_dispatch_ms" not in {m["name"] for m in per}
    readers = mf.readers(per, base)
    assert readers["pods_per_gang"]({"gangs": [{"pods": 3}, {"pods": 5}]}) == 4
