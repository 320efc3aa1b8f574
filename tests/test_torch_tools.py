"""The port's operator gates against the reference's tools, on the CPU.

Each JAX tool (tools/soak.py, trace_demo.py, trace_replay.py,
fleet_demo.py, fleet_top.py, loaded with importlib as
tests/test_torch_chaos.py loads chaos_storm.py) and its counterpart in
the port (``nhd_tpu_torch.sim.soak``, ``.sim.trace_demo``,
``.sim.trace_replay``, ``.sim.fleet_demo``, ``nhd_tpu_torch.obs.
fleet_top``) run at small sizes, the port with ``--device cpu``: soak 3
seeds x 30 steps, the trace demo and the replay demo at their defaults,
the replay CLI on the golden journal (faithful and with a node
dropped), the fleet demo at 20 steps, and fleet top over two replicas
serving one exposition and one that does not answer. Both must print
the same lines, write the same reports and artifacts and exit with the
same code. Tolerance: exact, with timings, wall stamps, paths and the
process's correlation counters masked.

A gate that solves refuses ``--device cuda`` on a machine without a GPU
with a non-zero exit that names cuda, before any work.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from chip_smoke import masked as _mask
from tests.test_torch_obs import _diff

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "fixtures" / "journal" / "golden_churn.journal.jsonl"

#: (pattern, replacement) applied to every output line, in order
MASKS = (
    (re.compile(r"(?<!\w)/\S+"), "<path>"),
    (re.compile(r"\d+\.\d+ seeds/s"), "<rate> seeds/s"),
    (re.compile(r" in \d+s "), " in <t>s "),
    (re.compile(r"\d+\.\d+ms"), "<t>ms"),
    (re.compile(r"c\d{6}"), "c*"),
    (re.compile(r"@ \d\d:\d\d:\d\d"), "@ <hh:mm:ss>"),
)


def _lines(text):
    out = []
    for line in text.splitlines():
        for pat, rep in MASKS:
            line = pat.sub(rep, line)
        out.append(line)
    return out


def _tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(
        "nhd_tpu_torch.obs.fleet_top" if name == "fleet_top"
        else f"nhd_tpu_torch.sim.{name}")


@pytest.fixture
def knobs(monkeypatch):
    """Both packages on the same posture: the reference's auto mesh would
    take the session's virtual devices, the port's counts GPUs."""
    monkeypatch.setenv("NHD_MESH", "off")
    return monkeypatch


def _run_both(name, argv_of, capsys, monkeypatch, *, argv_main=True):
    """(reference, port) as (exit code, masked lines) of one tool; the
    reference's soak reads ``sys.argv``."""
    got = []
    for side, mod, extra in (("jax", _tool(name), []),
                             ("port", _port(name), ["--device", "cpu"])):
        if name == "fleet_top":
            extra = []
        argv = argv_of(side) + extra
        if side == "jax" and not argv_main:
            monkeypatch.setattr(sys, "argv", [name] + argv)
            code = mod.main()
        else:
            code = mod.main(argv)
        got.append((code, _lines(capsys.readouterr().out)))
    return got


def test_soak_matches_the_reference_tool(knobs, capsys):
    ref, port = _run_both(
        "soak", lambda side: ["--seeds", "3", "--steps", "30"], capsys,
        knobs, argv_main=False)
    assert port == ref
    assert port[0] == 0 and port[1][-1].startswith("SOAK OK: 3 seeds x 30")


#: the trace demo's event count: the port's trace holds the reference's
#: spans and, besides, the batch's phases, the refresh's parts and the
#: collector's spans (docs/OBSERVABILITY.md), so the counts differ
EVENTS = re.compile(r"schema OK, (\d+) events")


def test_trace_demo_matches_the_reference_tool(knobs, capsys, tmp_path):
    import nhd_tpu.obs as jx_obs

    try:
        ref, port = _run_both(
            "trace_demo", lambda side: ["--out", str(tmp_path / side)],
            capsys, knobs)
    finally:
        jx_obs.disable()  # the reference's tool leaves its recorder on
    counts = [int(EVENTS.search(got[1][1]).group(1)) for got in (ref, port)]
    for got in (ref, port):
        got[1][1] = EVENTS.sub("schema OK, <n> events", got[1][1])
    assert port == ref
    assert counts[1] > counts[0]
    assert port[0] == 0 and "6/6 pods bound" in port[1][0]
    names = {}
    for side in ("jax", "port"):
        trace = json.loads((tmp_path / side / "trace_demo.json").read_text())
        assert trace["traceEvents"]
        names[side] = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert names["jax"] <= names["port"]
    assert {"prepass", "encode", "final_sync", "backfill"} <= (
        names["port"] - names["jax"])


def test_replay_demo_matches_the_reference_tool(knobs, capsys):
    ref, port = _run_both("trace_replay", lambda side: ["--demo"], capsys,
                          knobs)
    assert port == ref
    assert port[0] == 0 and port[1][-1] == "trace-replay: demo PASS"
    assert any("knob drift: NHD_MIN_BUSY_SECS" in line for line in port[1])


@pytest.mark.parametrize("extra", [[], ["--drop-node", "node0"]],
                         ids=["faithful", "node-dropped"])
def test_replay_cli_matches_the_reference_tool(extra, knobs, capsys,
                                               tmp_path):
    ref, port = _run_both(
        "trace_replay",
        lambda side: [str(GOLDEN), "--json-out",
                      str(tmp_path / f"{side}.json"), *extra],
        capsys, knobs)
    assert port == ref
    assert port[0] == (1 if extra else 0)
    reports = [_mask(json.loads((tmp_path / f"{s}.json").read_text()))
               for s in ("jax", "port")]
    assert _diff(reports[1], reports[0]) == []


def test_fleet_demo_matches_the_reference_tool(knobs, capsys, tmp_path):
    import nhd_tpu.k8s.retry as jx_retry
    import nhd_tpu.solver.guard as jx_guard
    import nhd_tpu_torch.k8s.retry as pt_retry
    import nhd_tpu_torch.solver.guard as pt_guard

    for mod in (jx_retry.API_COUNTERS, pt_retry.API_COUNTERS,
                jx_guard.GUARD, pt_guard.GUARD):
        mod.reset()  # process-wide tallies the payload folds in
    got = []
    for side, mod, extra in (("jax", _tool("fleet_demo"), []),
                             ("port", _port("fleet_demo"),
                              ["--device", "cpu"])):
        for m in (jx_retry.API_COUNTERS, pt_retry.API_COUNTERS):
            m.reset()
        out = tmp_path / side
        code = mod.main(["--steps", "20", "--out-dir", str(out), *extra])
        arts = {p.name: json.loads(p.read_text())
                for p in sorted(out.glob("*.json"))}
        got.append((code, _lines(capsys.readouterr().out), arts))
    (rc, lines, arts), (prc, plines, parts) = got
    assert (prc, plines) == (rc, lines)
    assert prc == 0 and sorted(parts) == sorted(arts)
    for name in arts:
        assert _diff(_mask(parts[name]), _mask(arts[name])) == [], name


EXPOSITION = "\n".join([
    "# TYPE nhd_shard_epoch gauge",
    'nhd_shard_epoch{shard="0"} 3',
    'nhd_shard_epoch{shard="2"} 1',
    "# TYPE nhd_slo_bind_observations_total counter",
    "nhd_slo_bind_observations_total 12",
    "nhd_slo_bind_breaches_total 1",
    'nhd_slo_bind_burn_rate{window="5m"} 0.5',
    'nhd_slo_bind_burn_rate{window="1h"} 0.25',
    "nhd_ha_stale_writes_rejected_total 2",
    "nhd_shard_spillover_claims_total 4",
    "nhd_shard_handoffs_total 1",
    'nhd_bind_latency_seconds_bucket{le="0.1"} 10',
    'nhd_bind_latency_seconds_bucket{le="+Inf"} 12',
]) + "\n"


class _Replica(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server's name)
        if self.path.startswith("/metrics"):
            body = EXPOSITION.encode()
        elif self.path.startswith("/decisions"):
            body = json.dumps({"decisions": [
                {"pod": "p0", "ns": "default", "outcome": "scheduled"}
            ]}).encode()
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_fleet_top_matches_the_reference_tool(capsys, tmp_path, monkeypatch):
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), _Replica)
               for _ in range(2)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    # a port nothing listens on: bound, then closed
    dead = ThreadingHTTPServer(("127.0.0.1", 0), _Replica)
    dead_port = dead.server_address[1]
    dead.server_close()
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    urls.append(f"http://127.0.0.1:{dead_port}")
    try:
        ref, port = _run_both(
            "fleet_top",
            lambda side: [*urls, "--timeout", "2", "--json-out",
                          str(tmp_path / f"{side}.json")],
            capsys, monkeypatch)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
    assert port == ref
    assert port[0] == 0 and "2/3 replicas" in port[1][0]
    assert any("UNREACHABLE" in line for line in port[1])
    arts = [json.loads((tmp_path / f"{s}.json").read_text())
            for s in ("jax", "port")]
    assert _diff(_mask(arts[1]), _mask(arts[0])) == []
    from nhd_tpu_torch.obs.fleet import validate_fleet_artifact

    assert validate_fleet_artifact(arts[1]) == []
    assert arts[1]["payload"]["fencing"]["stale_writes_rejected_total"] == 4
    assert arts[1]["payload"]["slo"]["worst_burn_rates"] == {"5m": 0.5, "1h": 0.25}


@pytest.mark.parametrize("name,argv", [
    ("soak", ["--seeds", "1", "--steps", "1"]),
    ("trace_demo", []),
    ("trace_replay", ["--demo"]),
    ("fleet_demo", ["--steps", "1"]),
])
def test_gate_without_a_gpu_exits_naming_cuda(name, argv, capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    if name in ("trace_demo", "fleet_demo"):
        argv = argv + ["--out" if name == "trace_demo" else "--out-dir",
                       str(tmp_path)]
    assert _port(name).main(argv + ["--device", "cuda"]) == 1
    out, err = capsys.readouterr()
    assert "cuda" in err and out == ""
    assert list(tmp_path.iterdir()) == []
