"""The flight recorder inside the port, on the CPU: the schedule's
phases as spans of exactly their ``BatchStats`` seconds, nested in the
call's ``schedule`` span under one correlation ID (``topology_fill``
inside ``final_sync``); ``refresh_context`` and its three parts; the
release tally; the collector's ``gc`` spans; the spans laid on a
``torch.profiler`` trace's clock; the port's ring rule; and
nothing at all with the recorder off.

Each test turns the process-global recorder on and off in its own scope.
The one ``cuda`` case (the megaround replay's device time) skips without
a card, decided inside the test.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from nhd_tpu_torch import obs
from nhd_tpu_torch.obs import chrome
from nhd_tpu_torch.obs.recorder import _on_gc
from nhd_tpu_torch.sim.requests import request_to_topology
from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
from nhd_tpu_torch.solver import BatchItem, BatchScheduler
from nhd_tpu_torch.solver.encode import ClusterDelta

ROOT = Path(__file__).resolve().parent.parent
GROUPS = ["default", "edge"]
#: the phases a CPU gang of workload_mix pods runs through
PHASES = {"prepass", "encode", "native_assign", "materialize", "final_sync",
          "backfill"}


@pytest.fixture
def recorder():
    """The process-global recorder, on for the test alone."""
    rec = obs.enable(capacity=1 << 16)
    try:
        yield rec
    finally:
        obs.disable()


def _setup(n_nodes=12, n_pods=120, device="cpu"):
    nodes = cap_cluster(n_nodes, GROUPS)
    sched = BatchScheduler(device=device)
    delta = ClusterDelta(nodes)
    ctx = sched.make_context(nodes, delta=delta)
    items = [BatchItem(("ns", f"p{i}"), r, request_to_topology(r))
             for i, r in enumerate(workload_mix(n_pods, GROUPS))]
    return sched, ctx, items


def _teardown(ctx, items, results):
    """Release every placed pod the daemon's way; returns the count."""
    n = 0
    for item, r in zip(items, results):
        if r.node is None:
            continue
        node = ctx.nodes[r.node]
        node.release_from_topology(item.topology)
        node.remove_scheduled_pod(item.key[1], item.key[0])
        ctx.delta.note(r.node)
        n += 1
    return n


def _inside(inner, outer, slack=1e-9):
    return (outer.t0 - slack <= inner.t0
            and inner.t0 + inner.dur <= outer.t0 + outer.dur + slack)


def test_schedule_phases_are_spans_of_their_seconds(recorder):
    sched, ctx, items = _setup()
    results, stats = sched.schedule(ctx.nodes, items, context=ctx)
    assert stats.scheduled > 0
    spans = recorder.spans()
    (call,) = [s for s in spans if s.name == "schedule"]
    assert PHASES <= set(stats.phases)
    for name, seconds in stats.phases.items():
        mine = [s for s in spans if s.name == name]
        assert mine, name
        assert abs(sum(s.dur for s in mine) - seconds) <= 1e-9, name
        assert all(_inside(s, call) for s in mine), name
    (sync,) = [s for s in spans if s.name == "final_sync"]
    (fill,) = [s for s in spans if s.name == "topology_fill"]
    assert _inside(fill, sync) and 0 < fill.dur <= sync.dur
    rounds = [s for s in spans if s.name.startswith("round")]
    assert len(rounds) == len(stats.round_end_seconds) > 0
    assert all(_inside(s, call) for s in rounds)
    gang = [s for s in spans if s.cat != "gc"]
    assert len({s.corr for s in gang}) == 1 and call.corr is not None


def test_recorder_off_records_nothing_and_keeps_the_phases(monkeypatch):
    sched, ctx, items = _setup()
    rec = obs.enable(capacity=1 << 16)
    try:
        _r, on = sched.schedule(ctx.nodes, items, context=ctx)
    finally:
        obs.disable()
    assert rec.spans()

    def refuse(*_a, **_k):
        raise AssertionError("profiler or CUDA event used with the recorder off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    sched, ctx, items = _setup()
    results, off = sched.schedule(ctx.nodes, items, context=ctx)
    _teardown(ctx, items, results)
    sched.refresh_context(ctx)
    assert obs.get_recorder() is None and _on_gc not in gc.callbacks
    assert set(off.phases) == set(on.phases)
    assert off.rec is None and off.corr is None
    assert [r.node for r in results] == [r.node for r in _r]


def test_refresh_context_records_its_three_parts(recorder):
    sched, ctx, items = _setup()
    results, _stats = sched.schedule(ctx.nodes, items, context=ctx)
    assert _teardown(ctx, items, results) > 0
    recorder.clear()
    sched.refresh_context(ctx)
    spans = [s for s in recorder.spans() if s.cat != "gc"]
    (outer,) = [s for s in spans if s.name == "refresh_context"]
    parts = {s.name: s for s in spans if s is not outer}
    assert set(parts) == {"delta_refresh", "fast_refresh", "row_scatter"}
    assert all(_inside(s, outer) for s in parts.values())
    assert sum(s.dur for s in parts.values()) <= outer.dur + 1e-9


def test_release_tally_counts_each_call():
    sched, ctx, items = _setup()
    results, _stats = sched.schedule(ctx.nodes, items, context=ctx)
    rec = obs.enable(capacity=1 << 10)
    try:
        n = _teardown(ctx, items, results)
        count, seconds = rec.tallies()["release_from_topology"]
    finally:
        obs.disable()
    assert n > 0 and count == n and seconds > 0
    # off: the same releases leave a recorder enabled afterwards empty
    results, _stats = sched.schedule(ctx.nodes, items, context=ctx)
    assert _teardown(ctx, items, results) > 0
    rec = obs.enable(capacity=1 << 10)
    try:
        assert rec.tallies() == {}
        trace = chrome.chrome_trace(rec)
        assert "tallies" not in trace["nhdMeta"]
    finally:
        obs.disable()


def test_tallies_export_with_the_spans_and_clear_with_them(recorder):
    recorder.tally("release_from_topology", 0.25, count=3)
    recorder.tally("release_from_topology", 0.5)
    assert recorder.tallies() == {"release_from_topology": (4, 0.75)}
    meta = chrome.chrome_trace(recorder)["nhdMeta"]
    assert meta["tallies"] == {"release_from_topology": {"count": 4, "seconds": 0.75}}
    recorder.clear()
    assert recorder.tallies() == {}


def test_a_collection_is_one_gc_span_and_disable_removes_the_hook():
    gc.collect()
    rec = obs.enable(capacity=1 << 10)
    assert _on_gc in gc.callbacks
    try:
        gc.collect()
        full = [s for s in rec.spans()
                if s.name == "gc" and s.attrs["generation"] == 2]
    finally:
        obs.disable()
    assert len(full) == 1 and full[0].dur > 0 and full[0].corr is None
    assert _on_gc not in gc.callbacks
    before = rec.occupancy()
    gc.collect()
    assert rec.occupancy() == before


def test_a_collection_inside_the_rings_lock_waits_for_it(recorder):
    """The hook never takes the ring's lock: a collection that starts
    inside one of the recorder's locked sections queues its span, and
    the ring takes it in at the next read."""
    with recorder._lock:
        gc.collect()
        assert len(recorder._spans) == 0 and recorder._pending
    got = recorder.spans()
    assert got and {s.name for s in got} == {"gc"}
    assert not recorder._pending


def test_spans_land_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = obs.enable(capacity=1 << 10)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            anchors = [chrome.clock_anchor()]
            a, b = torch.ones(64), torch.ones(64)
            for _ in range(3):
                time.sleep(0.02)
                # the add sits 1 ms inside the span on each side: mapped
                # within 100 us of where the profiler puts it, it lies in
                with obs.span("probe", cat="test"):
                    time.sleep(0.001)
                    with record_function("probe_fn"):
                        torch.add(a, b)
                    time.sleep(0.001)
                anchors.append(chrome.clock_anchor())
        spans = [s for s in rec.spans() if s.name == "probe"]
    finally:
        obs.disable()
    trace = {"traceEvents": [dict(e) for e in _events(prof)]}
    with pytest.raises(ValueError):
        chrome.lay_on_profile(dict(trace, traceEvents=list(trace["traceEvents"])),
                              spans, anchors[:2])
    laid = chrome.lay_on_profile(trace, spans, anchors)
    assert laid["spans"] == 3 and laid["residual_us"] < 100.0
    assert abs(laid["us_per_s"] / 1e6 - 1.0) < 0.05
    mine = sorted((e for e in trace["traceEvents"]
                   if e.get("cat") == chrome.PROFILE_CAT), key=lambda e: e["ts"])
    fns = sorted((e for e in trace["traceEvents"] if e.get("name") == "probe_fn"),
                 key=lambda e: e["ts"])
    adds = sorted((e for e in trace["traceEvents"] if e.get("name") == "aten::add"),
                  key=lambda e: e["ts"])
    assert len(mine) == len(fns) == 3 and len(adds) >= 3
    for span, fn in zip(mine, fns):
        assert span["args"]["cat"] == "test"
        inside = [e for e in adds if fn["ts"] <= e["ts"] <= fn["ts"] + fn["dur"]]
        assert inside
        for e in inside:
            assert span["ts"] + 900.0 <= e["ts"]
            assert e["ts"] + e["dur"] <= span["ts"] + span["dur"] - 900.0


def _events(prof):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def test_the_ring_rule_drops_nothing_over_480_pod_gangs():
    """The port's ring rule (``trace_demo.ring_capacity``, ten spans a
    pod) over gangs of 480 pods on 48 nodes, each scheduled, torn down
    the daemon's way and refreshed: every span kept (the phases, the
    refresh's parts, the collector's), one release tallied a placed pod."""
    from nhd_tpu_torch.sim import trace_demo

    gangs = 3
    sched, ctx, items = _setup(n_nodes=48, n_pods=480)
    rec = obs.enable(capacity=trace_demo.ring_capacity(gangs * len(items)))
    placed = 0
    try:
        for _ in range(gangs):
            results, _stats = sched.schedule(ctx.nodes, items, context=ctx)
            placed += _teardown(ctx, items, results)
            sched.refresh_context(ctx)
        spans = rec.spans()
        count, seconds = rec.tallies()["release_from_topology"]
    finally:
        obs.disable()
    assert rec.dropped() == 0 and placed > 0
    assert count == placed and seconds > 0
    assert sum(s.name == "schedule" for s in spans) == gangs
    assert sum(s.name == "refresh_context" for s in spans) == gangs
    assert len(spans) < trace_demo.SPANS_PER_POD * len(items)


def test_no_megaround_replay_span_on_the_cpu(recorder, monkeypatch):
    monkeypatch.setenv("NHD_TPU_SPECULATE", "1")
    sched, ctx, items = _setup()
    _results, stats = sched.schedule(ctx.nodes, items, context=ctx)
    assert "spec_dispatch" in stats.phases
    names = {s.name for s in recorder.spans()}
    assert "spec_pull" in names and "megaround_replay" not in names


def test_obs_imports_without_torch():
    # the package's own __init__ resolves devices through torch: load
    # obs under a bare package object, with torch unimportable
    code = (
        "import sys, types\n"
        "sys.modules['torch'] = None\n"
        "pkg = types.ModuleType('nhd_tpu_torch')\n"
        "pkg.__path__ = ['nhd_tpu_torch']\n"
        "sys.modules['nhd_tpu_torch'] = pkg\n"
        "import nhd_tpu_torch.obs as obs\n"
        "from nhd_tpu_torch.obs import chrome\n"
        "rec = obs.enable()\n"
        "rec.tally('x', 1.0)\n"
        "assert chrome.chrome_trace(rec)['nhdMeta']['tallies']\n"
        "obs.disable()\n"
        "try:\n"
        "    chrome.clock_anchor()\n"
        "except ImportError:\n"
        "    print('lazy')\n"
    )
    got = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "lazy"


@pytest.mark.cuda
def test_megaround_replay_carries_its_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sched, ctx, items = _setup(n_nodes=60, n_pods=600, device="cuda")
    sched.schedule(ctx.nodes, items[:60], context=ctx)  # capture the graph
    rec = obs.enable(capacity=1 << 16)
    try:
        _results, stats = sched.schedule(ctx.nodes, items[60:], context=ctx)
        replays = [s for s in rec.spans() if s.name == "megaround_replay"]
    finally:
        obs.disable()
    assert "spec_dispatch" in stats.phases
    (replay,) = replays
    assert replay.attrs["device_s"] > 0 and replay.dur == replay.attrs["device_s"]
    assert replay.attrs["passes"] == stats.counters["spec_iterations"]
