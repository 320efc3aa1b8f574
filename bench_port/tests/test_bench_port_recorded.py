"""The readers of the program's recorded spans and tallies on a synthetic
run: a mean a window gang, and nothing where nothing was recorded."""

import pytest

from bench_port import manifest as mf

SIX = ["native_assign_ms", "materialize_ms", "topology_fill_ms", "refresh_ms",
       "release_ms", "megaround_device_ms"]


def _run(spans, tallies, gangs=4):
    return {"gangs": [{}] * gangs, "spans": spans, "tallies": tallies}


def _span(name, dur, **attrs):
    s = {"name": name, "cat": "phase", "corr": None, "t0": 0.0, "dur": dur,
         "thread": "MainThread"}
    if attrs:
        s["attrs"] = attrs
    return s


@pytest.mark.parametrize("name", SIX)
def test_nothing_recorded_reads_none(name):
    read = mf.reader(name)
    assert read(_run(None, None)) is None  # an untraced run
    assert read(_run([], {})) is None
    assert read(_run([_span("gc", 0.5), _span("schedule", 1.0)],
                     {"other": (3, 0.1)})) is None
    assert read(_run([_span(n, 0.1, device_s=0.1) for n in (
        "native_assign", "materialize", "topology_fill", "refresh_context",
        "megaround_replay")], {"release_from_topology": (2, 0.2)}, gangs=0)) is None


def test_each_reads_its_span_or_tally_a_gang():
    spans = [_span("native_assign", 0.004), _span("native_assign", 0.002),
             _span("materialize", 0.008), _span("topology_fill", 0.012),
             _span("refresh_context", 0.016),
             _span("megaround_replay", 0.5, device_s=0.0004, passes=3),
             _span("megaround_replay", 0.5, device_s=0.0008, passes=2)]
    run = _run(spans, {"release_from_topology": (40, 0.02)}, gangs=2)
    got = {n: mf.reader(n)(run) for n in SIX}
    want = {"native_assign_ms": 3.0, "materialize_ms": 4.0, "topology_fill_ms": 6.0,
            "refresh_ms": 8.0, "release_ms": 10.0, "megaround_device_ms": 0.6}
    assert got == pytest.approx(want)


def test_a_ring_that_dropped_spans_reads_none():
    """Spans lost off the ring would make every span reading short; the
    tally is kept apart from the ring and still reads."""
    spans = [_span("native_assign", 0.004), _span("materialize", 0.008),
             _span("topology_fill", 0.012), _span("refresh_context", 0.016),
             _span("megaround_replay", 0.5, device_s=0.0004, passes=3)]
    run = _run(spans, {"release_from_topology": (40, 0.02)}, gangs=2)
    run["dropped"] = 1
    got = {n: mf.reader(n)(run) for n in SIX}
    assert got.pop("release_ms") == pytest.approx(10.0)
    assert set(got.values()) == {None}
