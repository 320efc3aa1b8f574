"""The daemon past ``NHD_STREAM_NODES`` under churn: the port against the
JAX package, on the CPU.

24 cfg4 nodes in tiles of 8 (routed placement and persistent tile
contexts, as bench.py's cfg7 drives its tiler; one tile worker on both
sides, so no thread order enters) take 48 of cfg4's pending pods, then
four turns of a seeded cfg7-mix script (``sim/pending.py``
``churn_script``: creates, deletes of bound pods, cordon and maintenance
toggles, group moves within the interned set), applied through each
package's fake backend and met by each daemon's inventory and watch
path (``apply_events``, ``churn_turn``). After every turn both packages
agree on every pod's node, solved config and NAD, the binds and the
device-state counters (rows uploaded, row patches, full rebuilds), and
each keeps bench.py:382-396's changed-row budget in every turn, the
turn before's binds charged to it beside its own (a batch's claimed rows
upload at the next batch's first solve; ``chip_smoke.turn_budgets``). Once
with classic rounds (the CPU's default), once with the speculative
round 0 (the card's).

Tolerance: exact equality.
"""

from __future__ import annotations

import importlib
import queue

import pytest

from chip_smoke import DEVICE_STATE_COUNTERS as COUNTERS
from chip_smoke import turn_budgets
from nhd_tpu_torch.sim import pending
from tests.test_torch_daemon import PACKAGES, _pkg

NODES, PODS, TILE, TURNS, EVENTS = 24, 48, 8, 4, 24


def _churn(root, mp):
    pkg = _pkg(root)
    mp.setattr(pkg.core, "STREAM_NODE_THRESH", 16)
    mp.setattr(pkg.core, "STREAM_TILE_NODES", TILE)
    mp.setattr(pkg.core, "STREAM_PLACEMENT", "routed")
    api = importlib.import_module(f"{root}.k8s.retry").API_COUNTERS
    backend = pkg.Backend()
    pending.fill_cfg4(backend, pkg.sim, NODES, PODS)
    sched = pkg.Scheduler(backend, pkg.WatchQueue(), queue.Queue(),
                          respect_busy=False)
    ctrl = pkg.Controller(backend, sched.nqueue)
    script = pending.churn_script(7, TURNS, EVENTS, NODES)
    turns = []

    def turn(fn, events):
        c0 = api.snapshot()
        b0 = sched.perf["batches_total"]
        binds = fn()
        c1 = api.snapshot()
        turns.append({
            "events": events, "binds": binds,
            "batches": sched.perf["batches_total"] - b0,
            **{k: c1[k] - c0[k] for k in COUNTERS},
            "pods": {key: (p.node, p.annotations.get(pkg.CFG),
                           p.annotations.get(pkg.NAD))
                     for key, p in sorted(backend.pods.items())},
        })

    turn(lambda: pending.drive(sched)["bound"], {"create": PODS})
    assert sched._stream is not None and sched._stream.persistent
    for i, events in enumerate(script):
        done = pending.apply_events(backend, pkg.sim, events)
        turn(lambda i=i: pending.churn_turn(sched, ctrl, float(i + 1)), done)
    return turns


@pytest.mark.parametrize("speculate", ["0", "1"], ids=["classic", "speculative"])
def test_churn_past_the_stream_threshold_matches_the_jax_daemon(speculate, monkeypatch):
    monkeypatch.setenv("NHD_STREAM_WORKERS", "1")
    monkeypatch.setenv("NHD_TPU_DEVICE_STATE", "1")
    monkeypatch.setenv("NHD_TPU_SPECULATE", speculate)
    monkeypatch.setenv("NHD_MESH", "off")
    got = {}
    for root in PACKAGES:
        with monkeypatch.context() as mp:
            got[root] = _churn(root, mp)
    for i, (port, ref) in enumerate(zip(got["nhd_tpu_torch"], got["nhd_tpu"],
                                        strict=True)):
        assert port == ref, f"turn {i}"
    kinds = set()
    for root in PACKAGES:
        turns = got[root]
        for i, budget in enumerate(turn_budgets(turns, NODES)):
            assert turns[i]["device_state_rows_uploaded_total"] <= budget, (root, i)
    for i, t in enumerate(got["nhd_tpu_torch"]):
        kinds |= set(t["events"])
        if i:
            # no node joined or left: every change is a row patch
            assert t["device_state_full_rebuilds_total"] == 0, f"turn {i}"
            assert t["device_state_deltas_total"] > 0, f"turn {i}"
    assert kinds == {"create", "delete", "cordon", "maint", "group"}
    assert got["nhd_tpu_torch"][0]["binds"] == PODS
    assert sum(t["binds"] for t in got["nhd_tpu_torch"][1:]) > 0
