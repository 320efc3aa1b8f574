"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped (device "cpu"), the rest of a run
driven as ``run.py`` drives it, once for each fault a cell can have.
(No cell spans several cards, so there is no exchange between cards to leave
out.)"""

import pytest

from bench_port import manifest as mf
from bench_port.run import run_cell
from bench_port.tests.conftest import small


def _state_unchanged(monkeypatch):
    """Refreshing the context between gangs returns it unchanged: the
    teardowns never reach the packed rows or the device."""
    from nhd_tpu_torch.solver.batch import BatchScheduler

    monkeypatch.setattr(BatchScheduler, "refresh_context",
                        lambda self, ctx, **kw: ctx)


def _half_left_out(monkeypatch):
    """Each schedule call places the first half of its gang and reports
    the rest unplaced."""
    from nhd_tpu_torch.solver.batch import BatchAssignment, BatchScheduler

    orig = BatchScheduler.schedule

    def half(self, nodes, items, **kw):
        k = len(items) // 2
        res, stats = orig(self, nodes, items[:k], **kw)
        return list(res) + [BatchAssignment(i.key, None) for i in items[k:]], stats

    monkeypatch.setattr(BatchScheduler, "schedule", half)


def _answer_altered(monkeypatch):
    """Where the answer is produced, one placed pod's first core moves to
    the other NUMA node."""
    from nhd_tpu_torch.solver.batch import BatchScheduler

    orig = BatchScheduler.schedule

    def altered(self, nodes, items, **kw):
        res, stats = orig(self, nodes, items, **kw)
        for r in res:
            if r.node is not None:
                ns, pod = r.key
                top = nodes[r.node].pod_info[(pod, ns)]
                core = top.proc_groups[0].proc_cores[0]
                core.core = (core.core + 32) % 64
                break
        return res, stats

    monkeypatch.setattr(BatchScheduler, "schedule", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["cap1k.backlog10k"])
def test_a_broken_run_is_not_correct(name, fault, manifest, cell_env, monkeypatch):
    cell = mf.cell(manifest, name)
    cfg, mix = small(mf.config(cell["config"]), mf.traffic(cell["traffic"]))
    cell_env(cfg)
    FAULTS[fault](monkeypatch)
    out = run_cell(manifest, cell, cfg, mix, 2 ** 34 + 3, 1.0, False, device="cpu")
    assert not out["correct"], out["checks"]
