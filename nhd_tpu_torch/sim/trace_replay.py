"""Record/replay journal driver on the port: replay journals, diff
decisions, and run the end-to-end demo gate, recording and replaying on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).

The port's counterpart of the reference's tools/trace_replay.py, inside
the package. Default mode replays one or more journal files through the
real scheduler/controller stack (sim/replay.py) and diffs the replayed
decisions against the recorded ones:

    python -m nhd_tpu_torch.sim.trace_replay run.journal.jsonl
    python -m nhd_tpu_torch.sim.trace_replay a.jsonl b.jsonl --speed 10 \\
        --drop-node node0 --json-out /tmp/diff.json

Exits non-zero when the replay diverges, so CI can gate on it.

``--demo`` is the self-contained proof loop: record a seeded chaos
churn storm, replay it (must NOT diverge), replay it again (must be
bit-identical), then replay with a dropped node and a flipped knob
(both MUST diverge, and the report must name the first divergent corr
and the drifted knob). Any unexpected outcome exits non-zero.

The golden journal of tests/fixtures/journal belongs to the reference's
tests and is not rewritten here. A CUDA request without a GPU exits
non-zero before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEMO_SEED = 1234
DEMO_NODES = 6
DEMO_STEPS = 20


def _record_churn(path: str, *, device) -> None:
    """Record the demo's seeded chaos churn storm, solved on *device*,
    into ``path``."""
    from nhd_tpu_torch.obs.journal import disable_journal, enable_journal
    from nhd_tpu_torch.sim.chaos import ChaosSim
    from nhd_tpu_torch.sim.faults import PROFILES

    enable_journal(path, identity="golden", seed=DEMO_SEED)
    try:
        sim = ChaosSim(
            seed=DEMO_SEED, n_nodes=DEMO_NODES, api_faults=PROFILES["churn"],
            device=device,
        )
        for _ in range(DEMO_STEPS):
            sim.step()
    finally:
        disable_journal()


def _summarize(result, label: str) -> None:
    print(
        f"trace-replay: {label}: {len(result.replayed)} replayed vs "
        f"{len(result.recorded)} recorded decisions, "
        f"{len(result.divergences)} divergence(s), "
        f"{len(result.knob_drift)} knob drift(s)"
    )
    fd = result.first_divergence
    if fd is not None:
        print(
            f"trace-replay:   first divergence: corr={fd.get('corr')} "
            f"pod={fd['ns']}/{fd['pod']} kind={fd['kind']} "
            f"recorded={fd.get('recorded')} replayed={fd.get('replayed')}"
        )
    for name, drift in sorted(result.knob_drift.items()):
        print(
            f"trace-replay:   knob drift: {name} recorded="
            f"{drift['recorded']!r} current={drift['current']!r}"
        )


def demo(device, workdir=None) -> int:
    """The four-act replay gate on *device*; see the module docstring.
    The journal is recorded under *workdir* (a fresh temporary
    directory when None) as ``churn.journal.jsonl``."""
    import tempfile

    from nhd_tpu_torch.sim.replay import _decision_sig, replay_journal

    workdir = workdir or tempfile.mkdtemp(prefix="nhd-replay-demo-")
    path = os.path.join(workdir, "churn.journal.jsonl")
    _record_churn(path, device=device)
    print(f"trace-replay: recorded {path}")

    r1 = replay_journal([path], device=device)
    _summarize(r1, "act 1 (faithful replay)")
    if r1.diverged or not r1.recorded:
        print("trace-replay: FAIL: faithful replay diverged (or recorded "
              "no decisions)")
        return 1

    r2 = replay_journal([path], device=device)
    sig = lambda r: [  # noqa: E731 (one-shot comparator)
        (d.get("ns"), d.get("pod"), _decision_sig(d)) for d in r.replayed
    ]
    if sig(r1) != sig(r2):
        print("trace-replay: FAIL: two replays of one journal differ "
              "(determinism broken)")
        return 1
    print(f"trace-replay: act 2: double replay bit-identical "
          f"({len(r2.replayed)} decisions)")

    r3 = replay_journal([path], drop_nodes=["node0"], device=device)
    _summarize(r3, "act 3 (negative control: node0 dropped)")
    if not r3.diverged or r3.first_divergence.get("corr") is None:
        print("trace-replay: FAIL: dropped node was not detected as a "
              "named divergence")
        return 1

    # knob-drift negative control: a replay under a different knob
    # environment must report the drift by name even when decisions
    # happen to agree. core/node.py read the busy window at import, so
    # the decisions are those of the imported window; the drift is read
    # from the environment, which is restored however the act ends
    knob, flipped = "NHD_MIN_BUSY_SECS", "31"
    prior = os.environ.get(knob)
    os.environ[knob] = flipped
    try:
        r4 = replay_journal([path], device=device)
    finally:
        if prior is None:
            del os.environ[knob]
        else:
            os.environ[knob] = prior
    _summarize(r4, f"act 4 (negative control: {knob}={flipped})")
    if knob not in r4.knob_drift:
        print(f"trace-replay: FAIL: flipped knob {knob} not reported "
              "as drift")
        return 1

    print("trace-replay: demo PASS")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="replay nhd_tpu_torch journals and diff decisions"
    )
    parser.add_argument("journals", nargs="*",
                        help="journal file(s); several are merged by "
                             "recorded timestamp")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="time compression for the replay clock")
    parser.add_argument("--drop-node", action="append", default=[],
                        metavar="NODE",
                        help="drop NODE from genesis (repeatable) — "
                             "perturbation probe")
    parser.add_argument("--json-out", default=None,
                        help="write the divergence report JSON here")
    parser.add_argument("--demo", action="store_true",
                        help="record + replay + perturb a seeded churn "
                             "storm; exit non-zero on any surprise")
    parser.add_argument("--device", default="cuda",
                        help="record and replay device (default cuda; cpu "
                             "runs the plain versions)")
    args = parser.parse_args(argv)

    from nhd_tpu_torch.device import resolve_for_tool

    device = resolve_for_tool(args.device, "trace-replay")
    if device is None:
        return 1
    if args.demo:
        return demo(device)
    if not args.journals:
        parser.error("no journal files given (or use --demo)")

    from nhd_tpu_torch.sim.replay import replay_journal

    try:
        result = replay_journal(
            args.journals, speed=args.speed, drop_nodes=args.drop_node,
            device=device,
        )
    except (OSError, ValueError) as exc:
        print(f"trace-replay: cannot replay: {exc}")
        return 2
    _summarize(result, "replay")
    if args.json_out:
        payload = result.report_payload()
        with open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"trace-replay: report → {args.json_out}")
    return 1 if result.diverged else 0


if __name__ == "__main__":
    sys.exit(main())
