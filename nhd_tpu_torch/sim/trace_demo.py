"""Flight-recorder demo and schema gate on the port: run the fake-backend
control plane with tracing on, dump the Chrome trace, and validate it,
solving on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).

The port's counterpart of the reference's tools/trace_demo.py, inside
the package. Pods arrive through the watch queue, the controller
translates, the scheduler batches and binds, with the recorder enabled;
then the demo

1. writes the Chrome trace JSON to --out (default artifacts/trace);
2. validates it against the schema the tests enforce
   (``obs.validate_chrome_trace``);
3. checks the ring dropped no span (a full ring fails the gate: a
   thinned trace would pass the checks below on what is left);
4. checks every bound pod's correlation ID carries the full
   queue_wait/solve/select/assign/bind pipeline;
5. prints the recent-decisions view.

    python -m nhd_tpu_torch.sim.trace_demo --device cpu

Exits non-zero on any failed check, and before any work when the device
is refused (a CUDA request without a GPU).
"""

from __future__ import annotations

import argparse
import json
import sys

#: the span names every bound pod's correlation ID carries
PIPELINE = frozenset({"queue_wait", "solve", "select", "assign", "bind"})
#: the least ring a run of the default width needs (the reference's)
MIN_CAPACITY = 16384
#: spans a pod leaves in the ring, at most on the watch path: watch
#: receipt, queue wait, solve/select/assign, bind, and the batch, round
#: and schedule spans of its one-pod batch (9), with one to spare; a pod
#: a scan batch retries adds three a retry, its batch-level spans are
#: shared
SPANS_PER_POD = 10


def ring_capacity(n_pods: int) -> int:
    """A span ring for *n_pods* pods: ``SPANS_PER_POD`` a pod, rounded up
    to a power of two, never below ``MIN_CAPACITY`` (131,072 at cfg4's
    10,000 pods)."""
    want = max(MIN_CAPACITY, SPANS_PER_POD * n_pods)
    return 1 << (want - 1).bit_length()


def demo(*, pods: int, nodes: int, device, out: str, capacity: int):
    """One drive with the recorder on; returns (exit code, recorder,
    backend). The recorder stays installed for the caller to read;
    ``main`` removes it."""
    import nhd_tpu_torch.obs as obs
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.scheduler.controller import Controller
    from nhd_tpu_torch.scheduler.core import Scheduler
    from nhd_tpu_torch.scheduler.events import WatchQueue
    from nhd_tpu_torch.sim import (
        SynthNodeSpec,
        make_node_labels,
        make_triad_config,
    )

    rec = obs.enable(capacity=capacity)

    backend = FakeClusterBackend()
    for i in range(nodes):
        spec = SynthNodeSpec(name=f"demo-node{i}")
        backend.add_node(spec.name, make_node_labels(spec),
                         hugepages_gb=spec.hugepages_gb)
    sched = Scheduler(backend, WatchQueue(), respect_busy=False,
                      device=device)
    sched.build_initial_node_list()
    controller = Controller(backend, sched.nqueue)

    for i in range(pods):
        backend.create_pod(
            f"demo-{i}",
            cfg_text=make_triad_config(gpus_per_group=i % 2, cpu_workers=2),
        )
        controller.run_once()
        while not sched.nqueue.empty():
            sched.run_once()

    bound = sum(1 for p in backend.pods.values() if p.node)
    print(f"trace-demo: {bound}/{pods} pods bound across {nodes} nodes")

    trace = obs.chrome_trace(rec)
    errors = obs.validate_chrome_trace(trace)
    if errors:
        print("trace-demo: SCHEMA INVALID:")
        for e in errors[:10]:
            print(f"  {e}")
        return 1, rec, backend
    path = obs.dump_chrome_trace(rec, out, stem="trace_demo")
    print(f"trace-demo: schema OK, {len(trace['traceEvents'])} events "
          f"→ {path}")

    if rec.dropped():
        print(f"trace-demo: FAIL — the ring (capacity {capacity}) dropped "
              f"{rec.dropped()} span(s)")
        return 1, rec, backend

    by_corr: dict = {}
    for s in rec.spans():
        by_corr.setdefault(s.corr, set()).add(s.name)
    complete = sum(1 for names in by_corr.values() if PIPELINE <= names)
    print(f"trace-demo: {complete} correlation id(s) carry the full "
          f"{'/'.join(sorted(PIPELINE))} pipeline")
    if complete < bound:
        print(f"trace-demo: FAIL — expected >= {bound}")
        return 1, rec, backend

    print("trace-demo: recent decisions:")
    for d in rec.recent_decisions(5):
        phases = {k: f"{v * 1e3:.2f}ms" for k, v in d["phases"].items()}
        print(f"  {d['ns']}/{d['pod']} corr={d['corr']} "
              f"{d['outcome']} node={d['node']} {json.dumps(phases)}")
    return 0, rec, backend


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="nhd_tpu_torch trace demo")
    parser.add_argument("--out", default="artifacts/trace",
                        help="directory for the dumped trace JSON")
    parser.add_argument("--pods", type=int, default=6)
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="solve device (default cuda; cpu runs the "
                             "plain versions)")
    args = parser.parse_args(argv)

    from nhd_tpu_torch.device import resolve_for_tool

    device = resolve_for_tool(args.device, "trace-demo")
    if device is None:
        return 1

    import nhd_tpu_torch.obs as obs

    try:
        code, _rec, _backend = demo(
            pods=args.pods, nodes=args.nodes, device=device, out=args.out,
            capacity=ring_capacity(args.pods),
        )
    finally:
        obs.disable()
    return code


if __name__ == "__main__":
    sys.exit(main())
