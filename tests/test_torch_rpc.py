"""The port's stats and metrics planes (nhd_tpu_torch/rpc/, obs/fleet.py)
against the JAX package's.

The six cases of tests/test_rpc.py run on the port's stack — fake
cluster, the port's ``Scheduler(device="cpu")``, its gRPC server and
client over localhost — beside the same stack of the JAX package, and
every reply must equal the JAX stack's reply for the same scenario (the
two packages share one ``nhd_stats.proto`` descriptor, so their messages
compare directly). Then the port of
tests/test_guard.py::test_guard_counters_on_metrics_and_fleet_payload,
and the Prometheus exposition (``render_metrics``) after one fake-backend
run through each daemon, each in a fresh interpreter (the registries are
process-global): equal
line for line once the samples that are wall-clock times are masked (the
``*_seconds*`` families' values and bucket counts; their ``_count``
stays). Both run in the port's posture, set on the JAX side by its own
knobs: ``NHD_MESH=off`` (the port solves on one device until multi-GPU
is ported, while the JAX package on this suite's eight virtual CPU
devices would shard its solve: the ``nhd_mesh_*`` families and the mesh
suffix of the ``nhd_jit_shape_uses_total`` shape key) and
``NHD_TPU_DEVICE_STATE=1`` (the port keeps resident state on every
device, the JAX package only on an accelerator by default:
``nhd_device_state_rows_uploaded_total``). No other family differs.

Tolerance: exact equality — replies, counters and exposition lines are
integers and strings.
"""

from __future__ import annotations

import importlib
import json
import queue
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

grpc = pytest.importorskip("grpc")

from tests.conftest import subprocess_env  # noqa: E402
from tests.test_torch_daemon import _pkg, make_backend, make_scheduler, pod_cfg  # noqa: E402

PACKAGES = ("nhd_tpu", "nhd_tpu_torch")
ROOT = Path(__file__).resolve().parent.parent


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


class _Stack:
    """Fake cluster → scheduler → gRPC server → client, for one package."""

    def __init__(self, root):
        self.pkg = _pkg(root)
        self.pb = _mod(root, "rpc.nhd_stats_pb2")
        server_mod = _mod(root, "rpc.server")
        self.backend = make_backend(self.pkg, n_nodes=2)
        self.backend.create_pod("triad-0", cfg_text=pod_cfg(self.pkg))
        self.sched = make_scheduler(self.pkg, self.backend)
        self.sched.check_pending_pods()
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._serve, daemon=True)
        self._pump.start()
        self.server = server_mod.StatsRpcServer(self.sched.rpcq, port=0)
        self.server.start()
        self.client = server_mod.NHDControlClient(
            f"localhost:{self.server.bound_port}")

    def _serve(self):
        while not self._stop.is_set():
            try:
                item = self.sched.rpcq.get(timeout=0.05)
            except queue.Empty:
                continue
            self.sched._parse_rpc_req(*item)

    def close(self):
        self.client.close()
        self.server.stop()
        self._stop.set()


@pytest.fixture
def stacks():
    both = {root: _Stack(root) for root in PACKAGES}
    yield both["nhd_tpu_torch"], both["nhd_tpu"]
    for s in both.values():
        s.close()


def test_basic_node_stats(stacks):
    port, ref = stacks
    reply = port.client.get_basic_node_stats()
    assert reply.status == port.pb.NHD_STATUS_OK
    assert len(reply.info) == 2
    n0 = {i.name: i for i in reply.info}["node0"]
    assert (n0.total_pods, n0.used_gpus, n0.used_hugepages, n0.active) == (1, 1, 4, True)
    assert len(n0.nic_info) == 4
    assert sum(i.used_rx for i in n0.nic_info) == 10
    assert reply == ref.client.get_basic_node_stats()


def test_scheduler_stats(stacks):
    port, ref = stacks
    reply = port.client.get_scheduler_stats()
    assert reply.status == port.pb.NHD_STATUS_OK
    assert reply.failed_schedule_count == 0
    assert reply == ref.client.get_scheduler_stats()


def _without_trace(reply, trace_key):
    """A PodStats reply with each pod's trace annotation (a wall-clock
    record) dropped."""
    for info in reply.info:
        info.annotations.pop(trace_key, None)
    return reply


def test_pod_stats(stacks):
    port, ref = stacks
    reply = port.client.get_pod_stats()
    assert reply.status == port.pb.NHD_STATUS_OK
    assert len(reply.info) == 1
    info = reply.info[0]
    assert (info.name, info.node, info.hugepages) == ("triad-0", "node0", 4)
    assert len(info.gpus) == 1
    assert all(c >= 0 for c in info.proc_cores)
    assert any("nhd_config" in k for k in info.annotations)
    trace = _mod("nhd_tpu_torch", "k8s.interface").TRACE_ANNOTATION
    assert _without_trace(reply, trace) == _without_trace(
        ref.client.get_pod_stats(), trace)


def test_detailed_node_stats(stacks):
    port, ref = stacks
    for node, pods in (("node0", 1), ("node1", 0)):
        reply = port.client.get_detailed_node_stats(node)
        assert reply.status == port.pb.NHD_STATUS_OK
        assert len(reply.podinfo) == pods
        assert reply == ref.client.get_detailed_node_stats(node)


def test_recent_decisions_roundtrip(stacks):
    """The flight-recorder decisions view over the gRPC plane, each
    package's client against its own recorder."""
    replies = []
    for stack in stacks:
        obs = _mod(stack.pkg.root, "obs")
        client = stack.client
        assert client.get_recent_decisions() == {"enabled": False, "decisions": []}
        rec = obs.enable(capacity=64)
        try:
            for pod, corr, outcome, node in (
                ("p0", "c-grpc", "scheduled", "node0"),
                ("p1", "c-grpc2", "unschedulable", None),
            ):
                rec.record_decision({"pod": pod, "ns": "default", "corr": corr,
                                     "outcome": outcome, "node": node,
                                     "phases": {}})
            out = client.get_recent_decisions(n=1)
            assert out["enabled"] is True
            assert [d["pod"] for d in out["decisions"]] == ["p1"]
            raw = client._calls["GetRecentDecisions"](b'{"n": null}')
            assert len(json.loads(raw.decode())["decisions"]) == 2
            replies.append(out)
        finally:
            obs.disable()
    assert replies[0] == replies[1]


@pytest.mark.parametrize("root", PACKAGES)
def test_scheduler_unresponsive_returns_err(root, monkeypatch):
    """A dead scheduler thread yields NHD_STATUS_ERR, not a hang, on
    both packages' servers."""
    monkeypatch.setattr(_mod(root, "rpc"), "RPC_TIMEOUT_SEC", 0.2)
    server_mod, pb = _mod(root, "rpc.server"), _mod(root, "rpc.nhd_stats_pb2")
    dead = server_mod.StatsRpcServer(queue.Queue(), port=0)
    dead.start()
    try:
        c = server_mod.NHDControlClient(f"localhost:{dead.bound_port}")
        grpc.channel_ready_future(c.channel).result(timeout=5)
        assert c.get_basic_node_stats().status == pb.NHD_STATUS_ERR
        assert c.get_scheduler_stats().status == pb.NHD_STATUS_ERR
        c.close()
    finally:
        dead.stop()


def test_both_packages_share_the_proto_messages():
    a = _mod("nhd_tpu", "rpc.nhd_stats_pb2")
    b = _mod("nhd_tpu_torch", "rpc.nhd_stats_pb2")
    assert a.Empty is b.Empty and a.DESCRIPTOR is b.DESCRIPTOR


def test_guard_counters_on_metrics_and_fleet_payload():
    from nhd_tpu_torch.obs.fleet import build_fleet_payload
    from nhd_tpu_torch.rpc.metrics import render_metrics

    out = render_metrics([], 0)
    for name in (
        "nhd_guard_rung", "nhd_guard_faults_total",
        "nhd_guard_audits_total", "nhd_guard_repairs_total",
        "nhd_guard_quarantined_shapes", "nhd_aot_export_failures_total",
    ):
        assert name in out
    payload = build_fleet_payload(
        [], counters={"guard_rung": 1, "guard_faults_total": 3,
                      "guard_repairs_total": 2},
    )
    g = payload["device_state"]["guard"]
    assert (g["rung"], g["faults_total"], g["repairs_total"]) == (1, 3, 2)


# ---------------------------------------------------------------------------
# the /metrics exposition after the same run through both daemons
# ---------------------------------------------------------------------------

#: a sample whose value is a wall-clock time (or a count of times under a
#: bucket edge): every ``*_seconds*`` family's samples except ``_count``
_TIMED = re.compile(r"^nhd_\w*seconds\w*(?<!_count)(\{[^}]*\})? ")


#: one fake-backend run through a package's daemon, then its exposition,
#: in a fresh interpreter: the metrics registries are process-global, and
#: whatever earlier tests in this process counted must not show
_EXPOSITION = """
import queue, sys
root = sys.argv[1]
if root == "nhd_tpu":
    import jax
    from nhd_tpu.utils import force_cpu_backend
    force_cpu_backend(jax)
from importlib import import_module
from tests.test_torch_daemon import _pkg, make_backend, make_scheduler, pod_cfg
pkg = _pkg(root)
backend = make_backend(pkg, n_nodes=3)
for i in range(5):
    backend.create_pod(f"triad-{i}", cfg_text=pod_cfg(pkg))
backend.create_pod("big-0", cfg_text=pod_cfg(pkg, hugepages_gb=500))
sched = make_scheduler(pkg, backend)
sched.check_pending_pods()
replies = []
for kind in ("NODE_INFO", "SCHEDULER_INFO", "PERF_INFO"):
    q = queue.Queue()
    sched._parse_rpc_req(getattr(pkg.RpcMsgType, kind), q)
    replies.append(q.get_nowait())
sys.stdout.write(import_module(root + ".rpc.metrics").render_metrics(*replies))
"""


def _exposition(root):
    proc = subprocess.run(
        [sys.executable, "-c", _EXPOSITION, root], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=subprocess_env(JAX_PLATFORMS="cpu", NHD_MESH="off",
                           NHD_TPU_DEVICE_STATE="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [line.rsplit(" ", 1)[0] + " <time>" if _TIMED.match(line) else line
            for line in proc.stdout.splitlines()]


def test_metrics_exposition_equals_the_reference():
    want = _exposition("nhd_tpu")
    got = _exposition("nhd_tpu_torch")
    assert any(line.startswith("nhd_scheduled_total 5") for line in got)
    assert any(line.startswith("nhd_failed_schedule_total 1") for line in got)
    assert "nhd_bind_latency_seconds_count 5" in got
    assert got == want
