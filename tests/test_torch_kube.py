"""The port's real Kubernetes backend (nhd_tpu_torch/k8s/{kube,restclient,
apistub}.py) against the JAX package's.

Every case of tests/test_kube.py (a fake ``kubernetes`` module) and of
tests/test_kube_http.py (the in-process stub API server over real HTTP)
runs on the port: each file is read with ``nhd_tpu`` as
``nhd_tpu_torch`` in its module paths and executed as a module of its
own, its fixtures are registered here, and one parametrised test calls
each case with them. A wire-parity test then drives one scenario (a few
nodes, pods of workload_mix's three Triad shapes, one delete and one
more create) through the JAX daemon and the port's daemon
(``device="cpu"``), each against its own stub, and holds every request
the two daemons made to be the same request: method, path, content type
and JSON body, with time stamps, uids and the trace annotation's
wall-clock record masked.

Tolerance: exact equality — the compared values are requests and
decisions (strings and integers).
"""

from __future__ import annotations

import importlib
import inspect
import json
import queue
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent


def _port_of(name: str) -> types.ModuleType:
    """tests/<name> with its module paths moved from nhd_tpu to the port."""
    path = TESTS / name
    src = path.read_text()
    ported = re.sub(r"\bnhd_tpu\.", "nhd_tpu_torch.", src)
    assert ported != src and not re.search(r"\bnhd_tpu\.", ported)
    mod = types.ModuleType(f"tests.port_of_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(ported, str(path), "exec"), mod.__dict__)
    return mod


SUITES = {"kube": _port_of("test_kube.py"), "http": _port_of("test_kube_http.py")}
# the suites' fixtures, under their own names, for the cases below
backend = SUITES["kube"].backend
stub = SUITES["http"].stub

CASES = [(suite, name) for suite, mod in SUITES.items()
         for name in sorted(vars(mod)) if name.startswith("test_")]


@pytest.mark.parametrize("suite,case", CASES, ids=[f"{s}-{c[5:]}" for s, c in CASES])
def test_reference_case_on_the_port(suite, case, request):
    fn = getattr(SUITES[suite], case)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_every_reference_case_is_ported():
    counts = {s: sum(1 for t, _ in CASES if t == s) for s in SUITES}
    assert counts == {"kube": 15, "http": 15}


# ---------------------------------------------------------------------------
# wire parity: the same scenario through both daemons, request by request
# ---------------------------------------------------------------------------

_MASKED = "<masked>"


def _mask(obj, trace_key):
    """A request body with its wall-clock and identity fields masked."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("firstTimestamp", "lastTimestamp", "eventTime", "uid"):
                out[k] = _MASKED
            elif k == trace_key:
                out[k] = _MASKED
            else:
                out[k] = _mask(v, trace_key)
        return out
    if isinstance(obj, list):
        return [_mask(v, trace_key) for v in obj]
    return obj


def _pod_of(request):
    _m, path, _ctype, body = request
    hit = re.search(r"/pods/([^/]+)", path)
    return hit.group(1) if hit else body.get("involvedObject", {}).get("name", "")


def _wire_run(root, monkeypatch):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    apistub, iface, kube = mod("k8s.apistub"), mod("k8s.interface"), mod("k8s.kube")
    sim, core, events = mod("sim"), mod("scheduler.core"), mod("scheduler.events")
    from nhd_tpu_torch.sim import pending

    srv = apistub.StubApiServer().start()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(srv.port))
    monkeypatch.setenv("KUBERNETES_SERVICE_SCHEME", "http")
    monkeypatch.setenv("NHD_K8S_TOKEN_FILE", "/nonexistent-token")
    try:
        for i in range(3):
            spec = sim.SynthNodeSpec(name=f"node{i}")
            srv.add_node(spec.name, labels=sim.make_node_labels(spec),
                         internal_ip=f"10.0.0.{i + 1}")
        cfgs = pending.pod_configs(sim.make_triad_config)

        def create(i):
            name = f"pod-{i}"
            srv.add_configmap(f"{name}-cfg", "default",
                              {"triad.cfg": cfgs[i % len(cfgs)]})
            srv.add_pod(name, uid=f"uid-{i}", configmap=f"{name}-cfg",
                        annotations={iface.CFG_TYPE_ANNOTATION: "triad"})

        for i in range(6):
            create(i)
        backend = kube.KubeClusterBackend(start_watches=False)
        kw = {"device": "cpu"} if root == "nhd_tpu_torch" else {}
        sched = core.Scheduler(backend, events.WatchQueue(), queue.Queue(),
                               respect_busy=False, **kw)
        sched.build_initial_node_list()
        sched.load_deployed_configs()
        sched.check_pending_pods()
        # the real backend commits on a pipeline thread: let it finish
        # before the API server loses a pod
        sched._drain_commits(block=True)
        # one delete, as the controller hands it over, then one more pod
        gone = srv.pods.pop(("default", "pod-0"))
        sched.handle_watch_item(events.WatchItem(
            events.WatchType.TRIAD_POD_DELETE,
            pod={"ns": "default", "name": "pod-0",
                 "node": gone["spec"]["nodeName"],
                 "cfg": gone["metadata"]["annotations"].get(iface.CFG_ANNOTATION)},
        ))
        create(6)
        sched.check_pending_pods()
        sched._drain_commits(block=True)
        writes = [
            (m, p, ctype, _mask(json.loads(body), iface.TRACE_ANNOTATION))
            for m, p, ctype, body in srv.requests if m != "GET"
        ]
        # the loop thread's events and the commit thread's writes
        # interleave by timing: compare each pod's requests in order
        writes.sort(key=_pod_of)
        placed = {k: v["spec"]["nodeName"] for k, v in sorted(srv.pods.items())}
        return writes, placed
    finally:
        srv.stop()


def test_wire_bodies_equal_the_reference_daemon(monkeypatch):
    monkeypatch.delitem(sys.modules, "kubernetes", raising=False)
    blocker = SUITES["http"]._BlockKubernetesImport()
    sys.meta_path.insert(0, blocker)
    try:
        want, want_placed = _wire_run("nhd_tpu", monkeypatch)
        got, got_placed = _wire_run("nhd_tpu_torch", monkeypatch)
    finally:
        sys.meta_path.remove(blocker)
    assert got_placed == want_placed
    assert sum(1 for p in want_placed.values() if p) >= 4
    kinds = {(m, p.rsplit("/", 1)[-1]) for m, p, _, _ in want}
    assert {("POST", "binding"), ("POST", "events")} <= kinds
    assert any(m == "PATCH" for m, _, _, _ in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
