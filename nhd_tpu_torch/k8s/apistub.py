"""In-process stub Kubernetes API server for contract-testing the real
HTTP path of KubeClusterBackend.

The reference's K8SMgr was hardened against a live API server (it even
codes around a kubernetes-client V1Binding deserialization quirk,
K8SMgr.py:468-492); a mocked client module can't catch payload or
serialization bugs. This stub speaks the actual REST endpoints kube.py
uses — list/read nodes and pods, ConfigMaps, strategic-merge pod
patches, pod bindings, events, pod creation, the TriadSet custom
resource, coordination.k8s.io Leases (with real resourceVersion
optimistic concurrency: a stale replace answers 409, and the
``fail_lease_puts`` hook forces conflicts for renewal-fault testing and
``fail_lease_gets`` fails reads for election/federation-liveness fault
testing),
and line-delimited watch streams — over a real HTTP socket,
records every request (method, path, content type, raw body bytes) for
byte-level assertions, and answers with faithful camelCase JSON shapes
(a binding POST returns a Status object, exactly the response that trips
the client quirk).

Watch behavior: each GET …?watch=true drains the currently queued events
as JSON lines and then closes the stream, so client reconnect loops are
exercised for real (reconnects are counted per path).

Test-facing surface: ``StubApiServer`` (start/stop, ``requests`` log,
``watch_connects``, seed helpers ``add_node``/``add_pod``/
``add_configmap``/``add_triadset``, ``queue_watch_event``) and the
``make_node``/``make_pod`` JSON builders.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse


def make_node(
    name: str,
    *,
    ready: bool = True,
    taint: bool = True,
    unschedulable: bool = False,
    labels: Optional[Dict[str, str]] = None,
    internal_ip: str = "10.0.0.1",
    hugepages_capacity: str = "64Gi",
    hugepages_allocatable: str = "60Gi",
) -> dict:
    """Node JSON the way an API server serves it (camelCase)."""
    taints = (
        [{"key": "sigproc.viasat.io/nhd_scheduler", "effect": "NoSchedule"}]
        if taint
        else []
    )
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels or {}},
        "spec": {"taints": taints, "unschedulable": unschedulable},
        "status": {
            "conditions": [
                {
                    "type": "Ready",
                    "reason": "KubeletReady",
                    "status": "True" if ready else "False",
                }
            ],
            "addresses": [
                {"type": "Hostname", "address": name},
                {"type": "InternalIP", "address": internal_ip},
            ],
            "capacity": {"hugepages-1Gi": hugepages_capacity},
            "allocatable": {"hugepages-1Gi": hugepages_allocatable},
        },
    }


def make_pod(
    name: str,
    namespace: str = "default",
    *,
    scheduler: str = "nhd-scheduler",
    node: Optional[str] = None,
    phase: str = "Pending",
    uid: str = "uid-1",
    annotations: Optional[Dict[str, str]] = None,
    configmap: Optional[str] = None,
    requests: Optional[Dict[str, str]] = None,
) -> dict:
    volumes = (
        [{"name": "cfg", "configMap": {"name": configmap}}] if configmap else []
    )
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": uid,
            "annotations": annotations or {},
        },
        "spec": {
            "schedulerName": scheduler,
            "nodeName": node,
            "volumes": volumes,
            "containers": [
                {"name": "main", "resources": {"requests": requests or {}}}
            ],
        },
        "status": {"phase": phase},
    }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "StubApiServer"

    # quiet the default stderr access log
    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    # ------------------------------------------------------------------

    def _reject_auth(self) -> bool:
        token = self.server.stub.token
        if token is None:
            return False
        if self.headers.get("Authorization") == f"Bearer {token}":
            return False
        self._send_json(401, _status(401, "Unauthorized"))
        return True

    def _send_json(self, code: int, obj: Any) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _record(self, body: bytes) -> None:
        stub = self.server.stub
        with stub.lock:
            stub.requests.append(
                (
                    self.command,
                    self.path,
                    self.headers.get("Content-Type", ""),
                    body,
                )
            )

    # ------------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        self._record(b"")
        if self._reject_auth():
            return
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        srv = self.server.stub
        if "watch=true" in (url.query or ""):
            return self._stream_watch(url.path)
        with srv.lock:
            if srv.fail_gets > 0:
                # transient-fault injection: the next N non-watch GETs
                # answer 5xx (exercises the retry policy over the wire).
                # Checked AFTER the watch dispatch so a concurrent watch
                # reconnect can't silently eat the injected budget
                srv.fail_gets -= 1
                return self._send_json(503, _status(503, "ServiceUnavailable"))
        with srv.lock:
            # /api/v1/nodes[/name]
            if parts[:3] == ["api", "v1", "nodes"]:
                if len(parts) == 3:
                    return self._send_json(
                        200, _list("NodeList", list(srv.nodes.values()))
                    )
                node = srv.nodes.get(parts[3])
                return self._send_json(
                    200 if node else 404, node or _status(404, "NotFound")
                )
            # /api/v1/pods
            if parts[:3] == ["api", "v1", "pods"]:
                return self._send_json(
                    200, _list("PodList", list(srv.pods.values()))
                )
            # /api/v1/namespaces/{ns}/...
            if parts[:3] == ["api", "v1", "namespaces"] and len(parts) >= 5:
                ns, kind = parts[3], parts[4]
                if kind == "pods" and len(parts) == 5:
                    pods = [
                        p
                        for (pns, _), p in srv.pods.items()
                        if pns == ns
                    ]
                    return self._send_json(200, _list("PodList", pods))
                if kind == "pods":
                    pod = srv.pods.get((ns, parts[5]))
                    return self._send_json(
                        200 if pod else 404, pod or _status(404, "NotFound")
                    )
                if kind == "configmaps":
                    cm = srv.configmaps.get((ns, parts[5]))
                    return self._send_json(
                        200 if cm else 404, cm or _status(404, "NotFound")
                    )
            # /apis/{group}/{version}/{plural}
            if parts[:1] == ["apis"] and len(parts) == 4:
                return self._send_json(
                    200,
                    {
                        "apiVersion": f"{parts[1]}/{parts[2]}",
                        "kind": "TriadSetList",
                        "items": list(srv.triadsets.values()),
                    },
                )
            # GET /apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}
            if (
                parts[:1] == ["apis"] and len(parts) == 7
                and parts[3] == "namespaces" and parts[5] == "leases"
            ):
                with srv.lock:
                    if srv.fail_lease_gets > 0:
                        srv.fail_lease_gets -= 1
                        # lease reads feed the election AND federation
                        # liveness (lease_live): a 500 here exercises the
                        # unverifiable-peer / unverifiable-shard paths
                        return self._send_json(
                            500, _status(500, "InternalError")
                        )
                lease = srv.leases.get((parts[4], parts[6]))
                return self._send_json(
                    200 if lease else 404, lease or _status(404, "NotFound")
                )
        self._send_json(404, _status(404, "NotFound"))

    def _stream_watch(self, path: str) -> None:
        srv = self.server.stub
        with srv.lock:
            srv.watch_connects[path] = srv.watch_connects.get(path, 0) + 1
            pending = srv.watch_events.get(path, [])
            srv.watch_events[path] = []
            hang = srv.watch_hang
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in pending:
                # raw entries (queue_watch_raw) go on the wire verbatim —
                # malformed-line fault injection
                line = (
                    ev if isinstance(ev, bytes)
                    else json.dumps(ev).encode() + b"\n"
                )
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            if hang:
                # dead-socket simulation: stream stays open, silent — the
                # client's finite read timeout must end it (in slices so
                # stop() doesn't wait the full hang out)
                deadline = time.monotonic() + hang
                while time.monotonic() < deadline and not srv.closing:
                    time.sleep(0.05)
            # terminal chunk: server closes the stream, client reconnects
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass  # client gave up mid-stream (e.g. its read timed out)
        self.close_connection = True

    def do_PATCH(self) -> None:  # noqa: N802
        body = self._body()
        self._record(body)
        if self._reject_auth():
            return
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        srv = self.server.stub
        patch = json.loads(body or b"{}")
        with srv.lock:
            # strategic-merge patch on a pod: merge metadata.annotations
            if parts[:3] == ["api", "v1", "namespaces"] and len(parts) == 6 \
                    and parts[4] == "pods":
                pod = srv.pods.get((parts[3], parts[5]))
                if pod is None:
                    return self._send_json(404, _status(404, "NotFound"))
                if srv.fail_patches:
                    return self._send_json(
                        500, _status(500, "InternalError")
                    )
                annots = (patch.get("metadata") or {}).get("annotations") or {}
                pod["metadata"].setdefault("annotations", {}).update(annots)
                return self._send_json(200, pod)
            # merge patch on a TriadSet status subresource
            if parts[:1] == ["apis"] and len(parts) == 8 and parts[7] == "status":
                ts = srv.triadsets.get((parts[4], parts[6]))
                if ts is None:
                    return self._send_json(404, _status(404, "NotFound"))
                ts.setdefault("status", {}).update(patch.get("status") or {})
                return self._send_json(200, ts)
        self._send_json(404, _status(404, "NotFound"))

    def do_PUT(self) -> None:  # noqa: N802
        """Lease replace with the API server's optimistic concurrency:
        a body whose metadata.resourceVersion is stale answers 409, and
        the ``fail_lease_puts`` fault hook forces the next N replaces to
        409 regardless — the conflict-on-renew injection
        (tests/test_kube_faults.py)."""
        body = self._body()
        self._record(body)
        if self._reject_auth():
            return
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        srv = self.server.stub
        payload = json.loads(body or b"{}")
        with srv.lock:
            if not (
                parts[:1] == ["apis"] and len(parts) == 7
                and parts[3] == "namespaces" and parts[5] == "leases"
            ):
                return self._send_json(404, _status(404, "NotFound"))
            key = (parts[4], parts[6])
            lease = srv.leases.get(key)
            if lease is None:
                return self._send_json(404, _status(404, "NotFound"))
            if srv.fail_lease_puts > 0:
                srv.fail_lease_puts -= 1
                return self._send_json(409, _status(409, "Conflict"))
            sent_rv = (payload.get("metadata") or {}).get("resourceVersion")
            cur_rv = lease["metadata"].get("resourceVersion")
            if sent_rv != cur_rv:
                return self._send_json(409, _status(409, "Conflict"))
            payload.setdefault("metadata", {})["resourceVersion"] = str(
                int(cur_rv) + 1
            )
            srv.leases[key] = payload
            return self._send_json(200, payload)

    def do_POST(self) -> None:  # noqa: N802
        body = self._body()
        self._record(body)
        if self._reject_auth():
            return
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        srv = self.server.stub
        payload = json.loads(body or b"{}")
        with srv.lock:
            # POST /apis/coordination.k8s.io/v1/namespaces/{ns}/leases
            if (
                parts[:1] == ["apis"] and len(parts) == 6
                and parts[3] == "namespaces" and parts[5] == "leases"
            ):
                name = (payload.get("metadata") or {}).get("name")
                if not name:
                    return self._send_json(400, _status(400, "BadRequest"))
                key = (parts[4], name)
                if key in srv.leases:
                    return self._send_json(409, _status(409, "Conflict"))
                payload["metadata"]["resourceVersion"] = "1"
                payload["metadata"].setdefault("namespace", parts[4])
                srv.leases[key] = payload
                return self._send_json(201, payload)
            if parts[:3] != ["api", "v1", "namespaces"]:
                return self._send_json(404, _status(404, "NotFound"))
            ns = parts[3]
            # POST …/pods/{name}/binding
            if len(parts) == 7 and parts[4] == "pods" and parts[6] == "binding":
                pod = srv.pods.get((ns, parts[5]))
                if pod is None:
                    return self._send_json(404, _status(404, "NotFound"))
                if srv.fail_bindings:
                    return self._send_json(409, _status(409, "Conflict"))
                srv.bindings.append((ns, parts[5], payload))
                pod["spec"]["nodeName"] = (payload.get("target") or {}).get(
                    "name"
                )
                # a real API server answers a binding create with Status —
                # the response that trips the client's V1Binding quirk
                return self._send_json(201, _status(201, "Created"))
            # POST …/events
            if len(parts) == 5 and parts[4] == "events":
                srv.events.append(payload)
                return self._send_json(201, payload)
            # POST …/pods (TriadSet pod creation)
            if len(parts) == 5 and parts[4] == "pods":
                name = (payload.get("metadata") or {}).get("name")
                if not name:
                    return self._send_json(400, _status(400, "BadRequest"))
                payload["metadata"].setdefault("namespace", ns)
                payload.setdefault("status", {"phase": "Pending"})
                srv.pods[(ns, name)] = payload
                return self._send_json(201, payload)
        self._send_json(404, _status(404, "NotFound"))


def _status(code: int, reason: str) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Status",
        "status": "Failure" if code >= 400 else "Success",
        "code": code,
        "reason": reason,
    }


def _list(kind: str, items: List[dict]) -> dict:
    return {"apiVersion": "v1", "kind": kind, "items": items}


class StubApiServer:
    """Threaded stub API server bound to 127.0.0.1:<ephemeral>."""

    def __init__(self, token: Optional[str] = None):
        self.nodes: Dict[str, dict] = {}
        self.pods: Dict[Tuple[str, str], dict] = {}
        self.configmaps: Dict[Tuple[str, str], dict] = {}
        self.triadsets: Dict[Tuple[str, str], dict] = {}
        self.events: List[dict] = []
        self.bindings: List[Tuple[str, str, dict]] = []
        self.requests: List[Tuple[str, str, str, bytes]] = []
        self.watch_events: Dict[str, List[dict]] = {}
        self.watch_connects: Dict[str, int] = {}
        self.leases: Dict[Tuple[str, str], dict] = {}
        self.fail_patches = False
        self.fail_bindings = False
        self.fail_gets = 0      # next N GETs answer 503 (retry testing)
        self.fail_lease_puts = 0  # next N lease replaces answer 409
        #                          (conflict-on-renew fault injection)
        self.fail_lease_gets = 0  # next N lease GETs answer 500 (election
        #                          + federation-liveness fault injection)
        self.watch_hang = 0.0   # seconds a watch stream stays open, silent
        self.closing = False
        self.token = token
        self.lock = threading.RLock()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        # the handler reads ALL state through this one reference, so
        # post-construction mutation of any stub attribute just works
        self._httpd.stub = self
        # short poll so stop() returns promptly (the default 0.5 s poll
        # costs every stub-based test its teardown)
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            daemon=True,
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "StubApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.closing = True  # unblocks any hanging watch handler
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # ---- seed helpers ----

    def add_node(self, name: str, **kw: Any) -> dict:
        node = make_node(name, **kw)
        with self.lock:
            self.nodes[name] = node
        return node

    def add_pod(self, name: str, namespace: str = "default", **kw: Any) -> dict:
        pod = make_pod(name, namespace, **kw)
        with self.lock:
            self.pods[(namespace, name)] = pod
        return pod

    def add_configmap(
        self, name: str, namespace: str, data: Dict[str, str]
    ) -> None:
        with self.lock:
            self.configmaps[(namespace, name)] = {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": namespace},
                "data": data,
            }

    def add_triadset(
        self,
        name: str,
        namespace: str,
        *,
        replicas: int,
        service_name: Optional[str] = None,
        template: Optional[dict] = None,
    ) -> None:
        with self.lock:
            self.triadsets[(namespace, name)] = {
                "apiVersion": "sigproc.viasat.io/v1",
                "kind": "TriadSet",
                "metadata": {"name": name, "namespace": namespace},
                "spec": {
                    "replicas": replicas,
                    "serviceName": service_name or name,
                    "template": template or {},
                },
            }

    def queue_watch_event(self, path: str, ev_type: str, obj: dict) -> None:
        """Queue one watch event; the next GET <path>?watch=true drains it."""
        with self.lock:
            self.watch_events.setdefault(path, []).append(
                {"type": ev_type, "object": obj}
            )

    def queue_watch_raw(self, path: str, raw: bytes) -> None:
        """Queue raw bytes as one watch line — malformed-line injection
        (a garbled chunk as the client would see it after a mid-cut)."""
        with self.lock:
            self.watch_events.setdefault(path, []).append(raw)
