"""Minimal kubernetes-client-compatible REST client over real HTTP.

The reference talks to the API server through the `kubernetes` package
(K8SMgr.py:9,44-48). That package isn't a baked-in dependency here, so —
exactly like config/libconfig.py replaces the libconf dependency — this
module implements the *subset of the kubernetes-client surface that
k8s/kube.py actually uses*, speaking genuine HTTP+JSON to an API server:

* ``client``: CoreV1Api / CustomObjectsApi, the request models
  (V1Binding, V1ObjectMeta, V1ObjectReference, CoreV1Event,
  V1EventSource), and ``client.exceptions.ApiException``;
* ``config``: load_incluster_config / load_kube_config;
* ``watch``: Watch with a reconnectable ``stream()``.

k8s/kube.py prefers the real ``kubernetes`` package when importable and
falls back to this module otherwise, so the backend works (and is
contract-tested over real HTTP, tests/test_kube_http.py) in hermetic
environments.

Wire-format notes (all mirroring the real client):

* response JSON is exposed as objects whose snake_case attributes map to
  camelCase JSON fields (``pod.spec.scheduler_name`` ⇒
  ``spec.schedulerName``), with dict-style access for map-valued fields
  (labels/annotations/capacity/data);
* pod patches are ``application/strategic-merge-patch+json``, custom
  object status patches ``application/merge-patch+json``
  (the real client's defaults for these calls);
* POST …/binding deliberately reproduces the kubernetes-client quirk the
  reference codes around (K8SMgr.py:487-491): the API server answers a
  binding create with a Status object, the client tries to deserialize
  it into the request model and raises ValueError — callers must treat
  ValueError after a 2xx as success, which k8s/kube.py does.
"""

from __future__ import annotations

import datetime as _dt
import http.client as _httplib
import json as _json
import logging as _logging
import os
import re
import ssl
import types
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, Optional

from nhd_tpu_torch.k8s.retry import API_COUNTERS

_logger = _logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# exceptions
# ---------------------------------------------------------------------------


class ApiException(Exception):
    """Mirror of kubernetes.client.exceptions.ApiException."""

    def __init__(self, status: int = 0, reason: str = "", body: str = "",
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(f"({status}) Reason: {reason}")
        self.status = status
        self.reason = reason
        self.body = body
        # response headers (Retry-After drives the retry policy's backoff
        # floor, k8s/retry.py)
        self.headers = dict(headers) if headers else {}


class ConfigException(Exception):
    """Mirror of kubernetes.config.ConfigException."""


# ---------------------------------------------------------------------------
# response objects: snake_case attributes over camelCase JSON
# ---------------------------------------------------------------------------

_SNAKE_RE = re.compile(r"_([a-z])")


def _snake_to_camel(name: str) -> str:
    return _SNAKE_RE.sub(lambda m: m.group(1).upper(), name)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return K8sObj(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


class K8sObj:
    """JSON response wrapper.

    Attribute access converts snake_case to camelCase and wraps nested
    structures (``obj.spec.node_name``); mapping access (get/keys/values/
    iteration/``dict()``) returns *raw* values, which is what callers do
    with labels/annotations/capacity/ConfigMap data. ``items`` is a JSON
    field (list responses), not the dict method, so no ``items()`` method
    is defined.
    """

    __slots__ = ("_data",)

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    # --- attribute access (model-object style) ---

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        for key in (_snake_to_camel(name), name):
            if key in data:
                return _wrap(data[key])
        return None

    # --- mapping access (dict-valued fields) ---

    def __getitem__(self, key: str) -> Any:
        return object.__getattribute__(self, "_data")[key]

    def get(self, key: str, default: Any = None) -> Any:
        return object.__getattribute__(self, "_data").get(key, default)

    def keys(self):
        return object.__getattribute__(self, "_data").keys()

    def values(self):
        return object.__getattribute__(self, "_data").values()

    def __iter__(self):
        return iter(object.__getattribute__(self, "_data"))

    def __contains__(self, key: str) -> bool:
        return key in object.__getattribute__(self, "_data")

    def __len__(self) -> int:
        return len(object.__getattribute__(self, "_data"))

    def __bool__(self) -> bool:
        return bool(object.__getattribute__(self, "_data"))

    def __repr__(self) -> str:
        return f"K8sObj({object.__getattribute__(self, '_data')!r})"

    def to_dict(self) -> Dict[str, Any]:
        return dict(object.__getattribute__(self, "_data"))


# ---------------------------------------------------------------------------
# request models (the ones k8s/kube.py constructs)
# ---------------------------------------------------------------------------


def _serialize(value: Any) -> Any:
    """Model/python value → JSON value (camelCase keys, RFC3339 times,
    None fields dropped) — the real client's sanitize_for_serialization."""
    if isinstance(value, _Model):
        out = {}
        for k, v in value.__dict__.items():
            if v is None:
                continue
            out[_snake_to_camel(k)] = _serialize(v)
        return out
    if isinstance(value, _dt.datetime):
        return value.isoformat().replace("+00:00", "Z")
    if isinstance(value, dict):
        # None values in plain dicts are kept: an explicit null in a
        # merge patch deletes the key (only unset *model* attributes are
        # dropped, matching the real client's sanitize_for_serialization)
        return {k: _serialize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_serialize(v) for v in value]
    return value


class _Model:
    """kwargs-bag base for request models; snake_case kwargs serialize to
    camelCase JSON via _serialize."""

    _required: tuple = ()

    def __init__(self, **kwargs: Any):
        self.__dict__.update(kwargs)


class V1ObjectMeta(_Model):
    pass


class V1ObjectReference(_Model):
    pass


class V1Binding(_Model):
    pass


class V1EventSource(_Model):
    pass


class CoreV1Event(_Model):
    pass


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class Configuration:
    def __init__(self, host: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None, verify_ssl: bool = True,
                 token_file: Optional[str] = None):
        self.host = host.rstrip("/")
        self.token = token
        # bound SA tokens rotate on disk (k8s 1.21+); when a file is known,
        # the HTTP layer re-reads it per request so credentials never go
        # stale in a long-lived scheduler process
        self.token_file = token_file
        self.ca_file = ca_file
        self.verify_ssl = verify_ssl

    def current_token(self) -> Optional[str]:
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    fresh = f.read().strip()
                if fresh:
                    self.token = fresh
            except OSError:
                pass  # keep the last good token
        return self.token


_active_config: Optional[Configuration] = None


def _set_config(cfg: Configuration) -> None:
    global _active_config
    _active_config = cfg


_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def load_incluster_config() -> None:
    """Env + mounted-serviceaccount config (in-pod). Raises ConfigException
    outside a cluster so callers can fall back to kubeconfig, matching the
    reference's pattern (K8SMgr.py:43-46)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT")
    if not host or not port:
        raise ConfigException(
            "Service host/port is not set (not running in a cluster)"
        )
    scheme = os.environ.get("KUBERNETES_SERVICE_SCHEME", "https")
    if ":" in host and not host.startswith("["):  # bare IPv6
        host = f"[{host}]"
    token = None
    token_file = os.environ.get("NHD_K8S_TOKEN_FILE", f"{_SA_DIR}/token")
    if os.path.exists(token_file):
        with open(token_file) as f:
            token = f.read().strip()
    else:
        token_file = None
    ca = f"{_SA_DIR}/ca.crt"
    _set_config(Configuration(
        f"{scheme}://{host}:{port}", token=token, token_file=token_file,
        ca_file=ca if os.path.exists(ca) else None,
    ))


def load_kube_config(config_file: Optional[str] = None) -> None:
    """Minimal kubeconfig loader: current-context cluster server + user
    token; TLS verification honors insecure-skip-tls-verify."""
    import yaml

    path = config_file or os.environ.get(
        "KUBECONFIG", os.path.expanduser("~/.kube/config")
    )
    if not os.path.exists(path):
        raise ConfigException(f"kubeconfig not found: {path}")
    with open(path) as f:
        doc = yaml.safe_load(f) or {}

    def by_name(section: str, name: str) -> dict:
        for entry in doc.get(section, []) or []:
            if entry.get("name") == name:
                return entry
        return {}

    ctx_name = doc.get("current-context", "")
    ctx = by_name("contexts", ctx_name).get("context", {})
    cluster = by_name("clusters", ctx.get("cluster", "")).get("cluster", {})
    user = by_name("users", ctx.get("user", "")).get("user", {})
    server = cluster.get("server")
    if not server:
        raise ConfigException(f"no cluster server in {path}")
    token = user.get("token")
    if not token and (
        user.get("client-certificate-data") or user.get("client-certificate")
    ):
        # cert-auth kubeconfigs (kubeadm default) aren't supported by this
        # minimal loader — fail loudly rather than send unauthenticated
        # requests that 401/403 confusingly later
        raise ConfigException(
            "kubeconfig uses client-certificate auth, which the minimal "
            "restclient does not support; use a token-based user or the "
            "real kubernetes package"
        )
    _set_config(Configuration(
        server, token=token,
        ca_file=cluster.get("certificate-authority"),
        verify_ssl=not cluster.get("insecure-skip-tls-verify", False),
    ))


# ---------------------------------------------------------------------------
# HTTP core
# ---------------------------------------------------------------------------

_DEFAULT_TIMEOUT = 30.0

# Finite socket timeout for watch streams. The old behavior (timeout=None)
# meant a silently dead socket — NAT reset with no FIN, crashed LB — blocked
# the watch thread FOREVER with no events and no error. A quiet-but-alive
# watch simply times out too: Watch.stream translates the read timeout into
# a normal stream end, and the reconnect loop in k8s/kube.py resumes from
# the tracked resourceVersion (no replay). 60s matches the order of the API
# server's own --min-request-timeout stream recycling.
_WATCH_READ_TIMEOUT = float(os.environ.get("NHD_WATCH_READ_TIMEOUT", "60"))


class _HttpClient:
    def __init__(self, cfg: Configuration):
        self.cfg = cfg

    def _context(self) -> Optional[ssl.SSLContext]:
        if not self.cfg.host.startswith("https"):
            return None
        if not self.cfg.verify_ssl:
            return ssl._create_unverified_context()
        ctx = ssl.create_default_context()
        if self.cfg.ca_file:
            ctx.load_verify_locations(self.cfg.ca_file)
        return ctx

    def request(
        self,
        method: str,
        path: str,
        *,
        body: Optional[Any] = None,
        content_type: str = "application/json",
        stream: bool = False,
        timeout: Optional[float] = _DEFAULT_TIMEOUT,
    ) -> Any:
        """One API call. Non-stream: parsed JSON (or None on an empty
        body). Stream: the raw response object (chunked decoding handled
        by http.client; iterate lines, close when done). Non-2xx raises
        ApiException."""
        data = None
        headers = {"Accept": "application/json"}
        if body is not None:
            data = _json.dumps(body).encode()
            headers["Content-Type"] = content_type
        token = self.cfg.current_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(
            self.cfg.host + path, data=data, headers=headers, method=method
        )
        try:
            resp = urllib.request.urlopen(
                req, timeout=_WATCH_READ_TIMEOUT if stream else timeout,
                context=self._context(),
            )
        except urllib.error.HTTPError as exc:
            raise ApiException(
                status=exc.code, reason=exc.reason,
                body=exc.read().decode(errors="replace"),
                headers=dict(exc.headers or {}),
            ) from None
        except urllib.error.URLError as exc:
            raise ApiException(status=0, reason=str(exc.reason)) from None
        if stream:
            return resp
        with resp:
            raw = resp.read()
        return _json.loads(raw) if raw else None


def _api_http() -> _HttpClient:
    if _active_config is None:
        raise ConfigException(
            "no configuration loaded: call config.load_incluster_config() "
            "or config.load_kube_config() first"
        )
    return _HttpClient(_active_config)


# ---------------------------------------------------------------------------
# CoreV1Api — exactly the calls k8s/kube.py makes
# ---------------------------------------------------------------------------


class CoreV1Api:
    def __init__(self) -> None:
        self._http = _api_http()

    # -- reads --

    def list_node(
        self, *, watch: bool = False, resource_version: Optional[str] = None
    ):
        if watch:
            path = "/api/v1/nodes?watch=true"
            if resource_version:
                path += f"&resourceVersion={resource_version}"
            return self._http.request("GET", path, stream=True)
        return K8sObj(self._http.request("GET", "/api/v1/nodes"))

    def read_node(self, name: str) -> K8sObj:
        return K8sObj(self._http.request("GET", f"/api/v1/nodes/{name}"))

    def read_namespaced_pod(self, name: str, namespace: str) -> K8sObj:
        return K8sObj(self._http.request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}"
        ))

    def list_pod_for_all_namespaces(
        self, *, watch: bool = False, resource_version: Optional[str] = None
    ):
        if watch:
            path = "/api/v1/pods?watch=true"
            if resource_version:
                path += f"&resourceVersion={resource_version}"
            return self._http.request("GET", path, stream=True)
        return K8sObj(self._http.request("GET", "/api/v1/pods"))

    def list_namespaced_pod(self, namespace: str) -> K8sObj:
        return K8sObj(self._http.request(
            "GET", f"/api/v1/namespaces/{namespace}/pods"
        ))

    def read_namespaced_config_map(self, name: str, namespace: str) -> K8sObj:
        return K8sObj(self._http.request(
            "GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}"
        ))

    # -- writes --

    def patch_namespaced_pod(self, name: str, namespace: str, body: Any) -> K8sObj:
        return K8sObj(self._http.request(
            "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
            body=_serialize(body),
            content_type="application/strategic-merge-patch+json",
        ))

    def create_namespaced_pod_binding(
        self, name: str, namespace: str, body: V1Binding
    ) -> Any:
        resp = self._http.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            body=_serialize(body),
        )
        # Faithful reproduction of the kubernetes-client quirk the
        # reference codes around (K8SMgr.py:487-491): the API server
        # answers with a Status object; deserializing it into the V1Binding
        # response model trips on the missing required 'target'.
        if not isinstance(resp, dict) or "target" not in resp:
            raise ValueError(
                "Invalid value for `target`, must not be `None`"
            )
        return K8sObj(resp)

    def create_namespaced_event(self, namespace: str, body: CoreV1Event) -> K8sObj:
        return K8sObj(self._http.request(
            "POST", f"/api/v1/namespaces/{namespace}/events",
            body=_serialize(body),
        ))

    def create_namespaced_pod(self, namespace: str, body: Any) -> K8sObj:
        return K8sObj(self._http.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods",
            body=_serialize(body),
        ))


class CustomObjectsApi:
    def __init__(self) -> None:
        self._http = _api_http()

    def list_cluster_custom_object(
        self, group: str, version: str, plural: str
    ) -> dict:
        # the real client returns plain JSON for custom objects
        return self._http.request("GET", f"/apis/{group}/{version}/{plural}")

    def patch_namespaced_custom_object_status(
        self, group: str, version: str, namespace: str, plural: str,
        name: str, body: Any,
    ) -> dict:
        return self._http.request(
            "PATCH",
            f"/apis/{group}/{version}/namespaces/{namespace}/{plural}/"
            f"{name}/status",
            body=_serialize(body),
            content_type="application/merge-patch+json",
        )

    # namespaced get/create/replace — the real client's generic custom-
    # object surface, which kube.py also uses for coordination.k8s.io
    # Lease objects (leader election, k8s/lease.py): plain-JSON shapes on
    # both client paths, and replace() carries metadata.resourceVersion so
    # the API server's optimistic concurrency (409 Conflict) is the CAS.

    def get_namespaced_custom_object(
        self, group: str, version: str, namespace: str, plural: str,
        name: str,
    ) -> dict:
        return self._http.request(
            "GET",
            f"/apis/{group}/{version}/namespaces/{namespace}/{plural}/{name}",
        )

    def create_namespaced_custom_object(
        self, group: str, version: str, namespace: str, plural: str,
        body: Any,
    ) -> dict:
        return self._http.request(
            "POST",
            f"/apis/{group}/{version}/namespaces/{namespace}/{plural}",
            body=_serialize(body),
        )

    def replace_namespaced_custom_object(
        self, group: str, version: str, namespace: str, plural: str,
        name: str, body: Any,
    ) -> dict:
        return self._http.request(
            "PUT",
            f"/apis/{group}/{version}/namespaces/{namespace}/{plural}/{name}",
            body=_serialize(body),
        )


# ---------------------------------------------------------------------------
# watch
# ---------------------------------------------------------------------------


class Watch:
    """Line-delimited JSON watch stream. The generator ends when the server
    closes the connection; callers reconnect by looping (k8s/kube.py wraps
    stream() in ``while True``, like kopf's own reconnect loop).

    ``resource_version`` is tracked across stream() calls on the same Watch
    — reconnects resume from the last seen event instead of replaying
    synthetic ADDED events for every live object (the real client's
    behavior)."""

    def __init__(self) -> None:
        self._stopped = False
        self._resp = None
        self.resource_version: Optional[str] = None

    def stream(self, func, **kwargs) -> Iterator[dict]:
        if self.resource_version and "resource_version" not in kwargs:
            kwargs["resource_version"] = self.resource_version
        try:
            resp = func(watch=True, **kwargs)
        except ApiException as exc:
            if exc.status == 410:
                # 410 Gone: our resourceVersion fell out of the etcd
                # compaction window — forget it so the next reconnect
                # starts a fresh (full-replay) watch instead of retrying
                # the stale version forever
                self.resource_version = None
            raise
        self._resp = resp
        try:
            for line in resp:
                if self._stopped:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = _json.loads(line)
                except ValueError:
                    # one garbled chunk (routine on a mid-stream cut) must
                    # not raise JSONDecodeError out of the generator and
                    # kill the watch thread: drop the line, end the stream,
                    # let the caller's reconnect loop start a fresh watch
                    API_COUNTERS.inc("watch_malformed_lines_total")
                    _logger.warning(
                        "malformed watch line (%d bytes); dropping and "
                        "ending stream for reconnect", len(line)
                    )
                    break
                obj = ev.get("object", {})
                rv = (obj.get("metadata") or {}).get("resourceVersion")
                if rv:
                    self.resource_version = rv
                yield {"type": ev.get("type"), "object": _wrap(obj)}
        except (OSError, _httplib.HTTPException) as exc:
            # the finite socket timeout (silently dead peer) or a torn
            # chunked read surfaces here mid-iteration — translate into a
            # normal stream end so the reconnect loop takes over instead
            # of the error escaping the generator. A plain timeout is
            # routine stream recycling on a quiet cluster: INFO, not a
            # warning per idle minute
            API_COUNTERS.inc("watch_read_timeouts_total")
            log = (_logger.info if isinstance(exc, TimeoutError)
                   else _logger.warning)
            log(f"watch stream read ended ({exc!r}); reconnecting")
        finally:
            try:
                resp.close()
            except Exception:  # nhdlint: ignore[NHD302]
                pass  # best-effort close of an already-broken stream
            self._resp = None

    def stop(self) -> None:
        self._stopped = True
        if self._resp is not None:
            try:
                self._resp.close()
            except Exception:  # nhdlint: ignore[NHD302]
                pass  # racing the reader's own close; either one wins


# ---------------------------------------------------------------------------
# package-shaped namespaces so `from ... import client, config, watch` works
# ---------------------------------------------------------------------------

client = types.SimpleNamespace(
    CoreV1Api=CoreV1Api,
    CustomObjectsApi=CustomObjectsApi,
    V1ObjectMeta=V1ObjectMeta,
    V1ObjectReference=V1ObjectReference,
    V1Binding=V1Binding,
    V1EventSource=V1EventSource,
    CoreV1Event=CoreV1Event,
    Configuration=Configuration,
    exceptions=types.SimpleNamespace(ApiException=ApiException),
)

config = types.SimpleNamespace(
    load_incluster_config=load_incluster_config,
    load_kube_config=load_kube_config,
    ConfigException=ConfigException,
)

watch = types.SimpleNamespace(Watch=Watch)
