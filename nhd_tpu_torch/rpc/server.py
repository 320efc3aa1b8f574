"""gRPC stats plane: the NHDControl service.

Functional equivalent of the reference's NHDRpcServer.py: a thread-pool
gRPC server that answers stats queries by posting (msg_type, reply_queue)
onto the scheduler's RPC queue and waiting up to 5 s (NHDRpcServer.py:55-58)
— the scheduler thread stays the single owner of all mutable state.

Two differences from the reference:
* service registration is hand-built with generic method handlers (this
  image has protoc but not grpc_python_plugin, so there are no generated
  servicer base classes — only the message bindings in nhd_stats_pb2);
* GetDetailedNodeStats is implemented (declared but unimplemented in the
  reference, nhd_stats.proto:75).
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent import futures
from typing import Callable, Dict, Optional

import grpc

from nhd_tpu_torch.obs import decisions_view
from nhd_tpu_torch.rpc import nhd_stats_pb2 as pb
from nhd_tpu_torch.scheduler.core import RpcMsgType
from nhd_tpu_torch.utils import get_logger

DEFAULT_PORT = 45655          # reference: NHDRpcServer.py:16
RPC_TIMEOUT_SEC = 5.0         # reference: NHDRpcServer.py:58
SERVICE_NAME = "NhdStats.NHDControl"


class NHDControlHandler:
    """Implements the four NHDControl methods against the scheduler queue."""

    def __init__(self, sched_queue: queue.Queue):
        self.logger = get_logger(__name__)
        self.mainq = sched_queue

    def _ask(self, msg_type: RpcMsgType):
        from nhd_tpu_torch.rpc import ask_scheduler

        return ask_scheduler(self.mainq, msg_type)

    # ------------------------------------------------------------------

    def GetBasicNodeStats(self, request, context) -> pb.NodeStats:
        """Reference: NHDRpcServer.py:51-79."""
        reply = pb.NodeStats()
        try:
            nodes = self._ask(RpcMsgType.NODE_INFO)
        except queue.Empty:
            reply.status = pb.NHD_STATUS_ERR
            return reply
        reply.status = pb.NHD_STATUS_OK
        for n in nodes:
            info = reply.info.add()
            info.name = n["name"]
            info.free_cpus = n["freecpu"]
            info.used_cpus = n["totalcpu"] - n["freecpu"]
            info.free_gpus = n["freegpu"]
            info.used_gpus = n["totalgpu"] - n["freegpu"]
            info.free_hugepages = max(n["freehuge_gb"], 0)
            info.used_hugepages = n["totalhuge_gb"] - n["freehuge_gb"]
            info.total_pods = n["totalpods"]
            info.active = n["active"]
            for rx, tx in n["nicstats"]:
                nic = info.nic_info.add()
                nic.used_rx = int(rx)
                nic.used_tx = int(tx)
        return reply

    def GetSchedulerStats(self, request, context) -> pb.SchedulerStats:
        """Reference: NHDRpcServer.py:81-94."""
        reply = pb.SchedulerStats()
        try:
            count = self._ask(RpcMsgType.SCHEDULER_INFO)
        except queue.Empty:
            reply.status = pb.NHD_STATUS_ERR
            return reply
        reply.status = pb.NHD_STATUS_OK
        reply.failed_schedule_count = count
        return reply

    def _pod_info_proto(self, p: dict) -> pb.PodInfo:
        info = pb.PodInfo(
            name=p["podname"],
            node=p["node"],
            namespace=p["namespace"],
            hugepages=p["hugepages"],
        )
        for k, v in p["annotations"].items():
            info.annotations[k] = v
        info.misc_cores.extend(c for c in p["misc_cores"] if c >= 0)
        info.proc_cores.extend(c for c in p["proc_cores"] if c >= 0)
        info.proc_helper_cores.extend(c for c in p["proc_helper_cores"] if c >= 0)
        info.gpus.extend(g for g in p["gpus"] if g >= 0)
        info.nic_macs.extend(p["nics"])
        return info

    def GetPodStats(self, request, context) -> pb.PodStats:
        """Reference: NHDRpcServer.py:96-121."""
        reply = pb.PodStats()
        try:
            pods = self._ask(RpcMsgType.POD_INFO)
        except queue.Empty:
            reply.status = pb.NHD_STATUS_ERR
            return reply
        reply.status = pb.NHD_STATUS_OK
        for p in pods:
            reply.info.append(self._pod_info_proto(p))
        return reply

    def GetDetailedNodeStats(self, request, context) -> pb.DetailedNodeStats:
        """Per-node pod detail — declared but left unimplemented in the
        reference (nhd_stats.proto:75)."""
        reply = pb.DetailedNodeStats(name=request.name)
        try:
            pods = self._ask(RpcMsgType.POD_INFO)
        except queue.Empty:
            reply.status = pb.NHD_STATUS_ERR
            return reply
        reply.status = pb.NHD_STATUS_OK
        for p in pods:
            if p["node"] == request.name:
                reply.podinfo.append(self._pod_info_proto(p))
        return reply

    def GetRecentDecisions(self, request: bytes, context) -> bytes:
        """Flight-recorder recent-decisions view over gRPC. JSON-over-
        bytes, not protobuf: this image has protoc message bindings but no
        grpc_python_plugin (module docstring), so extending the .proto
        would strand the hand-built service — both ends of this method are
        ours and the decision record is schema-fluid by design."""
        try:
            # TypeError included: json "n": null/list reaches int() —
            # malformed requests degrade to the default, never error
            n = int(json.loads(request.decode() or "{}").get("n", 50))
        except (TypeError, ValueError, AttributeError):
            n = 50
        return json.dumps(decisions_view(n)).encode()


_METHODS: Dict[str, tuple] = {
    "GetBasicNodeStats": (pb.Empty, pb.NodeStats),
    "GetSchedulerStats": (pb.Empty, pb.SchedulerStats),
    "GetPodStats": (pb.Empty, pb.PodStats),
    "GetDetailedNodeStats": (pb.NodeReq, pb.DetailedNodeStats),
}

# JSON-over-bytes methods (see GetRecentDecisions): name only — identity
# (de)serializers on both ends
_RAW_METHODS = ("GetRecentDecisions",)


def _generic_handler(handler: NHDControlHandler) -> grpc.GenericRpcHandler:
    method_handlers = {}
    for name, (req_cls, resp_cls) in _METHODS.items():
        method_handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(handler, name),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    for name in _RAW_METHODS:
        method_handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(handler, name),
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, method_handlers)


class StatsRpcServer(threading.Thread):
    """The RPC thread (reference: NHDRpcServer.py:21-41)."""

    def __init__(self, sched_queue: queue.Queue, *, port: int = DEFAULT_PORT,
                 max_workers: int = 8):
        super().__init__(name="nhd-rpc", daemon=True)
        self.logger = get_logger(__name__)
        self.port = port
        self.handler = NHDControlHandler(sched_queue)
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self.server.add_generic_rpc_handlers((_generic_handler(self.handler),))
        self.bound_port = self.server.add_insecure_port(f"[::]:{port}")
        self._stopped = threading.Event()

    def run(self) -> None:
        self.server.start()
        self.logger.warning(f"stats RPC serving on :{self.bound_port}")
        self._stopped.wait()

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self.server.stop(grace)
        self._stopped.set()


class NHDControlClient:
    """Typed client over the generic channel (replaces the reference's
    generated stubs + manual test script, test/RPCTest.py)."""

    def __init__(self, target: str):
        self.channel = grpc.insecure_channel(target)
        self._calls: Dict[str, Callable] = {}
        for name, (req_cls, resp_cls) in _METHODS.items():
            self._calls[name] = self.channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
        for name in _RAW_METHODS:
            self._calls[name] = self.channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )

    def get_basic_node_stats(self) -> pb.NodeStats:
        return self._calls["GetBasicNodeStats"](pb.Empty())

    def get_scheduler_stats(self) -> pb.SchedulerStats:
        return self._calls["GetSchedulerStats"](pb.Empty())

    def get_pod_stats(self) -> pb.PodStats:
        return self._calls["GetPodStats"](pb.Empty())

    def get_detailed_node_stats(self, node: str) -> pb.DetailedNodeStats:
        return self._calls["GetDetailedNodeStats"](pb.NodeReq(name=node))

    def get_recent_decisions(self, n: int = 50) -> dict:
        raw = self._calls["GetRecentDecisions"](
            json.dumps({"n": n}).encode()
        )
        return json.loads(raw.decode())

    def close(self) -> None:
        self.channel.close()
