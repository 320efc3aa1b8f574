"""Stats/introspection planes (gRPC + Prometheus text).

Both planes talk to the single-writer scheduler thread the same way: post
(msg_type, reply_queue) on its RPC queue and wait (reference:
NHDRpcServer.py:55-58). The shared helper lives here so the protocol has
one definition and no grpc dependency.
"""

import queue

RPC_TIMEOUT_SEC = 5.0  # reference: NHDRpcServer.py:58


def ask_scheduler(sched_queue: "queue.Queue", msg_type, arg=None):
    """One request/reply round trip against the scheduler thread.
    ``arg`` is an optional message payload (EXPLAIN_INFO's queried pod)."""
    tmpq: "queue.Queue" = queue.Queue()
    sched_queue.put((msg_type, tmpq, arg))
    return tmpq.get(timeout=RPC_TIMEOUT_SEC)
