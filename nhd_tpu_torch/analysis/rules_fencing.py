"""NHD5xx — fenced-commit discipline in the scheduling control plane.

HA mode (k8s/lease.py) is only sound if EVERY mutating backend call on
the commit path carries the current fencing epoch — one raw call is a
hole a deposed leader's in-flight batch can land through. The repo's
contract: inside ``nhd_tpu_torch/scheduler/``, the four commit-path mutators
(``bind_pod_to_node``, ``annotate_pod_config``, ``annotate_pod_gpu_map``,
``add_nad_to_pod``) are invoked ONLY through the fenced-commit helper
``Scheduler._commit_write`` (scheduler/core.py), which stamps the epoch.

* NHD501 — a ``*.backend.<mutator>(...)`` call in scheduler code outside
  the helper. Passing the bound method TO the helper
  (``self._commit_write(self.backend.bind_pod_to_node, ...)``) is the
  sanctioned form and is not a call expression, so it never flags.

The CONTROLLER's cluster mutators (``create_pod_for_triadset``,
``update_triadset_status`` — the TriadSet reconciliation writes) are in
scope too: they must route through ``Controller._coordinator_write``,
which re-checks coordinatorship at the write instead of only at the top
of the reconcile pass (a replica deposed — or whose coordinator shard
handed off under federation — mid-pass must not keep writing).

Reads and ``generate_pod_event`` (idempotent audit trail) are out of
scope — the rule guards exactly the writes whose double application
corrupts cluster state.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from nhd_tpu_torch.analysis.core import Finding, _dotted

# module-path gate: the pack judges only scheduler control-plane code
_SCOPE_PARTS = ("scheduler",)

#: the commit-path mutators that MUST carry a fencing epoch
#: (``evict_pod`` is the policy engine's preemption eviction — an
#: unfenced eviction is the preemption analog of the double-bind hole:
#: a deposed leader could evict a victim the new leader just placed)
FENCED_MUTATORS = frozenset({
    "bind_pod_to_node",
    "annotate_pod_config",
    "annotate_pod_gpu_map",
    "add_nad_to_pod",
    "annotate_pod_meta",
    "claim_spillover_pod",
    "evict_pod",
})

#: the controller's cluster mutators (TriadSet reconciliation) — gated
#: on coordinatorship per write, not per pass
COORDINATOR_MUTATORS = frozenset({
    "create_pod_for_triadset",
    "update_triadset_status",
})

#: mutator → the one function allowed to issue it
FENCE_HELPER = "_commit_write"
COORDINATOR_HELPER = "_coordinator_write"
_HELPER_FOR = {
    **{m: FENCE_HELPER for m in FENCED_MUTATORS},
    **{m: COORDINATOR_HELPER for m in COORDINATOR_MUTATORS},
}


def _in_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(p in parts for p in _SCOPE_PARTS)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []

    def _visit_func(self, node) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _enclosing(self) -> Optional[str]:
        return self._func_stack[-1] if self._func_stack else None

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d is not None:
            parts = d.split(".")
            # any receiver whose terminal name is 'backend': self.backend,
            # sched.backend, AND a bare `backend` parameter — a helper
            # taking the backend directly must not evade the rule
            if (
                len(parts) >= 2
                and parts[-1] in _HELPER_FOR
                and parts[-2] == "backend"
                and self._enclosing() != _HELPER_FOR[parts[-1]]
            ):
                helper = _HELPER_FOR[parts[-1]]
                if helper == FENCE_HELPER:
                    why = (
                        f"{d}() mutates cluster state outside the "
                        f"fenced-commit helper: without the fencing epoch "
                        f"a deposed leader's in-flight write can land "
                        f"after a standby's promotion — route it through "
                        f"Scheduler.{FENCE_HELPER}() "
                        "(docs/RESILIENCE.md 'HA & fencing')"
                    )
                else:
                    why = (
                        f"{d}() mutates cluster state outside the "
                        f"coordinator-write helper: a replica deposed "
                        f"mid-reconcile keeps writing against the new "
                        f"coordinator — route it through "
                        f"Controller.{COORDINATOR_HELPER}() "
                        "(docs/RESILIENCE.md 'Federation')"
                    )
                self.findings.append(Finding(
                    "NHD501", self.path, node.lineno, node.col_offset, why,
                ))
        self.generic_visit(node)


def check_module(tree: ast.Module, src: str, path: str) -> List[Finding]:
    if not _in_scope(path):
        return []
    visitor = _Visitor(path)
    visitor.visit(tree)
    return visitor.findings
