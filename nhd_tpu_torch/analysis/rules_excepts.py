"""NHD3xx — exception hygiene.

A watch thread that swallows an exception doesn't crash — it silently
stops translating cluster events, and the scheduler keeps running against
a frozen mirror. The reference crashed the whole process instead
(TriadController.py:147-152); this rebuild keeps threads alive, which
makes *visible* handling mandatory:

* NHD301 — bare ``except:`` also catches SystemExit/KeyboardInterrupt
  and turns Ctrl-C / sys.exit into an infinite loop;
* NHD302 — ``except Exception:`` whose handler neither logs, re-raises,
  returns, breaks, nor even reads the caught exception. ``pass`` and
  ``continue`` bodies are the classic watch-loop black hole.

A handler that returns a sentinel (``return False``) is deliberate
control flow, not swallowing — the caller sees the failure. That's why
NHD302 keys on "no observable signal at all" rather than "no logging".
"""

from __future__ import annotations

import ast
from typing import List

from nhd_tpu_torch.analysis.core import Finding

_BROAD = {"Exception", "BaseException"}
_LOGGING_HINTS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "print",
}


def _is_broad(type_node: ast.AST) -> bool:
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Attribute):
        return type_node.attr in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(e) for e in type_node.elts)
    return False


def _handler_signals(handler: ast.ExceptHandler) -> bool:
    """True if the handler produces any observable outcome: logs, raises,
    returns/breaks out, or reads the bound exception."""
    exc_name = handler.name
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Break)):
            return True
        if isinstance(node, ast.Call):
            func = node.func
            name = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if name in _LOGGING_HINTS:
                return True
        if (
            exc_name
            and isinstance(node, ast.Name)
            and node.id == exc_name
            and isinstance(node.ctx, ast.Load)
        ):
            return True
        if isinstance(node, ast.Assign):
            return True  # records state somewhere the caller can observe
    return False


def check_module(tree: ast.Module, src: str, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if handler.type is None:
                findings.append(Finding(
                    "NHD301", path, handler.lineno, handler.col_offset,
                    "bare 'except:' catches SystemExit/KeyboardInterrupt "
                    "— name the exceptions (at minimum 'except Exception')",
                ))
                continue
            if _is_broad(handler.type) and not _handler_signals(handler):
                findings.append(Finding(
                    "NHD302", path, handler.lineno, handler.col_offset,
                    "broad except swallows the error with no log, raise, "
                    "or return — a dead watch loop looks exactly like a "
                    "quiet one; log it or narrow the exception type",
                ))
    return findings
