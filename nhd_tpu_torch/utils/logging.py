"""Logger factory for the framework.

Equivalent role to the reference's NHDCommon.GetLogger (NHDCommon.py:20-38):
one logger per module, colored when attached to a TTY. Defaults to WARNING
(the reference's INFO narration is extremely chatty in the matcher); set
NHD_TPU_LOG_LEVEL=INFO to get it.

``NHD_LOG_JSON=1`` switches every record to one-line JSON stamped with the
active flight-recorder correlation ID (nhd_tpu/obs), so log lines join
against traces and the recent-decisions view: grep the corr id from either
side. The env var is read when a logger first builds its handler — set it
before the process imports the framework, like the log level.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from nhd_tpu_torch.obs.recorder import current_corr_id

_FMT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[1;31m",
}
_RESET = "\033[0m"


class _TtyColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        return f"{color}{msg}{_RESET}" if color else msg


class JsonFormatter(logging.Formatter):
    """One JSON object per record: ts (epoch seconds), level, logger,
    thread, msg, corr (the context correlation ID or null), and exc for
    records carrying exception info."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "thread": record.threadName,
            "msg": record.getMessage(),
            "corr": current_corr_id(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def _pick_formatter() -> logging.Formatter:
    if os.environ.get("NHD_LOG_JSON") == "1":
        return JsonFormatter()
    if sys.stderr.isatty():
        return _TtyColorFormatter(_FMT)
    return logging.Formatter(_FMT)


def get_logger(name: str) -> logging.Logger:
    """Return a configured logger for *name* (idempotent per name)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_pick_formatter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("NHD_TPU_LOG_LEVEL", "WARNING").upper())
        logger.propagate = False
    return logger
