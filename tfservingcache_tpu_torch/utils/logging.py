"""Structured logging setup (counterpart of ``tfservingcache_tpu/utils/logging.py``).

``fmt=json`` lines are trace-correlated: a log call made anywhere inside a
request's span tree (including worker threads that run under
``contextvars.copy_context``) carries the request's ``trace_id``/``span``
fields, so ``grep trace_id=... service.log`` reconstructs one request's log
story and joins it to /monitoring/traces. Outside a request context the
fields are absent — no empty-string spam for scrapers to special-case.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from tfservingcache_tpu_torch.utils.tracing import current_ids

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "panic": logging.CRITICAL,
}

# Attributes every LogRecord is born with — anything else on the record was
# passed by the caller via ``extra={...}`` and belongs in the JSON payload.
# (makeLogRecord keeps this version-proof: 3.12 added ``taskName``.)
_STD_RECORD_KEYS = frozenset(vars(logging.makeLogRecord({}))) | {
    "message", "asctime", "taskName",
}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(record.created)),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
            "logger": record.name,
        }
        ids = current_ids()
        if ids is not None:
            payload["trace_id"], payload["span"] = ids
        for key, val in record.__dict__.items():
            # logrus-style structured fields: emit extra={...} attributes
            # (dropping them silently was the old behavior) without letting
            # a caller clobber the core keys above
            if key in _STD_RECORD_KEYS or key.startswith("_") or key in payload:
                continue
            payload[key] = val
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def setup_logging(level: str = "info", fmt: str = "text") -> None:
    root = logging.getLogger()
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S")
        )
    root.handlers[:] = [handler]


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tpusc_torch.{name}")
