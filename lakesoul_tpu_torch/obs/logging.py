"""Structured logging: JSON formatter stamped with the active trace id (a
copy of ``lakesoul_tpu/obs/logging.py``, over the port's ``obs/tracing``).

``LAKESOUL_LOG_FORMAT=json`` switches CLI entry points (gateway, console) to
one-JSON-object-per-line log output; any record emitted inside an active
span carries that span's ``trace_id``, so server logs correlate with
client-supplied ids end to end.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from lakesoul_tpu_torch.obs.tracing import current_trace_id

__all__ = ["JsonLogFormatter", "configure_logging"]


class JsonLogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


_TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def configure_logging(
    level: int | str = logging.INFO,
    stream=None,
    fmt: str | None = None,
) -> logging.Handler:
    """Attach one handler to the ``lakesoul_tpu_torch`` package logger.

    ``fmt`` is ``"json"`` or ``"text"``; default comes from
    ``LAKESOUL_LOG_FORMAT`` (text when unset).  Idempotent: a handler
    installed by a previous call is replaced, not stacked."""
    fmt = (fmt or os.environ.get("LAKESOUL_LOG_FORMAT") or "text").lower()
    handler = logging.StreamHandler(stream or sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(_TEXT_FORMAT))
    handler._lakesoul_configured = True  # type: ignore[attr-defined]
    root = logging.getLogger("lakesoul_tpu_torch")
    for h in list(root.handlers):
        if getattr(h, "_lakesoul_configured", False):
            root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)
    return handler
