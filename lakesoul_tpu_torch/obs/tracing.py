"""Lightweight tracing spans with a propagatable trace id.

The role of the reference core's ``tracing`` instrumentation threaded through
reader/writer hot paths (reader.rs:116,147, pyo3-log): a ``span`` is a
context manager that records wall time, nests parent/child via contextvars,
and carries a ``trace_id`` that can be supplied by a remote client (the
Flight gateway propagates it via the ``x-trace-id`` header) so one request
can be followed across client → gateway → executor → io.

Every finished span

- observes its duration into the registry histogram
  ``lakesoul_span_seconds{name=...}``,
- is logged at DEBUG on this module's logger with its trace id (the JSON
  log formatter also stamps ``trace_id`` on any record emitted inside an
  active span), and
- lands in a bounded in-memory ring (``recent_spans``) for consoles/tests.
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import threading
import time
import uuid
from collections import deque

from lakesoul_tpu_torch.obs.metrics import registry

__all__ = [
    "ENV_TRACE_ID",
    "Span",
    "span",
    "ambient_trace_id",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "recent_spans",
    "sanitize_trace_id",
]

# the spawn-boundary handoff: a parent that pins this var in a child's
# environment makes every root span in the child join the parent's trace
# (x-trace-id covers Flight hops; this covers subprocess hops)
ENV_TRACE_ID = "LAKESOUL_TRACE_ID"

logger = logging.getLogger(__name__)

_CURRENT: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "lakesoul_current_span", default=None
)

_RECENT: deque = deque(maxlen=512)
_RECENT_LOCK = threading.Lock()

# trace ids cross process boundaries in headers/logs: bound length + charset
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def sanitize_trace_id(raw) -> str | None:
    """A client-supplied trace id, or None when absent/unusable."""
    if not raw:
        return None
    if isinstance(raw, bytes):
        try:
            raw = raw.decode()
        except UnicodeDecodeError:
            return None
    raw = str(raw)
    return raw if _TRACE_ID_RE.match(raw) else None


def ambient_trace_id() -> str | None:
    """The trace id handed across a process-spawn boundary
    (``LAKESOUL_TRACE_ID``), sanitized — root spans (and Flight clients)
    in a spawned role default to it, so one chaos run's commit →
    worker-decode → client-delivery path shares a single trace."""
    return sanitize_trace_id(os.environ.get(ENV_TRACE_ID))


class Span:
    """One timed unit of work.  Use via :func:`span`::

        with span("sql.execute", statement="Select") as s:
            ...          # s.trace_id is inherited or freshly minted
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "started", "duration_s", "_token", "_detached",
    )

    def __init__(
        self,
        name: str,
        trace_id: str | None = None,
        detached: bool = False,
        **attrs,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id: str | None = None
        self.attrs = attrs
        self.started = 0.0
        self.duration_s: float | None = None
        self._token = None
        # detached spans never become the contextvar "current" span: REQUIRED
        # for a span held open across generator yields (a Flight stream),
        # where enter and exit run in different Contexts — setting the var
        # there would leak a dead span into the serving thread's context and
        # later unrelated requests would inherit its trace_id
        self._detached = detached

    def __enter__(self) -> "Span":
        parent = _CURRENT.get()
        if parent is not None:
            self.parent_id = parent.span_id
            if self.trace_id is None:
                self.trace_id = parent.trace_id
        if self.trace_id is None:
            # a spawned role's root spans join the parent's trace when the
            # spawn handed one over; otherwise a fresh trace starts here
            self.trace_id = ambient_trace_id() or new_trace_id()
        self.started = time.perf_counter()
        if not self._detached:
            self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = time.perf_counter() - self.started
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        registry().histogram("lakesoul_span_seconds", name=self.name).observe(
            self.duration_s
        )
        record = self.to_dict()
        # wall-clock end stamp: cross-process trace assembly (the fleet
        # aggregator merging several processes' span exports) needs an
        # absolute ordering key; perf_counter timebases don't compare
        record["t_unix"] = round(time.time(), 3)
        if exc_type is not None:
            record["error"] = exc_type.__name__
        with _RECENT_LOCK:
            _RECENT.append(record)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "span %s finished in %.2fms trace_id=%s parent=%s %s",
                self.name,
                self.duration_s * 1e3,
                self.trace_id,
                self.parent_id,
                self.attrs or "",
            )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": round((self.duration_s or 0.0) * 1e3, 3),
            "attrs": dict(self.attrs),
        }


def span(
    name: str, *, trace_id: str | None = None, detached: bool = False, **attrs
) -> Span:
    """Open a span (context manager).  ``trace_id`` pins the trace (remote
    propagation); otherwise the enclosing span's id is inherited, or a new
    trace starts.  Pass ``detached=True`` for a span held open across
    ``yield``s you don't own (generator-resume contexts differ) — it is
    timed and recorded but never becomes the contextvar current span."""
    return Span(name, trace_id=trace_id, detached=detached, **attrs)


def current_span() -> Span | None:
    return _CURRENT.get()


def current_trace_id() -> str | None:
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


def recent_spans(
    name: str | None = None, trace_id: str | None = None
) -> list[dict]:
    """Most-recent finished spans (oldest first), optionally filtered."""
    with _RECENT_LOCK:
        out = list(_RECENT)
    if name is not None:
        out = [s for s in out if s["name"] == name]
    if trace_id is not None:
        out = [s for s in out if s["trace_id"] == trace_id]
    return out
