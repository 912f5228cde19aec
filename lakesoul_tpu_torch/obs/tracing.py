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

While a ``torch.profiler`` records in this process (:func:`device_timing`:
a benchmark's traced window, an operator's profiling session) a span also
opens ``torch.profiler.record_function("lakesoul.<name>")``, which puts the
program's spans on the profiler's clock in the same trace as the kernels
(all but a detached span opened without a device: it may close on another
thread, where a profiler range cannot).

Device timing.  A span opened with ``device=`` a CUDA device while a
profiler records also records a CUDA event (``enable_timing=True``) on the
current stream when it opens and another when it closes; its device time is
the elapsed time between the two.  Nothing on the span's path blocks: a
finished span waits in a bounded pending list (``PENDING_MAX``; past it the
oldest is dropped, and a reader that counts its spans sees one missing) and
is resolved when a later span opens, if ``event.query()`` says its end has
run, or by :func:`flush_device_spans`, which a caller uses after its own
synchronise.  Once resolved, a span observes its device time into
``lakesoul_span_device_seconds{name=...}``, the device twin of
``lakesoul_span_seconds`` (which keeps the host time), and its ring record
gains ``device_ms``.  An outermost timed span (no timed span open on its
device), such as a training step, also observes the device time from the
end event of the previous one of its name to its own start event into
``lakesoul_span_device_gap_seconds{name=...}``: the card's idle time between
steps, with any wait the stream was given there (a loader's copy event).
A :func:`device_timing` reading False ends the profiling session, so no gap
spans two sessions.  A timed span opened where no span is current, as from
an autograd hook on the engine's thread for its device, takes as its parent
the innermost timed span open on that device.

torch is imported only once a profiler records, when it is loaded already:
this module stays cheap to import.
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import sys
import threading
import time
import uuid
from collections import deque

from lakesoul_tpu_torch.obs.metrics import registry

__all__ = [
    "ENV_TRACE_ID",
    "Span",
    "span",
    "span_backward",
    "ambient_trace_id",
    "current_span",
    "current_trace_id",
    "device_timing",
    "flush_device_spans",
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

# the most finished device-timed spans that wait for their events at once:
# a host that runs ahead of the card by a few steps keeps a few dozen
PENDING_MAX = 4096
PROFILE_PREFIX = "lakesoul."

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


class _DeviceClock:
    """The device side of timed spans: the pending list, the open timed
    spans of each device and, while a profiling session lasts, the last end
    event of each outermost timed span's name."""

    def __init__(self, pending_max: int = PENDING_MAX):
        self.lock = threading.Lock()
        self.pending_max = pending_max
        self.pending: deque = deque()  # (span, ring record), oldest first
        self.open: dict = {}  # CUDA device index -> timed spans still open, innermost last
        self.gaps: dict | None = None  # name -> end event; None between sessions

    def innermost(self, index: int):
        with self.lock:
            spans = self.open.get(index)
            return spans[-1] if spans else None

    def start(self, sp: "Span", outermost: bool) -> dict | None:
        """Push ``sp`` on its device's open spans; → the session's gap table
        for an outermost span, else None."""
        with self.lock:
            self.open.setdefault(sp._index, []).append(sp)
            if not outermost:
                return None
            if self.gaps is None:
                self.gaps = {}
            return self.gaps

    def finish(self, sp: "Span", record: dict) -> None:
        with self.lock:
            self.open[sp._index].remove(sp)
            self.pending.append((sp, record))
            if len(self.pending) > self.pending_max:
                lost, _ = self.pending.popleft()
                gaps = lost._events[2]
                if gaps is not None:  # no gap may be read across the span never resolved
                    gaps.pop(lost.name, None)

    def resolve(self, block: bool) -> int:
        """Resolve the pending spans whose end event has run, oldest first;
        ``block`` waits for each instead."""
        done = 0
        with self.lock:
            while self.pending:
                sp, record = self.pending[0]
                end = sp._events[1]
                if block:
                    end.synchronize()
                elif not end.query():
                    break
                self.pending.popleft()
                self._observe(sp, record)
                done += 1
        return done

    @staticmethod
    def _observe(sp: "Span", record: dict) -> None:
        start, end, gaps = sp._events
        sp._events = None
        sp.device_s = start.elapsed_time(end) / 1e3
        registry().histogram("lakesoul_span_device_seconds", name=sp.name).observe(sp.device_s)
        if gaps is not None:
            prev = gaps.get(sp.name)
            gap = None if prev is None else prev.elapsed_time(start) / 1e3
            if gap is not None and gap >= 0:  # same-name spans that overlap have none
                registry().histogram(
                    "lakesoul_span_device_gap_seconds", name=sp.name).observe(gap)
            gaps[sp.name] = end
        with _RECENT_LOCK:
            record["device_ms"] = round(sp.device_s * 1e3, 3)


_CLOCK = _DeviceClock()


def device_timing() -> bool:
    """Whether device timing is on: while a ``torch.profiler`` records in
    this process.  A hot path reads it once per unit of work and opens its
    timed spans only when it is True; a False reading ends the profiling
    session, so the next one reads no gap across the time between."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return True
    _CLOCK.gaps = None
    return False


def flush_device_spans() -> int:
    """Resolve every pending device-timed span, waiting for each one's end
    event (nothing to wait for after the caller's own synchronise); → how
    many were resolved."""
    return _CLOCK.resolve(block=True)


class Span:
    """One timed unit of work.  Use via :func:`span`::

        with span("sql.execute", statement="Select") as s:
            ...          # s.trace_id is inherited or freshly minted
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "started", "duration_s", "device", "device_s",
        "_token", "_detached", "_profile", "_events", "_index",
    )

    def __init__(
        self,
        name: str,
        trace_id: str | None = None,
        detached: bool = False,
        device=None,
        **attrs,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id: str | None = None
        self.attrs = attrs
        self.started = 0.0
        self.duration_s: float | None = None
        # the device whose work the span times while a profiler records;
        # device_s is that time, once the span's events are resolved
        self.device = device
        self.device_s: float | None = None
        self._token = None
        # detached spans never become the contextvar "current" span: REQUIRED
        # for a span held open across generator yields (a Flight stream),
        # where enter and exit run in different Contexts — setting the var
        # there would leak a dead span into the serving thread's context and
        # later unrelated requests would inherit its trace_id
        self._detached = detached
        self._profile = None  # the open record_function while a profiler records
        # (start event, end event, the session's gap table or None) of a
        # timed span, and its CUDA device's index
        self._events = None
        self._index = None

    def __enter__(self) -> "Span":
        parent = _CURRENT.get()
        profiling = device_timing()
        if profiling and self.device is not None:
            self._index = _cuda_index(self.device)
        outer = None
        if self._index is not None:
            outer = _CLOCK.innermost(self._index)
            if parent is None:
                parent = outer
        if parent is not None:
            self.parent_id = parent.span_id
            if self.trace_id is None:
                self.trace_id = parent.trace_id
        if self.trace_id is None:
            # a spawned role's root spans join the parent's trace when the
            # spawn handed one over; otherwise a fresh trace starts here
            self.trace_id = ambient_trace_id() or new_trace_id()
        if profiling and (not self._detached or self.device is not None):
            import torch

            self._profile = torch.profiler.record_function(PROFILE_PREFIX + self.name)
            self._profile.__enter__()
        if self._index is not None:
            self._open_events(outermost=outer is None)
        self.started = time.perf_counter()
        if not self._detached:
            self._token = _CURRENT.set(self)
        return self

    def _open_events(self, outermost: bool) -> None:
        import torch

        _CLOCK.resolve(block=False)
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self._index))
        self._events = (start, None, _CLOCK.start(self, outermost))

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = time.perf_counter() - self.started
        if self._events is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._index))
            self._events = (self._events[0], end, self._events[2])
        if self._profile is not None:
            self._profile.__exit__(exc_type, exc, tb)
            self._profile = None
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
        if self._events is not None:
            _CLOCK.finish(self, record)
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
    name: str,
    *,
    trace_id: str | None = None,
    detached: bool = False,
    device=None,
    **attrs,
) -> Span:
    """Open a span (context manager).  ``trace_id`` pins the trace (remote
    propagation); otherwise the enclosing span's id is inherited, or a new
    trace starts.  Pass ``detached=True`` for a span held open across
    ``yield``s you don't own (generator-resume contexts differ) — it is
    timed and recorded but never becomes the contextvar current span.
    ``device``: the device whose work the span covers; a CUDA device's
    work is timed by events while a profiler records (the module's
    docstring)."""
    return Span(name, trace_id=trace_id, detached=detached, device=device, **attrs)


def span_backward(name: str, out, inp) -> None:
    """The span ``name`` over the backward of the computation from tensor
    ``inp`` to tensor ``out``, from two tensor hooks: ``out``'s gradient
    opens it, ``inp``'s closes it.  Both run where autograd runs those nodes
    (on a CUDA device, the engine's thread for it, where no span is
    current), so the span is detached and takes as its parent the innermost
    timed span open on the device (a training step's ``train.backward``)."""
    dev = inp.device  # the hooks hold no tensor: inp's own hook must not keep it alive
    opened = []

    def begin(grad):
        opened.append(span(name, device=dev, detached=True).__enter__())

    def end(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(begin)
    inp.register_hook(end)


def _cuda_index(device) -> int | None:
    """The index of a CUDA device (the current one for a bare ``cuda``),
    None for any other device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


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
