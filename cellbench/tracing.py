"""The measured window: the host clock around it, ending in a device
synchronise, and with ``--trace 1`` a ``torch.profiler`` trace of it that
``harness.reduce_trace`` reads.  The spans here are the benchmark's own,
put around each call into a layer of the program; spans inside the program
are not the benchmark's to add."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from harness import WINDOW_SPAN, read_trace_file, reduce_trace


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """``record_function`` spans named ``cellbench.<name>`` while tracing,
    and nothing at all otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def _span(self, name: str):
        return torch.profiler.record_function(f"cellbench.{name}")

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    def wrap(self, fn, name: str):
        if not self.enabled:
            return fn

        def traced(*a, **kw):
            with self._span(name):
                return fn(*a, **kw)

        return traced


class Window:
    """``with Window(trace, device) as w: ...`` — ``w.started`` after a
    synchronise, ``w.close()`` synchronises and stamps ``w.ended``; with
    tracing, ``w.trace`` then holds the reduced trace."""

    def __init__(self, trace: bool, device, spans: Spans | None = None):
        self.tracing = trace
        self.device = device
        self.spans = spans
        self.trace = None
        self._prof = None
        self._span = None
        self.started = self.ended = None

    def __enter__(self):
        sync(self.device)
        if self.tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        self.started = time.perf_counter()
        return self

    def close(self) -> None:
        """The end of the window: every unit of work it started has run."""
        if self.ended is not None:
            return
        sync(self.device)
        self.ended = time.perf_counter()
        if self._prof is not None:
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            fd, path = tempfile.mkstemp(prefix="cellbench_trace_", suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                self.trace = reduce_trace(read_trace_file(path))
            finally:
                os.unlink(path)
            self._prof = None

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        elif self._prof is not None:
            self._span.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return self.ended - self.started
