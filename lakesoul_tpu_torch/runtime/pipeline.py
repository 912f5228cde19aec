"""Staged execution pipelines: bounded, ordered, cancellable, observable.

The one pipelined-execution shape every hot path shares (the Deep Lake /
distributed-dataloader loader architecture): a source feeds stages —
serial ``map``, ordered ``map_parallel`` / ``flat_map_parallel`` fan-out on
the process :mod:`pool <lakesoul_tpu_torch.runtime.pool>`, and ``prefetch``
(a background pump with a bounded hand-off queue) — and the consumer pulls
results.  Guarantees:

- **Deterministic order.**  Parallel stages complete out of order but emit
  in SOURCE order (results are consumed in submission order), so a
  pipelined scan is byte-identical to the serial one.
- **Backpressure.**  Every buffer is bounded (``workers + 1`` in-flight
  items per parallel stage, ``buffer`` batches per flat-map slot,
  ``depth`` for prefetch); a slow consumer stalls the producer instead of
  ballooning memory.
- **Exception propagation.**  A stage failure cancels the pipeline and
  re-raises at the consumer; the failure is logged once WITH the
  pipeline's trace id, so a dead loader names the scan that killed it.
- **Cooperative cancellation.**  ``close()`` (or abandoning the iterator)
  stops producers promptly — no daemon thread keeps decoding into a queue
  nobody reads.
- **Deadlines.**  ``deadline_s`` bounds the WHOLE run; any wait past it
  raises :class:`DeadlineExceeded` and cancels the pipeline.
- **Fault injection.**  Every stage calls
  :func:`lakesoul_tpu_torch.runtime.faults.maybe_inject` with its qualified
  name, so ``LAKESOUL_FAULTS=stage:p`` can kill or delay any stage.

Observability: ``lakesoul_runtime_stage_seconds{pipeline=,stage=}`` per-item
stage latency and ``lakesoul_runtime_queue_depth{pipeline=,stage=}`` live
buffer depth, both in the shared obs registry.

Usage::

    from lakesoul_tpu_torch.runtime import pipeline

    it = (pipeline("scan")
          .source(units)
          .flat_map_parallel(decode_unit, workers=4, name="decode")
          .prefetch(4)
          .run())
    for batch in it:
        ...
    it.close()   # implicit on exhaustion / GC, explicit on early exit
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as _FutTimeout
from concurrent.futures import wait as _futwait
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

from lakesoul_tpu_torch.errors import LakeSoulError
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.obs.tracing import current_trace_id, new_trace_id
from lakesoul_tpu_torch.runtime import faults
from lakesoul_tpu_torch.runtime.pool import get_pool

__all__ = ["Pipeline", "PipelineIterator", "pipeline", "DeadlineExceeded", "PipelineCancelled"]

logger = logging.getLogger(__name__)

_DONE = object()
_POLL_S = 0.05  # cancellation latency bound for blocking waits


class DeadlineExceeded(LakeSoulError):
    """The pipeline's ``deadline_s`` elapsed before it finished."""


class PipelineCancelled(LakeSoulError):
    """Work skipped because the pipeline was cancelled (internal — consumers
    normally see the ORIGINAL error or their own close, not this)."""


@dataclass
class _Stage:
    kind: str  # map | map_parallel | flat_map_parallel | prefetch
    name: str
    fn: Callable | None = None
    workers: int = 0
    buffer: int = 4
    depth: int = 2
    queue: Any = field(default=None, repr=False)


class Pipeline:
    """Builder — stages appended left to right, executed lazily by
    :meth:`run`.  Builder methods return ``self`` (chainable)."""

    def __init__(self, name: str, *, deadline_s: float | None = None):
        self.name = name
        self.deadline_s = deadline_s
        self._source: Iterable | None = None
        self._stages: list[_Stage] = []

    # --------------------------------------------------------------- builder
    def source(self, iterable: Iterable) -> "Pipeline":
        self._source = iterable
        return self

    def map(self, fn: Callable, *, name: str | None = None) -> "Pipeline":
        """Serial transform in the consuming thread (cheap glue: collate,
        postprocess)."""
        self._stages.append(_Stage("map", name or f"map{len(self._stages)}", fn))
        return self

    def map_parallel(
        self, fn: Callable, *, workers: int | None = None, name: str | None = None
    ) -> "Pipeline":
        """Ordered parallel map on the process pool: up to ``workers + 1``
        items in flight, results emitted in source order."""
        self._stages.append(_Stage(
            "map_parallel", name or f"pmap{len(self._stages)}", fn,
            workers=self._workers(workers),
        ))
        return self

    def flat_map_parallel(
        self,
        fn: Callable[[Any], Iterable],
        *,
        workers: int | None = None,
        buffer: int = 4,
        name: str | None = None,
    ) -> "Pipeline":
        """Ordered parallel flat-map: ``fn(item)`` yields a STREAM of
        outputs; each in-flight item streams through its own bounded
        ``buffer``-slot queue (an item's output is never materialized
        whole), and outputs flatten in source order."""
        self._stages.append(_Stage(
            "flat_map_parallel", name or f"pflat{len(self._stages)}", fn,
            workers=self._workers(workers), buffer=max(1, buffer),
        ))
        return self

    def prefetch(self, depth: int = 2, *, name: str = "prefetch") -> "Pipeline":
        """Run everything upstream on a background pump thread feeding a
        bounded ``depth`` queue — decode-ahead for a consumer that
        alternates compute with pulling (the loader's host pipeline)."""
        self._stages.append(_Stage("prefetch", name, depth=max(1, depth)))
        return self

    @staticmethod
    def _workers(workers: int | None) -> int:
        return get_pool().size if workers is None else max(1, int(workers))

    # ------------------------------------------------------------------- run
    def run(self) -> "PipelineIterator":
        if self._source is None:
            raise LakeSoulError(f"pipeline {self.name!r} has no source")
        return PipelineIterator(self)

    def __iter__(self) -> Iterator:
        return iter(self.run())


def pipeline(name: str, *, deadline_s: float | None = None) -> Pipeline:
    """Start a staged pipeline (see module docstring)."""
    return Pipeline(name, deadline_s=deadline_s)


class PipelineIterator:
    """Executing pipeline: an iterator plus ``close()``/``stats()``.

    Exhausting it, closing it, or dropping it (GC) releases every producer;
    ``close()`` is idempotent and joins background pumps."""

    def __init__(self, p: Pipeline):
        self._name = p.name
        self._deadline = (
            time.monotonic() + p.deadline_s if p.deadline_s is not None else None
        )
        self._cancel = threading.Event()
        self._first_error: BaseException | None = None
        self._threads: list[threading.Thread] = []
        self._consumer_gens: list = []  # closed by close(); pump-owned gens excluded
        self._prefetch_queues: list[_queue.Queue] = []
        self._error_logged = False
        self._lock = threading.Lock()
        # the pipeline belongs to the trace that started it: a failure log
        # names this id even when the failing stage ran on a pool thread
        # (contextvars don't cross thread submits)
        self.trace_id = current_trace_id() or new_trace_id()

        gen: Iterable = iter(p._source)
        if hasattr(gen, "close"):
            # the source's own cleanup (e.g. a scan generator's finallys)
            # must run on close(), not whenever GC gets to the frame
            self._consumer_gens.append(gen)
        for st in p._stages:
            builder = {
                "map": self._gen_map,
                "map_parallel": self._gen_map_parallel,
                "flat_map_parallel": self._gen_flat_map,
                "prefetch": self._gen_prefetch,
            }[st.kind]
            gen = builder(gen, st)
            if st.kind == "prefetch":
                # everything upstream is now owned (iterated AND closed) by
                # the pump thread; the consumer must not touch those
                # generators from another thread
                self._consumer_gens = [gen]
            else:
                self._consumer_gens.append(gen)
        self._out = gen

    # ------------------------------------------------------------- obs utils
    def _stage_metrics(self, st: _Stage):
        reg = registry()
        hist = reg.histogram(
            "lakesoul_runtime_stage_seconds", pipeline=self._name, stage=st.name
        )
        depth = reg.gauge(
            "lakesoul_runtime_queue_depth", pipeline=self._name, stage=st.name
        )
        return hist, depth

    def _qual(self, st: _Stage) -> str:
        return f"{self._name}.{st.name}"

    # ------------------------------------------------------- waiting helpers
    def _remaining(self) -> float | None:
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    def _check_deadline(self) -> None:
        left = self._remaining()
        if left is not None and left <= 0:
            self._cancel.set()
            raise DeadlineExceeded(
                f"pipeline {self._name!r} exceeded its deadline"
            )

    def _poll(self) -> float:
        left = self._remaining()
        return _POLL_S if left is None else max(0.0, min(_POLL_S, left))

    def _q_put(self, q: _queue.Queue, item) -> bool:
        """Producer-side put honoring cancellation; False = pipeline gone."""
        while not self._cancel.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except _queue.Full:
                continue
        return False

    def _q_get(self, q: _queue.Queue):
        while True:
            try:
                return q.get(timeout=self._poll())
            except _queue.Empty:
                self._check_deadline()
                if self._cancel.is_set():
                    # surface the ORIGINAL failure, not an opaque
                    # cancellation, when a stage error triggered the cancel
                    # (its queue hand-off may have been refused)
                    err = self._first_error
                    if err is not None:
                        raise err
                    raise PipelineCancelled(f"pipeline {self._name!r} cancelled")

    def _await_future(self, f):
        while True:
            try:
                return f.result(timeout=self._poll())
            except _FutTimeout:
                self._check_deadline()

    def _raise_stage_error(self, st: _Stage, exc: BaseException):
        """First failure wins: record it, log it with the trace id, cancel
        everything, re-raise for the consumer.  The error is stashed BEFORE
        the cancel flag is set, so a consumer woken by the cancel always
        finds the real failure (never a bare PipelineCancelled)."""
        if not isinstance(exc, (PipelineCancelled, CancelledError, GeneratorExit)):
            with self._lock:
                first = not self._error_logged
                self._error_logged = True
                if self._first_error is None:
                    self._first_error = exc
            if first:
                logger.error(
                    "pipeline %s stage %s failed: %s: %s (trace_id=%s)",
                    self._name, st.name, type(exc).__name__, exc, self.trace_id,
                )
        self._cancel.set()
        raise exc

    # ---------------------------------------------------------------- stages
    def _run_item(self, st: _Stage, hist, item):
        """One unit of stage work (worker thread or inline): deadline +
        cancellation check, fault hook, user fn, latency observation."""
        self._check_deadline()  # deadline_s bounds the WHOLE run, serial
        # stages included — not just the queue/future waits
        if self._cancel.is_set():
            raise PipelineCancelled(f"pipeline {self._name!r} cancelled")
        started = time.perf_counter()
        faults.maybe_inject(self._qual(st))
        out = st.fn(item)
        hist.observe(time.perf_counter() - started)
        return out

    def _gen_map(self, upstream, st: _Stage):
        hist, _ = self._stage_metrics(st)
        for item in upstream:
            try:
                yield self._run_item(st, hist, item)
            except BaseException as e:
                self._raise_stage_error(st, e)

    def _gen_map_parallel(self, upstream, st: _Stage):
        pool = get_pool()
        hist, depth = self._stage_metrics(st)
        if pool.in_worker() or pool.size <= 1:
            # nested parallelism would deadlock a saturated pool — run inline
            yield from self._gen_map(upstream, st)
            return
        inflight = st.workers + 1
        # bounded by the `len(futs) < inflight` admission gate below
        futs: deque = deque()  # lakelint: ignore[unbounded-queue] inflight-windowed
        it = iter(upstream)
        exhausted = False
        try:
            while True:
                while not exhausted and len(futs) < inflight:
                    if self._cancel.is_set():
                        exhausted = True
                        break
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    futs.append(pool.submit(self._run_item, st, hist, item))
                    depth.inc()
                if not futs:
                    return
                f = futs.popleft()
                depth.dec()
                try:
                    yield self._await_future(f)
                except BaseException as e:
                    self._raise_stage_error(st, e)
        finally:
            if futs or not exhausted:
                self._cancel.set()
            for f in futs:
                f.cancel()
            if futs:
                # cancel() can't stop a RUNNING task: quiesce so no decode
                # outlives the pipeline and races whatever the caller does
                # next (cancel is set, so queued-but-started tasks bail at
                # their first check; only genuinely in-flight fns ride out)
                _futwait(list(futs))
            # delta accounting (shared gauge across concurrent pipelines):
            # release only this run's remaining in-flight window
            depth.dec(len(futs))

    def _gen_flat_map(self, upstream, st: _Stage):
        pool = get_pool()
        hist, depth = self._stage_metrics(st)
        if pool.in_worker() or pool.size <= 1:
            for item in upstream:
                try:
                    self._check_deadline()
                    started = time.perf_counter()
                    if self._cancel.is_set():
                        raise PipelineCancelled(f"pipeline {self._name!r} cancelled")
                    faults.maybe_inject(self._qual(st))
                    sub = iter(st.fn(item))
                except BaseException as e:
                    self._raise_stage_error(st, e)
                # consume explicitly: fn returns a GENERATOR, so failures
                # (and the stage's real latency) surface during iteration,
                # not creation — a bare `yield from` would bypass the
                # logged-once-with-trace-id error contract
                while True:
                    try:
                        out = next(sub)
                    except StopIteration:
                        hist.observe(time.perf_counter() - started)
                        break
                    except BaseException as e:
                        self._raise_stage_error(st, e)
                    yield out
            return

        def produce(item, q: _queue.Queue):
            try:
                started = time.perf_counter()
                if self._cancel.is_set():
                    raise PipelineCancelled(f"pipeline {self._name!r} cancelled")
                faults.maybe_inject(self._qual(st))
                for out in st.fn(item):
                    if not self._q_put(q, out):
                        return
                hist.observe(time.perf_counter() - started)
                self._q_put(q, _DONE)
            except BaseException as e:  # surfaced to the consumer in order
                self._q_put(q, e)

        it = iter(upstream)
        # bounded window of per-item output queues (spawn() admission gate)
        slots: deque = deque()  # lakelint: ignore[unbounded-queue] spawn-windowed
        exhausted = False

        def spawn() -> bool:
            nonlocal exhausted
            if exhausted or self._cancel.is_set():
                return False
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                return False
            q: _queue.Queue = _queue.Queue(maxsize=st.buffer)
            slots.append(q)
            # slot streamers are consumer-paced (they park on the bounded
            # queue whenever the consumer is slower), so they run as
            # dedicated pump threads, NOT pool tasks: a blocked producer
            # holding a shared pool worker would let one slow training
            # loop starve every other pipeline in the process.  The pool
            # is reserved for runnable work (map_parallel items).
            t = threading.Thread(  # lakelint: ignore[raw-thread] consumer-paced slot pump; a parked pool worker would starve other pipelines
                target=produce, args=(item, q),
                daemon=True, name=f"{self._name}-{st.name}-slot",
            )
            # under a downstream prefetch this generator body runs on the
            # pump thread while close() reads _threads from the consumer —
            # every _threads mutation holds _lock (racecheck-proven)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()
            depth.inc()
            return True

        try:
            for _ in range(st.workers + 1):
                if not spawn():
                    break
            while slots:
                q = slots.popleft()
                depth.dec()
                while True:
                    got = self._q_get(q)
                    if got is _DONE:
                        break
                    if isinstance(got, BaseException):
                        self._raise_stage_error(st, got)
                    yield got
                spawn()
        finally:
            if slots or not exhausted:
                self._cancel.set()
            # delta accounting: release only OUR remaining window, never
            # another concurrent pipeline's contribution to the shared gauge
            depth.dec(len(slots))

    def _gen_prefetch(self, upstream, st: _Stage):
        # NOT a generator: the pump thread starts EAGERLY at build time, so
        # decode-ahead begins before the consumer's first pull (k pipelines
        # built together prime concurrently — the MOR merger's k file
        # streams rely on this)
        hist, depth = self._stage_metrics(st)
        q: _queue.Queue = _queue.Queue(maxsize=st.depth)
        st.queue = q
        with self._lock:
            self._prefetch_queues.append((q, depth))
        owned = list(self._consumer_gens)  # the pump now owns the upstream chain

        def pump():
            try:
                try:
                    started = time.perf_counter()
                    for item in upstream:
                        hist.observe(time.perf_counter() - started)
                        if not self._q_put(q, item):
                            return
                        depth.inc()
                        started = time.perf_counter()
                    self._q_put(q, _DONE)
                finally:
                    # run upstream finallys (cancel futures, stop producers)
                    # HERE, on the thread that iterated them
                    for g in reversed(owned):
                        close = getattr(g, "close", None)
                        if close is not None:
                            try:
                                close()
                            except Exception:
                                pass
            except BaseException as e:
                # stash the error BEFORE the queue hand-off: if the
                # pipeline is already cancelled, _q_put refuses and the
                # consumer recovers the original failure from _first_error
                with self._lock:
                    if self._first_error is None:
                        self._first_error = e
                self._q_put(q, e)

        t = threading.Thread(  # lakelint: ignore[raw-thread] prefetch pump parks on a bounded queue; pool workers are reserved for runnable work
            target=pump, daemon=True, name=f"{self._name}-{st.name}"
        )
        with self._lock:
            self._threads.append(t)
        t.start()
        return self._drain_prefetch(q, st, depth)

    def _drain_prefetch(self, q: _queue.Queue, st: _Stage, depth):
        while True:
            try:
                got = self._q_get(q)
            except BaseException:
                self._cancel.set()
                raise
            if got is _DONE:
                return
            if isinstance(got, BaseException):
                self._raise_stage_error(st, got)
            depth.dec()
            yield got

    # -------------------------------------------------------------- iterator
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return next(self._out)

    def queue_depth(self) -> int:
        """Items buffered in the (last) prefetch stage — the loader's
        producer-queue depth."""
        if not self._prefetch_queues:
            return 0
        return self._prefetch_queues[-1][0].qsize()

    def close(self, join_timeout: float = 60.0) -> None:
        """Cancel producers, close stage generators, join pump threads.
        Idempotent; bounded by ``join_timeout`` per thread (a decode already
        in flight is allowed to finish)."""
        self._cancel.set()
        for g in reversed(self._consumer_gens):
            close = getattr(g, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        # snapshot under _lock (slot pumps mutate _threads/_prefetch_queues
        # from their own threads), join OUTSIDE it — joining under the lock
        # would be the lock-held-call deadlock shape
        with self._lock:
            threads = list(self._threads)
            queues, self._prefetch_queues = self._prefetch_queues, []
        for t in threads:
            t.join(timeout=join_timeout)
        # reconcile this run's leftover contribution to the shared
        # queue-depth gauges: items the pump enqueued but nobody consumed
        for q, depth in queues:
            while True:
                try:
                    got = q.get_nowait()
                except _queue.Empty:
                    break
                if got is not _DONE and not isinstance(got, BaseException):
                    depth.dec()

    def __del__(self):  # abandoned iterator: stop producers, don't join
        try:
            self._cancel.set()
        except Exception:
            pass
