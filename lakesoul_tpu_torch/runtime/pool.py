"""Process-wide worker pool — THE thread substrate for every hot path.

One sized, lazily-spawned, fork-safe thread pool per process replaces the
ad-hoc ``ThreadPoolExecutor``/``threading.Thread`` instances that used to be
scattered across io, data, sql, and compaction.  Sharing one pool means:

- the host's parallelism budget is a single knob (``LAKESOUL_RUNTIME_THREADS``)
  instead of N layers each spawning their own threads and oversubscribing
  the cores that the JAX host step needs;
- pool pressure is observable in one place (``lakesoul_runtime_*`` series);
- after ``os.fork()`` the child gets a FRESH pool on first use — worker
  threads do not survive a fork, so a pool inherited by reference would
  accept work that no thread will ever run (a classic multiprocessing hang).

Nested-parallelism contract: work running ON a pool thread must never block
on more pool work (all workers could end up waiting on tasks that need a
worker — deadlock).  Stages check :meth:`WorkerPool.in_worker` and fall back
to inline execution; that keeps one level of parallelism, which is the right
amount on a shared pool.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from lakesoul_tpu_torch.obs import registry

__all__ = ["WorkerPool", "get_pool", "shutdown_pool", "default_pool_size"]

_ENV_THREADS = "LAKESOUL_RUNTIME_THREADS"


def default_pool_size() -> int:
    """``LAKESOUL_RUNTIME_THREADS`` when set, else cpu count (min 2 so a
    prefetch stage and a decode stage can always overlap, capped at 32 —
    beyond that object-store fan-out wants multi-host sharding, not more
    threads in one process)."""
    raw = os.environ.get(_ENV_THREADS, "").strip()
    if raw:
        try:
            n = int(raw)
        except ValueError:
            n = 0
        if n > 0:
            return min(n, 128)
    return max(2, min(os.cpu_count() or 2, 32))


class WorkerPool:
    """Instrumented thread pool (thin, deliberately `concurrent.futures`
    shaped).  Workers spawn lazily on first submit; ``in_worker()`` is true
    on pool threads so callers can avoid nested blocking submits."""

    # the default worker-thread name prefix is a contract: the process-wide
    # pool outlives every test/scope by design, so leakcheck exempts threads
    # named "lakesoul-rt*" — a renamed pool loses that sanction
    def __init__(self, size: int | None = None, *, name: str = "lakesoul-rt"):
        self.size = size or default_pool_size()
        self.name = name
        self._lock = threading.Lock()
        self._executor: ThreadPoolExecutor | None = None
        self._local = threading.local()
        reg = registry()
        self._m_submitted = reg.counter("lakesoul_runtime_tasks_total")
        self._m_active = reg.gauge("lakesoul_runtime_active_tasks")
        self._g_threads = reg.gauge("lakesoul_runtime_pool_threads")

    # ---------------------------------------------------------------- submit
    def _ensure(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.size, thread_name_prefix=self.name
                )
                self._g_threads.set(self.size)
            return self._executor

    def submit(self, fn, /, *args, **kwargs) -> Future:
        ex = self._ensure()
        self._m_submitted.inc()
        self._m_active.inc()

        def run():
            self._local.in_worker = True
            try:
                return fn(*args, **kwargs)
            finally:
                self._m_active.dec()

        fut = ex.submit(run)

        def _done(f: Future) -> None:
            if f.cancelled():  # never ran: run()'s finally can't balance it
                self._m_active.dec()

        fut.add_done_callback(_done)
        return fut

    def in_worker(self) -> bool:
        """True on a pool thread — callers about to BLOCK on more pool work
        must instead run it inline (see module docstring)."""
        return bool(getattr(self._local, "in_worker", False))

    def active_tasks(self) -> int:
        return self._m_active.value

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=wait, cancel_futures=True)
            self._g_threads.set(0)


_POOL: WorkerPool | None = None
_POOL_LOCK = threading.Lock()


def get_pool() -> WorkerPool:
    """THE process-wide pool (lazily constructed; fresh after fork)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = WorkerPool()
        return _POOL


def shutdown_pool(wait: bool = True) -> None:
    """Tear down the process pool (tests / clean interpreter exit).  The
    next ``get_pool()`` builds a fresh one."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=wait)


def _after_fork_in_child() -> None:
    # worker threads do not survive fork: drop the dead pool without joining
    # (its threads only existed in the parent)
    global _POOL
    _POOL = None
    # the module lock may have been held by another thread at fork time
    global _POOL_LOCK
    _POOL_LOCK = threading.Lock()


if hasattr(os, "register_at_fork"):  # not on every platform
    os.register_at_fork(after_in_child=_after_fork_in_child)
