"""Resilience layer: ONE policy engine for retries, circuit breaking and
admission control across the whole stack.

Before this module every failure-handling path was ad-hoc: meta/client.py
hand-rolled commit retries with unseeded ``random.uniform`` sleeps,
compaction used a bare 3-attempt loop, the page cache hardcoded a 30 s
readahead backoff, and the storage proxy invented its own down-marking —
while the serving surfaces had no admission control and would collapse
rather than shed load.  Transient-fault absorption and bounded-queue load
shedding are first-class runtime concerns (arxiv 2604.21275, 2512.02862),
so they live here, next to the worker pool and the staged pipelines, and
every call site routes through the same three primitives:

- :func:`is_transient` — the error taxonomy layered onto ``errors.py``:
  transient failures (network blips, 5xx-shaped ``OSError``, commit races,
  injected chaos) are retryable; permanent ones (config, auth, not-found,
  programming errors) never are.
- :class:`RetryPolicy` — exponential backoff with *seeded* jitter: by
  default the seed mixes in process/thread identity so competing retriers
  decorrelate, while ``LAKESOUL_RETRY_SEED`` pins the whole schedule so a
  chaos run reproduces exactly (either way the determinism lint stays
  clean — no wall clock, no global RNG).  Plus per-attempt and total
  deadlines, and the obs counters ``lakesoul_retry_attempts_total`` /
  ``lakesoul_retry_exhausted_total`` labeled by call site.
- :class:`CircuitBreaker` — closed/open/half-open with the
  ``lakesoul_circuit_state`` gauge; protects callers from queueing behind
  a dead dependency.
- :class:`AdmissionController` — bounded in-flight + bounded wait queue;
  beyond both, requests get a typed :class:`OverloadedError` immediately
  (mapped to Flight UNAVAILABLE by the gateways) instead of growing an
  unbounded backlog.

Every ``for attempt in range(...)`` retry loop outside this module is a
lint finding (``ad-hoc-retry``): new retry behavior is added by
configuring a policy, not by writing another loop.

Env knobs (README table): ``LAKESOUL_RETRY_MAX_ATTEMPTS``,
``LAKESOUL_RETRY_BASE_S``, ``LAKESOUL_RETRY_CAP_S``,
``LAKESOUL_RETRY_SEED``, ``LAKESOUL_RETRY_READAHEAD_BACKOFF_S``,
``LAKESOUL_RETRY_DOWN_S``, ``LAKESOUL_ADMISSION_MAX_INFLIGHT``,
``LAKESOUL_ADMISSION_MAX_QUEUE``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field, replace

from lakesoul_tpu_torch.errors import (
    CircuitOpenError,
    CommitConflictError,
    ConfigError,
    MetadataError,
    OverloadedError,
    RBACError,
    TransientError,
)
from lakesoul_tpu_torch.runtime.faults import FaultInjected

__all__ = [
    "is_transient",
    "RetryPolicy",
    "CircuitBreaker",
    "AdmissionController",
    "default_retry_down_s",
    "default_readahead_backoff_s",
]

logger = logging.getLogger(__name__)

ENV_MAX_ATTEMPTS = "LAKESOUL_RETRY_MAX_ATTEMPTS"
ENV_BASE_S = "LAKESOUL_RETRY_BASE_S"
ENV_CAP_S = "LAKESOUL_RETRY_CAP_S"
ENV_SEED = "LAKESOUL_RETRY_SEED"
ENV_READAHEAD_BACKOFF_S = "LAKESOUL_RETRY_READAHEAD_BACKOFF_S"
ENV_DOWN_S = "LAKESOUL_RETRY_DOWN_S"
ENV_ADMISSION_MAX_INFLIGHT = "LAKESOUL_ADMISSION_MAX_INFLIGHT"
ENV_ADMISSION_MAX_QUEUE = "LAKESOUL_ADMISSION_MAX_QUEUE"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def default_retry_down_s() -> float:
    """How long a failed proxy backend stays circuit-broken before a
    half-open probe (``LAKESOUL_RETRY_DOWN_S``, default 10 s)."""
    return _env_float(ENV_DOWN_S, 10.0)


def default_readahead_backoff_s() -> float:
    """Per-object breather after a failed page-cache readahead fetch
    (``LAKESOUL_RETRY_READAHEAD_BACKOFF_S``, default 30 s — previously a
    hardcoded constant in io/page_cache.py)."""
    return _env_float(ENV_READAHEAD_BACKOFF_S, 30.0)


# ------------------------------------------------------------------ taxonomy

# LakeSoul errors that are definitively NOT worth a retry: the same call
# will fail the same way until a human or a code path changes something.
_PERMANENT_LAKESOUL = (ConfigError, RBACError)

# stdlib families that mean "the input/program is wrong", not "the world
# hiccuped".  FileNotFoundError/PermissionError subclass OSError and must be
# carved out BEFORE the OSError-is-transient default below.
_PERMANENT_STDLIB = (
    FileNotFoundError,
    PermissionError,
    NotADirectoryError,
    IsADirectoryError,
    ValueError,
    TypeError,
    KeyError,
    NotImplementedError,
)


def is_transient(exc: BaseException) -> bool:
    """The repo-wide transient-vs-permanent taxonomy.

    Transient: anything deriving from :class:`TransientError` (the typed
    opt-in), injected chaos faults, commit races (the optimistic protocol's
    designed-for conflict), and network/IO-shaped ``OSError``/timeouts —
    EXCEPT the not-found/permission/denied family, which no retry fixes.
    Everything else is permanent."""
    if isinstance(exc, CircuitOpenError):
        # the breaker exists to STOP traffic; retrying through it defeats it
        return False
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, FaultInjected):
        return True  # chaos faults model transient infrastructure failure
    if isinstance(exc, CommitConflictError):
        return True  # loser of an optimistic race retries on the new head
    if isinstance(exc, _PERMANENT_LAKESOUL):
        return False
    if isinstance(exc, MetadataError):
        return False  # schema/DAO shape problems don't clear on their own
    if isinstance(exc, _PERMANENT_STDLIB):
        return False
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return True
    return False


# -------------------------------------------------------------------- retry


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic seeded jitter.

    The jitter stream is a seeded ``random.Random`` instance (never the
    global RNG, so the stage-nondeterminism lint needs no pragma).  With
    the default ``seed=None`` the stream is seeded per (pid, thread) —
    competing writers that lose the same optimistic race spread out
    instead of retrying in lockstep; with an explicit seed (or
    ``LAKESOUL_RETRY_SEED``) the whole sleep schedule reproduces exactly
    for chaos runs.  ``classify`` decides which exceptions are worth
    another attempt (default: :func:`is_transient`).

    Deadlines: ``total_deadline_s`` bounds the whole retried call — a sleep
    that would cross it is skipped and the last error raised instead.
    ``attempt_timeout_s`` is the per-attempt budget, passed to the callable
    when it declares a ``timeout`` keyword (socket-level calls map it onto
    their connect/read timeouts); callables without one simply aren't
    per-attempt interruptible, which Python threads cannot do generically.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # fraction of each delay added as seeded jitter
    total_deadline_s: float | None = None
    attempt_timeout_s: float | None = None
    # None = decorrelate: jitter seeded per (pid, thread) so two writers
    # losing the same optimistic race never back off in lockstep (still
    # deterministic WITHIN a thread).  An explicit int — or
    # LAKESOUL_RETRY_SEED — pins the full schedule for chaos reproduction.
    seed: int | None = None
    classify: "staticmethod | object" = field(default=is_transient)

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        """Policy with the ``LAKESOUL_RETRY_*`` env family as defaults;
        keyword overrides win (call sites pin what must not drift)."""
        raw_seed = os.environ.get(ENV_SEED, "").strip()
        base = cls(
            max_attempts=max(1, _env_int(ENV_MAX_ATTEMPTS, cls.max_attempts)),
            base_delay_s=_env_float(ENV_BASE_S, cls.base_delay_s),
            max_delay_s=_env_float(ENV_CAP_S, cls.max_delay_s),
            seed=_env_int(ENV_SEED, 0) if raw_seed else None,
        )
        return replace(base, **overrides) if overrides else base

    def delays(self) -> list[float]:
        """The full backoff schedule (len == max_attempts - 1).  Seeded
        policies derive it deterministically from the seed alone; the
        decorrelating default (``seed=None``) mixes in process and thread
        identity so concurrent retriers spread out instead of colliding
        again on every attempt."""
        if self.seed is None:
            # golden-ratio mix keeps distinct (pid, thread) pairs from
            # colliding in the low bits
            rng = random.Random(os.getpid() * 0x9E3779B1 + threading.get_ident())
        else:
            rng = random.Random(self.seed)
        out = []
        for i in range(max(0, self.max_attempts - 1)):
            delay = min(self.max_delay_s, self.base_delay_s * self.multiplier**i)
            out.append(delay * (1.0 + self.jitter * rng.random()))
        return out

    def run(self, fn, *, op: str, on_retry=None, sleep=time.sleep):
        """Call ``fn`` under this policy.  ``op`` labels the obs counters
        (``lakesoul_retry_attempts_total{op=...}`` counts failed attempts,
        ``lakesoul_retry_exhausted_total{op=...}`` counts give-ups); it must
        be low-cardinality (a call-site name, never a path).  ``on_retry``
        is called as ``on_retry(attempt_no, exc)`` before each backoff
        sleep.  On exhaustion the LAST error is re-raised, so callers keep
        their native exception types."""
        from lakesoul_tpu_torch.obs import registry

        classify = self.classify
        started = time.monotonic()
        delays = self.delays()
        last: BaseException | None = None
        # THE one sanctioned retry loop; everywhere else this shape is an
        # ad-hoc-retry lint finding
        for attempt in range(1, self.max_attempts + 1):
            try:
                if self.attempt_timeout_s is not None:
                    return fn(timeout=self.attempt_timeout_s)
                return fn()
            except BaseException as e:  # noqa: BLE001 — classify() filters
                if not classify(e):
                    raise
                last = e
                registry().counter("lakesoul_retry_attempts_total", op=op).inc()
                if attempt >= self.max_attempts:
                    break
                delay = delays[attempt - 1]
                if (
                    self.total_deadline_s is not None
                    and time.monotonic() - started + delay > self.total_deadline_s
                ):
                    logger.warning(
                        "%s: total deadline %.2fs would pass during backoff;"
                        " giving up after attempt %d (%s)",
                        op, self.total_deadline_s, attempt, e,
                    )
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                logger.debug(
                    "%s: transient failure on attempt %d/%d (%s); backing off %.3fs",
                    op, attempt, self.max_attempts, e, delay,
                )
                sleep(delay)
        registry().counter("lakesoul_retry_exhausted_total", op=op).inc()
        logger.warning("%s: retries exhausted after %d attempts: %s",
                       op, self.max_attempts, last)
        assert last is not None
        raise last


# ------------------------------------------------------------------ breaker


class CircuitBreaker:
    """Closed → open → half-open circuit around one dependency.

    ``failure_threshold`` consecutive failures open the circuit; while open
    every :meth:`allow`/:meth:`call` fails fast.  After ``reset_timeout_s``
    the breaker lets ``half_open_max_calls`` probes through (half-open); a
    probe success closes it, a probe failure re-opens it for another
    timeout.  State is published to ``lakesoul_circuit_state{circuit=...}``
    (0 closed / 1 open / 2 half-open) when ``name`` is given — pass
    ``name=None`` for per-IP breakers whose owner aggregates state itself
    (label cardinality must stay bounded)."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(
        self,
        name: str | None = None,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float | None = None,
        half_open_max_calls: int = 1,
        clock=time.monotonic,
    ):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = (
            default_retry_down_s() if reset_timeout_s is None else float(reset_timeout_s)
        )
        self.half_open_max_calls = max(1, int(half_open_max_calls))
        self._clock = clock
        self._state_guard = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._publish(self.CLOSED)

    def _publish(self, state: int) -> None:
        if self.name is None:
            return
        from lakesoul_tpu_torch.obs import registry

        registry().gauge("lakesoul_circuit_state", circuit=self.name).set(state)

    def _set_state(self, state: int) -> None:
        if state != self._state:
            logger.info("circuit %s: %s -> %s",
                        self.name or "<anon>", self._state, state)
        self._state = state
        self._publish(state)

    @property
    def state(self) -> int:
        with self._state_guard:
            self._maybe_half_open()
            return self._state

    def open_until(self) -> float | None:
        """Clock value at which an OPEN circuit starts half-open probing;
        None when not open (owners expose "down until" views from this)."""
        with self._state_guard:
            self._maybe_half_open()
            if self._state == self.OPEN:
                return self._opened_at + self.reset_timeout_s
            return None

    def _maybe_half_open(self) -> None:
        if (
            self._state == self.OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._set_state(self.HALF_OPEN)
            self._half_open_inflight = 0

    def allow(self) -> bool:
        """Whether a call may proceed right now (half-open admits at most
        ``half_open_max_calls`` concurrent probes)."""
        with self._state_guard:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                if self._half_open_inflight < self.half_open_max_calls:
                    self._half_open_inflight += 1
                    return True
            return False

    def record_success(self) -> None:
        with self._state_guard:
            self._failures = 0
            if self._state != self.CLOSED:
                self._set_state(self.CLOSED)
            self._half_open_inflight = 0

    def record_failure(self) -> None:
        with self._state_guard:
            self._failures += 1
            if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._set_state(self.OPEN)
                self._half_open_inflight = 0

    def call(self, fn):
        """Run ``fn`` through the breaker: :class:`CircuitOpenError` when
        open, success/failure recorded otherwise."""
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name or '<anon>'} is open"
                f" (retry after {self.reset_timeout_s:.0f}s)"
            )
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


# ---------------------------------------------------------------- admission


class AdmissionController:
    """Bounded in-flight + bounded wait queue for a serving surface.

    ``max_inflight`` requests run concurrently; up to ``max_queue`` more
    wait (at most ``queue_timeout_s``).  Anything beyond both bounds — or a
    wait that times out — gets a typed :class:`OverloadedError`
    immediately: memory stays bounded and clients see a retryable signal
    (the gateways map it to Flight UNAVAILABLE) instead of a stalled
    connection.  Obs series, labeled ``gate=<name>``:
    ``lakesoul_admission_inflight`` / ``lakesoul_admission_queue_depth``
    gauges, ``lakesoul_admission_rejected_total`` counter and the
    ``lakesoul_admission_wait_seconds`` queue-wait histogram."""

    def __init__(
        self,
        name: str,
        *,
        max_inflight: int | None = None,
        max_queue: int | None = None,
        queue_timeout_s: float = 5.0,
    ):
        from lakesoul_tpu_torch.obs import registry

        self.name = name
        self.max_inflight = max(
            1,
            _env_int(ENV_ADMISSION_MAX_INFLIGHT, 64)
            if max_inflight is None else int(max_inflight),
        )
        self.max_queue = max(
            0,
            _env_int(ENV_ADMISSION_MAX_QUEUE, 256)
            if max_queue is None else int(max_queue),
        )
        self.queue_timeout_s = float(queue_timeout_s)
        self._slots = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        reg = registry()
        self._g_inflight = reg.gauge("lakesoul_admission_inflight", gate=name)
        self._g_queue = reg.gauge("lakesoul_admission_queue_depth", gate=name)
        self._c_rejected = reg.counter("lakesoul_admission_rejected_total", gate=name)
        self._h_wait = reg.histogram("lakesoul_admission_wait_seconds", gate=name)

    def acquire(self) -> None:
        """Take one slot or raise :class:`OverloadedError` (full queue, or
        queue wait past ``queue_timeout_s``)."""
        started = time.monotonic()
        with self._slots:
            # fast path only when nobody is queued: a fresh arrival must not
            # barge past waiters onto a just-released slot (the Condition
            # wakes waiters in wait order, so the queue drains ~FIFO and a
            # waiter can't be starved into a spurious timeout shed)
            if self._inflight < self.max_inflight and self._waiting == 0:
                self._inflight += 1
                self._g_inflight.inc()
                self._h_wait.observe(0.0)
                return
            if self._waiting >= self.max_queue:
                self._c_rejected.inc()
                raise OverloadedError(
                    f"{self.name}: overloaded ({self._inflight} in flight,"
                    f" queue of {self.max_queue} full); retry later"
                )
            self._waiting += 1
            self._g_queue.inc()
            try:
                deadline = started + self.queue_timeout_s
                while self._inflight >= self.max_inflight:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._c_rejected.inc()
                        raise OverloadedError(
                            f"{self.name}: overloaded (queued"
                            f" {self.queue_timeout_s:.1f}s without a slot);"
                            " retry later"
                        )
                    self._slots.wait(left)
                self._inflight += 1
                self._g_inflight.inc()
            finally:
                self._waiting -= 1
                self._g_queue.dec()
        self._h_wait.observe(time.monotonic() - started)

    def release(self) -> None:
        with self._slots:
            self._inflight -= 1
            self._g_inflight.dec()
            self._slots.notify()

    @contextlib.contextmanager
    def admit(self):
        """``with gate.admit():`` — acquire on entry (raising
        :class:`OverloadedError` when shedding), always release."""
        self.acquire()
        try:
            yield
        finally:
            self.release()

    def snapshot(self) -> dict:
        with self._slots:
            return {
                "inflight": self._inflight,
                "waiting": self._waiting,
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
            }
