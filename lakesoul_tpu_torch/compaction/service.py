"""Automatic compaction services (the port's copy of
``lakesoul_tpu/compaction/service.py``).

Role parity with the reference's Spark compaction service
(lakesoul-spark/…/compaction/NewCompactionTask.scala:22-150): it LISTENs for
`lakesoul_compaction_notify` events that the PG trigger emits when a
partition's version gap since the last CompactionCommit reaches the threshold
(meta_init.sql:101-150), hashes the partition onto a worker pool, and runs
the compaction through the normal write path.

Two deployment shapes:

- :class:`CompactionService` — single process: the metadata store fires the
  trigger event synchronously in the committing writer's process
  (SqliteMetadataStore._fire_compaction_triggers); jobs run on the shared
  runtime worker pool, bounded and deduplicated.
- :class:`LeasedCompactionService` — the **multi-process topology**: a
  standalone service process (``python -m lakesoul_tpu_torch.compaction``) that
  discovers work by polling committed-version gaps
  (:class:`~lakesoul_tpu_torch.compaction.events.PollingWatermarkNotifier` — the
  LISTEN/NOTIFY-shaped source, so a PG transport drops in later), takes a
  **per-partition lease** with a TTL and a fencing token
  (``meta/store.py`` lease table) before compacting, and commits with the
  lease as an atomic guard.  A SIGKILLed holder's lease expires after one
  TTL and any peer takes over (``lakesoul_compaction_takeovers_total``);
  the dead holder, were it ever to wake, is fenced at commit time — never
  a double-compaction.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from lakesoul_tpu_torch.errors import CommitConflictError, LeaseFencedError
from lakesoul_tpu_torch.meta.store import CompactionEvent
from lakesoul_tpu_torch.obs import registry, span
from lakesoul_tpu_torch.runtime import get_pool
from lakesoul_tpu_torch.runtime.lease import LeaseHeartbeat

logger = logging.getLogger(__name__)

from lakesoul_tpu_torch.runtime.resilience import _env_float

ENV_LEASE_TTL_S = "LAKESOUL_LEASE_TTL_S"
ENV_POLL_S = "LAKESOUL_COMPACTION_POLL_S"


def needs_compaction(table, partition_desc: str, min_file_num: int) -> bool:
    """Size-tiered gate shared by both services: only compact when some
    bucket stacks at least ``min_file_num`` files (reference: file
    num/size limits in the new-compaction path)."""
    units = table.scan().scan_plan()
    for u in units:
        if u.partition_desc == partition_desc and len(u.data_files) >= min_file_num:
            return True
    return False


def _run_conflict_retried_compaction(
    table, event: CompactionEvent, stats: "CompactionStats", min_file_num: int,
    *, lease=None, pre_attempt=None,
) -> str:
    """THE compaction attempt-loop, shared by the in-process service and the
    leased service so its conflict-retry tuning lives in one place.

    Writers may advance the partition mid-compact; each retry re-reads the
    fresh head, like the reference re-running on the next notify — with
    backoff between attempts (a hot writer gets a beat to finish its burst)
    and a ``lakesoul_retry_exhausted_total{op=compaction.conflict}`` signal
    when the job gives up.  ``pre_attempt`` runs before each try (the leased
    service fences on a lapsed heartbeat there).  Returns the outcome
    counter name; ``"conflicts"`` when retries exhaust."""
    from lakesoul_tpu_torch.meta.client import partition_desc_to_dict
    from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

    parts = partition_desc_to_dict(event.partition_desc) or None

    def attempt() -> str:
        if pre_attempt is not None:
            pre_attempt()
        if not needs_compaction(table, event.partition_desc, min_file_num):
            return "skipped"
        try:
            return "compacted" if table.compact(parts, lease=lease) else "skipped"
        except CommitConflictError:
            stats.bump("conflicts")
            raise

    policy = RetryPolicy.from_env(
        max_attempts=3,
        base_delay_s=0.02,
        max_delay_s=0.25,
        classify=lambda e: isinstance(e, CommitConflictError),
    )
    try:
        return policy.run(attempt, op="compaction.conflict")
    except CommitConflictError:
        logger.info(
            "compaction kept losing races for %s; deferring to a later"
            " poll", event.partition_desc,
        )
        return "conflicts"


@dataclass
class CompactionStats:
    triggered: int = 0
    compacted: int = 0
    skipped: int = 0
    conflicts: int = 0
    errors: int = 0
    # leased-service outcomes
    lease_held: int = 0
    fenced: int = 0
    takeovers: int = 0

    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        # mirrored into the shared registry so one /metrics endpoint covers
        # the compaction service next to streams/cache/loader
        registry().counter("lakesoul_compaction_events_total", kind=name).inc()


class CompactionService:
    """Consume compaction events for one catalog and compact them as jobs on
    the shared runtime pool (at most ``workers`` concurrently).

    Usage::

        svc = CompactionService(catalog, workers=2)
        svc.start()           # subscribes to the store's trigger events
        ...                   # writes keep committing; gaps trigger events
        svc.drain(); svc.stop()
    """

    def __init__(
        self,
        catalog,
        *,
        workers: int = 2,
        min_file_num: int = 2,
        queue_size: int = 256,
        notifier=None,
    ):
        from lakesoul_tpu_torch.compaction.events import StoreTriggerNotifier

        self.catalog = catalog
        self.notifier = notifier or StoreTriggerNotifier(catalog.client.store)
        self.workers = workers
        self.min_file_num = min_file_num
        self.queue_size = queue_size
        self.stats = CompactionStats()
        self._lock = threading.Lock()
        self._pending: list[CompactionEvent] = []
        self._running = 0
        self._in_flight: set[tuple[str, str]] = set()
        self._idle = threading.Condition(self._lock)
        self._stop = threading.Event()
        # updated with inc/dec DELTAS, never set(): several services in one
        # process (one per catalog) then aggregate instead of clobbering
        # each other's snapshots
        reg = registry()
        self._g_pending = reg.gauge("lakesoul_compaction_pending")
        self._g_running = reg.gauge("lakesoul_compaction_running")

    # --------------------------------------------------------------- control
    def start(self) -> None:
        self._stop.clear()
        self.notifier.listen(self._on_event)

    def stop(self, timeout: float = 5.0) -> None:
        """Unsubscribe, drop queued events, wait (bounded) for running jobs."""
        self._stop.set()
        self.notifier.unlisten(self._on_event)
        # monotonic: an NTP step during shutdown must not turn a 5 s grace
        # period into 0 (or an hour) — enforced by the wall-clock-lease lint
        deadline = time.monotonic() + timeout
        with self._idle:
            for ev in self._pending:
                self._in_flight.discard((ev.table_id, ev.partition_desc))
            self._g_pending.dec(len(self._pending))
            self._pending.clear()
            while self._running:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._idle.wait(timeout=left)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until no events are pending and no job is running."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._pending or self._running:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._idle.wait(timeout=min(left, 0.1))

    # ---------------------------------------------------------------- events
    def _on_event(self, event: CompactionEvent) -> None:
        self.stats.bump("triggered")
        key = (event.table_id, event.partition_desc)
        with self._lock:
            if self._stop.is_set():
                return
            if key in self._in_flight:
                return  # already queued/running for this partition
            if len(self._pending) >= self.queue_size:
                logger.warning("compaction queue full; dropping event for %s", key)
                return
            self._in_flight.add(key)
            self._pending.append(event)
            self._g_pending.inc()
        self._pump()

    def _pump(self) -> None:
        """Submit pending events to the pool up to the ``workers`` bound."""
        while True:
            with self._lock:
                if self._stop.is_set() or self._running >= self.workers or not self._pending:
                    return
                event = self._pending.pop(0)
                self._running += 1
                self._g_pending.dec()
                self._g_running.inc()
            get_pool().submit(self._job, event)

    def _job(self, event: CompactionEvent) -> None:
        key = (event.table_id, event.partition_desc)
        try:
            # a job that was queued behind other pool work may only get a
            # worker AFTER stop() — it must not compact against a catalog
            # the caller already tore down
            if not self._stop.is_set():
                self._compact_one(event)
        except Exception:
            self.stats.bump("errors")
            logger.exception("compaction failed for %s", key)
        finally:
            with self._idle:
                self._in_flight.discard(key)
                self._running -= 1
                self._g_running.dec()
                self._idle.notify_all()
            self._pump()

    def _compact_one(self, event: CompactionEvent) -> None:
        sp = span("compaction.job", partition=event.partition_desc)
        try:
            with sp:
                self._compact_one_inner(event)
        finally:
            # the span already timed the job (duration_s is set even when
            # the body raised) — feed the histogram from it
            registry().histogram("lakesoul_compaction_job_seconds").observe(
                sp.duration_s or 0.0
            )

    def _compact_one_inner(self, event: CompactionEvent) -> None:
        info = self.catalog.client.store.get_table_info_by_id(event.table_id)
        if info is None:
            self.stats.bump("skipped")
            return
        table = self.catalog.table(info.table_name, info.table_namespace)
        outcome = _run_conflict_retried_compaction(
            table, event, self.stats, self.min_file_num
        )
        if outcome != "conflicts":
            self.stats.bump(outcome)

    # ------------------------------------------------------------- full sweep
    def sweep(self) -> int:
        """Compact every table/partition that crosses the file threshold —
        the scheduled fallback when no trigger fired (e.g. after restarts)."""
        total = 0
        for ns in self.catalog.list_namespaces():
            for name in self.catalog.list_tables(ns):
                table = self.catalog.table(name, ns)
                units = table.scan().scan_plan()
                descs = {
                    u.partition_desc
                    for u in units
                    if len(u.data_files) >= self.min_file_num
                }
                for desc in descs:
                    from lakesoul_tpu_torch.meta.client import partition_desc_to_dict

                    try:
                        total += table.compact(partition_desc_to_dict(desc) or None)
                    except CommitConflictError:
                        self.stats.bump("conflicts")
        return total


class LeasedCompactionService:
    """Standalone leased compaction service — one per *process*, any number
    of processes per warehouse.

    Discovery: a polling watermark consumer over committed-version gaps
    (:class:`~lakesoul_tpu_torch.compaction.events.PollingWatermarkNotifier`);
    the watermark is the last CompactionCommit version in the store, so a
    killed service loses no events — any peer's next poll re-derives them.

    Coordination: one lease per (table, partition) in the metadata store's
    lease table.  ``acquire`` → work → fenced commit → ``release``.  The
    holder tracks its LOCAL validity with ``time.monotonic()`` (wall-clock
    jumps cannot extend or shrink it); the store compares expiry on its
    own shared timebase; and the **fencing token**, checked atomically
    inside the commit transaction, is what actually prevents a zombie's
    late commit — clocks only bound *liveness* (takeover within one TTL),
    never correctness.

    Obs: ``lakesoul_lease_state{key=}`` (1 while held here),
    ``lakesoul_compaction_takeovers_total``, plus the shared
    ``lakesoul_compaction_events_total{kind=}`` outcome counters.
    """

    LEASE_PREFIX = "compaction/"

    def __init__(
        self,
        catalog,
        *,
        service_id: str | None = None,
        lease_ttl_s: float | None = None,
        poll_interval_s: float | None = None,
        min_file_num: int = 2,
        version_gap: int | None = None,
    ):
        import os
        import uuid

        from lakesoul_tpu_torch.compaction.events import PollingWatermarkNotifier
        from lakesoul_tpu_torch.meta.store import COMPACTION_TRIGGER_VERSION_GAP

        self.catalog = catalog
        self.service_id = service_id or f"compactor-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.lease_ttl_s = (
            _env_float(ENV_LEASE_TTL_S, 30.0) if lease_ttl_s is None else float(lease_ttl_s)
        )
        self.poll_interval_s = (
            _env_float(ENV_POLL_S, 5.0) if poll_interval_s is None else float(poll_interval_s)
        )
        self.min_file_num = min_file_num
        self.version_gap = (
            COMPACTION_TRIGGER_VERSION_GAP if version_gap is None else version_gap
        )
        self.stats = CompactionStats()
        self.notifier = PollingWatermarkNotifier(
            catalog.client.store, version_gap=self.version_gap
        )
        self.notifier.listen(self._on_event)
        self._stop = threading.Event()
        self._poll_events: list[CompactionEvent] = []
        # (table_id, desc) → head version we already judged not-compactable
        # (version gap present but no bucket stacks min_file_num files, e.g.
        # after a DML rewrite).  Gap-derived discovery would re-emit such a
        # candidate on EVERY poll forever; suppressing it until its head
        # ADVANCES turns that into one lease+scan_plan per new commit
        # instead of one per poll interval.
        self._skipped_heads: dict[tuple[str, str], int] = {}

    # ----------------------------------------------------------------- events
    def _on_event(self, event: CompactionEvent) -> None:
        self.stats.bump("triggered")
        self._poll_events.append(event)

    def _lease_key(self, event: CompactionEvent) -> str:
        return f"{self.LEASE_PREFIX}{event.table_id}/{event.partition_desc}"

    def poll_once(self) -> dict:
        """One discovery + work cycle; returns outcome counts.  Candidates a
        live peer is already leasing are skipped (``lease_held``) and will
        be re-derived next poll if their gap survives the peer's job."""
        self._poll_events = []
        self.notifier.poll()
        # a skipped head stays a candidate while its gap is open; once it
        # compacts (or its table drops) it leaves the candidate set — prune
        # so a long-running service doesn't pin every head ever judged
        live = {(e.table_id, e.partition_desc) for e in self._poll_events}
        for k in [k for k in self._skipped_heads if k not in live]:
            del self._skipped_heads[k]
        counts = {
            "candidates": len(self._poll_events),
            "compacted": 0, "skipped": 0, "lease_held": 0,
            "fenced": 0, "conflicts": 0, "errors": 0,
        }
        for event in self._poll_events:
            if self._stop.is_set():
                break
            if self._skipped_heads.get(
                (event.table_id, event.partition_desc), -1
            ) >= event.version:
                counts["skipped"] += 1
                continue
            try:
                outcome = self._compact_candidate(event)
            except Exception:
                outcome = "errors"
                self.stats.bump("errors")
                logger.exception(
                    "leased compaction failed for %s/%s",
                    event.table_id, event.partition_desc,
                )
            key = (event.table_id, event.partition_desc)
            if outcome == "skipped":
                self._skipped_heads[key] = event.version
            elif outcome == "compacted":
                self._skipped_heads.pop(key, None)
            counts[outcome] = counts.get(outcome, 0) + 1
        return counts

    def _compact_candidate(self, event: CompactionEvent) -> str:
        from lakesoul_tpu_torch.runtime import faults

        store = self.catalog.client.store
        key = self._lease_key(event)
        ttl_ms = int(self.lease_ttl_s * 1000)
        lease = store.acquire_lease(key, self.service_id, ttl_ms)
        if lease is None:
            self.stats.bump("lease_held")
            return "lease_held"
        # heartbeat renews the store row at TTL/3 and tracks local validity
        # on the monotonic clock (wall jumps cannot resurrect a lapsed
        # lease); jobs longer than one TTL stay held instead of fencing
        heartbeat = LeaseHeartbeat(
            store, key, self.service_id, lease.fencing_token, ttl_ms
        )
        gauge = registry().gauge("lakesoul_lease_state", key=key)
        try:
            # everything after acquire runs under the finally that stops
            # the heartbeat and releases the lease — a raise anywhere here
            # must not leak a perpetually-renewed lease
            heartbeat.start()
            gauge.set(1)
            if lease.taken_over:
                self.stats.bump("takeovers")
                registry().counter("lakesoul_compaction_takeovers_total").inc()
                logger.info(
                    "%s took over lease %s (fencing token %d)",
                    self.service_id, key, lease.fencing_token,
                )
            # chaos point: a service hung (or killed) HERE still holds the
            # lease — the takeover tests SIGKILL inside this window
            faults.maybe_inject("compaction.leased_job")
            info = store.get_table_info_by_id(event.table_id)
            if info is None:
                self.stats.bump("skipped")
                return "skipped"
            table = self.catalog.table(info.table_name, info.table_namespace)

            def check_lease() -> None:
                if heartbeat.fenced or time.monotonic() >= heartbeat.valid_until:
                    # the heartbeat lost the lease (or stalled past the
                    # window): abort before more work — the commit guard
                    # would catch it anyway, but a whole compact pass
                    # would be wasted
                    raise LeaseFencedError(f"lease {key} lapsed locally")

            outcome = _run_conflict_retried_compaction(
                table, event, self.stats, self.min_file_num,
                lease=lease, pre_attempt=check_lease,
            )
            if outcome != "conflicts":
                self.stats.bump(outcome)
            return outcome
        except LeaseFencedError:
            self.stats.bump("fenced")
            if heartbeat.fenced:
                # the store rejected our renewal outright: token stale —
                # a peer fenced past us
                logger.warning(
                    "%s fenced on %s: a peer took over; abandoning the job",
                    self.service_id, key,
                )
            else:
                # local validity lapsed (renewals erroring — see the
                # heartbeat warnings) or the commit-time guard rejected
                # the token; don't blame a peer the logs can't prove
                logger.warning(
                    "%s abandoned %s: lease no longer provably held"
                    " (lapsed local validity or commit-guard rejection)",
                    self.service_id, key,
                )
            return "fenced"
        finally:
            heartbeat.stop()
            gauge.set(0)
            store.release_lease(key, self.service_id, lease.fencing_token)

    # ---------------------------------------------------------------- control
    def run_forever(self, *, max_polls: int | None = None) -> None:
        """Poll → work → sleep until :meth:`stop` (or ``max_polls``)."""
        polls = 0
        while not self._stop.is_set():
            counts = self.poll_once()
            if counts["candidates"]:
                logger.info("%s poll: %s", self.service_id, counts)
            polls += 1
            if max_polls is not None and polls >= max_polls:
                return
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        self.notifier.close()
