"""Compaction event delivery across process boundaries (the port's copy
of ``lakesoul_tpu/compaction/events.py``).

The reference's compaction service LISTENs on a PG channel that a trigger
NOTIFYs (meta_init.sql:101-150).  This module gives the Python stack the
same *shape* — a :class:`CompactionNotifier` that pushes
:class:`~lakesoul_tpu_torch.meta.store.CompactionEvent`\\ s to subscribed
callbacks — over two transports:

- :class:`StoreTriggerNotifier`: the in-process path — the store
  fires listeners synchronously in the committing writer's process.  Fast,
  but events die with the process and never cross one.
- :class:`PollingWatermarkNotifier`: the cross-process path for SQLite
  deployments.  Events are **derived, not messaged**: each ``poll()``
  re-computes the partitions whose committed head is ≥ ``version_gap``
  versions past their last CompactionCommit
  (``store.get_compaction_candidates``).  The consumer's watermark is the
  last CompactionCommit version already in ``partition_info`` — committed
  state, not consumer memory — so a SIGKILLed consumer loses nothing: the
  gap persists and the next poll, in any process, re-emits the event.
  A PostgreSQL deployment drops in a LISTEN/NOTIFY notifier behind the
  same three methods and the service code does not change.

Deduplication is deliberately the *consumer's* job (in-flight sets,
per-partition leases): at-least-once delivery is the crash-safe default,
and the leases make the redundant deliveries harmless.
"""

from __future__ import annotations

import logging
from typing import Callable

from lakesoul_tpu_torch.meta.store import (
    COMPACTION_TRIGGER_VERSION_GAP,
    CompactionEvent,
)

logger = logging.getLogger(__name__)


class CompactionNotifier:
    """LISTEN/NOTIFY-shaped event source: ``listen`` registers a callback,
    ``poll`` pumps pending events for pull-based transports (push-based
    ones no-op it), ``close`` detaches."""

    def listen(self, fn: Callable[[CompactionEvent], None]) -> None:
        raise NotImplementedError

    def unlisten(self, fn: Callable[[CompactionEvent], None]) -> None:
        raise NotImplementedError

    def poll(self) -> int:
        """Deliver pending events to listeners; returns how many."""
        return 0

    def close(self) -> None:
        pass


class StoreTriggerNotifier(CompactionNotifier):
    """In-process push transport: adapts the store's synchronous trigger
    listeners (``SqliteMetadataStore._fire_compaction_triggers``) to the
    notifier API.  Events fire inside the committing writer's process —
    the single-process deployment shape."""

    def __init__(self, store):
        self.store = store
        self._fns: list[Callable[[CompactionEvent], None]] = []

    def listen(self, fn) -> None:
        self._fns.append(fn)
        self.store.add_compaction_listener(fn)

    def unlisten(self, fn) -> None:
        try:
            self._fns.remove(fn)
            self.store.remove_compaction_listener(fn)
        except ValueError:
            pass

    def close(self) -> None:
        for fn in list(self._fns):
            self.unlisten(fn)


class PollingWatermarkNotifier(CompactionNotifier):
    """Pull transport over committed-version gaps (see module docstring).

    ``poll()`` is cheap — one grouped SQL scan of ``partition_info`` — and
    *stateless across crashes*: the watermark each partition is compared
    against is its last CompactionCommit version, which only a successful
    compaction advances.  Every open gap is re-delivered on every poll
    (at-least-once); suppressing repeats is the consumer's job — the
    leased service already tracks not-compactable heads, and per-partition
    leases make redundant deliveries harmless.

    Failure isolation (the long-running-service contract): the candidate
    derivation runs under the shared
    :class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy` (transient store
    blips retry on the seeded schedule; exhaustion/permanent errors fail
    THIS poll only — logged, counted, re-derived next tick, because the
    watermark is committed state and loses nothing).  A raising listener
    no longer aborts the poll: its exception is logged once with the
    active trace id, counted into
    ``lakesoul_notifier_listener_errors_total``, and the remaining
    listeners and events still see the delivery."""

    def __init__(
        self,
        store,
        *,
        version_gap: int = COMPACTION_TRIGGER_VERSION_GAP,
        retry_policy=None,
    ):
        from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

        self.store = store
        self.version_gap = version_gap
        self._fns: list[Callable[[CompactionEvent], None]] = []
        self._policy = retry_policy or RetryPolicy.from_env()

    def listen(self, fn) -> None:
        self._fns.append(fn)

    def unlisten(self, fn) -> None:
        try:
            self._fns.remove(fn)
        except ValueError:
            pass

    def _candidates(self) -> list[CompactionEvent]:
        from lakesoul_tpu_torch.obs import registry

        def attempt():
            return list(self.store.get_compaction_candidates(self.version_gap))

        try:
            return self._policy.run(attempt, op="notifier.poll")
        except Exception:
            # candidates are RE-DERIVED every poll from committed state: a
            # failed derivation delays delivery by one tick, it must never
            # kill the owning service loop
            registry().counter("lakesoul_notifier_poll_errors_total").inc()
            logger.exception(
                "compaction candidate derivation failed; retrying next poll"
            )
            return []

    def poll(self) -> int:
        if not self._fns:
            return 0
        from lakesoul_tpu_torch.obs import registry
        from lakesoul_tpu_torch.obs.tracing import current_span

        delivered = 0
        for ev in self._candidates():
            for fn in list(self._fns):
                try:
                    fn(ev)
                except Exception:
                    # isolate: one bad listener must not starve the others
                    # (or later events) of the delivery
                    registry().counter(
                        "lakesoul_notifier_listener_errors_total"
                    ).inc()
                    sp = current_span()
                    logger.exception(
                        "compaction listener %r failed for %s/%s (trace %s)",
                        getattr(fn, "__qualname__", fn),
                        ev.table_id,
                        ev.partition_desc,
                        sp.trace_id if sp is not None else "-",
                    )
            delivered += 1
        return delivered

    def close(self) -> None:
        self._fns.clear()
