"""Freshness layer of the port: the ingest-to-train staleness contract,
measured (copies of ``lakesoul_tpu/freshness/``).

- :mod:`~lakesoul_tpu_torch.freshness.slo` — :class:`SloMonitor` turns each
  delivered commit into a commit-to-visible latency observation
  (``lakesoul_freshness_seconds``) against a declared target
  (``LAKESOUL_FRESHNESS_SLO_S``) with error-budget accounting, and
  :class:`ThroughputSlo` does the same for sustained rows/s; the fleet
  aggregator (``obs/fleet.py``) evaluates both fleet-wide.
- :mod:`~lakesoul_tpu_torch.freshness.follower` — the bounded-staleness
  follower: ``scan.follow()``'s poll/decode loop under the shared
  :class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy`, with an
  exactly-once resumable position (:class:`FollowerState`, the reference's
  JSON) and a batch-source adapter (:class:`FollowBatchSource`) so
  ``scan.to_torch_iter(follow=...)`` is a continuous training source on the
  card.
- ``python -m lakesoul_tpu_torch.freshness writer`` — the CDC-writer process
  role of the three-role harness (writer + leased compactor + follower
  trainer).
"""

from __future__ import annotations

from lakesoul_tpu_torch.freshness.follower import (
    FollowBatchSource,
    FollowerState,
    FreshFollower,
    default_follow_poll_s,
)
from lakesoul_tpu_torch.freshness.slo import SloMonitor, ThroughputSlo

__all__ = [
    "FollowBatchSource",
    "FollowerState",
    "FreshFollower",
    "SloMonitor",
    "ThroughputSlo",
    "default_follow_poll_s",
]
