"""Freshness layer of the port: the ingest-to-train staleness contract.

:mod:`~lakesoul_tpu_torch.freshness.slo` is a copy of
``lakesoul_tpu/freshness/slo.py``: :class:`SloMonitor` turns each delivered
commit into a commit-to-visible latency observation
(``lakesoul_freshness_seconds``) against a declared target
(``LAKESOUL_FRESHNESS_SLO_S``) with error-budget accounting, and
:class:`ThroughputSlo` does the same for sustained rows/s; the fleet
aggregator (``obs/fleet.py``) evaluates both fleet-wide.  The reference's
follower (``scan.follow()``, ``to_jax_iter(follow=...)``) is not ported yet,
so ``follow=`` raises ``ConfigError`` in the port.
"""

from __future__ import annotations

from lakesoul_tpu_torch.freshness.slo import SloMonitor, ThroughputSlo

__all__ = ["SloMonitor", "ThroughputSlo"]
