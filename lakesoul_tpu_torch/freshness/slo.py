"""Freshness / throughput SLO evaluation (a copy of
``lakesoul_tpu/freshness/slo.py``).

An SLO here is a *declared* target plus *measured* conformance — never a
guess.  Two monitors:

- :class:`SloMonitor`: per-delivered-commit **commit-to-visible latency**.
  The commit instant comes from the ``partition_info`` version row's
  timestamp (``ScanPlanPartition.commit_timestamp_ms`` — stamped by
  ``MetaDataClient.poll_scan_plan``); the visible instant is when the
  follower hands the commit's FIRST batch to its consumer.  Every
  observation lands in the ``lakesoul_freshness_seconds`` histogram; an
  observation over the declared target (``LAKESOUL_FRESHNESS_SLO_S``)
  counts into ``lakesoul_slo_violations_total{slo=...}`` and burns error
  budget (``LAKESOUL_FRESHNESS_BUDGET``, a violation *fraction* — the SRE
  shape: 1% budget means 99% of commits must land inside the target).

- :class:`ThroughputSlo`: sustained delivered rows/s over a window,
  evaluated once at the end of a run (chaos legs declare a floor; dipping
  under it is a violation on the same counter family).

Percentiles: the registry histogram gives every /metrics consumer the
bucket-estimated quantiles (``Histogram.quantile``); the monitor
additionally keeps a bounded reservoir of RAW latencies so the bench/chaos
legs publish exact p50/p99 for the committed BENCH trajectory.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from lakesoul_tpu_torch.obs import registry

ENV_FRESHNESS_SLO_S = "LAKESOUL_FRESHNESS_SLO_S"
ENV_FRESHNESS_BUDGET = "LAKESOUL_FRESHNESS_BUDGET"

FRESHNESS_FAMILY = "lakesoul_freshness_seconds"
VIOLATIONS_FAMILY = "lakesoul_slo_violations_total"

# seconds buckets spanning sub-100ms same-host polls to minutes-stale
# backlogs; coarser than DEFAULT_TIME_BUCKETS at the fast end (a freshness
# SLO under 50 ms is not a lakehouse claim) and wider at the slow end
FRESHNESS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0, 120.0, 300.0,
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def default_freshness_slo_s() -> float:
    """Declared commit-to-visible target (``LAKESOUL_FRESHNESS_SLO_S``,
    default 10 s — a couple of follower poll ticks plus decode under
    load, not a real-time promise)."""
    return _env_float(ENV_FRESHNESS_SLO_S, 10.0)


def default_freshness_budget() -> float:
    """Allowed violation fraction (``LAKESOUL_FRESHNESS_BUDGET``, default
    0.01: 99% of delivered commits must land inside the target)."""
    return max(0.0, min(1.0, _env_float(ENV_FRESHNESS_BUDGET, 0.01)))


def _exact_percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over a raw sample (exact, no interpolation
    surprises in tiny chaos runs)."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[rank]


class SloMonitor:
    """Commit-to-visible freshness tracker + declared-target evaluator.

    Thread-safe: the follower's delivery thread observes, the trainer (or
    the chaos harness) snapshots concurrently.  ``slo`` labels the
    violation counter series (default ``"freshness"``) so several monitors
    (train vs eval followers) stay distinguishable on /metrics.
    """

    RESERVOIR = 8192  # raw latencies kept for exact percentiles (bounded)

    def __init__(
        self,
        target_s: float | None = None,
        *,
        budget_fraction: float | None = None,
        slo: str = "freshness",
    ):
        self.slo = slo
        self.target_s = (
            default_freshness_slo_s() if target_s is None else float(target_s)
        )
        self.budget_fraction = (
            default_freshness_budget()
            if budget_fraction is None
            else max(0.0, min(1.0, float(budget_fraction)))
        )
        self._lock = threading.Lock()
        self._lat: deque[float] = deque(maxlen=self.RESERVOIR)
        self._count = 0
        self._violations = 0
        self._max = 0.0
        reg = registry()
        self._h = reg.histogram(FRESHNESS_FAMILY, buckets=FRESHNESS_BUCKETS)
        self._c_viol = reg.counter(VIOLATIONS_FAMILY, slo=slo)

    # ---------------------------------------------------------- observation
    def observe(self, latency_s: float) -> None:
        """One delivered commit's commit-to-visible latency."""
        latency_s = max(0.0, float(latency_s))
        self._h.observe(latency_s)
        violated = latency_s > self.target_s
        with self._lock:
            self._lat.append(latency_s)
            self._count += 1
            if latency_s > self._max:
                self._max = latency_s
            if violated:
                self._violations += 1
        if violated:
            self._c_viol.inc()

    def observe_commit(self, commit_timestamp_ms: int, now_ms: int | None = None) -> float:
        """Observe from a commit's visibility instant (``partition_info``
        timestamp, ``now_millis`` timebase).  Unknown timestamps (0) are
        skipped — a unit from a batch plan carries no freshness claim.
        Returns the observed latency (or -1.0 when skipped)."""
        if not commit_timestamp_ms:
            return -1.0
        if now_ms is None:
            from lakesoul_tpu_torch.meta.entity import now_millis

            now_ms = now_millis()
        latency_s = (now_ms - commit_timestamp_ms) / 1000.0
        self.observe(latency_s)
        return latency_s

    # ----------------------------------------------------------- evaluation
    def percentile(self, q: float) -> float:
        """Exact q-percentile over the (bounded) raw-latency reservoir."""
        with self._lock:
            vals = sorted(self._lat)
        return _exact_percentile(vals, q)

    def allowed_violations(self) -> int:
        """How many observations MAY exceed the target inside the budget
        (floor of fraction × count — the budget never rounds up)."""
        with self._lock:
            return int(self._count * self.budget_fraction)

    def in_budget(self) -> bool:
        """True while violations fit the error budget.  Zero observations
        is vacuously in budget (an idle follower has violated nothing)."""
        with self._lock:
            return self._violations <= int(self._count * self.budget_fraction)

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._lat)
            count = self._count
            violations = self._violations
            mx = self._max
        allowed = int(count * self.budget_fraction)
        return {
            "slo": self.slo,
            "target_s": self.target_s,
            "budget_fraction": self.budget_fraction,
            "count": count,
            "violations": violations,
            "allowed_violations": allowed,
            "budget_remaining": allowed - violations,
            "in_budget": violations <= allowed,
            "p50_s": _exact_percentile(vals, 0.50),
            "p99_s": _exact_percentile(vals, 0.99),
            "max_s": mx,
        }


class ThroughputSlo:
    """Sustained-throughput floor: declared min rows/s, evaluated over the
    monitor's lifetime (``start()`` → ``add_rows()`` × N → ``evaluate()``).

    The clock is monotonic (wall jumps must not fake a violation).  A
    violation increments ``lakesoul_slo_violations_total{slo=...}`` once
    per :meth:`evaluate` call that lands under the floor."""

    def __init__(self, min_rows_per_s: float, *, slo: str = "throughput"):
        import time

        self.slo = slo
        self.min_rows_per_s = float(min_rows_per_s)
        self._clock = time.monotonic
        self._lock = threading.Lock()
        self._rows = 0
        self._started: float | None = None
        self._c_viol = registry().counter(VIOLATIONS_FAMILY, slo=slo)

    def start(self) -> None:
        with self._lock:
            if self._started is None:
                self._started = self._clock()

    def add_rows(self, n: int) -> None:
        with self._lock:
            if self._started is None:
                self._started = self._clock()
            self._rows += int(n)

    def rows_per_s(self) -> float:
        with self._lock:
            if self._started is None:
                return 0.0
            elapsed = self._clock() - self._started
            return self._rows / elapsed if elapsed > 0 else 0.0

    def evaluate(self) -> dict:
        rate = self.rows_per_s()
        ok = rate >= self.min_rows_per_s
        if not ok:
            self._c_viol.inc()
        with self._lock:
            rows = self._rows
        return {
            "slo": self.slo,
            "min_rows_per_s": self.min_rows_per_s,
            "rows": rows,
            "rows_per_s": rate,
            "ok": ok,
        }
