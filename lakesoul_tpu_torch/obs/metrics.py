"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of the part of ``lakesoul_tpu/obs/metrics.py`` that the
ANN endpoint and the ANN plane record into.  Naming scheme as there:
``lakesoul_<layer>_<name>`` with ``_total`` for counters and ``_seconds``
for duration histograms.
All metric types are thread-safe; getters are memoized per (name, labels).
"""

from __future__ import annotations

import bisect
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry"]

# seconds buckets spanning sub-ms kernel work to minute-long jobs
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonic counter."""

    kind = "counter"
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Set/inc/dec point-in-time value."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative-``le`` semantics:
    bucket i counts observations ``<= bounds[i]``, plus the implicit +Inf."""

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(
        self,
        name: str,
        labels: tuple[tuple[str, str], ...] = (),
        buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
    ):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1) from the cumulative buckets —
        Prometheus ``histogram_quantile`` semantics: linear interpolation
        inside the owning bucket, the lowest bucket interpolates from 0, and
        observations beyond the last finite bound clamp to it.  Returns 0.0
        on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                if i >= len(self.bounds):
                    return self.bounds[-1] if self.bounds else 0.0
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * ((rank - prev_cum) / c)
        return self.bounds[-1] if self.bounds else 0.0

    @property
    def value(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        buckets = {}
        for bound, c in zip(self.bounds, counts):
            cum += c
            buckets[bound] = cum
        return {"buckets": buckets, "count": total, "sum": s}


class MetricsRegistry:
    """Thread-safe registry of named metrics.  ``counter/gauge/histogram``
    memoize on (name, sorted labels); a name is bound to its first kind and
    re-registering it under another kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Counter | Gauge | Histogram] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, cls, name: str, labels: dict):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                bound = self._kinds.setdefault(name, cls.kind)
                if bound != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {bound}, not {cls.kind}"
                    )
                m = self._metrics[key] = cls(name, key[1])
            return m

    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, /, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """JSON-friendly view: series name (with labels) → number, or for
        histograms → {buckets, count, sum}."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name + _fmt_labels(labels): m.value for (name, labels), m in metrics}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """THE process-wide registry every layer of the port records into."""
    return _REGISTRY
