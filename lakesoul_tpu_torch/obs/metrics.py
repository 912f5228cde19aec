"""Process-wide metrics registry: counters, gauges, histograms.

The standing instrumentation contract for the repo (reference: the
PrometheusBuilder exporter wired through bin/flight_sql_server.rs:21-70 and
the per-layer stats structs — StreamWriteMetrics, cache/stats.rs).  Every
layer records into ONE registry so a single ``/metrics`` endpoint (or
``registry().snapshot()``) shows the whole data path: gateway streams, page
cache, SQL stage latencies, merge/scan timings, meta commits, compaction
jobs, and loader throughput.

Naming scheme: ``lakesoul_<layer>_<name>`` with ``_total`` for counters and
``_seconds`` for duration histograms; low-cardinality labels only (stage,
op, mode — never table names or paths).

All metric types are thread-safe; getters are memoized per (name, labels)
so hot paths pay one dict lookup + one lock per update.
"""

from __future__ import annotations

import bisect
import re
import threading
import weakref
from dataclasses import dataclass, field

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "parse_series_key",
    "StreamMetrics",
    "DEFAULT_TIME_BUCKETS",
]

# seconds buckets spanning sub-ms kernel work to minute-long compaction jobs
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


# the inverse of _fmt_labels: snapshot keys are the fleet's cross-process
# wire format, so they must parse back exactly (label values in this repo
# are bounded identifiers — worker ids, stage names, roles — never quoted
# or comma-bearing strings)
_SERIES_KEY_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')


def parse_series_key(key: str) -> "tuple[str, dict] | tuple[None, None]":
    """Split a ``snapshot()`` series key back into (name, labels_dict);
    (None, None) when the key is not a well-formed series."""
    m = _SERIES_KEY_RE.match(key)
    if m is None:
        return None, None
    name, raw = m.group(1), m.group(2)
    if not raw:
        return name, {}
    return name, {k: v for k, v in _LABEL_RE.findall(raw)}


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

    def expose(self) -> list[tuple[str, float]]:
        return [(self.name + _fmt_labels(self.labels), self.value)]


class Gauge:
    """Set/inc/dec point-in-time value; optionally backed by a callable."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_value", "_lock", "_fn")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()
        self._fn = None

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    def set_function(self, fn) -> None:
        """Sample ``fn()`` at exposition time instead of a stored value."""
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:  # a broken sampler must never break exposition
                return 0
        with self._lock:
            return self._value

    def expose(self) -> list[tuple[str, float]]:
        return [(self.name + _fmt_labels(self.labels), self.value)]


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

    def merge(self, total_s: float, count: int) -> None:
        """Fold an EXTERNAL (sum, count) delta into this histogram — the
        cross-process transport for stage attribution (a scanplane worker's
        per-range timings riding into the client's registry).  Sum and count
        stay exact; bucket placement is approximated at the delta's mean
        (the remote process only ships aggregates, not raw observations)."""
        if count <= 0:
            return
        idx = bisect.bisect_left(self.bounds, total_s / count)
        with self._lock:
            self._counts[idx] += count
            self._sum += total_s
            self._count += count

    def merge_dist(self, buckets: dict, total_s: float, count: int) -> None:
        """Fold an external CUMULATIVE bucket distribution (a remote
        histogram's ``value["buckets"]``, possibly JSON-round-tripped with
        string bounds) into this one.  Each source bucket's count lands at
        the first local bound >= the source bound — exact when the bound
        grids match (the common fleet case: every process registers the
        same family with the same buckets), conservative otherwise.
        Observations beyond the last source bound go to +Inf."""
        if count <= 0:
            return
        items = sorted((float(b), int(c)) for b, c in buckets.items())
        add = [0] * (len(self.bounds) + 1)
        prev = 0
        for bound, cum in items:
            c = cum - prev
            prev = cum
            if c > 0:
                add[bisect.bisect_left(self.bounds, bound)] += c
        tail = count - prev  # the source's implicit +Inf bucket
        if tail > 0:
            add[len(self.bounds)] += tail
        with self._lock:
            for i, c in enumerate(add):
                self._counts[i] += c
            self._sum += total_s
            self._count += count

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1) from the cumulative buckets —
        Prometheus ``histogram_quantile`` semantics: linear interpolation
        inside the owning bucket, the lowest bucket interpolates from 0,
        and observations beyond the last finite bound clamp to it (the
        +Inf bucket has no upper edge to interpolate toward).  Returns 0.0
        on an empty histogram.  SLO evaluators that need EXACT percentiles
        keep their own bounded reservoir (freshness/slo.py) — this is the
        registry-side estimate every exporter consumer can reproduce."""
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

    def expose(self) -> list[tuple[str, float]]:
        snap = self.value
        out = []
        for bound, cum in snap["buckets"].items():
            lab = self.labels + (("le", repr(bound)),)
            out.append((f"{self.name}_bucket" + _fmt_labels(lab), cum))
        lab = self.labels + (("le", "+Inf"),)
        out.append((f"{self.name}_bucket" + _fmt_labels(lab), snap["count"]))
        out.append((f"{self.name}_sum" + _fmt_labels(self.labels), snap["sum"]))
        out.append((f"{self.name}_count" + _fmt_labels(self.labels), snap["count"]))
        return out


class MetricsRegistry:
    """Thread-safe registry of named metrics plus pluggable collectors.

    ``counter/gauge/histogram`` memoize on (name, sorted labels), so call
    sites simply re-ask for the metric.  A name is permanently bound to its
    first kind — re-registering under another kind is a programming error
    and raises.  ``register_collector`` accepts a zero-arg callable
    returning ``[(name, kind, value, labels_dict), ...]`` for stats owned
    elsewhere (page-cache instances, per-server stream metrics) that are
    sampled at exposition time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Counter | Gauge | Histogram] = {}
        self._kinds: dict[str, str] = {}
        self._collectors: list = []

    # ------------------------------------------------------------- factories
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                bound = self._kinds.setdefault(name, cls.kind)
                if bound != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {bound}, not {cls.kind}"
                    )
                m = self._metrics[key] = cls(name, key[1], **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
                )
            return m

    # positional-only metric names: label keys like name=/buckets= must not
    # collide with the parameters
    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, /, buckets: tuple[float, ...] | None = None, **labels
    ) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, labels)
        m = self._get(Histogram, name, labels, buckets=buckets)
        want = tuple(sorted(float(b) for b in buckets))
        if m.bounds != want:
            # memoization would silently hand back the first caller's bounds
            # and observations would land in wrong buckets — that's a
            # programming error, same as a kind mismatch
            raise ValueError(
                f"histogram {name!r} already registered with buckets"
                f" {m.bounds}, not {want}"
            )
        return m

    def register_collector(self, fn) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def series(self, name: str) -> list[tuple[dict, "Counter | Gauge | Histogram"]]:
        """Every registered series of one metric family, as
        ``(labels_dict, metric)`` pairs — the aggregation hook for families
        that fan out over labels (e.g. ``lakesoul_scan_stage_seconds`` with
        per-consumer ``queue`` series): callers sum across the returned
        metrics instead of reaching into the registry's internals."""
        with self._lock:
            items = [
                (dict(labels), m)
                for (n, labels), m in self._metrics.items()
                if n == name
            ]
        return items

    # ----------------------------------------------------------- aggregation
    def kinds(self) -> dict[str, str]:
        """Metric-family → kind, covering registered metrics AND collector
        samples — shipped alongside ``snapshot()`` so a consumer (the fleet
        aggregator) can merge scalars correctly: counters sum, gauges keep
        per-process labels."""
        with self._lock:
            out = dict(self._kinds)
        for name, kind, _value, _labels in self._collected():
            out.setdefault(name, kind)
        return out

    def merge_snapshot(
        self,
        snap: dict,
        *,
        kinds: dict | None = None,
        labels: dict | None = None,
        gauge_labels: dict | None = None,
    ) -> int:
        """Fold another process's ``snapshot()``-shaped series into this
        registry — the fleet-aggregation primitive (and the scan-plane
        client's sidecar stage merge rides the same path):

        - histogram values (``{buckets?, count, sum}``) merge bucket-aware
          when the source ships bounds (:meth:`Histogram.merge_dist`),
          else at the delta mean (:meth:`Histogram.merge`);
        - counters SUM (``inc`` by the remote value — callers aggregating
          repeatedly must merge into a fresh registry, counters are
          monotonic);
        - gauges SET per-series, so distinguishing processes needs
          ``gauge_labels`` (the per-process identity: role, service_id) —
          counters/histograms keep their source labels and sum across the
          fleet.

        ``kinds`` is the source registry's :meth:`kinds` map; scalar series
        without an entry default to counter.  ``labels`` merge into EVERY
        series key (e.g. ``worker=`` on sidecar stage deltas).  A series
        whose name/kind/buckets clash with a local registration is skipped
        — one bad member must not sink the aggregate.  Returns the number
        of series merged."""
        kinds = kinds or {}
        merged = 0
        for key, value in snap.items():
            name, series_labels = parse_series_key(str(key))
            if name is None:
                continue
            if labels:
                series_labels.update(labels)
            try:
                if isinstance(value, dict):
                    buckets = value.get("buckets") or {}
                    total = float(value.get("sum", 0.0))
                    count = int(value.get("count", 0))
                    if buckets:
                        try:
                            h = self.histogram(
                                name,
                                buckets=tuple(float(b) for b in buckets),
                                **series_labels,
                            )
                        except ValueError:
                            # local series exists with other bounds: fall
                            # back to the existing grid, conservative merge
                            h = self.histogram(name, **series_labels)
                        h.merge_dist(buckets, total, count)
                    else:
                        self.histogram(name, **series_labels).merge(total, count)
                else:
                    kind = kinds.get(name, "counter")
                    if kind == "gauge":
                        if gauge_labels:
                            series_labels.update(gauge_labels)
                        self.gauge(name, **series_labels).set(value)
                    else:
                        self.counter(name, **series_labels).inc(value)
            except (TypeError, ValueError):
                continue
            merged += 1
        return merged

    # ------------------------------------------------------------ exposition
    def _collected(self) -> list[tuple[str, str, float, dict]]:
        with self._lock:
            fns = list(self._collectors)
        out = []
        for fn in fns:
            try:
                out.extend(fn())
            except Exception:  # one broken collector must not hide the rest
                continue
        return out

    def snapshot(self) -> dict:
        """JSON-friendly view: series name (with labels) → number, or for
        histograms → {buckets, count, sum}."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for (name, labels), m in metrics:
            out[name + _fmt_labels(labels)] = m.value
        for name, _kind, value, labels in self._collected():
            key = name + _fmt_labels(tuple(sorted(labels.items())))
            out[key] = out.get(key, 0) + value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every registered metric and every
        collector sample, one ``# TYPE`` line per metric name."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        typed: set[str] = set()
        for (name, _labels), m in metrics:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {m.kind}")
            for series, value in m.expose():
                lines.append(f"{series} {value}")
        collected: dict[str, float] = {}
        kinds: dict[str, str] = {}
        order: list[str] = []
        for name, kind, value, labels in self._collected():
            key = name + _fmt_labels(tuple(sorted(labels.items())))
            if key not in collected:
                order.append(key)
            collected[key] = collected.get(key, 0) + value
            kinds[key] = (name, kind)
        for key in order:
            name, kind = kinds[key]
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{key} {collected[key]}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """THE process-wide registry every layer records into."""
    return _REGISTRY


# --------------------------------------------------------------------- streams
# Gateway stream metrics (parity with StreamWriteMetrics,
# flight_sql_service.rs:90).  One instance per server; every live instance is
# aggregated into the shared registry's lakesoul_flight_* series, while the
# per-server `metrics` / `metrics_prometheus` Flight actions keep their
# original byte format.

_STREAM_INSTANCES: "weakref.WeakSet[StreamMetrics]" = weakref.WeakSet()

# lifetime counts of GC'd instances: counters must stay MONOTONIC across
# server churn (a decrease reads as a counter reset to Prometheus rate());
# gauges (active_*) correctly drop with the instance
_STREAM_RETIRED: dict[str, int] = {}
_STREAM_RETIRED_LOCK = threading.Lock()


def _retire_stream(fields: dict) -> None:
    with _STREAM_RETIRED_LOCK:
        for k in StreamMetrics._FIELDS:
            if not k.startswith("active"):
                _STREAM_RETIRED[k] = _STREAM_RETIRED.get(k, 0) + fields.get(k, 0)


@dataclass(eq=False)
class StreamMetrics:
    active_get_streams: int = 0
    active_put_streams: int = 0
    total_get_streams: int = 0
    total_put_streams: int = 0
    rows_out: int = 0
    rows_in: int = 0
    bytes_in: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        _STREAM_INSTANCES.add(self)
        # the finalizer holds the instance's __dict__ (ints live there), not
        # the instance — no resurrection, but the final totals survive GC
        weakref.finalize(self, _retire_stream, self.__dict__)

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    _FIELDS = (
        "active_get_streams", "active_put_streams", "total_get_streams",
        "total_put_streams", "rows_out", "rows_in", "bytes_in",
    )

    def snapshot(self) -> dict:
        with self._lock:
            return {k: getattr(self, k) for k in self._FIELDS}

    def prometheus_text(self) -> str:
        """Prometheus exposition format (parity with the reference's
        PrometheusBuilder exporter, bin/flight_sql_server.rs:21-70)."""
        snap = self.snapshot()
        lines = []
        for k, v in snap.items():
            kind = "gauge" if k.startswith("active") else "counter"
            lines.append(f"# TYPE lakesoul_flight_{k} {kind}")
            lines.append(f"lakesoul_flight_{k} {v}")
        return "\n".join(lines) + "\n"


def _collect_streams() -> list[tuple[str, str, float, dict]]:
    with _STREAM_RETIRED_LOCK:
        agg = {k: _STREAM_RETIRED.get(k, 0) for k in StreamMetrics._FIELDS}
    for inst in list(_STREAM_INSTANCES):
        snap = inst.snapshot()
        for k in agg:
            agg[k] += snap[k]
    return [
        (
            f"lakesoul_flight_{k}",
            "gauge" if k.startswith("active") else "counter",
            v,
            {},
        )
        for k, v in agg.items()
    ]


_REGISTRY.register_collector(_collect_streams)
