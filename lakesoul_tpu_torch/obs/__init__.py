"""Unified observability layer: metrics registry + tracing spans (the port's
copy of ``lakesoul_tpu/obs``, every module of it).

Pure-stdlib (cheap to import from any layer, no pyarrow/torch).  Five pieces:

- :mod:`lakesoul_tpu_torch.obs.metrics` — process-wide :func:`registry` of
  counters/gauges/histograms with Prometheus text + JSON snapshot
  exposition, plus the gateway ``StreamMetrics``.
- :mod:`lakesoul_tpu_torch.obs.stages` — the scan stage series
  (``lakesoul_scan_stage_seconds``).
- :mod:`lakesoul_tpu_torch.obs.tracing` — context-manager :func:`span` with
  wall-time, parent/child nesting, and a propagatable trace id
  (``x-trace-id`` over Flight).
- :mod:`lakesoul_tpu_torch.obs.logging` — ``LAKESOUL_LOG_FORMAT=json``
  structured formatter that stamps the active trace id on every record.
- :mod:`lakesoul_tpu_torch.obs.fleet` — cross-process plane: every role
  publishes snapshots + a flight-recorder ring to a shared spool
  (``LAKESOUL_OBS_SPOOL``); :class:`FleetAggregator` merges them into one
  fleet view with staleness, north-star rows/s, fleet-wide SLOs, traces,
  and crash postmortems.

Instrumentation contract (see ARCHITECTURE.md "Observability"): metric
names are ``lakesoul_<layer>_<name>``; hot paths fetch their metric once
and update it, never format strings per row.
"""

from lakesoul_tpu_torch.obs.exporter import serve_prometheus
from lakesoul_tpu_torch.obs.fleet import (
    FleetAggregator,
    FleetPublisher,
    FlightRecorder,
    arm,
    child_env,
    flush_now,
    identity_labels,
    process_identity,
    record_event,
)
from lakesoul_tpu_torch.obs.logging import JsonLogFormatter, configure_logging
from lakesoul_tpu_torch.obs.stages import (
    SCAN_STAGES,
    queue_seconds_by_consumer,
    stage_counts,
    stage_histogram,
    stage_merge,
    stage_observe,
    stage_seconds,
)
from lakesoul_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StreamMetrics,
    parse_series_key,
    registry,
)
from lakesoul_tpu_torch.obs.tracing import (
    Span,
    ambient_trace_id,
    current_span,
    current_trace_id,
    new_trace_id,
    recent_spans,
    sanitize_trace_id,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StreamMetrics",
    "registry",
    "parse_series_key",
    "Span",
    "span",
    "ambient_trace_id",
    "current_span",
    "current_trace_id",
    "new_trace_id",
    "recent_spans",
    "sanitize_trace_id",
    "FleetAggregator",
    "FleetPublisher",
    "FlightRecorder",
    "arm",
    "child_env",
    "flush_now",
    "identity_labels",
    "process_identity",
    "record_event",
    "JsonLogFormatter",
    "configure_logging",
    "serve_prometheus",
    "SCAN_STAGES",
    "queue_seconds_by_consumer",
    "stage_counts",
    "stage_histogram",
    "stage_merge",
    "stage_observe",
    "stage_seconds",
]
