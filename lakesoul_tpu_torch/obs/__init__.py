"""Observability of the port: the process-wide metrics registry, the scan
stage series and tracing spans (copies of ``lakesoul_tpu/obs/metrics.py``,
``stages.py`` and ``tracing.py``).  The reference's exporter, fleet plane
and log formatter are not ported yet."""

from lakesoul_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StreamMetrics,
    parse_series_key,
    registry,
)
from lakesoul_tpu_torch.obs.stages import (
    SCAN_STAGES,
    queue_seconds_by_consumer,
    stage_counts,
    stage_histogram,
    stage_merge,
    stage_observe,
    stage_seconds,
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
    "SCAN_STAGES",
    "queue_seconds_by_consumer",
    "stage_counts",
    "stage_histogram",
    "stage_merge",
    "stage_observe",
    "stage_seconds",
]
