"""Shared pipelined-execution runtime of the port (copies of
``lakesoul_tpu/runtime/``).

- :mod:`lakesoul_tpu_torch.runtime.pool` — one process-wide, fork-safe,
  lazily spawned worker pool (``LAKESOUL_RUNTIME_THREADS``).
- :mod:`lakesoul_tpu_torch.runtime.pipeline` — staged pipelines with
  bounded queues, backpressure, ordered output, exception propagation,
  cooperative cancellation and deadlines.
- :mod:`lakesoul_tpu_torch.runtime.faults` — ``LAKESOUL_FAULTS=stage:p``
  fault injection.
- :mod:`lakesoul_tpu_torch.runtime.resilience` — transient/permanent
  taxonomy, :class:`RetryPolicy`, :class:`CircuitBreaker`,
  :class:`AdmissionController`.
- :mod:`lakesoul_tpu_torch.runtime.atomicio` — atomic publication of one
  local file (the subset the index and plane manifests use).
"""

from lakesoul_tpu_torch.runtime.faults import FaultInjected, FaultSpec
from lakesoul_tpu_torch.runtime.pipeline import (
    DeadlineExceeded,
    Pipeline,
    PipelineCancelled,
    PipelineIterator,
    pipeline,
)
from lakesoul_tpu_torch.runtime.pool import (
    WorkerPool,
    default_pool_size,
    get_pool,
    shutdown_pool,
)
from lakesoul_tpu_torch.runtime.resilience import (
    AdmissionController,
    CircuitBreaker,
    RetryPolicy,
    is_transient,
)

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "DeadlineExceeded",
    "FaultInjected",
    "FaultSpec",
    "Pipeline",
    "PipelineCancelled",
    "PipelineIterator",
    "RetryPolicy",
    "WorkerPool",
    "default_pool_size",
    "get_pool",
    "is_transient",
    "pipeline",
    "shutdown_pool",
]
