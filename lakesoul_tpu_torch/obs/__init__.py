"""Observability of the port: the process-wide metrics registry."""

from lakesoul_tpu_torch.obs.metrics import registry

__all__ = ["registry"]
