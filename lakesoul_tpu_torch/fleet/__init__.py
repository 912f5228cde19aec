"""Fleet plane of the port: the process axis a multi-process run shards a
scan by (:mod:`multihost`, a copy of ``lakesoul_tpu/fleet/multihost.py``
that asks ``torch.distributed`` where the reference asks jax) and the
``train`` role of ``python -m lakesoul_tpu_torch.fleet``.  The reference's
transports and autoscaler are not ported yet."""

from __future__ import annotations

from lakesoul_tpu_torch.fleet.multihost import digest_batch, process_axis, shard_scan

__all__ = ["digest_batch", "process_axis", "shard_scan"]
