"""Fleet plane of the port: the process axis a multi-process run shards a
scan by (:mod:`multihost`, a copy of ``lakesoul_tpu/fleet/multihost.py``
that asks ``torch.distributed`` where the reference asks jax) and the
``train`` role of ``python -m lakesoul_tpu_torch.fleet`` (in-process, or
through a scan-plane gateway with ``--location``), and the transport seam a
scan-plane exchange delivers spool segments over (:mod:`transport`: shm,
object-store spill, Flight stream).  The reference's autoscaler is not
ported yet."""

from __future__ import annotations

from lakesoul_tpu_torch.fleet.multihost import digest_batch, process_axis, shard_scan

__all__ = ["digest_batch", "process_axis", "shard_scan"]
