"""Fleet plane of the port (copies of ``lakesoul_tpu/fleet/``): the
cross-host tier composing the existing planes.

- :mod:`~lakesoul_tpu_torch.fleet.transport` — the spool-segment transport
  seam a scan-plane exchange delivers over: shm, object-store spill, Flight
  stream.
- :mod:`~lakesoul_tpu_torch.fleet.autoscale` — a leased controller that
  watches the spool backlog and the FleetAggregator merged view and spawns /
  retires scanplane workers between a declared min/max; a SIGKILLed
  controller fails over fenced via the metadata store's lease table.
- :mod:`~lakesoul_tpu_torch.fleet.multihost` — the process axis a
  multi-process run shards a scan by (``torch.distributed``'s rank and world
  size where the reference asks jax).

``python -m lakesoul_tpu_torch.fleet`` exposes the ``autoscale`` and
``train`` roles — the processes the chaos tests SIGKILL.
"""

from __future__ import annotations

from lakesoul_tpu_torch.fleet.multihost import digest_batch, process_axis, shard_scan
from lakesoul_tpu_torch.fleet.transport import (
    TRANSPORTS,
    forced_transport,
    meter_range,
    negotiated,
)

__all__ = [
    "TRANSPORTS",
    "digest_batch",
    "forced_transport",
    "meter_range",
    "negotiated",
    "process_axis",
    "shard_scan",
]
