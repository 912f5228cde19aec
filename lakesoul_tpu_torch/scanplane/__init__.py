"""Disaggregated scan plane: one table feeding a fleet of trainers (the
port's copy of ``lakesoul_tpu/scanplane/``).

The single-process data path terminates in the process that decodes it;
this package scales the scan OUT (the reference's L6 Flight gateway role;
Deep Lake's streaming dataloader, arxiv 2209.10785).  Workers decode on the
host; the card comes in where a trainer consumes the stream:
``scan.via_scanplane(location).to_torch_iter()`` puts each batch on the CUDA
card through the same pinned side-stream copies as a local scan.

- **Sessions** (:mod:`.session`): a scan request + the pinned plan, split
  into deterministic *ranges* (one per scan unit, in plan order) and
  published as a manifest every process can read.
- **Workers** (:mod:`.worker`): separate OS processes that lease ranges
  through the metadata store's lease table (fencing tokens, TTL heartbeat), decode +
  MOR-merge them through the normal scan path, and publish each range as
  an Arrow IPC *spool segment* (atomic rename) with a sidecar carrying
  rows and per-stage timings.  SIGKILL a worker: its leases expire within
  one TTL and a peer re-produces the ranges — byte-identical, because the
  scan path is deterministic.
- **Delivery** (:mod:`.delivery` + the ``scan_stream`` DoExchange verb in
  :mod:`lakesoul_tpu_torch.service.flight`): trainer clients stream their rank's
  ranges over Flight, admission-gated and RBAC-checked like every other
  verb; same-host clients negotiate the shared-memory fast path and read
  the spool segments zero-copy (``pa.memory_map``) — only control messages
  cross the socket.  Default spool dirs are pid-stamped (``.spool-owner``)
  and atexit-swept; :func:`.delivery.prune_stale_spools` reclaims dirs
  whose owner died without atexit (SIGKILL), so tmpfs never accretes
  debris across restarts.
- **Clients** (:mod:`.client`): :class:`~.client.ScanPlaneClient` is a
  drop-in batch source for ``scan.to_torch_iter()`` / the torch
  adapter (``scan.via_scanplane(...)``), with mid-stream reconnect resume
  (exactly-once delivery across worker deaths and socket errors) and the
  workers' stage timings merged into the local registry snapshot.
- **Service** (:mod:`.service`, ``python -m lakesoul_tpu_torch.scanplane``):
  the deployable process — a Flight gateway plus N worker child processes —
  mirroring the reference's compaction service entry.
"""

from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient
from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery
from lakesoul_tpu_torch.scanplane.session import ScanSession, session_request_from_scan
from lakesoul_tpu_torch.scanplane.worker import ScanPlaneWorker

__all__ = [
    "ScanPlaneClient",
    "ScanPlaneDelivery",
    "ScanPlaneWorker",
    "ScanSession",
    "session_request_from_scan",
]
