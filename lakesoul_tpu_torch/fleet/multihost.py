"""Process-indexed multi-host sharding: ONE table feeding N hosts.

``to_torch_iter(multihost=True)`` (and ``LakeSoulScan.auto_shard``) resolve
this module's :func:`process_axis` — the host's position on the data
axis — and shard the scan ``i % count == index`` through the existing
``shard()`` builder, so every downstream consumer (batch-source seam,
scanplane delivery, replay cache) sees a plain sharded scan:

- ranks are **disjoint** and their union is **complete** (the unit
  assignment is round-robin over the deterministic plan order);
- the per-rank stream is byte-identical to a single-process
  ``scan.shard(rank, world)`` — the property the fleet bench asserts
  per rank with sha256 oracles;
The axis comes from ``torch.distributed``'s rank and world size when a
process group is initialised (the reference asks
``jax.process_index()/process_count()``).  ``LAKESOUL_FLEET_PROCESS_INDEX``
/ ``LAKESOUL_FLEET_PROCESS_COUNT`` override it — the emulation hook that
runs N "hosts" as N processes on one machine, and an escape hatch for
launchers that know the topology before a process group exists.
"""

from __future__ import annotations

import os

from lakesoul_tpu_torch.errors import ConfigError

ENV_INDEX = "LAKESOUL_FLEET_PROCESS_INDEX"
ENV_COUNT = "LAKESOUL_FLEET_PROCESS_COUNT"


def process_axis() -> "tuple[int, int]":
    """(process_index, process_count) for the data axis: the env override
    when set (both vars required together, validated), else the rank and
    world size of the initialised ``torch.distributed`` process group, else
    a single process."""
    raw_idx = os.environ.get(ENV_INDEX)
    raw_cnt = os.environ.get(ENV_COUNT)
    if raw_idx is not None or raw_cnt is not None:
        if raw_idx is None or raw_cnt is None:
            raise ConfigError(
                f"{ENV_INDEX} and {ENV_COUNT} must be set together"
            )
        try:
            idx, cnt = int(raw_idx), int(raw_cnt)
        except ValueError:
            raise ConfigError(
                f"non-integer {ENV_INDEX}/{ENV_COUNT}:"
                f" {raw_idx!r}/{raw_cnt!r}"
            )
        if cnt < 1 or not 0 <= idx < cnt:
            raise ConfigError(
                f"invalid process axis index={idx} count={cnt}"
            )
        return idx, cnt
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def digest_batch(digest, batch: dict) -> int:
    """Fold one collated batch into a sha256 — the per-rank identity
    oracle (``fleet train`` output vs a single-process shard scan).
    Content-deterministic across processes: numeric arrays hash their
    buffer bytes; string/object columns hash their VALUES (an object
    array's raw buffer is per-process pointers).  A tensor on the card is
    copied to the host first, so a card batch hashes as its host batch
    does.  Returns the row count."""
    import numpy as np

    rows = None
    for name in sorted(batch):
        col = batch[name]
        if getattr(col, "is_cuda", False):
            col = col.cpu()
        arr = np.asarray(col)
        rows = len(arr) if rows is None else rows
        digest.update(name.encode())
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            for v in arr:
                digest.update(str(v).encode())
                digest.update(b"\x00")
        else:
            digest.update(np.ascontiguousarray(arr).tobytes())
    return rows or 0


def shard_scan(scan):
    """Apply the process axis to a scan.  A scan the caller already
    sharded CONSISTENTLY passes through (idempotent — a shared input
    pipeline built once per host may hit both paths); an inconsistent
    explicit shard is a configuration conflict that must fail loudly,
    not silently train on the wrong rows."""
    index, count = process_axis()
    if scan._rank is not None:
        if (scan._rank, scan._world) == (index, count):
            return scan
        raise ConfigError(
            f"multihost=True on a scan already sharded"
            f" ({scan._rank}/{scan._world}) differently from this host's"
            f" process axis ({index}/{count}); drop the explicit shard()"
            " or the multihost flag"
        )
    if count <= 1:
        return scan
    return scan.shard(index, count)
