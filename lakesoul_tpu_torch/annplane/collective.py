"""Cross-device top-k merge for device-sharded planes, the port of
``lakesoul_tpu/annplane/collective.py``.

When shards live in different cards' memory, each card produces its local
top-k and the plane needs ONE global top-k without shipping full candidate
sets to the host: all-gather the (distances, local rows) pairs — k entries
a rank, tiny — then every rank computes the identical merged top-k.  Ties
resolve as the reference's ``lax.top_k`` over the negated distances does,
the lower flat index (source rank, then slot) first: a stable sort, since
``torch.topk`` gives no order among ties.

Row ids cross the collective as int32 LOCAL row indices, as in the
reference; the host maps (source rank, local row) back to u64 ids.
``dryrun_multichip`` runs the merge on ``n`` gloo CPU ranks and holds it
against the host oracle merge.
"""

from __future__ import annotations

import numpy as np
import torch

from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.parallel.collectives import all_gather_stack


def cross_chip_topk(dists_local, rows_local, *, k: int | None = None, group):
    """Merge this rank's top-k candidates with every other rank's of ``group``.

    ``dists_local`` / ``rows_local``: [k_local] (float32 / int32 local row
    indices), on the group's device.  → (merged dists [k], rows [k], source
    rank [k] int32), the same on every rank."""
    d = torch.as_tensor(dists_local, dtype=torch.float32)
    r = torch.as_tensor(rows_local, dtype=torch.int32, device=d.device)
    if r.shape != d.shape or d.dim() != 1:
        raise VectorIndexError("dists/rows shape mismatch")
    gd = all_gather_stack(d, group)  # [n, k_local]
    gr = all_gather_stack(r, group)
    n, k_local = gd.shape
    k = k_local if k is None else min(k, n * k_local)
    flat = gd.reshape(-1)
    order = torch.sort(flat, stable=True).indices[:k]
    return flat[order], gr.reshape(-1)[order], (order // k_local).to(torch.int32)


def _candidates(n_devices: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    local_k = 2 * k
    dists = rng.random((n_devices, local_k)).astype(np.float32)
    rows = rng.integers(0, 1 << 20, (n_devices, local_k)).astype(np.int32)
    return dists, rows


def _dryrun_rank(n_devices: int, k: int, seed: int):
    import torch.distributed as dist

    dists, rows = _candidates(n_devices, k, seed)
    me = dist.get_rank()
    d, r, src = cross_chip_topk(dists[me], rows[me], k=k, group=dist.group.WORLD)
    return d.numpy(), r.numpy(), src.numpy()


def dryrun_multichip(n_devices: int = 8, *, k: int = 10, seed: int = 0) -> dict:
    """One cross-rank merge over ``n_devices`` gloo CPU ranks with seeded
    candidates, every rank's answer held against the host oracle.  Raises
    on any divergence; returns the merged result for the record."""
    from lakesoul_tpu_torch.parallel.launch import run_ranks

    dists, rows = _candidates(n_devices, k, seed)
    flat_d = dists.reshape(-1)
    order = np.argsort(flat_d, kind="stable")[:k]
    for d, r, src in run_ranks("lakesoul_tpu_torch.annplane.collective:_dryrun_rank",
                               n_devices, (n_devices, k, seed)):
        np.testing.assert_allclose(d, flat_d[order], rtol=1e-6)
        np.testing.assert_array_equal(r, rows.reshape(-1)[order])
        np.testing.assert_array_equal(src, (order // dists.shape[1]).astype(np.int32))
    return {"devices": n_devices, "k": k, "dists": flat_d[order].tolist()}
