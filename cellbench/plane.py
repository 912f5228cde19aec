"""The ANN plane of an ``ann_plane_*`` configuration, built in memory on the
card, shard by shard, by the program's own calls.

Each shard is built as ``annplane/build.py``'s ``ShardedAnnBuilder.
_build_shard`` builds it: ``IvfRabitqIndex.train`` on a seeded sample of
the shard's rows, ``insert_batch`` of every row in the builder's chunks,
``merge_deltas``; its ``write_index`` is left out, since the shards with
raw vectors would be ~6 GB on disk, more than a run may write.
``AnnPlane.from_indexes`` then opens the plane.  The corpus is
``inputs.corpus_rows``, made on the card from the seed; a row's id is its
index in the corpus.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

import inputs
from harness import log


def plane_config(cfg: dict):
    from lakesoul_tpu_torch.annplane import AnnPlaneConfig
    from lakesoul_tpu_torch.vector import VectorIndexConfig

    index = VectorIndexConfig("emb", int(cfg["dim"]), nlist=int(cfg["nlist"]),
                              total_bits=int(cfg["total_bits"]), rotator=cfg["rotator"],
                              seed=int(cfg["index_seed"]))
    return AnnPlaneConfig(index=index, shard_budget_bytes=int(cfg["shard_budget_bytes"]),
                          keep_raw=bool(cfg["keep_raw"]),
                          train_sample_rows=int(cfg["train_sample_rows"]),
                          kmeans_iters=int(cfg["kmeans_iters"]))


def shard_ranges(rows: int, rows_per_shard: int) -> list:
    return [(lo, min(lo + rows_per_shard, rows)) for lo in range(0, rows, rows_per_shard)]


def build(seed: int, cfg: dict, device, *, faults=()):
    """→ (plane, shard ranges, the corpus's centres).  ``faults`` may plant
    ``kmeans_unchanged`` underneath the build: k-means hands back its
    initial centroids."""
    from lakesoul_tpu_torch.annplane import AnnPlane
    from lakesoul_tpu_torch.vector import index as index_mod

    pcfg = plane_config(cfg)
    centers = inputs.corpus_centers(seed, cfg["corpus"], pcfg.index.dim, device)
    ranges = shard_ranges(int(cfg["rows"]), pcfg.rows_per_shard())
    indexes = []
    t = time.perf_counter()
    kmeans = index_mod.kmeans
    if "kmeans_unchanged" in faults:
        index_mod.kmeans = lambda data, k, *, iters=10, seed=42: kmeans(data, k, iters=0, seed=seed)
    try:
        indexes = _shards(seed, cfg, pcfg, centers, ranges, device)
    finally:
        index_mod.kmeans = kmeans
    log(f"{len(ranges)} shards built in {time.perf_counter() - t:.1f} s")
    plane = AnnPlane.from_indexes(pcfg, indexes, device=device)
    del indexes
    return plane, ranges, centers


@contextlib.contextmanager
def planted(plane, faults):
    """While open, ``scores`` in ``faults`` plants a fault underneath every
    search of ``plane``: each estimate ``ragged_score`` produces is read one
    row off."""
    if "scores" not in faults:
        yield plane
        return
    from lakesoul_tpu_torch.annplane import search as search_mod

    real = search_mod.ragged_score
    search_mod.ragged_score = lambda *x, **k: torch.roll(real(*x, **k), 1, dims=1)
    try:
        yield plane
    finally:
        search_mod.ragged_score = real


def _shards(seed, cfg, pcfg, centers, ranges, device) -> list:
    """Each shard as ``ShardedAnnBuilder._build_shard`` builds it, but for
    its ``write_index``: a copy of its calls, so ``setup_s`` follows this
    copy, and a change to the builder's own order or chunking shows only
    once a build entry that writes nothing replaces it."""
    from lakesoul_tpu_torch.annplane.build import INSERT_CHUNK_ROWS
    from lakesoul_tpu_torch.vector.index import IvfRabitqIndex

    icfg = pcfg.index
    dim = icfg.dim
    indexes = []
    for shard, (lo, hi) in enumerate(ranges):
        x = inputs.corpus_rows(seed, cfg["corpus"], centers, lo, hi)
        ids = np.arange(lo, hi, dtype=np.uint64)
        n = hi - lo
        kw = dict(keep_raw=pcfg.keep_raw, kmeans_iters=pcfg.kmeans_iters, device=device)
        if n <= pcfg.train_sample_rows:
            index = IvfRabitqIndex.train(x, ids, icfg, **kw)
        else:
            sel = np.random.default_rng(icfg.seed + shard).choice(n, pcfg.train_sample_rows,
                                                                  replace=False)
            index = IvfRabitqIndex.train(x[torch.from_numpy(sel).to(x.device)], ids[sel], icfg,
                                         **kw)
            empty = torch.zeros((0, dim), dtype=torch.float32, device=x.device)
            index.clusters = [index._make_cluster(empty, np.zeros(0, np.uint64), c)
                              for c in index.centroids]
            for a in range(0, n, INSERT_CHUNK_ROWS):
                index.insert_batch(x[a:a + INSERT_CHUNK_ROWS], ids[a:a + INSERT_CHUNK_ROWS])
            index.merge_deltas()
        indexes.append(index)
        del x
    return indexes


def sample_row_ids(seed: int, ranges, per_shard: int) -> list:
    """The rows of each shard whose build state is checked, drawn from the
    seed: sorted corpus indices."""
    rng = np.random.Generator(np.random.PCG64(inputs.derive_seed(seed, "build_rows")))
    return [np.sort(lo + rng.choice(hi - lo, min(per_shard, hi - lo), replace=False))
            for lo, hi in ranges]


def plane_state(plane, row_ids) -> dict:
    """What the benchmark reads of a built plane, on the host, before the
    plane is freed: each shard's centroids and rows a list (the roofline's
    count and the reference's judging of the k-means), and for the rows
    ``row_ids`` names in each shard, the list that holds the row and its
    resident codes (û = codes · scale) and estimator constants ``a``, ``b``."""
    state = {"centroids": [], "row_counts": [], "rows": []}
    for s, want in zip(plane.shards, row_ids):
        state["centroids"].append(s.centroids.cpu().numpy())
        state["row_counts"].append(np.asarray(s.row_count, np.int64))
        counts = np.asarray(s.row_count, np.int64)
        pos = np.concatenate([np.arange(a, a + n) for a, n in zip(s.row_start, counts)])
        lists = np.repeat(np.arange(len(counts)), counts)
        ids = s.ids[pos].astype(np.int64)
        order = np.argsort(ids, kind="stable")
        at = order[np.minimum(np.searchsorted(ids[order], want), len(ids) - 1)]
        p = torch.from_numpy(pos[at]).to(s.codes.device)
        # a row in no list of its shard is held by none: list -1
        state["rows"].append({"ids": want, "list": np.where(ids[at] == want, lists[at], -1),
                              "u_hat": s.codes[p].cpu().numpy(), "a": s.a[p].cpu().numpy(),
                              "b": s.b[p].cpu().numpy()})
    return state
