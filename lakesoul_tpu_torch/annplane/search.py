"""Multi-shard ANN search (the port of ``lakesoul_tpu/annplane/search.py``):
global probe selection, ragged dispatch, cross-shard candidate union and
exact re-rank, all on the plane's device.

Opening a plane loads every shard's IVF-RaBitQ index into a RESIDENT layout
built on the device: cluster-sorted rows, padded per cluster to a TILE
multiple, 1-bit codes unpacked to f32 (ex-codes as codes · scales, the same
f32 layout).  A search micro-batch:

1. **probe selection** — one gram matmul of the batch against ALL shards'
   centroids and a ``topk``: each query takes its ``nprobe`` nearest
   clusters *globally*.  Rotation is orthonormal, so the same distances are
   the estimator's per-(query, cluster) ``csq``.  The probe pairs come to
   the host once per batch.
2. **ragged scoring** — per shard, the pairs that landed there become item
   tables (:func:`~lakesoul_tpu_torch.annplane.ragged.plan_items`) and one
   :func:`ragged_score` launch; :func:`items_topk` keeps each query's
   estimator top-``shortlist`` rows.
3. **exact re-rank + union** — candidates re-rank against the raw vectors
   (one gather + ``bmm``), then one ``topk`` over the [nq, shards·s] union
   cuts to top-k.  With ``keep_raw=False`` planes the union merges
   estimator distances instead.

A query's answer does not depend on the batch it rides in: the probe
distances, ``csum`` and the re-rank distances are taken in float64 and
rounded to float32, because cuBLAS picks its kernel — and with it the order
of a float32 sum — by the batch's shape (a batch of one runs a gemv), and a
last-bit change at the probe or shortlist boundary changes which rows a
query sees.  The item kernel computes each item alone, so it is invariant.

Shards run one after another on the current CUDA stream.  A plane opened
on the CPU takes the reference's host path where the native library is
built, chosen by the plane's device: :func:`ragged_topk_host` for the
shortlist and the native exact re-rank, as the reference's CPU plane does.
Without the library it runs the item path and the float64 re-rank, as the
card does, on the kernels' plain versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lakesoul_tpu_torch import native
from lakesoul_tpu_torch.annplane.config import AnnPlaneConfig
from lakesoul_tpu_torch.annplane.manifest import PlaneManifestStore
from lakesoul_tpu_torch.annplane.ragged import (
    PAD_B,
    TILE,
    fold_cluster,
    items_topk,
    plan_items,
    ragged_score,
    ragged_topk_host,
)
from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex, SearchParams
from lakesoul_tpu_torch.vector.kernels import PAD_RAW, exact_distances
from lakesoul_tpu_torch.vector.manifest import ManifestStore
from lakesoul_tpu_torch.vector.rabitq import RabitqQuantizer, unpack_bits


class _ShardResident:
    """One shard's arrays in the ragged-search layout, on ``device``.

    Rows are cluster-sorted and padded per cluster to a TILE multiple; the
    pad rows carry ``b = PAD_B`` (and codes 0, a 0, raw ``PAD_RAW``) so the
    kernel scores them out.  ``tile_start``/``tile_count`` (host int32) index
    the padded tiles, ``row_start``/``row_count`` (host int64) the real rows.
    ``ids`` stay host ``np.uint64``."""

    def __init__(self, index: IvfRabitqIndex, *, tile: int = TILE, device=None):
        if index.centroids is None:
            raise VectorIndexError("shard index is not trained")
        dev = index.device if device is None else torch.device(device)
        dpad = index.quantizer.padded_dim
        nlist = len(index.centroids)
        self.centroids = index.centroids.to(dev)
        self.tile = tile

        segs = [(c, s) for c in range(nlist) for s in index._cluster_segments(c) if len(s.ids)]
        counts = np.zeros(nlist, np.int64)
        for c, s in segs:
            counts[c] += len(s.ids)
        padded = (counts + tile - 1) // tile * tile
        n_pad = int(padded.sum()) or tile
        self.tile_start = np.concatenate([[0], np.cumsum(padded[:-1] // tile)]).astype(np.int32)
        self.tile_count = (padded // tile).astype(np.int32)
        self.row_start = self.tile_start.astype(np.int64) * tile
        self.row_count = counts
        self.num_vectors = int(counts.sum())

        self.codes = torch.zeros((n_pad, dpad), dtype=torch.float32, device=dev)
        self.a = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        self.b = torch.full((n_pad,), float(PAD_B), dtype=torch.float32, device=dev)
        self.h = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        self.ids = np.zeros(n_pad, np.uint64)
        self.raw = (
            torch.full((n_pad, index.config.dim), float(PAD_RAW), dtype=torch.float32, device=dev)
            if index.keep_raw else None
        )
        if not segs:
            return
        # each real row's destination: its cluster's first row + its place
        # among the cluster's rows, segments in order (base, then deltas)
        seg_cluster = np.array([c for c, _ in segs], np.int64)
        seg_len = np.array([len(s.ids) for _, s in segs], np.int64)
        seg_base = np.cumsum(seg_len) - seg_len  # first concatenated row of each segment
        first = np.searchsorted(seg_cluster, seg_cluster)  # first segment of its cluster
        seg_dest = self.row_start[seg_cluster] + seg_base - seg_base[first]
        dest = np.repeat(seg_dest - seg_base, seg_len) + np.arange(seg_len.sum())
        self.ids[dest] = np.concatenate([s.ids for _, s in segs])
        dest_t = torch.from_numpy(dest).to(dev)

        def cat(field):
            return torch.cat([getattr(s, field) for _, s in segs]).to(dev)

        ex = index.config.total_bits > 1
        if ex:
            if any(s.scales is None for _, s in segs):
                raise VectorIndexError("ex-bits shard segment has no scales — rebuild")
            # u_hat = codes · scales, one float32 multiply an element
            self.codes[dest_t] = cat("codes").to(torch.float32) * cat("scales")[:, None]
        else:
            self.codes[dest_t] = unpack_bits(cat("codes"), dpad)
        a, b, h = fold_cluster(cat("norms"), cat("factors"), cat("code_dot_c"), d=dpad, ex=ex)
        self.a[dest_t], self.b[dest_t], self.h[dest_t] = a, b, h
        if self.raw is not None:
            if any(s.raw is None for _, s in segs):
                raise VectorIndexError("keep_raw shard has a segment without raw vectors")
            self.raw[dest_t] = cat("raw")


class AnnPlane:
    """A loaded multi-shard plane, ready to serve ragged micro-batches.  The
    ragged kernel runs iff the plane's device is CUDA."""

    def __init__(self, config: AnnPlaneConfig, shards: list[_ShardResident], *,
                 manifest: dict | None = None):
        if not shards:
            raise VectorIndexError("ANN plane has no shards")
        self.plane_config = config
        self.config: VectorIndexConfig = config.index
        self.shards = shards
        self.manifest = manifest or {}
        self.device = shards[0].codes.device
        self.quantizer = RabitqQuantizer(
            self.config.dim, rotator=self.config.rotator, seed=self.config.seed,
            device=self.device,
        )
        # plane-global cluster table: concatenated centroids with a
        # (shard, local cluster) map for every global cluster id
        self.centroids = torch.cat([s.centroids for s in shards])
        self.shard_of = np.concatenate(
            [np.full(len(s.centroids), i, np.int32) for i, s in enumerate(shards)]
        )
        self.local_cluster = np.concatenate(
            [np.arange(len(s.centroids), dtype=np.int32) for s in shards]
        )
        self._cent64 = self.centroids.double()
        self._cent_sq = (self._cent64 * self._cent64).sum(1)
        self._cent_rot_sum = self.quantizer.rotate(self.centroids).double().sum(1).cpu().numpy()
        self._ex = self.config.total_bits > 1  # ex-codes: csum is 0
        # a shard's candidate row r is plane row row_offset[shard] + r
        sizes = [len(s.ids) for s in shards]
        self._row_offset = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self._ids = np.concatenate([s.ids for s in shards])
        reg = registry()
        self._c_queries = reg.counter("lakesoul_ann_ragged_queries_total")
        self._c_pairs = reg.counter("lakesoul_ann_ragged_pairs_total")
        self._h_dispatch = reg.histogram("lakesoul_ann_ragged_dispatch_seconds")

    # ------------------------------------------------------------------- load
    @classmethod
    def open(cls, root: str, storage_options: dict | None = None, *, device=None,
             tile: int = TILE) -> "AnnPlane":
        """Load a complete plane directory (written by either package; a
        local path or an object-store URI); each shard at the generation the
        plane record pinned."""
        from lakesoul_tpu_torch.annplane.build import shard_root

        dev = resolve_device(device)
        manifest = PlaneManifestStore(root, storage_options).read()
        if manifest is None:
            raise VectorIndexError(f"no ANN plane at {root}")
        if not manifest.get("complete"):
            raise VectorIndexError(
                f"ANN plane at {root} is mid-build"
                f" ({len(manifest.get('shards', ()))} shard(s) durable);"
                " resume the builder first"
            )
        config = AnnPlaneConfig(
            index=VectorIndexConfig.parse(manifest["index_config"]),
            shard_budget_bytes=manifest["shard_budget_bytes"],
            keep_raw=manifest["keep_raw"],
        )
        # load the generation the plane record PINNED, not LATEST: a
        # concurrent rebuild bumps shard stores one by one, and reading their
        # moving pointers would mix generations into one plane
        shards = [
            _ShardResident(
                ManifestStore(shard_root(root, e["shard"]), storage_options).read_at(
                    e["generation"], device=dev),
                tile=tile,
            )
            for e in manifest["shards"]
        ]
        return cls(config, shards, manifest=manifest)

    @classmethod
    def from_indexes(cls, config: AnnPlaneConfig, indexes, *, device=None,
                     tile: int = TILE) -> "AnnPlane":
        """A plane over in-memory port indexes, one shard each."""
        dev = resolve_device(device)
        return cls(config, [_ShardResident(ix, tile=tile, device=dev) for ix in indexes])

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def num_vectors(self) -> int:
        return sum(s.num_vectors for s in self.shards)

    # ----------------------------------------------------------------- search
    def search(self, query, params: SearchParams = SearchParams()):
        ids, dists = self.batch_search(query, params)
        return ids[0], dists[0]

    def probe_pairs(self, queries: torch.Tensor, nprobes: np.ndarray):
        """Global probe selection for a batch → host numpy (pairs_q,
        pairs_gc, csq, csum), query-major and nearest first within a query,
        plus the rotated queries [nq, d] on the device."""
        nq = len(queries)
        q64 = queries.double()
        cd = (q64 * q64).sum(1, keepdim=True) - 2.0 * q64 @ self._cent64.T + self._cent_sq[None, :]
        sel_d, sel = torch.topk(cd, int(nprobes.max()), dim=1, largest=False, sorted=True)
        q_glob = self.quantizer.rotate(queries).contiguous()
        qsum = q_glob.double().sum(1)
        sel, sel_d, qsum = sel.cpu().numpy(), sel_d.float().cpu().numpy(), qsum.cpu().numpy()
        keep = np.arange(sel.shape[1])[None, :] < nprobes[:, None]
        pairs_q = np.repeat(np.arange(nq, dtype=np.int64), keep.sum(axis=1))
        pairs_gc = sel[keep]
        if self._ex:
            csum = np.zeros(len(pairs_gc), np.float32)
        else:
            csum = (self._cent_rot_sum[pairs_gc] - qsum[pairs_q]).astype(np.float32)
        return pairs_q, pairs_gc, sel_d[keep], csum, q_glob

    def batch_search(self, queries, params: SearchParams = SearchParams(), *,
                     nprobes=None):
        """→ (ids per query, dists per query).  ``nprobes`` overrides
        ``params.nprobe`` per query — the ragged dispatch fuses the mixed
        probe depths into one scoring pass per shard."""
        start = time.perf_counter()
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        queries = queries.reshape(-1, queries.shape[-1])
        nq = len(queries)
        n_clusters = len(self.centroids)
        if nprobes is None:
            nprobes = np.full(nq, params.nprobe, np.int64)
        else:
            nprobes = np.asarray(nprobes, np.int64)
            if len(nprobes) != nq:
                raise VectorIndexError("nprobes length must match queries")
        nprobes = np.clip(nprobes, 1, n_clusters)
        s = params.shortlist()
        pairs_q, pairs_gc, csq, csum, q_glob = self.probe_pairs(queries, nprobes)
        self._c_queries.inc(nq)
        self._c_pairs.inc(len(pairs_gc))

        shard_sel = self.shard_of[pairs_gc]
        dists, rows = [], []
        for si, shard in enumerate(self.shards):
            m = shard_sel == si
            if not m.any():
                continue
            r, est = self._score_shard(shard, q_glob, pairs_q[m], self.local_cluster[pairs_gc[m]],
                                       csq[m], csum[m], nq, s)
            dists.append(self._rerank_shard(shard, queries, r, est))
            rows.append(torch.where(r >= 0, r + int(self._row_offset[si]), -1))
        # union: one top-k over every shard's candidates, +inf holes last
        d_all, r_all = torch.cat(dists, dim=1), torch.cat(rows, dim=1)
        top_d, top_i = torch.topk(d_all, min(params.top_k, d_all.shape[1]), dim=1,
                                  largest=False, sorted=True)
        top_d = top_d.cpu().numpy()
        top_r = torch.gather(r_all, 1, top_i).cpu().numpy()
        out_ids, out_d = [], []
        for q in range(nq):
            valid = np.isfinite(top_d[q])
            out_ids.append(self._ids[top_r[q][valid]])
            out_d.append(top_d[q][valid])
        self._h_dispatch.observe(time.perf_counter() - start)
        return out_ids, out_d

    # ------------------------------------------------------------- internals
    def _score_shard(self, shard, q_glob, pairs_q, pairs_lc, csq, csum, nq: int, s: int):
        """Estimator top-``s`` rows of one shard for every query of the
        batch: (rows [nq, s] with -1 holes, est [nq, s] with +inf holes).
        On the card: the item tables into ``ragged_score``; on the CPU with
        the native library: the reference's host path."""
        if self.device.type == "cpu" and native.available():
            rows, est = ragged_topk_host(
                shard.codes.numpy(), shard.a.numpy(), shard.b.numpy(), shard.h.numpy(),
                shard.row_start, shard.row_count, pairs_q, pairs_lc, csq, csum,
                q_glob.numpy(), nq, s,
            )
            return torch.from_numpy(rows), torch.from_numpy(est)
        item_q, item_tile, icsq, icsum = plan_items(
            pairs_q, pairs_lc, csq, csum, shard.tile_start, shard.tile_count
        )
        est = ragged_score(item_q, item_tile, icsq, icsum, q_glob, shard.codes,
                           shard.a, shard.b, shard.h, tile=shard.tile)
        return items_topk(est, item_q, item_tile, nq, s, tile=shard.tile)

    @staticmethod
    def _rerank_shard(shard, queries, rows, est):
        """Exact distances of one shard's candidate rows (raw kept), else the
        estimator distances pass through; -1 rows stay +inf holes.  On the
        CPU with the native library: its re-rank, as the reference's."""
        if shard.raw is None:
            return est
        if rows.device.type == "cpu" and native.available():
            r = np.ascontiguousarray(rows.numpy(), np.int64)
            return torch.from_numpy(
                native.ann_exact_rerank(shard.raw.numpy(), r, queries.numpy()))
        exact = exact_distances(shard.raw[rows.clamp_min(0)].double(), queries.double())
        return exact.float().masked_fill(rows < 0, float("inf"))
