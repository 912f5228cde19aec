"""IVF + RaBitQ ANN index in PyTorch (the port of
``lakesoul_tpu/vector/index.py``).

Cluster scans are packed-code products on the index's device
(:mod:`lakesoul_tpu_torch.vector.kernels`) for 1-bit codes, and codes ·
query products taken in float64 for the ex-codes of ``total_bits`` 2-16
(int8 up to 8 bits, int16 above, one scale a row); train is k-means on
the same device.  Codes, norms, factors, scales and raw vectors live on the
device as tensors; row ids stay on the host as ``np.uint64`` (torch has no
usable unsigned 64-bit type).

Incremental inserts append to per-cluster *delta* segments, mirroring the
reference's base + delta segments; ``merge_deltas()`` folds them in.

:meth:`IvfRabitqIndex.state` and :meth:`IvfRabitqIndex.from_state` carry an
index across as numpy arrays, with the field names of ``_Cluster`` — the
same fields as the JAX package's ``_Cluster``, so an index built there
becomes one here with no math."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import ConfigError, VectorIndexError
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.kernels import (
    PAD_FACTOR,
    PAD_NORM,
    PAD_RAW,
    _fused_search_resident,
    _fused_search_resident_batch,
    _fused_search_resident_ex_batch,
    _pad_tail,
    _pow2_bucket,
    fused_search,
    fused_search_ex,
)
from lakesoul_tpu_torch.vector.kmeans import kmeans
from lakesoul_tpu_torch.vector.rabitq import RabitqQuantizer

# the batched kernel's query axis per call; larger batches are chunked
MAX_Q = 256


def _finalize_topk(ids: np.ndarray, dists: np.ndarray, idx: np.ndarray, top_k: int):
    """Drop pad rows from a fused-search result and cut to top_k."""
    valid = (idx < len(ids)) & np.isfinite(dists)
    idx, dists = idx[valid], dists[valid]
    k = min(top_k, len(ids))
    return ids[idx[:k]], dists[:k]


def _empty_result():
    return np.zeros(0, np.uint64), np.zeros(0, np.float32)


@dataclass(frozen=True)
class SearchParams:
    """reference: SearchParams{top_k, nprobe} (ivf/mod.rs:29).

    ``rerank_depth`` sizes the estimator shortlist handed to the exact
    re-rank (None → 4·top_k)."""

    top_k: int = 10
    nprobe: int = 8
    rerank_depth: int | None = None

    def shortlist(self) -> int:
        s = self.rerank_depth if self.rerank_depth is not None else self.top_k * 4
        return max(s, self.top_k)


@dataclass
class _Cluster:
    codes: torch.Tensor  # 1-bit: [n, padded/8] uint8 packed; ex: [n, padded] int8|int16
    norms: torch.Tensor  # [n] f32
    factors: torch.Tensor  # [n] f32
    ids: np.ndarray  # [n] u64 row ids, host side
    code_dot_c: torch.Tensor  # [n] f32: bits (or u_hat) · P(centroid)
    raw: torch.Tensor | None = None  # [n, dim] f32 (kept for exact re-rank)
    scales: torch.Tensor | None = None  # [n] f32, ex-codes only (u_hat = codes*scales)


_FIELDS = ("codes", "norms", "factors", "code_dot_c", "raw", "scales")


class IvfRabitqIndex:
    def __init__(self, config: VectorIndexConfig, device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.quantizer = RabitqQuantizer(
            config.dim, rotator=config.rotator, seed=config.seed, device=self.device
        )
        self.centroids: torch.Tensor | None = None  # [nlist, dim]
        self._centroids_rot: torch.Tensor | None = None  # cache of P(centroids)
        self.clusters: list[_Cluster] = []
        self.deltas: list[list[_Cluster]] = []
        self.keep_raw = True
        self._device_cache_enabled = False
        self._device_bundle = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @property
    def _ex_bits(self) -> bool:
        return self.config.total_bits > 1

    def _quantize(self, vectors: torch.Tensor, centroid: torch.Tensor) -> dict:
        """The quantized fields of rows against their centroid (one, or one
        a row): 1-bit packed codes, or ex-codes with their scales."""
        if self._ex_bits:
            codes, scales, norms, factors, cdc = self.quantizer.quantize_ex(
                vectors, centroid, self.config.total_bits)
        else:
            codes, norms, factors, cdc = self.quantizer.quantize(vectors, centroid)
            scales = None
        return {"codes": codes, "norms": norms, "factors": factors, "code_dot_c": cdc,
                "scales": scales}

    # ------------------------------------------------------------------ train
    @classmethod
    def train(
        cls,
        vectors,
        ids: np.ndarray,
        config: VectorIndexConfig,
        *,
        keep_raw: bool = True,
        kmeans_iters: int = 10,
        device: str | torch.device | None = None,
    ) -> "IvfRabitqIndex":
        """vectors: [N, dim] numpy array or tensor; ids: [N] row ids."""
        index = cls(config, device)
        vectors = index._tensor(vectors).contiguous()
        ids = np.asarray(ids, dtype=np.uint64)
        if vectors.ndim != 2 or vectors.shape[1] != config.dim:
            raise VectorIndexError(
                f"expected [N, {config.dim}] vectors, got {tuple(vectors.shape)}"
            )
        if len(ids) != len(vectors):
            raise VectorIndexError("ids/vectors length mismatch")
        index.keep_raw = keep_raw
        nlist = min(config.nlist, max(1, len(vectors)))
        index.centroids, assign = kmeans(vectors, nlist, iters=kmeans_iters, seed=config.seed)
        index.clusters = index._split_clusters(vectors, ids, assign, nlist)
        index.deltas = [[] for _ in range(nlist)]
        return index

    @classmethod
    def train_from_batches(cls, batches, config: VectorIndexConfig, **kw) -> "IvfRabitqIndex":
        """batches: iterable of (vectors [n, dim], ids [n])."""
        vs, ds = [], []
        for v, i in batches:
            vs.append(np.asarray(v, dtype=np.float32))
            ds.append(np.asarray(i, dtype=np.uint64))
        if not vs:
            raise VectorIndexError("no vectors to train on")
        return cls.train(np.concatenate(vs), np.concatenate(ds), config, **kw)

    def _split_clusters(self, vectors, ids, assign, nlist: int) -> list[_Cluster]:
        """Quantize every row against its own centroid in one call, then cut
        the cluster-sorted rows into per-cluster segments (views).  The
        stable sort keeps each cluster's rows in input order, as the
        reference's boolean masks do."""
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=nlist).tolist()
        vs = vectors[order]
        fields = self._quantize(vs, self.centroids[assign[order]])
        fields["raw"] = vs if self.keep_raw else None
        parts = {f: torch.split(t, counts) if t is not None else [None] * nlist
                 for f, t in fields.items()}
        ids_parts = np.split(ids[order.cpu().numpy()], np.cumsum(counts)[:-1])
        return [_Cluster(ids=i, **{f: p[c] for f, p in parts.items()})
                for c, i in enumerate(ids_parts)]

    def _make_cluster(self, vectors: torch.Tensor, ids: np.ndarray, centroid) -> _Cluster:
        """One segment of rows against one centroid; no rows give an empty
        segment with the index's code layout ([0, padded] int8 / int16 for
        ex-codes)."""
        return _Cluster(ids=ids, raw=vectors.clone() if self.keep_raw else None,
                        **self._quantize(vectors, centroid))

    # ------------------------------------------------------------ carry over
    def state(self) -> dict:
        """The index as numpy arrays: config string, keep_raw, centroids, and
        per-cluster base and delta segments with ``_Cluster``'s field names."""

        def seg(c: _Cluster) -> dict:
            out = {"ids": c.ids.copy()}
            for f in _FIELDS:
                t = getattr(c, f)
                out[f] = None if t is None else t.cpu().numpy()
            return out

        return {
            "config": self.config.encode(),
            "keep_raw": self.keep_raw,
            "centroids": None if self.centroids is None else self.centroids.cpu().numpy(),
            "clusters": [seg(c) for c in self.clusters],
            "deltas": [[seg(s) for s in ds] for ds in self.deltas],
        }

    @classmethod
    def from_state(cls, state: dict, *, device: str | torch.device | None = None
                   ) -> "IvfRabitqIndex":
        """Rebuild an index from :meth:`state` — or from the same fields of a
        JAX-built index's clusters / deltas / centroids."""
        index = cls(VectorIndexConfig.parse(state["config"]), device)
        index.keep_raw = bool(state["keep_raw"])
        if state["centroids"] is not None:
            index.centroids = index._tensor(np.array(state["centroids"], np.float32))
        index.clusters = [index._segment_from_state(s) for s in state["clusters"]]
        index.deltas = [[index._segment_from_state(s) for s in ds] for ds in state["deltas"]]
        return index

    def _segment_from_state(self, s: dict) -> _Cluster:
        """One segment's arrays as tensors on the index's device.  An ex
        segment without scales loads, and its search raises, as the
        reference's does."""
        if s.get("code_dot_c") is None:
            raise VectorIndexError("segment has no code_dot_c: rebuild the index")
        tb = self.config.total_bits
        code_dtype = np.uint8 if tb == 1 else np.int8 if tb <= 8 else np.int16

        def f32(f):
            return None if s.get(f) is None else self._tensor(np.array(s[f], np.float32))

        # np.array copies: the index never aliases the caller's arrays
        return _Cluster(
            codes=torch.as_tensor(np.array(s["codes"], code_dtype), device=self.device),
            ids=np.array(s["ids"], np.uint64),
            **{f: f32(f) for f in _FIELDS if f != "codes"},
        )

    # ----------------------------------------------------------------- insert
    def insert_batch(self, vectors, ids: np.ndarray) -> None:
        """Incremental insert: assign to nearest centroid, quantize, append as
        a delta segment (reference: insert_batch → delta segments)."""
        if self.centroids is None:
            raise VectorIndexError("index not trained")
        vectors = self._tensor(vectors).contiguous()
        ids = np.asarray(ids, dtype=np.uint64)
        c = self.centroids
        d2 = (
            (vectors**2).sum(1, keepdim=True)
            - 2.0 * vectors @ c.T
            + (c**2).sum(1)[None, :]
        )
        self._invalidate_device_cache()
        # one quantize call for the whole batch, cut per cluster: rows keep
        # their input order within a cluster, as the reference's masks do
        assign = torch.argmin(d2, dim=1)
        for cl, seg in enumerate(self._split_clusters(vectors, ids, assign, len(c))):
            if len(seg.ids):
                self.deltas[cl].append(seg)

    def merge_deltas(self) -> None:
        """Fold delta segments into base clusters (compaction of the index)."""
        self._invalidate_device_cache()
        for c, deltas in enumerate(self.deltas):
            if not deltas:
                continue
            segs = [self.clusters[c]] + deltas

            def cat(f):
                ts = [getattr(s, f) for s in segs]
                return torch.cat(ts) if all(t is not None for t in ts) else None

            self.clusters[c] = _Cluster(
                ids=np.concatenate([s.ids for s in segs]),
                **{f: cat(f) for f in _FIELDS if f != "raw"},
                raw=cat("raw") if self.keep_raw else None,
            )
            self.deltas[c] = []

    @property
    def num_vectors(self) -> int:
        return sum(len(c.ids) for c in self.clusters) + sum(
            len(s.ids) for ds in self.deltas for s in ds
        )

    # ------------------------------------------------------- device residency
    def enable_device_cache(self) -> None:
        """Keep the shard's arrays concatenated in device memory: subsequent
        searches add only the query + per-cluster scalars (one pass, no
        candidate gathering).  Invalidated automatically by insert/merge."""
        self._device_cache_enabled = True

    def _invalidate_device_cache(self) -> None:
        self._device_bundle = None

    def _get_device_bundle(self):
        bundle = self._device_bundle
        if bundle is not None:
            return bundle
        segs = [
            (c, seg)
            for c in range(len(self.clusters))
            for seg in self._cluster_segments(c)
            if len(seg.ids)
        ]
        if not segs:
            return None
        n = sum(len(s.ids) for _, s in segs)
        n_pad = _pow2_bucket(n)

        def cat(field, const=0.0):
            return _pad_tail(torch.cat([getattr(s, field) for _, s in segs]), n_pad, const)

        raws = [s.raw for _, s in segs]
        bundle = {
            "codes": cat("codes", 0),
            # ex-codes: pad rows get scale 1 (their codes are 0)
            "scales": (
                cat("scales", 1.0)
                if self._ex_bits and all(s.scales is not None for _, s in segs)
                else None
            ),
            "norms": cat("norms", PAD_NORM),
            "factors": cat("factors", PAD_FACTOR),
            "cdc": cat("code_dot_c"),
            "cluster_id": _pad_tail(
                torch.cat([torch.full((len(s.ids),), c, dtype=torch.int64, device=self.device)
                           for c, s in segs]),
                n_pad,
            ),
            "raw": (
                cat("raw", PAD_RAW)
                if self.keep_raw and all(r is not None for r in raws)
                else None
            ),
            "ids": np.concatenate([s.ids for _, s in segs]),  # host side
            "n": n,
        }
        self._device_bundle = bundle
        return bundle

    def _search_device_resident(self, query: torch.Tensor, params: SearchParams, probe):
        bundle = self._get_device_bundle()
        if bundle is None:
            return _empty_result()
        q_glob = self.quantizer.rotate(query)
        xc = self._rotated_centroids() - q_glob[None, :]
        probe_mask = torch.zeros(len(self.centroids), dtype=torch.bool, device=self.device)
        probe_mask[probe] = True
        do_rerank = bundle["raw"] is not None
        n_pad = len(bundle["codes"])
        dists, idx = _fused_search_resident(
            bundle["codes"], bundle["norms"], bundle["factors"], bundle["cdc"],
            bundle["cluster_id"], probe_mask, (xc * xc).sum(1), xc.sum(1),
            q_glob.contiguous(), bundle["raw"], query,
            d=self.quantizer.padded_dim, s=min(params.shortlist(), n_pad),
            k=min(params.top_k, n_pad), do_rerank=do_rerank,
        )
        dists, idx = dists.cpu().numpy(), idx.cpu().numpy()
        valid = (idx < bundle["n"]) & np.isfinite(dists)
        idx, dists = idx[valid], dists[valid]
        kk = min(params.top_k, len(idx))
        return bundle["ids"][idx[:kk]], dists[:kk]

    # ----------------------------------------------------------------- search
    def _rotated_centroids(self) -> torch.Tensor:
        if self._centroids_rot is None or len(self._centroids_rot) != len(self.centroids):
            self._centroids_rot = self.quantizer.rotate(self.centroids)
        return self._centroids_rot

    def _cluster_segments(self, c: int):
        yield self.clusters[c]
        yield from self.deltas[c]

    def _probe(self, query: torch.Tensor, nprobe: int) -> torch.Tensor:
        cd = ((self.centroids - query[None, :]) ** 2).sum(1)
        return torch.argsort(cd)[:nprobe]

    def search(
        self,
        query,
        params: SearchParams = SearchParams(),
        *,
        allowed_ids: np.ndarray | None = None,
        rerank: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (ids [k] u64, distances [k] f32), nearest first.

        ``allowed_ids`` implements search_filtered (ivf/mod.rs:1149).
        ``rerank`` re-scores the RaBitQ candidates with exact distances when
        raw vectors are kept."""
        if self.centroids is None:
            raise VectorIndexError("index not trained")
        query = self._tensor(query)
        ex = self._ex_bits
        resident = self._device_cache_enabled and allowed_ids is None and rerank == self.keep_raw
        if resident and ex:
            # ex-codes: the batched resident search IS the single-query path
            # (one query column), as the reference's; it probes for itself
            out = self._batch_search_device_resident(query[None, :], params)
            if out is not None:
                return out[0][0], out[1][0]
        probe = self._probe(query, min(params.nprobe, len(self.centroids)))
        if resident and not ex:
            return self._search_device_resident(query, params, probe)

        # All probed segments are concatenated into ONE fused pass.  Rotation
        # is linear, so the estimator works in the *global* query frame: with
        # Q = P(query) and xc = P(c) - Q (per cluster),
        #   dist² ≈ ||r||² + ||xc||² + 2·||r||·<o_bar, xc>/factor,
        # where <o_bar, xc> needs only bits·Q plus the build-time per-row
        # constant code_dot_c = bits·P(c) and two per-cluster scalars
        # (||xc||², Σxc) broadcast per row.
        cand = {k: [] for k in ("ids", "codes", "norms", "factors", "cdc", "csq", "csum", "raw",
                                "scales")}
        q_glob = self.quantizer.rotate(query)  # P(query), computed once
        rot = self._rotated_centroids()
        for c in probe.tolist():
            xc = rot[c] - q_glob
            xc_sq, xc_sum = (xc * xc).sum(), xc.sum()  # the ex estimator takes no csum
            for seg in self._cluster_segments(c):
                if len(seg.ids) == 0:
                    continue
                ids = seg.ids
                sel = slice(None)
                if allowed_ids is not None:
                    m = np.isin(ids, allowed_ids)
                    if not m.any():
                        continue
                    sel = torch.from_numpy(np.flatnonzero(m)).to(self.device)
                    ids = ids[m]
                n_seg = len(ids)
                cand["ids"].append(ids)
                cand["codes"].append(seg.codes[sel])
                cand["norms"].append(seg.norms[sel])
                cand["factors"].append(seg.factors[sel])
                cand["cdc"].append(seg.code_dot_c[sel])
                cand["csq"].append(xc_sq.expand(n_seg))
                cand["csum"].append(xc_sum.expand(n_seg))
                cand["raw"].append(seg.raw[sel] if seg.raw is not None else None)
                if ex:
                    if seg.scales is None:
                        raise VectorIndexError(
                            "index config says total_bits > 1 but segment has no scales"
                            " (legacy 1-bit shard?) — rebuild the index"
                        )
                    cand["scales"].append(seg.scales[sel])

        if not cand["ids"]:
            return _empty_result()
        ids = np.concatenate(cand["ids"])
        use_rerank = rerank and self.keep_raw and all(r is not None for r in cand["raw"])
        if ex:
            dists, idx = fused_search_ex(
                torch.cat(cand["codes"]),
                torch.cat(cand["scales"]),
                torch.cat(cand["norms"]),
                torch.cat(cand["factors"]),
                torch.cat(cand["cdc"]),
                torch.cat(cand["csq"]),
                q_glob,
                torch.cat(cand["raw"]) if use_rerank else None,
                query,
                top_k=params.top_k,
                shortlist=params.shortlist(),
            )
            return _finalize_topk(ids, dists, idx, params.top_k)
        dists, idx = fused_search(
            torch.cat(cand["codes"]),
            torch.cat(cand["norms"]),
            torch.cat(cand["factors"]),
            torch.cat(cand["cdc"]),
            torch.cat(cand["csq"]),
            torch.cat(cand["csum"]),
            q_glob,
            torch.cat(cand["raw"]) if use_rerank else None,
            query,
            d=self.quantizer.padded_dim,
            top_k=params.top_k,
            shortlist=params.shortlist(),
        )
        return _finalize_topk(ids, dists, idx, params.top_k)

    def search_filtered(self, query, allowed_ids, params: SearchParams = SearchParams()):
        return self.search(query, params, allowed_ids=np.asarray(allowed_ids, np.uint64))

    def tune_nprobe(
        self,
        queries: np.ndarray,
        *,
        target_recall: float = 0.95,
        top_k: int = 10,
        rerank_depth: int | None = None,
        candidates: list[int] | None = None,
        max_queries: int = 128,
    ) -> dict:
        """Pick the smallest ``nprobe`` whose measured recall@top_k on the
        given held-out queries meets ``target_recall``.  Ground truth is
        exact brute force over the raw vectors (``keep_raw=True`` needed).
        Returns ``{"nprobe", "recall", "target_met", "measured"}``; the sweep
        stops at the first qualifying nprobe."""
        from lakesoul_tpu_torch.vector.oracle import exact_topk, recall_at_k, subsample_queries

        raws, id_chunks = [], []
        for c in range(len(self.clusters)):
            for seg in self._cluster_segments(c):
                if seg.raw is None:
                    raise ConfigError(
                        "tune_nprobe needs raw vectors (build with keep_raw=True)"
                    )
                if len(seg.ids):
                    raws.append(seg.raw)
                    id_chunks.append(seg.ids)
        if not raws:
            raise ConfigError("tune_nprobe on an empty index")
        base = torch.cat(raws).cpu().numpy()
        base_ids = np.concatenate(id_chunks)
        queries = subsample_queries(queries, max_queries, self.config.seed)
        truth = exact_topk(base, base_ids, queries, top_k)
        nlist = len(self.clusters)
        if candidates is None:
            candidates, p = [], 1
            while p < nlist:
                candidates.append(p)
                p *= 2
            candidates.append(nlist)
        measured = []
        best = None
        for nprobe in sorted(set(candidates)):
            params = SearchParams(top_k=top_k, nprobe=nprobe, rerank_depth=rerank_depth)
            got_ids, _ = self.batch_search(queries, params)
            recall = recall_at_k(truth, got_ids)
            measured.append((nprobe, recall))
            if recall >= target_recall:
                best = (nprobe, recall)
                break  # smallest qualifying nprobe: stop sweeping
        if best is None:
            best = measured[-1]
        return {
            "nprobe": best[0],
            "recall": best[1],
            "target_met": best[1] >= target_recall,
            "measured": measured,
        }

    def batch_search(self, queries, params: SearchParams = SearchParams()):
        """Search many queries; with the device cache enabled, up to
        ``MAX_Q`` queries share ONE pass over the packed codes."""
        queries = self._tensor(queries)
        if self._device_cache_enabled:
            out = self._batch_search_device_resident(queries, params)
            if out is not None:
                return out
        results = [self.search(q, params) for q in queries]
        return [o[0] for o in results], [o[1] for o in results]

    def _batch_search_device_resident(self, queries: torch.Tensor, params: SearchParams):
        nq = len(queries)
        if nq > MAX_Q:
            bundle = self._get_device_bundle()
            if bundle is None or (self._ex_bits and bundle["scales"] is None):
                return None  # the guards of _dispatch_resident, before chunking
            ids_all, d_all = [], []
            for start in range(0, nq, MAX_Q):
                ids_c, d_c = self._batch_search_device_resident(
                    queries[start : start + MAX_Q], params
                )
                ids_all.extend(ids_c)
                d_all.extend(d_c)
            return ids_all, d_all
        disp = self._dispatch_resident(queries, params)
        if disp is None:
            return None
        return self._resolve_resident(*disp, params)

    def search_async(self, query, params: SearchParams = SearchParams()):
        """Dispatch ONE query on the device-resident bundle WITHOUT waiting
        and return a zero-arg resolver yielding (ids, dists).

        CUDA launches are asynchronous, so a serving loop overlaps the device
        round-trip by dispatching query i+1 before resolving query i; the
        resolver does the readback.  Falls back to the synchronous path
        (resolver returns a precomputed result) when no resident bundle
        applies."""
        query = self._tensor(query)
        disp = None
        if self._device_cache_enabled:
            disp = self._dispatch_resident(query[None, :], params)
        if disp is None:
            out = self.search(query, params)
            return lambda: out
        dists, idx, nq, bundle = disp

        def resolve():
            ids_b, d_b = self._resolve_resident(dists, idx, nq, bundle, params)
            return ids_b[0], d_b[0]

        return resolve

    def _dispatch_resident(self, queries: torch.Tensor, params: SearchParams):
        """Device dispatch of a ≤MAX_Q query block against the resident
        bundle; returns (device dists, device idx, nq, bundle) or None when
        the resident path doesn't apply.  Does NOT wait for the result."""
        bundle = self._get_device_bundle()
        if bundle is None:
            return None
        if self._ex_bits and bundle["scales"] is None:
            return None  # segments without scales: the non-resident path raises
        nq = len(queries)
        # pow2 query buckets ≥ 8, as the reference: pad queries stay fully
        # masked and score +inf
        nq_pad = 8
        while nq_pad < nq:
            nq_pad *= 2
        if nq_pad != nq:
            queries = torch.nn.functional.pad(queries, (0, 0, 0, nq_pad - nq))
        nprobe = min(params.nprobe, len(self.centroids))
        c = self.centroids
        q = queries[:nq]
        cd = (q**2).sum(1, keepdim=True) - 2.0 * q @ c.T + (c**2).sum(1)[None, :]  # [Q, nlist]
        probe = torch.argsort(cd, dim=1)[:, :nprobe]
        probe_mask = torch.zeros((len(c), nq_pad), dtype=torch.bool, device=self.device)
        probe_mask[probe, torch.arange(nq, device=self.device)[:, None]] = True
        q_glob = self.quantizer.rotate(queries)  # [Q, d]
        # closed forms — no [nlist, Q, d] intermediate:
        #   ||c - q||² = ||c||² - 2 c·q + ||q||² ;  Σ(c - q) = Σc - Σq
        cent = self._rotated_centroids()
        csq_c = (
            (cent * cent).sum(1)[:, None]
            - 2.0 * (cent @ q_glob.T)
            + (q_glob * q_glob).sum(1)[None, :]
        )
        csum_c = cent.sum(1)[:, None] - q_glob.sum(1)[None, :]
        n_pad = len(bundle["codes"])
        s, k = min(params.shortlist(), n_pad), min(params.top_k, n_pad)
        do_rerank = bundle["raw"] is not None
        if self._ex_bits:
            dists, idx = _fused_search_resident_ex_batch(
                bundle["codes"], bundle["scales"], bundle["norms"], bundle["factors"],
                bundle["cdc"], bundle["cluster_id"], probe_mask, csq_c, q_glob,
                bundle["raw"], queries, s=s, k=k, do_rerank=do_rerank,
            )
        else:
            dists, idx = _fused_search_resident_batch(
                bundle["codes"], bundle["norms"], bundle["factors"], bundle["cdc"],
                bundle["cluster_id"], probe_mask, csq_c, csum_c, q_glob.contiguous(),
                bundle["raw"], queries,
                d=self.quantizer.padded_dim, s=s, k=k, do_rerank=do_rerank,
            )
        return dists, idx, nq, bundle

    @staticmethod
    def _resolve_resident(dists, idx, nq, bundle, params):
        """Host-side tail of a resident search: reads the device values back
        (``.cpu()`` waits for them) and maps row indices to caller ids."""
        dists, idx = dists.cpu().numpy(), idx.cpu().numpy()
        ids_out, d_out = [], []
        for qi in range(nq):
            valid = (idx[qi] < bundle["n"]) & np.isfinite(dists[qi])
            sel = idx[qi][valid][: params.top_k]
            ids_out.append(bundle["ids"][sel])
            d_out.append(dists[qi][valid][: params.top_k])
        return ids_out, d_out
