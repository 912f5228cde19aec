"""Exact brute-force recall oracle (the port's copy of
``lakesoul_tpu/vector/oracle.py``).

One definition of ground truth for every recall@k claim: :func:`exact_topk`
for in-memory corpora (one batched gram matmul for all queries) and
:class:`StreamingExactOracle` for corpora streamed in chunks.  Recall's
denominator is the *achievable* hit count (truth sets can be smaller than k
on tiny or duplicate-id corpora; a perfect search reaches 1.0)."""

from __future__ import annotations

import numpy as np


def subsample_queries(queries: np.ndarray, max_queries: int, seed: int) -> np.ndarray:
    """Seeded query subsample so repeated oracle runs measure the same set."""
    queries = np.asarray(queries, np.float32)
    if len(queries) <= max_queries:
        return queries
    rng = np.random.default_rng(seed)
    return queries[rng.choice(len(queries), max_queries, replace=False)]


def exact_topk(
    base: np.ndarray, base_ids: np.ndarray, queries: np.ndarray, k: int
) -> list[set]:
    """Exact L2 top-k truth sets, one per query (``k`` clamped to the
    corpus size)."""
    base = np.asarray(base, np.float32)
    base_ids = np.asarray(base_ids)
    queries = np.asarray(queries, np.float32)
    d2 = (
        np.sum(queries**2, axis=1, keepdims=True)
        - 2.0 * queries @ base.T
        + np.sum(base**2, axis=1)[None, :]
    )
    k_eff = min(k, d2.shape[1])
    part = np.argpartition(d2, k_eff - 1, axis=1)[:, :k_eff]
    return [set(base_ids[row].tolist()) for row in part]


def recall_at_k(truth: list[set], got_ids) -> float:
    """Achievable-hit recall: |truth ∩ got| summed over queries, divided by
    the total achievable hits (``sum(len(t))``, not ``Q * k``)."""
    hits = sum(
        len(truth[i] & {int(x) for x in got_ids[i]}) for i in range(len(truth))
    )
    return hits / max(1, sum(len(t) for t in truth))


class StreamingExactOracle:
    """Exact top-k over a corpus streamed in chunks (bounded memory): holds
    per-query running (distances, ids) of size ``k``."""

    def __init__(self, queries: np.ndarray, k: int):
        self.queries = np.asarray(queries, np.float32)
        self.k = int(k)
        self._q_sq = np.sum(self.queries**2, axis=1, keepdims=True)
        nq = len(self.queries)
        self._best_d = np.full((nq, self.k), np.inf, np.float32)
        self._best_i = np.zeros((nq, self.k), np.uint64)
        self.rows = 0

    def consume(self, vectors: np.ndarray, ids: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        ids = np.asarray(ids, np.uint64)
        if not len(ids):
            return
        d2 = (
            self._q_sq
            - 2.0 * self.queries @ vectors.T
            + np.sum(vectors**2, axis=1)[None, :]
        ).astype(np.float32)
        cand_d = np.concatenate([self._best_d, d2], axis=1)
        cand_i = np.concatenate(
            [self._best_i, np.broadcast_to(ids, (len(self.queries), len(ids)))],
            axis=1,
        )
        part = np.argpartition(cand_d, self.k - 1, axis=1)[:, : self.k]
        self._best_d = np.take_along_axis(cand_d, part, axis=1)
        self._best_i = np.take_along_axis(cand_i, part, axis=1)
        self.rows += len(ids)

    def truth(self) -> list[set]:
        k_eff = min(self.k, self.rows)
        out = []
        for qi in range(len(self.queries)):
            order = np.argsort(self._best_d[qi])[:k_eff]
            out.append({int(x) for x in self._best_i[qi][order]})
        return out
