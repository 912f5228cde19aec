"""k-means clustering in PyTorch (Lloyd's iterations on the data's device),
the port of ``lakesoul_tpu/vector/kmeans.py``.

The assignment step is one (N, D) x (D, K) matmul per row chunk; the update
step is the reference's one-hot product, taken in the same row chunks, so
its [N, K] one-hot matrix (4 GB at 1M x 1024) never exists whole.  Every
sum runs in a fixed order: a matmul's for one shape, and the chunks one
after another.  So one seed gives the same bits on every run, on the card
too — a float ``index_add_`` adds by atomics there, in no fixed order.
The initial centroids are the reference's numpy draw, so one seed starts
both packages from the same points.
"""

from __future__ import annotations

import numpy as np
import torch

# rows per chunk of the assignment and update matmuls: bounds the [rows, K]
# distance and one-hot blocks (256 MB at K = 1024) whatever N is
_ASSIGN_CHUNK = 65536


def _assign(x: torch.Tensor, x_sq: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - c_k||² = ||x||² - 2 x·c + ||c||², chunked over rows."""
    c_sq = (centroids * centroids).sum(1)
    out = torch.empty(len(x), dtype=torch.int64, device=x.device)
    for lo in range(0, len(x), _ASSIGN_CHUNK):
        hi = lo + _ASSIGN_CHUNK
        d2 = x_sq[lo:hi] - 2.0 * (x[lo:hi] @ centroids.T) + c_sq[None, :]
        out[lo:hi] = torch.argmin(d2, dim=1)
    return out


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """Σ of the rows of each cluster, [K, D]: the one-hot product
    ``onehot.T @ x`` one row chunk at a time, chunks summed in order."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, len(x), _ASSIGN_CHUNK):
        hi = lo + _ASSIGN_CHUNK
        onehot = torch.nn.functional.one_hot(assign[lo:hi], k).to(x.dtype)
        sums += onehot.T @ x[lo:hi]
    return sums


def kmeans(data: torch.Tensor, k: int, *, iters: int = 10, seed: int = 42):
    """Returns (centroids [K, D] f32, assignments [N] int64), both on
    ``data``'s device."""
    n = len(data)
    rng = np.random.default_rng(seed)
    k_eff = min(k, n)
    init_idx = rng.choice(n, size=k_eff, replace=False)
    if k_eff < k:
        # degenerate tiny input: pad by repeating points
        init_idx = np.concatenate([init_idx, init_idx[np.zeros(k - k_eff, dtype=int)]])
    x = data.to(torch.float32)
    centroids = x[torch.from_numpy(init_idx).to(x.device)]
    x_sq = (x * x).sum(1, keepdim=True)
    for _ in range(iters):
        assign = _assign(x, x_sq, centroids)
        sums = _segment_sums(x, assign, k)
        # integer counts: exact, whatever order they are added in
        counts = torch.bincount(assign, minlength=k).to(torch.float32)[:, None]
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return centroids, _assign(x, x_sq, centroids)
