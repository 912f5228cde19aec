"""ANN search kernels and the search bodies around them (the port of
``lakesoul_tpu/vector/kernels.py``'s single-index search path).

Four kernels written in CUDA C++ for Hopper.  Three are packed 1-bit
code × query products (``lakesoul_tpu_torch/csrc/packed_dot.cu``):

- :func:`packed_dot` — bits [N, 8·d8] · q [d] → [N].  Replaces
  ``packed_dot_pallas`` → ``_packed_dot_kernel``.  Bound by bytes: 71 MB at
  N = 1,048,576, d = 512, ~21 µs at 3.35 TB/s.
- :func:`packed_dot_batch` — bits · Qᵀ, Q [nq, d] → [N, nq].  Replaces
  ``packed_dot_batch_pallas`` → ``_packed_dot_batch_kernel``.  Bound by
  operations: 2.75e11 f32 FLOP at N = 1,048,576, d = 512, nq = 256, ~4.1 ms at
  the 67 TFLOP/s f32 peak (its 1.14 GB of traffic take ~0.34 ms).
- :func:`packed_scan` — one cluster's RaBitQ estimate, bits·q with the
  estimator fused → [N].  Replaces ``packed_scan_pallas`` →
  ``_packed_scan_kernel``.  Bound by bytes, like ``packed_dot``.

and one is the exact scan of the brute-force oracle
(``lakesoul_tpu_torch/csrc/bruteforce.cu``):

- :func:`bruteforce_distances` — ‖x‖² − 2x·q + ‖q‖² over [N, D] f32 → [N].
  Replaces ``bruteforce_distances_pallas`` → ``_bruteforce_kernel``.  Bound
  by bytes: N·D·4 (5.1 GB, ~1.5 ms at 3.35 TB/s, at 10M × 128).
  :func:`bruteforce_topk` adds a torch top-k.

Each wrapper checks its inputs and raises on anything else; for a CUDA
tensor it launches its kernel or raises, and only a tensor on the CPU takes
the plain PyTorch version beside it (``*_torch``).  Each wrapper counts its
launches in a plain integer attribute, ``launches``.  The TPU wrappers'
pow2 row buckets only bounded compiles there; results for the real rows
are the same without them, so they are dropped.

The query is taken in natural order: the plane-concat layout of the TPU
kernels only avoided 3-D reshapes in Mosaic.  Top-k, gather and exact
re-rank are torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.vector.rabitq import estimate_distances, unpack_bits

# pad sentinels shared by every padded-candidate path (fused_search host
# wrapper and the device-resident bundle): pad rows must sort last and divide
# safely
PAD_NORM = np.float32(1e9)
PAD_FACTOR = np.float32(1.0)
PAD_RAW = np.float32(1e9)


def _pow2_bucket(n: int, floor: int = 512) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_tail(a: torch.Tensor, n_pad: int, const=0) -> torch.Tensor:
    """Pad a candidate tensor's first axis to n_pad with a constant."""
    pad = n_pad - len(a)
    if pad <= 0:
        return a
    return torch.cat([a, a.new_full((pad, *a.shape[1:]), float(const))])


# --------------------------------------------------------------------------
# packed-code products: CUDA kernels + plain versions
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_dot")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ls_packed_dot.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.ls_packed_dot_batch.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.ls_packed_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ctypes.c_float, ptr]
    for fn in (lib.ls_packed_dot, lib.ls_packed_dot_batch, lib.ls_packed_scan):
        fn.restype = i32  # a cudaError_t
    return lib


@functools.cache
def _bruteforce_lib() -> ctypes.CDLL:
    lib = _build.load("bruteforce")
    lib.ls_bruteforce_distances.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.ls_bruteforce_distances.restype = ctypes.c_int  # a cudaError_t
    return lib


def _check(codes: torch.Tensor, q: torch.Tensor, q_ndim: int) -> None:
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise ValueError(f"codes must be [N, d8] uint8, got {codes.dtype} {tuple(codes.shape)}")
    if q.dtype != torch.float32 or q.ndim != q_ndim:
        raise ValueError(f"query must be {q_ndim}-D float32, got {q.dtype} {tuple(q.shape)}")
    if q.shape[-1] > 8 * codes.shape[1]:
        raise ValueError(f"query width {q.shape[-1]} exceeds the {8 * codes.shape[1]} code bits")
    if codes.device != q.device or codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"codes on {codes.device} and query on {q.device}: need one cpu or cuda device")
    if not (codes.is_contiguous() and q.is_contiguous()):
        raise ValueError("codes and query must be contiguous")


def _check_rows(n: int, device: torch.device, **vecs: torch.Tensor) -> None:
    """Per-row f32 vectors of a kernel: [n], contiguous, on ``device``."""
    for name, t in vecs.items():
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be [{n}] float32, got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _launch(fn: str, device: torch.device, *args) -> None:
    _build.launch(_lib(), fn, device, *args)


def packed_dot_torch(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_dot`: unpack the bits, then matvec."""
    return unpack_bits(codes, q.shape[0]) @ q


def packed_dot_batch_torch(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_dot_batch`: unpack, then matmul."""
    return unpack_bits(codes, q.shape[1]) @ q.T


def packed_dot(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bits·q over [N, d8] packed codes and q [d] → [N] f32."""
    _check(codes, q, 1)
    if codes.device.type == "cpu":
        return packed_dot_torch(codes, q)
    n, d8 = codes.shape
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    if n:
        _launch("ls_packed_dot", codes.device, codes.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, d8, q.shape[0])
        packed_dot.launches += 1
    return out


packed_dot.launches = 0


# the batch kernel's query tiles: a block takes 8·g queries (packed_dot.cu)
QUERY_GROUPS = (2, 4, 8)


def pick_query_group(nq: int) -> int:
    """The narrowest query tile that holds nq queries; the widest past 32."""
    return next((g for g in QUERY_GROUPS if nq <= 8 * g), QUERY_GROUPS[-1])


def packed_dot_batch(codes: torch.Tensor, q: torch.Tensor, *,
                     query_group: int | None = None) -> torch.Tensor:
    """bits·Qᵀ over [N, d8] packed codes and Q [nq, d] → [N, nq] f32.

    ``query_group`` forces the kernel's query tile (one of QUERY_GROUPS),
    to time one tile against another; None picks by nq."""
    _check(codes, q, 2)
    if query_group is not None and query_group not in QUERY_GROUPS:
        raise ValueError(f"query_group must be one of {QUERY_GROUPS}, got {query_group}")
    if codes.device.type == "cpu":
        return packed_dot_batch_torch(codes, q)
    n, d8 = codes.shape
    nq, d = q.shape
    out = torch.empty((n, nq), dtype=torch.float32, device=codes.device)
    if n and nq:
        g = pick_query_group(nq) if query_group is None else query_group
        _launch("ls_packed_dot_batch", codes.device, codes.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, d8, d, nq, g)
        packed_dot_batch.launches += 1
    return out


packed_dot_batch.launches = 0


def packed_scan_torch(codes, norms, factors, q_rot, *, d: int) -> torch.Tensor:
    """Plain version of :func:`packed_scan`: the estimator of
    ``rabitq.estimate_distances``, the reference's own twin."""
    return estimate_distances(codes, norms, factors, q_rot, d=d)


def packed_scan(codes: torch.Tensor, norms: torch.Tensor, factors: torch.Tensor,
                q_rot: torch.Tensor, *, d: int) -> torch.Tensor:
    """Estimated squared distances of one cluster's packed codes [N, d8] to
    the rotated query residual ``q_rot`` [≤ 8·d8] → [N] f32.  Bits past
    ``len(q_rot)`` get zero weight; ``d`` scales the estimate (√d)."""
    _check(codes, q_rot, 1)
    n, d8 = codes.shape
    _check_rows(n, codes.device, norms=norms, factors=factors)
    if codes.device.type == "cpu":
        return packed_scan_torch(codes, norms, factors, q_rot, d=d)
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    if n:
        _launch("ls_packed_scan", codes.device, codes.data_ptr(), q_rot.data_ptr(),
                norms.data_ptr(), factors.data_ptr(), out.data_ptr(), n, d8, q_rot.shape[0],
                math.sqrt(d))
        packed_scan.launches += 1
    return out


packed_scan.launches = 0


# --------------------------------------------------------------------------
# exact brute-force scan: CUDA kernel + plain version, then torch top-k
# --------------------------------------------------------------------------


def bruteforce_distances_torch(vectors: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bruteforce_distances` (``_bruteforce_jnp``)."""
    return (vectors * vectors).sum(1) - 2.0 * (vectors @ query) + (query * query).sum()


def bruteforce_distances(vectors: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Exact ‖x‖² − 2x·q + ‖q‖² of every row of ``vectors`` [N, D] to
    ``query`` [D] → [N] f32."""
    if vectors.dtype != torch.float32 or vectors.ndim != 2:
        raise ValueError(f"vectors must be [N, D] float32, got {vectors.dtype} {tuple(vectors.shape)}")
    n, dd = vectors.shape
    if vectors.device.type not in ("cpu", "cuda") or not vectors.is_contiguous():
        raise ValueError(f"vectors must be contiguous on a cpu or cuda device, not {vectors.device}")
    _check_rows(dd, vectors.device, query=query)
    if vectors.device.type == "cpu":
        return bruteforce_distances_torch(vectors, query)
    out = torch.empty(n, dtype=torch.float32, device=vectors.device)
    if n:
        _build.launch(_bruteforce_lib(), "ls_bruteforce_distances", vectors.device,
                      vectors.data_ptr(), query.data_ptr(), out.data_ptr(), n, dd)
        bruteforce_distances.launches += 1
    return out


bruteforce_distances.launches = 0


def bruteforce_topk(vectors: torch.Tensor, query: torch.Tensor, k: int):
    """Exact L2 top-k over [N, D] vectors: (dists [k], indices [k]) on the
    vectors' device, nearest first, ``k`` clamped to N."""
    dists = bruteforce_distances(vectors, query)
    return torch.topk(dists, min(k, len(dists)), largest=False, sorted=True)


# --------------------------------------------------------------------------
# search bodies
# --------------------------------------------------------------------------


def _smallest(x: torch.Tensor, k: int, dim: int = -1):
    return torch.topk(x, k, dim=dim, largest=False, sorted=True)


def _estimate(bq, norms, factors, code_dot_c, csq, csum, d: int):
    """The RaBitQ estimator in the global query frame (see _fused_search)."""
    dot_obar_xc = (2.0 * (code_dot_c - bq) - csum) / math.sqrt(d)
    return norms * norms + csq + 2.0 * norms * dot_obar_xc / factors


def _exact(sub: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return (sub * sub).sum(-1) - 2.0 * (sub @ q) + (q * q).sum()


def _fused_search(codes, norms, factors, code_dot_c, csq, csum, q_glob, raw, query,
                  *, d, s, k, do_rerank):
    """One device pass per query over the concatenated probe set.

    Estimator in the *global* query frame (rows may come from different
    clusters): with Q = P(query), xc = P(c) - Q per row's cluster,
        dist² ≈ ||r||² + ||xc||² + 2·||r||·<o_bar, xc>/factor
        <o_bar, xc> = (2·(code_dot_c - bits·Q) - csum) / √D
    so the only O(N·D) work is ONE bits·Q product.  Then top-S shortlist →
    gather + exact re-rank → top-k."""
    bq = packed_dot(codes, q_glob)
    est = _estimate(bq, norms, factors, code_dot_c, csq, csum, d)
    if not do_rerank:
        return _smallest(est, k)
    _, idx_s = _smallest(est, s)
    exact = _exact(raw[idx_s], query)
    dists, order = _smallest(exact, k)
    return dists, idx_s[order]


def _fused_search_resident(codes, norms, factors, code_dot_c, cluster_id, probe_mask,
                           csq_c, csum_c, q_glob, raw, query, *, d, s, k, do_rerank):
    """Device-resident variant: the WHOLE shard stays in device memory; per
    query only the rotated query and three (nlist,) vectors are new.
    Non-probed clusters are masked to +inf."""
    bq = packed_dot(codes, q_glob)
    est = _estimate(bq, norms, factors, code_dot_c, csq_c[cluster_id], csum_c[cluster_id], d)
    est = est.masked_fill(~probe_mask[cluster_id], math.inf)
    if not do_rerank:
        return _smallest(est, k)
    est_s, idx_s = _smallest(est, s)
    exact = _exact(raw[idx_s], query)
    exact = exact.masked_fill(~torch.isfinite(est_s), math.inf)  # masked rows stay out
    dists, order = _smallest(exact, k)
    return dists, idx_s[order]


def exact_distances(sub: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Exact squared distances of gathered rows ``sub`` [Q, s, d] to their
    queries [Q, d] → [Q, s]: one batched product."""
    return (
        (sub * sub).sum(-1)
        - 2.0 * torch.bmm(sub, queries[:, :, None])[..., 0]
        + (queries * queries).sum(-1)[:, None]
    )


def _batched_rerank_topk(est, raw, queries, *, s: int, k: int, do_rerank: bool):
    """Shared tail of the batched resident search: [N, Q] estimates →
    (dists [Q, k], indices [Q, k]), with optional exact re-rank."""
    # top-k along the last axis of the [Q, N] view, as the reference does;
    # along axis 0 of [N, Q] torch's radix top-k was the largest device cost
    # of the batch at serving size (chip_smoke.py's profile)
    est_t = est.T
    if not do_rerank:
        return _smallest(est_t, k)
    est_s, idx_s = _smallest(est_t, s)  # [Q, s]
    exact = exact_distances(raw[idx_s], queries)  # gathers [Q, s, d]
    exact = exact.masked_fill(~torch.isfinite(est_s), math.inf)
    dists, order = _smallest(exact, k)
    return dists, torch.gather(idx_s, 1, order)


def _fused_search_resident_batch(codes, norms, factors, code_dot_c, cluster_id,
                                 probe_mask, csq_c, csum_c, q_glob, raw, queries,
                                 *, d, s, k, do_rerank):
    """Batched device-resident search: Q queries share one pass over the
    packed codes, which stay packed in device memory."""
    bq = packed_dot_batch(codes, q_glob)  # [N, Q]
    est = _estimate(
        bq, norms[:, None], factors[:, None], code_dot_c[:, None],
        csq_c[cluster_id], csum_c[cluster_id], d,
    )
    est.masked_fill_(~probe_mask[cluster_id], math.inf)  # [N, Q], in place: 1 GB at serving size
    return _batched_rerank_topk(est, raw, queries, s=s, k=k, do_rerank=do_rerank)


def fused_search(codes, norms, factors, code_dot_c, csq, csum, q_glob, raw, query,
                 *, d, top_k, shortlist):
    """Host wrapper: pow2-pad candidate tensors, run the fused search, return
    (dists, indices) as numpy — indices >= the true candidate count are pad
    rows the caller must drop."""
    n = len(codes)
    n_pad = _pow2_bucket(n)
    codes = _pad_tail(codes, n_pad)
    # pad rows get a huge norm → huge estimated distance → never selected
    norms = _pad_tail(norms, n_pad, PAD_NORM)
    factors = _pad_tail(factors, n_pad, PAD_FACTOR)
    code_dot_c = _pad_tail(code_dot_c, n_pad)
    csq = _pad_tail(csq, n_pad)
    csum = _pad_tail(csum, n_pad)
    do_rerank = raw is not None
    if do_rerank:
        raw = _pad_tail(raw, n_pad, PAD_RAW)
    dists, idx = _fused_search(
        codes, norms, factors, code_dot_c, csq, csum, q_glob.contiguous(), raw, query,
        d=d, s=min(shortlist, n_pad), k=min(top_k, n_pad), do_rerank=do_rerank,
    )
    return dists.cpu().numpy(), idx.cpu().numpy()
