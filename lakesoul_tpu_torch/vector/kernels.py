"""ANN search kernels and the search bodies around them (the port of
``lakesoul_tpu/vector/kernels.py``'s single-index search path).

Two kernels, each a packed 1-bit code × query product written in CUDA C++
for Hopper (``lakesoul_tpu_torch/csrc/packed_dot.cu``):

- :func:`packed_dot` — bits [N, 8·d8] · q [d] → [N].  Replaces
  ``packed_dot_pallas`` → ``_packed_dot_kernel``.  Bound by bytes: 71 MB at
  N = 1,048,576, d = 512, ~21 µs at 3.35 TB/s.
- :func:`packed_dot_batch` — bits · Qᵀ, Q [nq, d] → [N, nq].  Replaces
  ``packed_dot_batch_pallas`` → ``_packed_dot_batch_kernel``.  Bound by
  operations: 2.75e11 f32 FLOP at N = 1,048,576, d = 512, nq = 256, ~4.1 ms at
  the 67 TFLOP/s f32 peak (its 1.14 GB of traffic take ~0.34 ms).

Each wrapper checks its inputs and raises on anything else; for a CUDA
tensor it launches its kernel or raises, and only a tensor on the CPU takes
the plain PyTorch version beside it (``packed_dot_torch`` /
``packed_dot_batch_torch``: unpack, then matmul).  Each wrapper counts its
launches in a plain integer attribute, ``launches``.

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
from lakesoul_tpu_torch.vector.rabitq import unpack_bits

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
    lib.ls_packed_dot.restype = i32
    lib.ls_packed_dot_batch.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.ls_packed_dot_batch.restype = i32
    lib.ls_cuda_error_string.argtypes = [i32]
    lib.ls_cuda_error_string.restype = ctypes.c_char_p
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


def _launch(fn: str, device: torch.device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: {lib.ls_cuda_error_string(err).decode()}")


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
    sub = raw[idx_s]  # [Q, s, d]
    exact = (
        (sub * sub).sum(-1)
        - 2.0 * torch.bmm(sub, queries[:, :, None])[..., 0]
        + (queries * queries).sum(-1)[:, None]
    )
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
