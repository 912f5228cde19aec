"""ANN search kernels and the search bodies around them (the port of
``lakesoul_tpu/vector/kernels.py``'s single-index search path).

Four kernels written in CUDA C++ for Hopper.  Three are packed 1-bit
code × query products (``lakesoul_tpu_torch/csrc/packed_dot.cu``):

- :func:`packed_dot` — bits [N, 8·d8] · q [d] → [N], and
  :func:`packed_estimate`, the same kernel with the estimator and the probe
  mask fused, which the resident single query runs.  Replace
  ``packed_dot_pallas`` → ``_packed_dot_kernel`` (and the jnp estimator
  around it).  Nibble lookup tables in shared memory: a row is 2·d8 lookups.
  Bound by bytes: 71 MB at N = 1,048,576, d = 512, ~21 µs at 3.35 TB/s; the
  estimate mode reads code bytes only for rows whose cluster is probed.
- :func:`packed_dot_batch` — bits · Qᵀ, Q [nq, d] → [N, nq], and
  :func:`packed_estimate_batch`, the same kernel with the estimator, the
  probe mask and the ``[Q, N]`` layout in its epilogue.  Replace
  ``packed_dot_batch_pallas`` → ``_packed_dot_batch_kernel`` (and the jnp
  estimator around it).  bf16 tensor cores over an exact three-plane split
  of the query (:func:`split_bf16x3`): 8.25e11 FLOP at N = 1,048,576,
  d = 512, nq = 256, ~0.83 ms at the 989 TFLOP/s bf16 peak.
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
re-rank are torch ops, and so are the ex-code search bodies
(``total_bits`` 2-16: :func:`fused_search_ex`,
:func:`_fused_search_resident_ex_batch`), which the reference computes
outside any Pallas kernel: int8 / int16 codes times the queries in float64,
EX_CHUNK rows at a time (:func:`ex_dot`).
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


_PTR, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# each C entry point's arguments before the stream
_ENTRY_POINTS = {
    "ls_packed_dot": ("packed_dot", [_PTR, _PTR, _PTR, _I64, _I32, _I32]),
    "ls_packed_estimate": ("packed_dot", [_PTR] * 10 + [_I64, _I32, _I32, _F32]),
    "ls_packed_dot_batch": ("packed_dot", [_PTR, _PTR, _PTR, _I64, _I32, _I32, _I32, _I32]),
    "ls_packed_estimate_batch": ("packed_dot", [_PTR] * 10 + [_I64, _I32, _I32, _I32, _F32, _I32]),
    "ls_packed_scan": ("packed_dot", [_PTR] * 5 + [_I64, _I32, _I32, _F32]),
    "ls_bruteforce_distances": ("bruteforce", [_PTR, _PTR, _PTR, _I64, _I32]),
}


@functools.cache
def _launcher(name: str):
    """The bound launcher of one C entry point, built and loaded at first use."""
    source, argtypes = _ENTRY_POINTS[name]
    return _build.entry(_build.load(source), name, argtypes)


def _check(codes: torch.Tensor, q: torch.Tensor, q_ndim: int, **rows: torch.Tensor) -> None:
    """One pass over a kernel's inputs: codes [N, d8] uint8, a q_ndim-D f32
    query no wider than the code bits, and per-row f32 vectors [N], all
    contiguous on one cpu or cuda device.  It runs on every launch, so the
    common case is a handful of attribute reads; the messages are built
    only on failure."""
    if codes.dtype is not torch.uint8 or codes.ndim != 2:
        raise ValueError(f"codes must be [N, d8] uint8, got {codes.dtype} {tuple(codes.shape)}")
    if q.dtype is not torch.float32 or q.ndim != q_ndim:
        raise ValueError(f"query must be {q_ndim}-D float32, got {q.dtype} {tuple(q.shape)}")
    n, d8 = codes.shape
    if q.shape[-1] > 8 * d8:
        raise ValueError(f"query width {q.shape[-1]} exceeds the {8 * d8} code bits")
    dev = codes.device
    if q.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"codes on {dev} and query on {q.device}: need one cpu or cuda device")
    if not (codes.is_contiguous() and q.is_contiguous()):
        raise ValueError("codes and query must be contiguous")
    for name, t in rows.items():
        if (t.dtype is not torch.float32 or t.shape != (n,) or t.device != dev
                or not t.is_contiguous()):
            _check_tensor(name, t, torch.float32, (n,), dev)


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                  dev: torch.device) -> None:
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name} must be {list(shape)} {dtype}, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def _check_estimate(codes, q_glob, norms, factors, code_dot_c, cluster_id, probe_mask, csq_c,
                    csum_c, *, batch: bool = False) -> None:
    """The inputs of an estimate mode: one query [d] with per-cluster
    tables [nlist], or (``batch``) queries [nq, d] with tables [nlist, nq];
    per-row vectors and cluster ids in [0, nlist) as for the product."""
    _check(codes, q_glob, 1 + batch, norms=norms, factors=factors, code_dot_c=code_dot_c)
    dev = codes.device
    _check_tensor("cluster_id", cluster_id, torch.int64, (len(codes),), dev)
    per_cluster = tuple(q_glob.shape[:-1])  # (nq,) for a batch, () for one query
    nlist = probe_mask.shape[0] if probe_mask.ndim == 1 + batch else -1
    for name, t, dtype in (("probe_mask", probe_mask, torch.bool), ("csq_c", csq_c, torch.float32),
                           ("csum_c", csum_c, torch.float32)):
        _check_tensor(name, t, dtype, (nlist, *per_cluster), dev)
    _check_cluster_ids(cluster_id, nlist)


def _check_cluster_ids(cluster_id: torch.Tensor, nlist: int) -> None:
    """Every cluster id in [0, nlist): the kernels read the per-cluster
    tables at them unchecked.  On the CPU a bad id raises at once; on the
    card the check is a device-side assertion, as a torch gather's bounds
    check is, so the host does not wait for the device."""
    if not len(cluster_id):
        return
    lo, hi = torch.aminmax(cluster_id)
    ok = (lo >= 0) & (hi < nlist)
    if cluster_id.device.type == "cpu":
        if not ok:  # lakelint: ignore[device-host-sync] the CPU branch: nothing to wait for; on the card the check is the device-side assertion below
            raise ValueError(f"cluster_id must lie in [0, {nlist}), got [{int(lo)}, {int(hi)}]")
    else:
        torch._assert_async(ok, f"cluster_id must lie in [0, {nlist})")


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
    out = codes.new_empty(n, dtype=torch.float32)
    if n:
        _launcher("ls_packed_dot")(codes.device, codes.data_ptr(), q.data_ptr(),
                                   out.data_ptr(), n, d8, q.shape[0])
        packed_dot.launches += 1
    return out


packed_dot.launches = 0  # counts both modes: one TPU kernel's port


def packed_estimate_torch(codes, q_glob, norms, factors, code_dot_c, cluster_id, probe_mask,
                          csq_c, csum_c, *, d: int) -> torch.Tensor:
    """Plain version of :func:`packed_estimate`: the product, the estimator
    on the gathered (cluster) tables, then the mask."""
    bq = packed_dot_torch(codes, q_glob)
    est = _estimate(bq, norms, factors, code_dot_c, csq_c[cluster_id], csum_c[cluster_id], d)
    return est.masked_fill(~probe_mask[cluster_id], math.inf)


def packed_estimate(codes: torch.Tensor, q_glob: torch.Tensor, norms: torch.Tensor,
                    factors: torch.Tensor, code_dot_c: torch.Tensor, cluster_id: torch.Tensor,
                    probe_mask: torch.Tensor, csq_c: torch.Tensor, csum_c: torch.Tensor, *,
                    d: int) -> torch.Tensor:
    """RaBitQ estimates [N] f32 of one globally rotated query ``q_glob``
    [≤ 8·d8] against every row of the packed codes [N, d8], +inf where the
    row's cluster is not probed: the estimate mode of ``packed_dot``'s
    kernel (see :func:`_estimate`), which reads no code bytes of such rows.

    Per row: ``norms``, ``factors``, ``code_dot_c`` [N] f32 and
    ``cluster_id`` [N] int64, each id in [0, nlist); per cluster:
    ``probe_mask`` [nlist] bool, ``csq_c`` and ``csum_c`` [nlist] f32.
    ``d`` scales the estimate (√d)."""
    _check_estimate(codes, q_glob, norms, factors, code_dot_c, cluster_id, probe_mask, csq_c,
                    csum_c)
    n, d8 = codes.shape
    dev = codes.device
    if dev.type == "cpu":
        return packed_estimate_torch(codes, q_glob, norms, factors, code_dot_c, cluster_id,
                                     probe_mask, csq_c, csum_c, d=d)
    out = torch.empty_like(norms)
    if n:
        _launcher("ls_packed_estimate")(
            dev, codes.data_ptr(), q_glob.data_ptr(), norms.data_ptr(), factors.data_ptr(),
            code_dot_c.data_ptr(), cluster_id.data_ptr(), probe_mask.data_ptr(),
            csq_c.data_ptr(), csum_c.data_ptr(), out.data_ptr(), n, d8, q_glob.shape[0],
            math.sqrt(d))
        packed_dot.launches += 1
    return out


def split_bf16x3(q: torch.Tensor):
    """f32 → three bf16 planes (hi, mid, lo) with hi + mid + lo == q: the
    split the batch kernel makes of its queries in its prologue, with the
    same round-to-nearest arithmetic (bits are exact in bf16, so three bf16
    products give the f32 product up to summation order)."""
    hi = q.to(torch.bfloat16)
    r1 = q - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


# the batch kernel's query tiles, queries a block (packed_dot.cu); the tile
# changes speed only: every value is the same whatever the tile
QUERY_GROUPS = (16, 32, 64)


def pick_query_group(nq: int) -> int:
    """The narrowest query tile that holds nq queries; the widest past 64."""
    return next((g for g in QUERY_GROUPS if nq <= g), QUERY_GROUPS[-1])


def _query_group(nq: int, query_group: int | None) -> int:
    if query_group is None:
        return pick_query_group(nq)
    if query_group not in QUERY_GROUPS:
        raise ValueError(f"query_group must be one of {QUERY_GROUPS}, got {query_group}")
    return query_group


def packed_dot_batch(codes: torch.Tensor, q: torch.Tensor, *,
                     query_group: int | None = None) -> torch.Tensor:
    """bits·Qᵀ over [N, d8] packed codes and Q [nq, d] → [N, nq] f32: the
    product-only mode of the batch kernel.

    ``query_group`` forces the kernel's query tile (one of QUERY_GROUPS),
    to time one tile against another; None picks by nq."""
    _check(codes, q, 2)
    g = _query_group(q.shape[0], query_group)
    if codes.device.type == "cpu":
        return packed_dot_batch_torch(codes, q)
    n, d8 = codes.shape
    nq, d = q.shape
    out = codes.new_empty((n, nq), dtype=torch.float32)
    if n and nq:
        _launcher("ls_packed_dot_batch")(codes.device, codes.data_ptr(), q.data_ptr(),
                                         out.data_ptr(), n, d8, d, nq, g)
        packed_dot_batch.launches += 1
    return out


packed_dot_batch.launches = 0  # counts both modes: one TPU kernel's port


def packed_estimate_batch_torch(codes, q_glob, norms, factors, code_dot_c, cluster_id,
                                probe_mask, csq_c, csum_c, *, d: int) -> torch.Tensor:
    """Plain version of :func:`packed_estimate_batch`: the product, the
    estimator over [N, Q], the mask, then the [Q, N] layout."""
    bq = packed_dot_batch_torch(codes, q_glob)
    est = _estimate(bq, norms[:, None], factors[:, None], code_dot_c[:, None],
                    csq_c[cluster_id], csum_c[cluster_id], d)
    est.masked_fill_(~probe_mask[cluster_id], math.inf)
    return est.T.contiguous()


def packed_estimate_batch(codes: torch.Tensor, q_glob: torch.Tensor, norms: torch.Tensor,
                          factors: torch.Tensor, code_dot_c: torch.Tensor,
                          cluster_id: torch.Tensor, probe_mask: torch.Tensor,
                          csq_c: torch.Tensor, csum_c: torch.Tensor, *, d: int,
                          query_group: int | None = None) -> torch.Tensor:
    """RaBitQ estimates [nq, N] f32 of Q globally rotated queries ``q_glob``
    [nq, ≤ 8·d8] against every row of the packed codes [N, d8], +inf where
    the row's cluster is not probed for the query: the estimate mode of the
    batch kernel (see :func:`_estimate`).

    Per row: ``norms``, ``factors``, ``code_dot_c`` [N] f32 and
    ``cluster_id`` [N] int64, each id in [0, nlist); per (cluster, query):
    ``probe_mask`` [nlist, nq] bool, ``csq_c`` and ``csum_c`` [nlist, nq]
    f32.  ``d`` scales the estimate (√d)."""
    _check_estimate(codes, q_glob, norms, factors, code_dot_c, cluster_id, probe_mask, csq_c,
                    csum_c, batch=True)
    n, d8 = codes.shape
    nq = q_glob.shape[0]
    dev = codes.device
    g = _query_group(nq, query_group)
    if dev.type == "cpu":
        return packed_estimate_batch_torch(codes, q_glob, norms, factors, code_dot_c,
                                           cluster_id, probe_mask, csq_c, csum_c, d=d)
    out = codes.new_empty((nq, n), dtype=torch.float32)
    if n and nq:
        _launcher("ls_packed_estimate_batch")(
            dev, codes.data_ptr(), q_glob.data_ptr(), norms.data_ptr(), factors.data_ptr(),
            code_dot_c.data_ptr(), cluster_id.data_ptr(), probe_mask.data_ptr(),
            csq_c.data_ptr(), csum_c.data_ptr(), out.data_ptr(), n, d8, q_glob.shape[1], nq,
            math.sqrt(d), g)
        packed_dot_batch.launches += 1
    return out


def packed_scan_torch(codes, norms, factors, q_rot, *, d: int) -> torch.Tensor:
    """Plain version of :func:`packed_scan`: the estimator of
    ``rabitq.estimate_distances``, the reference's own twin."""
    return estimate_distances(codes, norms, factors, q_rot, d=d)


def packed_scan(codes: torch.Tensor, norms: torch.Tensor, factors: torch.Tensor,
                q_rot: torch.Tensor, *, d: int) -> torch.Tensor:
    """Estimated squared distances of one cluster's packed codes [N, d8] to
    the rotated query residual ``q_rot`` [≤ 8·d8] → [N] f32.  Bits past
    ``len(q_rot)`` get zero weight; ``d`` scales the estimate (√d)."""
    _check(codes, q_rot, 1, norms=norms, factors=factors)
    if codes.device.type == "cpu":
        return packed_scan_torch(codes, norms, factors, q_rot, d=d)
    n, d8 = codes.shape
    out = torch.empty_like(norms)
    if n:
        _launcher("ls_packed_scan")(codes.device, codes.data_ptr(), q_rot.data_ptr(),
                                    norms.data_ptr(), factors.data_ptr(), out.data_ptr(), n, d8,
                                    q_rot.shape[0], math.sqrt(d))
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
    _check_tensor("query", query, torch.float32, (dd,), vectors.device)
    if vectors.device.type == "cpu":
        return bruteforce_distances_torch(vectors, query)
    out = vectors.new_empty(n)
    if n:
        _launcher("ls_bruteforce_distances")(vectors.device, vectors.data_ptr(),
                                             query.data_ptr(), out.data_ptr(), n, dd)
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


def _rerank_topk(est, raw, query, *, s: int, k: int, do_rerank: bool):
    """Shared tail of the single-query searches: [N] estimates → (dists
    [k], indices [k]) after the top-S shortlist's exact re-rank."""
    if not do_rerank:
        return _smallest(est, k)
    _, idx_s = _smallest(est, s)
    exact = _exact(raw[idx_s], query)
    dists, order = _smallest(exact, k)
    return dists, idx_s[order]


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
    return _rerank_topk(est, raw, query, s=s, k=k, do_rerank=do_rerank)


def _fused_search_resident(codes, norms, factors, code_dot_c, cluster_id, probe_mask,
                           csq_c, csum_c, q_glob, raw, query, *, d, s, k, do_rerank):
    """Device-resident variant: the WHOLE shard stays in device memory; per
    query only the rotated query and three (nlist,) vectors are new.
    Non-probed clusters are masked to +inf, in one kernel that reads no code
    bytes of theirs."""
    est = packed_estimate(codes, q_glob, norms, factors, code_dot_c, cluster_id, probe_mask,
                          csq_c, csum_c, d=d)
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
    """Shared tail of the batched resident search: [Q, N] estimates →
    (dists [Q, k], indices [Q, k]), with optional exact re-rank.  The
    estimates come in the layout the top-k reads, along the last axis, as
    the reference takes it (its ``est.T``)."""
    if not do_rerank:
        return _smallest(est, k)
    est_s, idx_s = _smallest(est, s)  # [Q, s]
    exact = exact_distances(raw[idx_s], queries)  # gathers [Q, s, d]
    exact = exact.masked_fill(~torch.isfinite(est_s), math.inf)
    dists, order = _smallest(exact, k)
    return dists, torch.gather(idx_s, 1, order)


def _fused_search_resident_batch(codes, norms, factors, code_dot_c, cluster_id,
                                 probe_mask, csq_c, csum_c, q_glob, raw, queries,
                                 *, d, s, k, do_rerank):
    """Batched device-resident search: Q queries share one pass over the
    packed codes, which stay packed in device memory.  One kernel gives the
    masked [Q, N] estimates; no [N, Q] intermediate exists."""
    est = packed_estimate_batch(codes, q_glob, norms, factors, code_dot_c, cluster_id,
                                probe_mask, csq_c, csum_c, d=d)
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


# --------------------------------------------------------------------------
# ex-code search bodies (total_bits 2-16): torch ops, as the reference's
# jnp bodies are (no Pallas kernel lies behind them)
# --------------------------------------------------------------------------

# code rows converted to float64 at a time: bounds the temporary (256 MB at
# d 512) whatever N is
EX_CHUNK = 65536


def ex_dot(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Integer ex-codes [N, d] (int8 / int16) times q [d] → [N], or times
    Qᵀ for q [nq, d] → [N, nq], in float32.

    Torch has no int8 × float32 matmul on CUDA, so each chunk of EX_CHUNK
    rows is converted, to float64: every code × query product is exact
    there and the sum carries 53 bits, so rounding it to float32 hides the
    summation order cuBLAS picks by the batch's shape (but for a sum within
    ~1e-16 of a float32 rounding boundary) — a query's products are the
    same alone and in a batch."""
    q64 = q.double() if q.ndim == 1 else q.double().T
    out = torch.empty((len(codes), *q64.shape[1:]), dtype=torch.float32, device=codes.device)
    for lo in range(0, len(codes), EX_CHUNK):
        out[lo:lo + EX_CHUNK] = codes[lo:lo + EX_CHUNK].double() @ q64
    return out


def _estimate_ex(g, scales, norms, factors, code_dot_c, csq):
    """The ex-code estimator in the global query frame, with
    g = codes · Q (u_hat · Q = g · scale):
        dist² ≈ ||r||² + ||xc||² + 2·||r||·(code_dot_c - u_hat·Q)/factor
    (no csum: u_hat is real-valued, not ±1 bits)."""
    return norms * norms + csq + 2.0 * norms * (code_dot_c - g * scales) / factors


def _fused_search_ex(codes, scales, norms, factors, code_dot_c, csq, q_glob, raw, query,
                     *, s, k, do_rerank):
    """One pass per query over the concatenated probe set's ex-codes: one
    codes · Q product, the estimator, then top-S shortlist → exact re-rank
    → top-k."""
    est = _estimate_ex(ex_dot(codes, q_glob), scales, norms, factors, code_dot_c, csq)
    return _rerank_topk(est, raw, query, s=s, k=k, do_rerank=do_rerank)


def fused_search_ex(codes, scales, norms, factors, code_dot_c, csq, q_glob, raw, query,
                    *, top_k, shortlist):
    """Host wrapper of the ex-code search (pow2 padding and pad rows as
    :func:`fused_search`'s): (dists, indices) as numpy."""
    n = len(codes)
    n_pad = _pow2_bucket(n)
    do_rerank = raw is not None
    dists, idx = _fused_search_ex(
        _pad_tail(codes, n_pad), _pad_tail(scales, n_pad), _pad_tail(norms, n_pad, PAD_NORM),
        _pad_tail(factors, n_pad, PAD_FACTOR), _pad_tail(code_dot_c, n_pad),
        _pad_tail(csq, n_pad), q_glob.contiguous(),
        _pad_tail(raw, n_pad, PAD_RAW) if do_rerank else None, query,
        s=min(shortlist, n_pad), k=min(top_k, n_pad), do_rerank=do_rerank,
    )
    return dists.cpu().numpy(), idx.cpu().numpy()


def _fused_search_resident_ex_batch(codes, scales, norms, factors, code_dot_c, cluster_id,
                                    probe_mask, csq_c, q_glob, raw, queries, *, s, k,
                                    do_rerank):
    """Batched device-resident search over ex-codes: Q queries share one
    pass over the resident codes, EX_CHUNK rows at a time — the product,
    the estimator and the probe mask of a chunk, written into the [Q, N]
    estimates that the top-k reads along their last axis."""
    n = len(codes)
    est = torch.empty((len(q_glob), n), dtype=torch.float32, device=codes.device)
    for lo in range(0, n, EX_CHUNK):
        rows = slice(lo, lo + EX_CHUNK)
        cid = cluster_id[rows]
        e = _estimate_ex(ex_dot(codes[rows], q_glob), scales[rows, None], norms[rows, None],
                         factors[rows, None], code_dot_c[rows, None], csq_c[cid])
        est[:, rows] = e.masked_fill_(~probe_mask[cid], math.inf).T
    return _batched_rerank_topk(est, raw, queries, s=s, k=k, do_rerank=do_rerank)
