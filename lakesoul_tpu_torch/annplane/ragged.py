"""Ragged query batching for multi-shard ANN scoring (the port of
``lakesoul_tpu/annplane/ragged.py``).

A serving micro-batch holds Q queries with DIFFERENT ``nprobe`` and
different probed-cluster sets.  It is flattened into (query, cluster-tile)
WORK ITEMS: :func:`plan_items` turns the (query, cluster) probe pairs into
item tables on the host, :func:`ragged_score` scores every item's tile
against its query row on the device, and :func:`items_topk` takes each
query's top-``s`` rows — no (rows × queries) rectangle ever exists.

Estimator (global query frame, shared with ``vector/kernels.py``): per row
    est = b + csq - h * csum - a * g,      g = codes_f · P(query)
where ``codes_f``/``a``/``b``/``h`` are per-row constants
(:func:`fold_cluster`) and ``csq``/``csum`` per-(query, cluster) scalars.

:func:`ragged_score` launches the CUDA kernel ``csrc/ragged_score.cu`` for
tensors on a CUDA device, which replaces ``ragged_score_pallas`` →
``_ragged_score_kernel``, and takes its plain version
:func:`ragged_score_torch` (the gather form of the reference's
``ragged_score_jnp``) only for tensors on the CPU.  On the card the items
are first grouped by tile (:func:`group_items_by_tile`, a few torch ops on
the device), so the kernel stages each probed tile once for every query
that probes it, as the reference's host path groups its products by
cluster.  The reference's pow2 padding of M and Q bounded TPU compiles and
is dropped.

:func:`ragged_topk_host` is the reference's host path, which a plane opened
on the CPU runs where the native library is built: its scan + per-query
top-``s`` in one call (``native.ann_ragged_topk``).  Same math as the item
path, without tile padding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lakesoul_tpu_torch import _build

TILE = 128  # rows per work item
MAX_KERNEL_TILE = 128  # the CUDA kernel's largest tile (kMaxTile in csrc/ragged_score.cu)
# pad rows carry this additive constant: estimated distances become
# huge-but-finite (inf would poison a*g arithmetic), and the top-k treats
# anything at or above PAD_EST_VALID as a hole
PAD_B = np.float32(1e30)
PAD_EST_VALID = np.float32(1e29)


def ragged_arange(starts, counts) -> np.ndarray:
    """Concatenate ``arange(s, s + c)`` for each (s, c) pair, vectorized."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    base = np.repeat(np.asarray(starts, np.int64), counts)
    resets = np.repeat(np.cumsum(counts) - counts, counts)
    return base + (np.arange(total, dtype=np.int64) - resets)


def fold_cluster(norms: torch.Tensor, factors: torch.Tensor, code_dot_c: torch.Tensor,
                 *, d: int, ex: bool = False):
    """Fold per-row RaBitQ constants into the (a, b, h) form of the ragged
    estimator, on the tensors' device.  ``ex`` selects the ex-code
    estimator (a = 2·norm/factor, csum unused, h = 0); the 1-bit form folds
    the 1/sqrt(D) bit-plane normalization in."""
    if ex:
        a = 2.0 * norms / factors
        return a, norms * norms + a * code_dot_c, torch.zeros_like(a)
    root_d = float(np.float32(np.sqrt(d)))
    hh = 2.0 * norms / (factors * root_d)
    a = 2.0 * hh
    return a, norms * norms + a * code_dot_c, hh


def plan_items(pairs_q, pairs_c, csq, csum, tile_start, tile_count):
    """Flatten (query, cluster) probe pairs into per-tile work items, on the
    host.  Pairs must arrive query-major (sorted by query) so item rows stay
    query-contiguous for :func:`items_topk`.  Returns (item_q, item_tile)
    int32 and (csq, csum) f32 numpy arrays, one entry per item."""
    pairs_c = np.asarray(pairs_c, np.int64)
    reps = np.asarray(tile_count, np.int64)[pairs_c]
    item_q = np.repeat(np.asarray(pairs_q, np.int64), reps).astype(np.int32)
    item_tile = ragged_arange(np.asarray(tile_start, np.int64)[pairs_c], reps).astype(np.int32)
    item_csq = np.repeat(np.asarray(csq, np.float32), reps)
    item_csum = np.repeat(np.asarray(csum, np.float32), reps)
    return item_q, item_tile, item_csq, item_csum


# --------------------------------------------------------------------------
# the kernel: CUDA wrapper + plain version
# --------------------------------------------------------------------------


@functools.cache
def _launcher():
    return _build.entry(_build.load("ragged_score"), "ls_ragged_score",
                        [ctypes.c_void_p] * 12 + [ctypes.c_int64] + [ctypes.c_int] * 3)


def group_items_by_tile(item_tile: torch.Tensor, n_tiles: int):
    """Tile-major view of the item tables, on ``item_tile``'s device, with
    no copy between host and device and no sync.  Returns

    * ``order`` [M] int64 — item indices tile by tile, ascending within a
      tile (a stable sort of ``item_tile``);
    * ``tile_ptr`` [n_tiles + 1] int32 — tile t's items are
      ``order[tile_ptr[t]:tile_ptr[t + 1]]``;
    * ``walk`` [n_tiles] int64 — the tiles by item count, largest first,
      ties by tile index: the order the kernel's blocks take them in."""
    keys, order = torch.sort(item_tile, stable=True)
    bounds = torch.arange(n_tiles + 1, dtype=keys.dtype, device=keys.device)
    tile_ptr = torch.searchsorted(keys, bounds, out_int32=True)
    walk = torch.argsort(tile_ptr[1:] - tile_ptr[:-1], descending=True, stable=True)
    return order, tile_ptr, walk


def ragged_score_torch(item_q: torch.Tensor, item_tile: torch.Tensor, csq: torch.Tensor,
                       csum: torch.Tensor, q_glob, codes, a, b, h, *, tile: int = TILE):
    """Plain version of :func:`ragged_score`: gather each item's tile and
    query row, then one batched product (materializes [M, tile, d])."""
    rows = item_tile.long()[:, None] * tile + torch.arange(tile, device=codes.device)[None, :]
    g = torch.bmm(codes[rows], q_glob[item_q.long()][:, :, None])[..., 0]
    return b[rows] + csq[:, None] - h[rows] * csum[:, None] - a[rows] * g


def _check_score_inputs(item_q, item_tile, csq, csum, q_glob, codes, a, b, h, tile):
    m = len(item_q)
    if not (len(item_tile) == len(csq) == len(csum) == m):
        raise ValueError("item_q, item_tile, csq and csum must have one entry per item")
    if codes.dtype != torch.float32 or codes.ndim != 2 or q_glob.dtype != torch.float32 \
            or q_glob.ndim != 2 or q_glob.shape[1] != codes.shape[1]:
        raise ValueError(f"need codes [R, d] and q_glob [Q, d] float32, got"
                         f" {tuple(codes.shape)} {codes.dtype}, {tuple(q_glob.shape)} {q_glob.dtype}")
    r = codes.shape[0]
    if tile < 1 or r % tile:
        raise ValueError(f"codes rows {r} are not a multiple of the tile {tile}")
    dev = codes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"codes on {dev}: need a cpu or cuda device")
    for name, t in (("a", a), ("b", b), ("h", h)):
        if t.dtype != torch.float32 or t.shape != (r,):
            raise ValueError(f"{name} must be [{r}] float32, got {t.dtype} {tuple(t.shape)}")
    for t in (q_glob, codes, a, b, h):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"q_glob, codes, a, b, h must be contiguous on {dev}")
    if m and not (0 <= item_tile.min() and item_tile.max() < r // tile):
        raise ValueError(f"item_tile out of range [0, {r // tile})")
    if m and not (0 <= item_q.min() and item_q.max() < q_glob.shape[0]):
        raise ValueError(f"item_q out of range [0, {q_glob.shape[0]})")
    if dev.type == "cuda" and not (tile <= MAX_KERNEL_TILE and m < 2**31):
        raise ValueError(f"the CUDA kernel takes tiles of at most {MAX_KERNEL_TILE} rows and"
                         f" fewer than 2^31 items, got tile {tile} and {m} items")


def ragged_score(item_q, item_tile, csq, csum, q_glob: torch.Tensor, codes: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor, h: torch.Tensor, *,
                 tile: int = TILE) -> torch.Tensor:
    """Item scores [M, tile] f32 on ``codes``' device.

    ``item_q``/``item_tile`` (int) and ``csq``/``csum`` (f32) are the host
    item tables of :func:`plan_items`, [M] each; they are checked against
    ``q_glob`` [Q, d] and ``codes`` [R, d] before they are copied to the
    device.  ``a``/``b``/``h`` are [R] f32.  On the card the tables are
    grouped by tile there (:func:`group_items_by_tile`) and one kernel
    launch scores every item."""
    item_q = np.asarray(item_q, np.int32)
    item_tile = np.asarray(item_tile, np.int32)
    csq = np.asarray(csq, np.float32)
    csum = np.asarray(csum, np.float32)
    _check_score_inputs(item_q, item_tile, csq, csum, q_glob, codes, a, b, h, tile)
    dev = codes.device
    ints = torch.from_numpy(np.stack([item_q, item_tile])).to(dev)
    floats = torch.from_numpy(np.stack([csq, csum])).to(dev)
    if dev.type == "cpu":
        return ragged_score_torch(ints[0], ints[1], floats[0], floats[1], q_glob, codes, a, b, h,
                                  tile=tile)
    m = len(item_q)
    out = torch.empty((m, tile), dtype=torch.float32, device=dev)
    if m:
        n_tiles = codes.shape[0] // tile
        order, tile_ptr, walk = group_items_by_tile(ints[1], n_tiles)
        _launcher()(dev, ints[0].data_ptr(), floats[0].data_ptr(), floats[1].data_ptr(),
                    order.data_ptr(), tile_ptr.data_ptr(), walk.data_ptr(), q_glob.data_ptr(),
                    codes.data_ptr(), a.data_ptr(), b.data_ptr(), h.data_ptr(), out.data_ptr(),
                    m, n_tiles, codes.shape[1], tile)
        ragged_score.launches += 1
    return out


ragged_score.launches = 0


def items_topk(est: torch.Tensor, item_q, item_tile, nq: int, s: int, *, tile: int = TILE):
    """Per-query top-``s`` over item scores, on ``est``'s device with no
    per-query loop.  Items are query-contiguous: each query's item rows are
    scattered into one row of a [nq, max_items·tile] buffer of +inf, then
    one ``torch.topk``.  Returns (rows [nq, s] int64 with -1 holes,
    est [nq, s] f32 with +inf holes); scores >= PAD_EST_VALID are holes."""
    dev = est.device
    out_rows = torch.full((nq, s), -1, dtype=torch.int64, device=dev)
    out_est = torch.full((nq, s), float("inf"), dtype=torch.float32, device=dev)
    item_q = np.asarray(item_q, np.int64)
    m = len(item_q)
    if m == 0 or s == 0:
        return out_rows, out_est
    counts = np.bincount(item_q, minlength=nq)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(m, dtype=np.int64) - offsets[item_q]  # item's place in its query
    width = int(counts.max()) * tile
    buf = torch.full((nq, width), float("inf"), dtype=torch.float32, device=dev)
    cols = torch.from_numpy(slot).to(dev)[:, None] * tile + torch.arange(tile, device=dev)
    buf[torch.from_numpy(item_q).to(dev)[:, None], cols] = est
    k = min(s, width)
    vals, pos = torch.topk(buf, k, dim=1, largest=False, sorted=True)
    # pos → item (via the query's first item) → shard row
    tiles = torch.from_numpy(np.asarray(item_tile, np.int64)).to(dev)
    first = torch.from_numpy(offsets).to(dev)[:, None]
    item = (first + pos // tile).clamp_max(m - 1)
    rows = tiles[item] * tile + pos % tile
    valid = vals < float(PAD_EST_VALID)
    out_est[:, :k] = torch.where(valid, vals, float("inf"))
    out_rows[:, :k] = torch.where(valid, rows, -1)
    return out_rows, out_est


# --------------------------------------------------------------------------
# host path: the native library's scan + per-query top-s
# --------------------------------------------------------------------------


def ragged_topk_host(
    codes, a, b, h, row_start, row_count,
    pairs_q, pairs_c, csq, csum, q_glob, nq: int, s: int,
):
    """Per-query top-``s`` estimator candidates on the host (numpy in, numpy
    out; the reference's ``ragged_topk_host`` through its native branch).

    The native library runs the whole scan + top-``s`` in one GIL-released
    call, each probed cluster's codes touched once against the queries that
    probed it.  Returns (rows [nq, s'] int64 with -1 holes, est [nq, s'] f32
    with +inf holes), ``s' = min(s, rows of the shard)``, shortlist order
    unspecified.  Needs ``native.available()``; without the library a CPU
    plane runs the item path."""
    from lakesoul_tpu_torch import native

    if not native.available():
        raise RuntimeError("ragged_topk_host needs the native library")
    pairs_q = np.asarray(pairs_q, np.int64)
    pairs_c = np.asarray(pairs_c, np.int64)
    csq = np.asarray(csq, np.float32)
    csum = np.asarray(csum, np.float32)
    row_start = np.asarray(row_start, np.int64)
    row_count = np.asarray(row_count, np.int64)
    s = min(int(s), max(1, int(row_count.sum())))
    if not len(pairs_q):
        return np.full((nq, s), -1, np.int64), np.full((nq, s), np.inf, np.float32)
    corder = np.argsort(pairs_c, kind="stable")
    uniq, grp_start = np.unique(pairs_c[corder], return_index=True)
    grp_off = np.append(grp_start, len(corder)).astype(np.int64)
    use_csum = bool(np.any(h)) and bool(np.any(csum))
    return native.ann_ragged_topk(
        codes, a, b, h if use_csum else None,
        row_start, row_count,
        np.ascontiguousarray(q_glob, np.float32),
        uniq.astype(np.int32), grp_off,
        np.ascontiguousarray(pairs_q[corder], np.int32),
        np.ascontiguousarray(csq[corder], np.float32),
        np.ascontiguousarray(csum[corder], np.float32) if use_csum else None,
        s,
    )
