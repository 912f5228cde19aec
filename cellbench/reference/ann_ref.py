"""Plain PyTorch check of the ANN plane: its build and its answers.

It makes the corpus again from the seed (``inputs.corpus_rows``) and works
out, in float64, what the program derived from it:

- each shard's k-means: Lloyd's iterations from the configuration's seeded
  initial rows of the shard's seeded training sample, as many as the
  configuration states;
- the RaBitQ quantisation of a row against a centroid: the seeded
  sign-flip Hadamard rotation as one orthonormal matrix, the symmetric
  ``total_bits`` integer codes of the unit residual over its largest
  coordinate, the scale, the factor and the estimator's two per-row
  constants ``a`` = 2·norm/factor and ``b`` = norm² + a·(û·P(c));
- the probe: each query's ``nprobe`` nearest centroids over every shard;
  the lists: each row's nearest centroid of its shard; the exact top-k
  among the rows of the probed lists, merged over shards; the exact
  distance of every row the program returned.

The program's state is read to be judged: its centroids, and for a sample
of each shard's rows drawn from the seed, the list that holds the row and
the row's resident codes and constants (``plane.plane_state``).  The probe
and the lists follow the program's centroids, once ``kmeans_gap`` has held
them against the reference's own: Lloyd's iterations in float32 and in
float64 part after a near-tie flips a row, so the reference's own lists
differ from the program's at a few rows on some seeds, and the exact top-k
with them.  The numbers ``correct`` is decided by:

- ``kmeans_gap``: each program centroid against the reference's, over the
  list's rms radius (floored at the median list's), the worst list;
- ``list_gap``: how much farther a sampled row lies from the centroid of
  the program's list than from the nearest of the program's centroids,
  relative, the worst row: the assignment judged on the centroids it was
  made with;
- ``codes_off``: the share of the sampled rows' code entries that differ
  from the reference's quantisation of the row against the centroid of
  its program list, a level either way at an exact rounding tie excepted;
- ``factor_gap``: the widest relative gap of a sampled row's scale, ``a``
  and ``b``, the same quantisation;
- ``dist_err``: the widest gap between a returned distance and the exact
  distance of the row returned, relative (floor 1): the re-rank, the union
  and the id map;
- ``topk_gap``: the widest gap between the k-th distance returned and the
  k-th of the probed exact top-k, relative (floor 1): the probe, the
  scoring, the shortlist and the union;
- ``order_bad``: answers whose distances are not ascending or whose rows
  repeat.

It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import inputs

ROW_CHUNK = 65_536
WRONG = 1e30  # the reading of an answer that cannot be right
TIE = 1e-3  # code units within which a rounding may go either way


# ---------------------------------------------------------------- build
def train_sample(n: int, sample_rows: int, index_seed: int, shard: int) -> np.ndarray:
    """The rows of a shard its k-means trains on, as the build draws them."""
    if n <= sample_rows:
        return np.arange(n)
    return np.random.default_rng(index_seed + shard).choice(n, sample_rows, replace=False)


def _d2(x: torch.Tensor, c: torch.Tensor, products=torch.float64) -> torch.Tensor:
    """Squared distances [len(x), len(c)] in float64 by the expanded form,
    the cross products taken in ``products`` (summed in float32 below
    float64)."""
    if products == torch.float64:
        xc = x.double() @ c.double().T
    else:
        xc = (x.to(products) @ c.to(products).T).double()
    return (x.double() ** 2).sum(1)[:, None] - 2.0 * xc + (c.double() ** 2).sum(1)[None, :]


def nearest(x: torch.Tensor, c: torch.Tensor, products=torch.float64) -> torch.Tensor:
    out = torch.empty(len(x), dtype=torch.int64, device=x.device)
    for lo in range(0, len(x), ROW_CHUNK):
        out[lo:lo + ROW_CHUNK] = torch.argmin(_d2(x[lo:lo + ROW_CHUNK], c, products), dim=1)
    return out


def kmeans(x: torch.Tensor, k: int, iters: int, seed: int, products=torch.float64):
    """Lloyd's iterations from the seeded initial rows: (centroids [k, d]
    float64, each row's list).  A list left empty keeps its centroid."""
    n = len(x)
    x = x.double()
    k_eff = min(k, n)
    init = np.random.default_rng(seed).choice(n, size=k_eff, replace=False)
    if k_eff < k:
        init = np.concatenate([init, init[np.zeros(k - k_eff, dtype=int)]])
    c = x[torch.from_numpy(init).to(x.device)]
    for _ in range(iters):
        a = nearest(x, c, products)
        counts = torch.bincount(a, minlength=k).double()[:, None]
        sums = torch.zeros_like(c).index_add_(0, a, x)
        c = torch.where(counts > 0, sums / counts.clamp_min(1.0), c)
    return c, nearest(x, c, products)


def kmeans_gap(prog: torch.Tensor, ref: torch.Tensor, x: torch.Tensor, lists) -> float:
    """The worst list's centroid gap over its rms radius (floored at the
    median list's)."""
    k = len(ref)
    counts = torch.bincount(lists, minlength=k).double()
    sq = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, lists, ((x.double() - ref[lists]) ** 2).sum(1))
    radius = (sq / counts.clamp_min(1.0)).sqrt()
    floor = radius[counts > 0].median()
    return float(((prog.double() - ref).norm(dim=1) / torch.maximum(radius, floor)).max())


def rotation(dim: int, seed: int, device, rounds: int = 3) -> torch.Tensor:
    """The seeded rotation as a float64 matrix [dim, padded] on row vectors:
    pad to a power of two, then ``rounds`` times flip the signs drawn from
    the seed and apply the orthonormal Hadamard matrix."""
    padded = 1 << max(dim - 1, 0).bit_length()
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], size=(rounds, padded))
    idx = np.arange(padded)
    had = (-1.0) ** np.array([[bin(i & j).count("1") for j in idx] for i in idx])
    m = np.eye(padded)[:dim]
    for r in range(rounds):
        m = (m * signs[r][None, :]) @ had / math.sqrt(padded)
    return torch.from_numpy(m).to(device)


def quantize(x: torch.Tensor, c: torch.Tensor, rot: torch.Tensor, bits: int,
             prog_codes: torch.Tensor | None = None) -> dict:
    """Rows ``x`` [n, d] against centroids ``c`` [n, d] (one a row), float64.
    Where ``prog_codes`` is given, a code at an exact rounding tie that the
    program took a level the other way is taken as the program took it."""
    qmax = float(2 ** (bits - 1) - 1)
    r = (x.double() - c.double()) @ rot
    norm = r.norm(dim=1)
    u = r / norm.clamp_min(1e-20)[:, None]
    amax = u.abs().amax(dim=1).clamp_min(1e-20)
    t = u / amax[:, None] * qmax
    codes = torch.round(t).clamp(-qmax, qmax)
    if prog_codes is not None:
        tie = ((t - t.floor() - 0.5).abs() < TIE) & ((prog_codes - codes).abs() == 1)
        codes = torch.where(tie, prog_codes, codes)
    scale = amax / qmax
    u_hat = codes * scale[:, None]
    factor = (u_hat * u).sum(1)
    factor = torch.where(factor.abs() < 1e-6, torch.ones_like(factor), factor)
    a = 2.0 * norm / factor
    cdc = (u_hat * (c.double() @ rot)).sum(1)
    return {"codes": codes, "scale": scale, "a": a, "b": norm * norm + a * cdc,
            "b_scale": norm * norm + (a * cdc).abs()}


def prog_codes(u_hat: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The integer codes and the scale of resident rows û = codes · scale:
    the largest coordinate's code is ±qmax."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = u_hat.double().abs().amax(dim=1) / qmax
    return torch.round(u_hat.double() / scale.clamp_min(1e-30)[:, None]), scale


def sampled_rows(x: torch.Tensor, lo: int, rows: dict, centroids: torch.Tensor,
                 rot: torch.Tensor, bits: int) -> dict:
    """``list_gap``, ``codes_off`` and ``factor_gap`` of one shard's sampled
    rows ``rows`` (ids, list, u_hat, a, b) against the shard's centroids
    that ``rows`` was built with."""
    dev = x.device
    held = np.asarray(rows["list"], np.int64) >= 0
    if not held.all():
        return {"list_gap": WRONG, "codes_off": 0, "entries": 0, "factor_gap": WRONG}
    xs = x[torch.as_tensor(np.asarray(rows["ids"], np.int64) - lo, device=dev)].double()
    lists = torch.as_tensor(np.asarray(rows["list"], np.int64), device=dev)
    c = centroids.double()
    d2 = _d2(xs, c)
    best = d2.min(dim=1).values
    own = d2.gather(1, lists[:, None])[:, 0]
    list_gap = float(((own - best) / best.clamp_min(1e-12)).max()) if len(xs) else 0.0
    codes_p, scale_p = prog_codes(torch.as_tensor(np.asarray(rows["u_hat"]), device=dev), bits)
    ref = quantize(xs, c[lists], rot, bits, codes_p)
    off = int((codes_p != ref["codes"]).sum())
    a_p = torch.as_tensor(np.asarray(rows["a"]), device=dev).double()
    b_p = torch.as_tensor(np.asarray(rows["b"]), device=dev).double()
    gaps = torch.stack([(scale_p - ref["scale"]).abs() / ref["scale"],
                        (a_p - ref["a"]).abs() / ref["a"].abs(),
                        (b_p - ref["b"]).abs() / ref["b_scale"]])
    return {"list_gap": list_gap, "codes_off": off, "entries": int(codes_p.numel()),
            "factor_gap": float(gaps.max()) if len(xs) else 0.0}


def control_state(*, seed: int, cfg: dict, shard_ranges, row_ids, device) -> dict:
    """The control's build, in the program's place, one step below each
    stated precision: k-means and the lists with bfloat16 products, codes at
    one bit fewer; the same sampled rows."""
    bits = int(cfg["total_bits"]) - 1
    dim = int(cfg["dim"])
    rot = rotation(dim, int(cfg["index_seed"]), device)
    centers = inputs.corpus_centers(seed, cfg["corpus"], dim, device)
    state = {"centroids": [], "rows": []}
    for si, (lo, hi) in enumerate(shard_ranges):
        x = inputs.corpus_rows(seed, cfg["corpus"], centers, lo, hi)
        sel = train_sample(hi - lo, int(cfg["train_sample_rows"]), int(cfg["index_seed"]), si)
        c, _ = kmeans(x[torch.from_numpy(sel).to(device)], int(cfg["nlist"]),
                      int(cfg["kmeans_iters"]), int(cfg["index_seed"]), torch.bfloat16)
        xs = x[torch.as_tensor(np.asarray(row_ids[si], np.int64) - lo, device=device)]
        lists = nearest(xs, c, torch.bfloat16)
        q = quantize(xs, c[lists], rot, bits)
        state["centroids"].append(c.float().cpu().numpy())
        state["rows"].append({"ids": np.asarray(row_ids[si]), "list": lists.cpu().numpy(),
                              "u_hat": (q["codes"] * q["scale"][:, None]).float().cpu().numpy(),
                              "a": q["a"].float().cpu().numpy(),
                              "b": q["b"].float().cpu().numpy()})
        del x
    return state


def build_centroids(*, seed: int, cfg: dict, shard_ranges, device, products=torch.float64):
    """Every shard's k-means, the reference's own, as the build trains it."""
    dim = int(cfg["dim"])
    centers = inputs.corpus_centers(seed, cfg["corpus"], dim, device)
    out = []
    for si, (lo, hi) in enumerate(shard_ranges):
        x = inputs.corpus_rows(seed, cfg["corpus"], centers, lo, hi)
        sel = train_sample(hi - lo, int(cfg["train_sample_rows"]), int(cfg["index_seed"]), si)
        out.append(kmeans(x[torch.from_numpy(sel).to(device)], int(cfg["nlist"]),
                          int(cfg["kmeans_iters"]), int(cfg["index_seed"]), products))
        del x
    return out


# --------------------------------------------------------------- answers
def probe_mask(q64: torch.Tensor, cent64: torch.Tensor, nprobes) -> torch.Tensor:
    """[S, C] True where query s probes global cluster c."""
    cd = (cent64 * cent64).sum(1)[None, :] - 2.0 * q64 @ cent64.T
    nprobes = torch.as_tensor(np.asarray(nprobes), device=q64.device).clamp(1, cent64.shape[0])
    sel = torch.topk(cd, int(nprobes.max()), dim=1, largest=False, sorted=True).indices
    keep = torch.arange(sel.shape[1], device=q64.device)[None, :] < nprobes[:, None]
    mask = torch.zeros(cd.shape, dtype=torch.bool, device=q64.device)
    mask.scatter_(1, sel, keep)
    return mask


def _scan(*, seed, cfg, shard_ranges, centroids, queries, nprobes, dtype, device, rows=None,
          query_of=None):
    """One pass over the corpus, shard by shard, in ``dtype``: the exact
    top-k of every query among the lists it probes under ``centroids``,
    and the distances of ``rows`` (to the queries ``query_of`` names)."""
    dev = torch.device(device)
    top_k = int(cfg["search"]["top_k"])
    q = torch.as_tensor(np.asarray(queries)).to(dev, dtype)
    S = len(q)
    cents = [c.to(dev, dtype) for c in centroids]
    base = np.concatenate([[0], np.cumsum([len(c) for c in cents])[:-1]])
    probed = probe_mask(q, torch.cat(cents), nprobes)
    best_d = torch.full((S, top_k), float("inf"), dtype=dtype, device=dev)
    best_r = torch.full((S, top_k), -1, dtype=torch.int64, device=dev)
    rows = np.zeros(0, np.int64) if rows is None else np.asarray(rows, np.int64)
    q_of = torch.from_numpy(np.asarray(query_of if query_of is not None else [], np.int64)).to(dev)
    exact = np.full(len(rows), np.nan)
    q_sq = (q * q).sum(1)
    centers = inputs.corpus_centers(seed, cfg["corpus"], int(cfg["dim"]), dev)
    for si, (lo, hi) in enumerate(shard_ranges):
        x = inputs.corpus_rows(seed, cfg["corpus"], centers, lo, hi).to(dtype)
        glist = nearest(x, cents[si], dtype) + int(base[si])
        for a in range(0, hi - lo, ROW_CHUNK):
            xs = x[a:a + ROW_CHUNK]
            d = (xs * xs).sum(1)[:, None] - 2.0 * xs @ q.T + q_sq[None, :]
            d = d.T.masked_fill(~probed[:, glist[a:a + ROW_CHUNK]], float("inf"))
            vd, vi = torch.topk(d, min(top_k, d.shape[1]), dim=1, largest=False)
            cat_d = torch.cat([best_d, vd], 1)
            cat_r = torch.cat([best_r, vi + lo + a], 1)
            best_d, pos = torch.topk(cat_d, top_k, dim=1, largest=False)
            best_r = torch.gather(cat_r, 1, pos)
        here = np.flatnonzero((rows >= lo) & (rows < hi))
        if len(here):
            xr = x[torch.from_numpy(rows[here] - lo).to(dev)]
            exact[here] = ((xr - q[q_of[torch.from_numpy(here).to(dev)]]) ** 2).sum(1).cpu().numpy()
        del x, glist
    return best_d.cpu().numpy(), best_r.cpu().numpy(), exact


def control_answers(*, seed, cfg, shard_ranges, centroids, queries, nprobes, device) -> list:
    """The control's answers: the probe, the lists and the exact top-k over
    ``centroids`` all in float32, the distances by the expanded form
    ‖x‖² − 2x·q + ‖q‖² a float32 re-rank would take: the nearest precision
    below the configuration's float64 probe and re-rank."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d, r, _ = _scan(seed=seed, cfg=cfg, shard_ranges=shard_ranges,
                        centroids=[torch.as_tensor(c) for c in centroids], queries=queries,
                        nprobes=nprobes, dtype=torch.float32, device=device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return [(r[j].astype(np.uint64), d[j].astype(np.float32)) for j in range(len(r))]


# ----------------------------------------------------------------- check
def check(*, seed: int, cfg: dict, shard_ranges, state: dict, queries, nprobes, answers,
          device) -> dict:
    """The readings of the build's ``state`` (``plane.plane_state``'s
    ``centroids`` and ``rows``) and of the ``answers`` [(ids, dists)] to the
    sampled ``queries`` [S, d] with their ``nprobes`` [S]; with
    ``probe_miss`` (the share of the probed exact top-k the answers left
    out) and ``kmeans_gap_f32`` (the reference's own k-means with float32
    products against its float64 one), logged, not compared."""
    dev = torch.device(device)
    top_k = int(cfg["search"]["top_k"])
    bits = int(cfg["total_bits"])
    rot = rotation(int(cfg["dim"]), int(cfg["index_seed"]), dev)
    built = build_centroids(seed=seed, cfg=cfg, shard_ranges=shard_ranges, device=dev)
    built32 = build_centroids(seed=seed, cfg=cfg, shard_ranges=shard_ranges, device=dev,
                              products=torch.float32)
    centers = inputs.corpus_centers(seed, cfg["corpus"], int(cfg["dim"]), dev)
    read = {"kmeans_gap": 0.0, "kmeans_gap_f32": 0.0, "list_gap": 0.0, "codes_off": 0,
            "entries": 0, "factor_gap": 0.0}
    for si, (lo, hi) in enumerate(shard_ranges):
        x = inputs.corpus_rows(seed, cfg["corpus"], centers, lo, hi)
        sample = x[torch.from_numpy(train_sample(hi - lo, int(cfg["train_sample_rows"]),
                                                 int(cfg["index_seed"]), si)).to(dev)]
        c_ref, lists = built[si]
        c_prog = torch.as_tensor(np.asarray(state["centroids"][si]), device=dev)
        read["kmeans_gap"] = max(read["kmeans_gap"], kmeans_gap(c_prog, c_ref, sample, lists))
        read["kmeans_gap_f32"] = max(read["kmeans_gap_f32"],
                                     kmeans_gap(built32[si][0], c_ref, sample, lists))
        s = sampled_rows(x, lo, state["rows"][si], c_prog, rot, bits)
        read["list_gap"] = max(read["list_gap"], s["list_gap"])
        read["factor_gap"] = max(read["factor_gap"], s["factor_gap"])
        read["codes_off"] += s["codes_off"]
        read["entries"] += s["entries"]
        del x, sample

    lens = [len(np.asarray(ids)) for ids, _ in answers]
    rows = np.concatenate([np.asarray(ids, np.int64) for ids, _ in answers] + [[]]).astype(
        np.int64)
    best_d, best_r, exact = _scan(
        seed=seed, cfg=cfg, shard_ranges=shard_ranges,
        centroids=[torch.as_tensor(np.asarray(c)) for c in state["centroids"]],
        queries=queries, nprobes=nprobes, dtype=torch.float64, device=dev, rows=rows,
        query_of=np.repeat(np.arange(len(answers)), lens))
    exact = np.split(exact, np.cumsum(lens)[:-1])
    dist_err, topk_gap, hit, order_bad = 0.0, 0.0, 0, 0
    for j, (ids, dists) in enumerate(answers):
        ids = np.asarray(ids, np.int64)
        dists = np.asarray(dists, np.float64)
        if len(ids) and (np.isnan(exact[j]).any() or not np.isfinite(dists).all()):
            dist_err = WRONG  # a row no shard holds, or no distance at all
        elif len(ids):
            dist_err = max(dist_err, float(np.max(np.abs(dists - exact[j])
                                                  / np.maximum(exact[j], 1.0))))
        k = min(len(dists), top_k)
        if k:
            want = best_d[j][:k]
            topk_gap = max(topk_gap, float(np.max(np.abs(dists[:k] - want)
                                                  / np.maximum(want, 1.0))))
        if np.any(np.diff(dists) < 0) or len(np.unique(ids)) != len(ids):
            order_bad += 1
        hit += len(set(ids.tolist()) & set(best_r[j].tolist()))
    return {"kmeans_gap": read["kmeans_gap"], "list_gap": read["list_gap"],
            "codes_off": read["codes_off"] / max(read["entries"], 1),
            "factor_gap": read["factor_gap"], "dist_err": dist_err,
            "topk_gap": min(topk_gap, WRONG), "order_bad": float(order_bad),
            "probe_miss": 1.0 - hit / max(len(answers) * top_k, 1),
            "kmeans_gap_f32": read["kmeans_gap_f32"]}
