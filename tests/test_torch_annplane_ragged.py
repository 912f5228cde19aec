"""The port's ragged item scoring against the JAX package's, on the CPU.

``ragged_arange``, ``plan_items`` and ``fold_cluster`` against the JAX
functions; ``ragged_score`` (its plain version on a CPU tensor) against JAX
``ragged_score_jnp`` and ``ragged_score_pallas(interpret=True)``; the
port's device ``items_topk`` against the JAX per-query loop, zero-pair
queries and empty clusters included.  The CUDA kernel itself runs only on
the card (``chip_smoke.py`` holds it against the same plain version there).

Tolerance: rtol 1e-5, atol 1e-4 — float32 sums of up to 128 products taken
in another order (torch ``bmm`` vs XLA einsum vs the Pallas interpreter);
``fold_cluster`` is the same float32 arithmetic, held at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from lakesoul_tpu.annplane import ragged as J
from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.annplane import ragged as R

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Fails the test if anything tries to build or load a CUDA kernel."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _plan(seed=0, n_rows=4_096, d=64, nlist=12, nq=6, tile=128, empty=(), idle_queries=()):
    """A shard in the resident layout with ragged probe sets, as
    ``TestRaggedKernels._plan`` of the JAX tests builds it; ``empty``
    clusters hold no rows, ``idle_queries`` probe nothing."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(n_rows, np.ones(nlist) / nlist)
    counts[list(empty)] = 0
    padded = (counts + tile - 1) // tile * tile
    n_pad = int(padded.sum())
    tile_start = np.concatenate([[0], np.cumsum(padded[:-1] // tile)]).astype(np.int32)
    tile_count = (padded // tile).astype(np.int32)
    row_start = tile_start.astype(np.int64) * tile
    codes = np.zeros((n_pad, d), np.float32)
    a = np.zeros(n_pad, np.float32)
    b = np.full(n_pad, J.PAD_B, np.float32)
    h = np.zeros(n_pad, np.float32)
    for c in range(nlist):
        rs, n_c = int(row_start[c]), int(counts[c])
        codes[rs : rs + n_c] = rng.normal(size=(n_c, d)).astype(np.float32)
        a[rs : rs + n_c] = rng.random(n_c).astype(np.float32) + 0.5
        b[rs : rs + n_c] = rng.random(n_c).astype(np.float32) * 10
        h[rs : rs + n_c] = rng.random(n_c).astype(np.float32)
    pairs_q, pairs_c = [], []
    for q in range(nq):
        if q in idle_queries:
            continue
        probed = rng.choice(nlist, rng.integers(1, nlist), replace=False)
        pairs_q.extend([q] * len(probed))
        pairs_c.extend(sorted(probed))
    pairs_q = np.asarray(pairs_q, np.int64)
    pairs_c = np.asarray(pairs_c, np.int64)
    return dict(
        codes=codes, a=a, b=b, h=h, tile_start=tile_start, tile_count=tile_count,
        pairs_q=pairs_q, pairs_c=pairs_c,
        csq=rng.random(len(pairs_q)).astype(np.float32) * 5,
        csum=rng.random(len(pairs_q)).astype(np.float32),
        q_glob=rng.normal(size=(nq, d)).astype(np.float32), nq=nq, tile=tile,
    )


def _items(p, mod):
    return mod.plan_items(p["pairs_q"], p["pairs_c"], p["csq"], p["csum"],
                          p["tile_start"], p["tile_count"])


def _port_score(p, items):
    t = {k: torch.from_numpy(p[k]) for k in ("q_glob", "codes", "a", "b", "h")}
    return R.ragged_score(*items, t["q_glob"], t["codes"], t["a"], t["b"], t["h"],
                          tile=p["tile"])


@pytest.mark.parametrize("starts, counts", [
    ([5, 0, 9], [3, 0, 2]), ([], []), ([0, 0], [0, 0]), ([7], [1]), ([100, 3, 50], [4, 4, 0]),
])
def test_ragged_arange_matches_jax(starts, counts):
    np.testing.assert_array_equal(R.ragged_arange(np.array(starts, np.int64), np.array(counts)),
                                  J.ragged_arange(np.array(starts, np.int64), np.array(counts)))


@pytest.mark.parametrize("seed, empty, idle", [(0, (), ()), (3, (2, 5), (1,)), (9, (0,), (0, 4))])
def test_plan_items_matches_jax(seed, empty, idle):
    p = _plan(seed=seed, empty=empty, idle_queries=idle)
    for got, want in zip(_items(p, R), _items(p, J)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [32, 64, 100, 128])
def test_fold_cluster_matches_jax(d):
    rng = np.random.default_rng(d)
    norms = rng.random(500).astype(np.float32) * 4
    factors = rng.random(500).astype(np.float32) * 0.5 + 0.5
    cdc = rng.normal(size=500).astype(np.float32) * 10
    got = R.fold_cluster(torch.from_numpy(norms), torch.from_numpy(factors),
                         torch.from_numpy(cdc), d=d)
    for g, w in zip(got, J.fold_cluster(norms, factors, cdc, d=d, ex=False)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed, d, nq, empty, idle", [
    (7, 64, 4, (), ()), (1, 32, 6, (3,), ()), (2, 100, 5, (0, 4), (2,)), (4, 128, 1, (), ()),
])
def test_ragged_score_matches_jnp_and_pallas(seed, d, nq, empty, idle, no_cuda_build):
    p = _plan(seed=seed, n_rows=1_024, d=d, nlist=6, nq=nq, empty=empty, idle_queries=idle)
    items = _items(p, R)
    before = R.ragged_score.launches
    got = _port_score(p, items).numpy()
    assert R.ragged_score.launches == before  # the plain path launches nothing
    args = (*items, p["q_glob"], p["codes"], p["a"], p["b"], p["h"])
    twin = J.ragged_score_jnp(*args, tile=p["tile"])
    pallas = J.ragged_score_pallas(*args, tile=p["tile"], interpret=True)
    assert got.shape == (len(items[0]), p["tile"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, twin, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    # pad rows score out: every row past a cluster's count is a hole
    assert (got[p["b"][items[1][:, None] * p["tile"] + np.arange(p["tile"])] == J.PAD_B]
            >= J.PAD_EST_VALID).all()


@pytest.mark.parametrize("seed, s, empty, idle", [
    (0, 16, (), ()), (5, 200, (1, 7), (3,)), (11, 5000, (), (0, 5)), (13, 1, (4,), ()),
])
def test_items_topk_matches_jax(seed, s, empty, idle, no_cuda_build):
    p = _plan(seed=seed, empty=empty, idle_queries=idle)
    items = _items(p, R)
    est = _port_score(p, items)
    rows, dist = R.items_topk(est, items[0], items[1], p["nq"], s, tile=p["tile"])
    rows_j, dist_j = J.items_topk(est.numpy(), items[0], items[1], p["nq"], s, tile=p["tile"])
    assert rows.shape == (p["nq"], s) and dist.shape == (p["nq"], s)
    rows, dist = rows.numpy(), dist.numpy()
    for q in range(p["nq"]):
        # same candidate SET and distances; holes are -1 / +inf together
        np.testing.assert_array_equal(np.sort(dist[q]), np.sort(dist_j[q]))
        assert set(rows[q][rows[q] >= 0]) == set(rows_j[q][rows_j[q] >= 0])
        assert ((rows[q] < 0) == np.isinf(dist[q])).all()
    for q in idle:
        assert (rows[q] == -1).all()


def test_items_topk_with_no_items():
    rows, dist = R.items_topk(torch.zeros((0, 128)), np.zeros(0, np.int32),
                              np.zeros(0, np.int32), 3, 4)
    assert (rows.numpy() == -1).all() and np.isinf(dist.numpy()).all()


def test_empty_plan_scores_nothing(no_cuda_build):
    p = _plan(seed=2, nq=2, idle_queries=(0, 1))
    items = _items(p, R)
    assert len(items[0]) == 0
    assert _port_score(p, items).shape == (0, p["tile"])


@pytest.mark.parametrize("case", ["tile_high", "tile_neg", "query_high", "lengths", "rows",
                                  "width", "dtype", "contiguity", "device"])
def test_ragged_score_rejects_bad_inputs(case, no_cuda_build):
    p = _plan(seed=1, n_rows=512, nlist=4, nq=3)
    item_q, item_tile, csq, csum = _items(p, R)
    t = {k: torch.from_numpy(p[k]) for k in ("q_glob", "codes", "a", "b", "h")}
    n_tiles = len(p["codes"]) // p["tile"]
    if case == "tile_high":
        item_tile = item_tile.copy()
        item_tile[-1] = n_tiles
    elif case == "tile_neg":
        item_tile = item_tile.copy()
        item_tile[0] = -1
    elif case == "query_high":
        item_q = item_q.copy()
        item_q[0] = p["nq"]
    elif case == "lengths":
        csq = csq[:-1]
    elif case == "rows":
        t["codes"] = t["codes"][:-1]
    elif case == "width":
        t["q_glob"] = t["q_glob"][:, :-1]
    elif case == "dtype":
        t["a"] = t["a"].double()
    elif case == "contiguity":
        t["codes"] = torch.from_numpy(np.asfortranarray(p["codes"]))
    elif case == "device":  # neither cpu nor cuda: no fallback
        t = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError):
        R.ragged_score(item_q, item_tile, csq, csum, t["q_glob"], t["codes"], t["a"], t["b"],
                       t["h"], tile=p["tile"])
