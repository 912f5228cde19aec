"""The tile-major view that the CUDA ``ragged_score`` walks, on the CPU.

``group_items_by_tile`` turns the item tables of ``plan_items`` into
``order`` (item indices tile by tile), ``tile_ptr`` (each tile's run) and
``walk`` (tiles by item count, largest first).  The kernel runs only on the
card (``chip_smoke.py`` holds it against its plain version there); here the
tables are checked for what the kernel relies on, on the plans the JAX
package's tests use, and a walk of the tables in the kernel's order is held
against the JAX package's ``ragged_score_jnp``.

Tolerance of that walk: rtol 1e-5, atol 1e-4 — float32 sums of up to 128
products taken in another order (torch ``matmul`` vs XLA einsum).
"""

import numpy as np
import pytest
import torch

from lakesoul_tpu.annplane import ragged as J
from lakesoul_tpu_torch.annplane import ragged as R

from test_torch_annplane_ragged import _items, _plan

RTOL, ATOL = 1e-5, 1e-4


def _check_tables(item_tile, n_tiles, order, tile_ptr, walk):
    """Everything the kernel relies on, for host ``item_tile`` [M]."""
    m = len(item_tile)
    order, tile_ptr, walk = order.numpy(), tile_ptr.numpy(), walk.numpy()
    assert order.dtype == np.int64 and tile_ptr.dtype == np.int32 and walk.dtype == np.int64
    assert order.shape == (m,) and tile_ptr.shape == (n_tiles + 1,) and walk.shape == (n_tiles,)
    np.testing.assert_array_equal(np.sort(order), np.arange(m))  # a permutation of the items
    assert tile_ptr[0] == 0 and tile_ptr[-1] == m
    counts = np.diff(tile_ptr)
    assert (counts >= 0).all()  # monotone
    np.testing.assert_array_equal(counts, np.bincount(item_tile, minlength=n_tiles))
    for t in range(n_tiles):
        run = order[tile_ptr[t]:tile_ptr[t + 1]]
        assert (item_tile[run] == t).all()  # every item of the run names its tile
        assert (np.diff(run) > 0).all()  # in ascending item index
    np.testing.assert_array_equal(np.sort(walk), np.arange(n_tiles))  # a permutation of the tiles
    # by item count, largest first, ties by tile index
    np.testing.assert_array_equal(walk, np.lexsort((np.arange(n_tiles), -counts)))


def _walk_scores(p, items, order, tile_ptr, walk):
    """The kernel's walk in plain torch: tile by tile in ``walk`` order,
    each tile's rows once against every query of its run; every item's row
    written once."""
    item_q, _, csq, csum = (torch.from_numpy(np.asarray(x)) for x in items)
    q_glob, codes, a, b, h = (torch.from_numpy(p[k]) for k in ("q_glob", "codes", "a", "b", "h"))
    tile = p["tile"]
    out = torch.full((len(item_q), tile), float("nan"))
    written = torch.zeros(len(item_q), dtype=torch.int64)
    for t in walk.tolist():
        run = order[tile_ptr[t]:tile_ptr[t + 1]]
        if len(run) == 0:
            break  # the walk is in falling item count
        rows = slice(t * tile, (t + 1) * tile)
        g = codes[rows] @ q_glob[item_q[run].long()].T  # [tile, run]
        out[run] = (b[rows, None] + csq[run] - h[rows, None] * csum[run] - a[rows, None] * g).T
        written[run] += 1
    assert (written == 1).all()
    return out.numpy()


@pytest.mark.parametrize("seed, empty, idle", [(0, (), ()), (3, (2, 5), (1,)), (9, (0,), (0, 4))])
def test_grouping_tables_on_plans(seed, empty, idle):
    p = _plan(seed=seed, empty=empty, idle_queries=idle)
    items = _items(p, R)
    n_tiles = len(p["codes"]) // p["tile"]
    tables = R.group_items_by_tile(torch.from_numpy(items[1]), n_tiles)
    _check_tables(items[1], n_tiles, *tables)


@pytest.mark.parametrize("seed, d, nq, empty, idle", [
    (7, 64, 4, (), ()), (2, 100, 5, (0, 4), (2,)), (4, 128, 1, (), ()), (5, 32, 40, (1,), (3, 7)),
])
def test_walk_of_the_tables_matches_jnp(seed, d, nq, empty, idle):
    p = _plan(seed=seed, n_rows=1_024, d=d, nlist=6, nq=nq, empty=empty, idle_queries=idle)
    items = _items(p, R)
    n_tiles = len(p["codes"]) // p["tile"]
    got = _walk_scores(p, items, *R.group_items_by_tile(torch.from_numpy(items[1]), n_tiles))
    want = J.ragged_score_jnp(*items, p["q_glob"], p["codes"], p["a"], p["b"], p["h"],
                              tile=p["tile"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_no_items():
    order, tile_ptr, walk = R.group_items_by_tile(torch.zeros(0, dtype=torch.int32), 5)
    _check_tables(np.zeros(0, np.int32), 5, order, tile_ptr, walk)
    assert (tile_ptr.numpy() == 0).all()


@pytest.mark.parametrize("nq", [1, 32, 129])
def test_one_tile_named_by_every_query(nq):
    """One tile that every query probes, as a dense cluster's tile is: one
    run of all the items, first in the walk, the other tiles empty."""
    item_tile = np.full(nq, 2, np.int32)
    order, tile_ptr, walk = R.group_items_by_tile(torch.from_numpy(item_tile), 4)
    _check_tables(item_tile, 4, order, tile_ptr, walk)
    np.testing.assert_array_equal(tile_ptr.numpy(), [0, 0, 0, nq, nq])
    assert walk[0] == 2


def test_empty_and_unprobed_tiles_walk_last():
    """Tiles of empty clusters and tiles no query probes have no run and
    come after every probed tile, so the kernel's blocks stop at the first."""
    p = _plan(seed=3, empty=(2, 5), idle_queries=(1,))
    items = _items(p, R)
    n_tiles = len(p["codes"]) // p["tile"] + 3  # three more tiles that no item names
    order, tile_ptr, walk = R.group_items_by_tile(torch.from_numpy(items[1]), n_tiles)
    _check_tables(items[1], n_tiles, order, tile_ptr, walk)
    counts = np.diff(tile_ptr.numpy())[walk.numpy()]
    n_probed = len(np.unique(items[1]))
    assert (counts[:n_probed] > 0).all() and (counts[n_probed:] == 0).all()


def test_grouping_takes_int64_tiles_too():
    p = _plan(seed=0)
    items = _items(p, R)
    n_tiles = len(p["codes"]) // p["tile"]
    a = R.group_items_by_tile(torch.from_numpy(items[1]), n_tiles)
    b = R.group_items_by_tile(torch.from_numpy(items[1].astype(np.int64)), n_tiles)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
