"""The port's cross-device top-k merge (``annplane/collective.py``) and
entry points (``entry.py``) against the JAX package's, on the CPU.

``cross_chip_topk`` runs on 4 gloo ranks (one spawn for the module), each
holding one shard's candidates, against the reference's merge over 4 of
``tests/conftest.py``'s CPU devices: distances, local rows and source
shards exactly, ties included (distances drawn from 8 values, so most
candidates tie: the lower flat index first, as ``lax.top_k`` of the negated
distances orders them).  Then both packages' ``dryrun_multichip(4)`` and
``entry()``'s shapes.
"""

import pathlib

import numpy as np
import pytest
import torch

from lakesoul_tpu.annplane import collective as JC
from lakesoul_tpu_torch.annplane import collective as TC
from lakesoul_tpu_torch.parallel.launch import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)
N, K_LOCAL = 4, 12
KS = (1, 5, 12, 30, N * K_LOCAL)


def _candidates(seed: int, levels: int | None):
    rng = np.random.default_rng(seed)
    if levels:
        dists = (rng.integers(0, levels, (N, K_LOCAL)) / levels).astype(np.float32)
    else:
        dists = rng.random((N, K_LOCAL)).astype(np.float32)
    rows = rng.integers(0, 1 << 20, (N, K_LOCAL)).astype(np.int32)
    return dists, rows


CASES = {f"{'ties' if levels else 'distinct'}_k{k}": (seed, levels, k)
         for seed, levels in ((0, 8), (1, None)) for k in KS}


@pytest.fixture(scope="module")
def port():
    calls = [("topk", (*_candidates(seed, levels), k)) for seed, levels, k in CASES.values()]
    ranks = run_ranks("torch_parallel_jobs:many", N, (calls,), sys_path=(TESTS,))
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_cross_chip_topk_matches_the_references_merge(name, port):
    seed, levels, k = CASES[name]
    dists, rows = _candidates(seed, levels)
    want = JC.cross_chip_topk(dists, rows, k=k)
    for d, r, src in port[name]:  # the same answer on every rank
        np.testing.assert_array_equal(d, want[0])
        np.testing.assert_array_equal(r, want[1])
        np.testing.assert_array_equal(src, want[2])


def test_ties_resolve_by_the_lower_flat_index(port):
    dists, rows = _candidates(0, 8)
    d, r, src = port["ties_k30"][0]
    order = np.argsort(dists.reshape(-1), kind="stable")[:30]
    assert len(np.unique(d)) < 30  # ties inside the answer
    np.testing.assert_array_equal(r, rows.reshape(-1)[order])
    np.testing.assert_array_equal(src, order // K_LOCAL)


def test_without_a_group_the_merge_is_the_local_sort():
    dists, rows = _candidates(2, 8)
    d, r, src = TC.cross_chip_topk(dists[0], rows[0], k=5, group=None)
    order = np.argsort(dists[0], kind="stable")[:5]
    np.testing.assert_array_equal(d.numpy(), dists[0][order])
    np.testing.assert_array_equal(r.numpy(), rows[0][order])
    assert src.dtype == torch.int32 and (src.numpy() == 0).all()


def test_mismatched_shapes_raise():
    from lakesoul_tpu_torch.errors import VectorIndexError

    with pytest.raises(VectorIndexError, match="shape mismatch"):
        TC.cross_chip_topk(np.zeros(4, np.float32), np.zeros(3, np.int32), group=None)


def test_collective_dryrun_multichip_4():
    want = JC.dryrun_multichip(4)
    got = TC.dryrun_multichip(4)
    assert got == want


def test_entry_dryrun_multichip_4():
    """Every parallel axis over 4 gloo ranks: dp2·tp2 fed from a primary-key
    table with an upsert wave through ``to_torch_iter``, dp2·pp2, dp2·ep2;
    every rank's losses finite and equal."""
    from lakesoul_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4)
    assert out["table"]["mesh"] == (2, 2, 1)
    assert (out["pipeline"]["dp"], out["pipeline"]["pp"]) == (2, 2)
    assert (out["moe"]["dp"], out["moe"]["ep"]) == (2, 2)
    assert all(np.isfinite(v["loss"]) for v in out.values())


def test_entry_is_bert_base_forward():
    from lakesoul_tpu_torch.entry import entry

    fn, (model, ids, mask) = entry(device="cpu")
    assert model.cfg.hidden == 768 and len(model.layers) == 12 and ids.shape == (8, 128)
    meta = model.to("meta")
    out = fn(meta, ids.to("meta"), mask.to("meta"))
    assert out.shape == (8, 128, 30522) and out.dtype == torch.float32
