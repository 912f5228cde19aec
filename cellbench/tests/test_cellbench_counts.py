"""The frozen counts against hand-worked values."""

import json

import numpy as np
import pytest

from conftest import BENCH
from counts.bert_flops import bert_step_flops
from counts.ragged_bound import bound_seconds, shard_bound

PEAKS = json.loads((BENCH / "counts" / "peaks.json").read_text())


def test_bert_base_step_with_4915_labelled_positions():
    # 256 x 128 tokens; encoder 6·12·(4·768² + 2·768·3072)·32768 = 16.70e12,
    # attention 12·128·768·12·32768 = 0.4639e12, head 6·30522·768·4915 = 0.6913e12
    f = bert_step_flops(hidden=768, ff=3072, layers=12, vocab=30522, seq=128,
                        tokens=256 * 128, labelled=4915)
    assert f["encoder"] / 1e12 == pytest.approx(16.70, abs=0.005)
    assert f["attention"] / 1e12 == pytest.approx(0.4639, abs=0.0005)
    assert f["head"] / 1e12 == pytest.approx(0.6913, abs=0.0005)
    assert f["total"] == f["encoder"] + f["attention"] + f["head"]


def test_the_head_is_counted_at_the_labelled_positions_only():
    a = bert_step_flops(hidden=8, ff=16, layers=1, vocab=100, seq=4, tokens=16, labelled=3)
    b = bert_step_flops(hidden=8, ff=16, layers=1, vocab=100, seq=4, tokens=16, labelled=6)
    assert b["head"] == 2 * a["head"] and b["encoder"] == a["encoder"]


def test_ragged_bound_by_hand():
    # a shard of 3 lists of 10, 20 and 30 rows, d 128 at 4 bits; pairs
    # (q0, c0), (q0, c2), (q1, c2): lists 0 and 2 read once, 40 rows of
    # (64 + 8) bytes; 2 query rows of 512; 3 pairs of 12; 70 scores of 4
    n_bytes, flops = shard_bound(np.array([0, 2, 2]), np.array([10, 20, 30]), 2, dim=128, bits=4)
    assert n_bytes == 40 * 72 + 2 * 512 + 3 * 12 + 70 * 4
    assert flops == 70 * 2 * 128
    assert bound_seconds(n_bytes, flops, PEAKS) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12))


def test_ragged_bound_counts_codes_at_the_configured_bits():
    four = shard_bound(np.array([0]), np.array([1000]), 1, dim=128, bits=4)[0]
    one = shard_bound(np.array([0]), np.array([1000]), 1, dim=128, bits=1)[0]
    assert four - one == 1000 * 128 * 3 / 8
