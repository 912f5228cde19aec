"""The control of each cell comes out not correct: the numbers it reads,
at the cell's own size on the card, fail at least one of the cell's limits.
BERT's control is the reference with its products in fp8 in the
program's place; the plane's is the reference's build one step below each
stated precision (k-means and lists with bfloat16 products, 3-bit codes)
and its answers in float32, in the program's place.  Run on the card with
``python -m pytest cellbench/tests -m chip``; here they skip."""

import json

import pytest

import harness

SEEDS = [4_000_000_007]


def over_a_limit(row: dict, limits: dict) -> bool:
    return any(row[k] > v for k, v in limits.items() if k in row)


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["bert_mlm_table", "ann_plane_batch"])
def test_the_control_is_not_correct_at_the_cells_size(chip, cell):
    import time
    from types import SimpleNamespace

    import tracing

    from conftest import manifest

    spec = harness.resolve_cell(manifest(), cell)
    ctx = SimpleNamespace(seed=SEEDS[0], seeds=SEEDS, seconds=2.0, trace=False, device="cuda",
                          config=spec["config"], traffic=spec["traffic"], cell=spec["cell"],
                          t0=time.perf_counter(), spans=tracing.Spans(False), faults=set())
    rows = harness.load_module(spec["driver"]).control(ctx)
    limits = {**spec["config"]["limits"], "order_bad": 0.0, "rows_wrong": 0.0}
    controls = [r for r in rows if r["variant"] == "control"]
    assert controls
    for r in controls:
        assert over_a_limit(r, limits), json.dumps(r)
    for r in rows:
        if r["variant"] == "sound":
            assert not over_a_limit(r, limits), json.dumps(r)
        elif r["variant"] != "control" and not r["variant"].startswith("reading."):
            # each planted fault fails a number too
            assert r.get("failed", 0) > 0 or over_a_limit(r, limits), json.dumps(r)
