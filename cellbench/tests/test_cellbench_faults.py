"""A run with its timed path broken underneath comes out not correct: the
drivers run on the CPU at a small size, past the harness's look for a card,
and ``run.report`` finishes the run as on the card.  One sound run of each
driver comes out correct under the same limits.  The faults are each that
its cell can have: a step that returns its state unchanged, half of the
batch left out, a token or an answer altered where it is produced."""

import json

import pytest

import harness
from conftest import BENCH, manifest, tiny_ctx

RUN = harness.load_module(BENCH / "run.py", "cellbench_run")
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}


def finish(cell, **kw):
    spec = harness.resolve_cell(manifest(), cell)
    ctx = tiny_ctx(cell, **kw)
    run = harness.load_module(spec["driver"]).run(ctx)
    correct, line, _ = RUN.report(spec, run, ctx.trace, DEVICE)
    out = json.loads(line)
    assert out["correct"] == correct and list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("cell,faults", [
    ("bert_mlm_table", ()),
    ("bert_mlm_table", ("unchanged",)),
    ("bert_mlm_table", ("half_batch",)),
    ("bert_mlm_table", ("token",)),
    ("ann_plane_batch", ()),
    ("ann_plane_batch", ("answer",)),
    ("ann_plane_batch", ("half_batch",)),
])
def test_a_broken_timed_path_is_not_correct(cell, faults):
    out = finish(cell, seconds=0.5, faults=faults)
    assert out["correct"] is (not faults), out["checks"]
    assert out["attempted"] > 0


def test_a_traced_run_reports_its_per_layer_metrics_and_breakdown():
    out = finish("bert_mlm_table", seconds=0.5, trace=True)
    assert {"step_mfu.bert", "loader_wait_share.bert"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("fault,number", [
    (None, None),
    ("factor", "factor_gap"),
    ("code", "codes_off"),
    ("list", "list_gap"),
])
def test_the_build_check_reads_a_wrong_factor_code_or_list(fault, number):
    """The plane's build state judged row by row: a row's constant ``a``
    off by 1e-3, one code a level off, or a row quantised into a list not
    its nearest each reads above the limit the sound rows stay under."""
    import numpy as np
    import torch

    from reference import ann_ref

    g = torch.Generator().manual_seed(11)
    x = torch.randn(400, 32, generator=g) * 3
    cents = x[:16].clone() + 0.1
    rot = ann_ref.rotation(32, 42, "cpu")
    lists = ann_ref.nearest(x, cents)
    if fault == "list":
        lists[3] = (lists[3] + 1) % 16
    q = ann_ref.quantize(x, cents[lists], rot, 4)
    rows = {"ids": np.arange(400), "list": lists.numpy(),
            "u_hat": (q["codes"] * q["scale"][:, None]).float().numpy(),
            "a": q["a"].float().numpy(), "b": q["b"].float().numpy()}
    if fault == "factor":
        rows["a"][7] *= 1 + 1e-3
    elif fault == "code":
        c = rows["u_hat"][5]
        j = int(np.argmin(np.abs(c)))  # a small coordinate: never the largest
        c[j] += float(q["scale"][5]) * (1 if c[j] <= 0 else -1)
    read = ann_ref.sampled_rows(x, 0, rows, cents.float(), rot, 4)
    limits = json.loads((BENCH / "configs" / "ann_plane_10m_128d_4bit.json").read_text())["limits"]
    over = {k for k in ("list_gap", "codes_off", "factor_gap")
            if read[k] / (read["entries"] if k == "codes_off" else 1) > limits[k]}
    assert over == ({number} if number else set()), read
