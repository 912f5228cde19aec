"""The port's sharded ``TrainCheckpointer`` on gloo CPU ranks
(``parallel/launch.py`` ``run_ranks``), and its step sequence against the
reference's (Orbax) one.

Each rank trains a tiny BERT (or its MoE) under a plan for two AdamW steps,
saves through ``torch.distributed.checkpoint``, restores into a fresh state
drawn from another seed with other hyperparameters, and both states take
one more step.  Held bit-equal: the gathered parameters, both AdamW moments
and the step counts of the saved and the restored state; the losses of the
unbroken and the restored run's next step and the parameters after it
(gloo on the CPU sums in a fixed order), which a wrongly restored
hyperparameter would move.  A copy of a plan model's state dict, which has
lost the model's sharding rules, is refused.  A
dp2·tp2·sp2 save restores onto dp2·tp2 on 4 ranks and onto the whole model
in this process (``plan=None``), as does a dp2·pp2 pipeline save.
"""

import pathlib

import numpy as np
import pytest

from lakesoul_tpu_torch.models import MLP, TrainCheckpointer, adam, adamw
from lakesoul_tpu_torch.models.bert import Bert, BertConfig
from lakesoul_tpu_torch.parallel.launch import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)
LR = 1e-2
DENSE = dict(vocab_size=128, hidden=64, layers=2, heads=4, ff=128, max_len=32, dtype="float32")
MOE = dict(vocab_size=128, hidden=32, layers=2, heads=4, ff=64, max_len=16, dtype="float32",
           n_experts=4, capacity_factor=0.5)
PIPE = dict(vocab_size=128, hidden=32, layers=4, heads=4, ff=64, max_len=16, dtype="float32")


def _batch(B, T, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, B)[:, None]
    labels = np.where(mask & (rng.random((B, T)) < 0.25), rng.integers(0, 128, (B, T)), -100)
    labels[:, 0] = 5  # every row labelled
    return ids, labels.astype(np.int32), mask


# name → (world, mesh, config, mode, batch)
SAVES = {
    "dp2_tp2_sp2": (8, dict(dp=2, tp=2, sp=2), DENSE, "ring", _batch(4, 32, 0)),
    "moe_dp2_ep2": (4, dict(dp=2, tp=1, sp=1, ep=2), MOE, "ring", _batch(8, 16, 1)),
    "pipeline_dp2_pp2": (4, dict(dp=2, tp=1, sp=1, pp=2), PIPE, "pipeline", _batch(8, 16, 2)),
}
STEPS = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    out = {"roots": {n: str(root / n) for n in SAVES}}
    for world in (8, 4):
        calls = [("checkpoint_save", (out["roots"][n], mesh, cfg, mode, batch, LR, STEPS))
                 for n, (w, mesh, cfg, mode, batch) in SAVES.items() if w == world]
        if world == 4:  # the 8-rank save onto another plan
            calls.append(("checkpoint_restore", (out["roots"]["dp2_tp2_sp2"],
                                                 dict(dp=2, tp=2, sp=1), DENSE, "ring", LR)))
        res = run_ranks("torch_parallel_jobs:many", world, (calls,), sys_path=(TESTS,))
        for i, n in enumerate(n for n, c in SAVES.items() if c[0] == world):
            out[n] = res[0][i]
            out[f"{n}_ranks"] = [r[i] for r in res]
        if world == 4:
            out["replanned"] = res[0][-1]
    return out


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for part in ("params", "exp_avg", "exp_avg_sq"):
        assert sorted(got[part]) == sorted(want[part]), part
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")
    assert got["step"] == want["step"]


@pytest.mark.parametrize("name", list(SAVES))
def test_restored_state_is_bit_equal(name, runs):
    rec = runs[name]
    assert rec["step"] == STEPS
    assert rec["saved"]["step"] == [float(STEPS)]
    _equal(rec["restored"], rec["saved"])
    # the fresh state really was another one before the restore
    fresh = Bert(BertConfig(**SAVES[name][2]), seed=7, device="cpu").state_dict()
    assert any(not np.array_equal(fresh[k].numpy(), v) for k, v in rec["saved"]["params"].items())


@pytest.mark.parametrize("name", list(SAVES))
def test_the_next_step_after_a_restore_is_the_unbroken_runs(name, runs):
    for rec in runs[f"{name}_ranks"]:
        assert np.isfinite(rec["loss_unbroken"])
        assert rec["loss_restored"] == rec["loss_unbroken"]
    after, unbroken = runs[name]["after_restored"], runs[name]["after_unbroken"]
    assert sorted(after) == sorted(unbroken)
    for k, v in unbroken.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    # the step moved them: the check could see a wrong learning rate
    assert any(not np.array_equal(v, runs[name]["saved"]["params"][k])
               for k, v in unbroken.items())


@pytest.mark.parametrize("name", list(SAVES))
def test_a_state_dict_without_its_rules_is_refused(name, runs):
    """``dict(model.state_dict())`` drops the rules the model was cut by:
    a pipeline stage's ``layers.0`` could not be told from another's, so
    the save raises on every rank before it writes anything."""
    for rec in runs[f"{name}_ranks"]:
        assert "carries its sharding rules" in rec["refused"]


def test_a_save_restores_onto_another_plan(runs):
    """dp2·tp2·sp2 on 8 ranks → dp2·tp2 on 4: every rank reads its own
    slices (tp halves of other widths than it saved) from the saved ones."""
    assert runs["replanned"]["step"] == STEPS
    _equal(runs["replanned"]["restored"], runs["dp2_tp2_sp2"]["saved"])


@pytest.mark.parametrize("name", ["dp2_tp2_sp2", "pipeline_dp2_pp2"])
def test_a_sharded_save_restores_onto_the_whole_model(name, runs):
    """``plan=None`` in one process: the whole tensors, a pipeline stage's
    layers under their global index."""
    cfg = BertConfig(**SAVES[name][2])
    model = Bert(cfg, seed=7, device="cpu")
    opt = adamw(model.parameters(), LR * 3, weight_decay=0.5)
    params, opt_state, at = TrainCheckpointer(runs["roots"][name]).restore_latest(
        like=(model.state_dict(), opt.state_dict()))
    model.load_state_dict(params)
    opt.load_state_dict(opt_state)
    assert at == STEPS
    saved = runs[name]["saved"]
    named = dict(model.named_parameters())
    got = {"params": {k: v.detach().numpy() for k, v in named.items()},
           **{m: {k: opt.state[p][m].numpy() for k, p in named.items()}
              for m in ("exp_avg", "exp_avg_sq")},
           "step": sorted({float(opt.state[p]["step"]) for p in named.values()})}
    _equal(got, saved)
    want = adamw(Bert(cfg, device="cpu").parameters(), LR).param_groups[0]
    assert {k: v for k, v in opt.param_groups[0].items() if k != "params"} == \
        {k: v for k, v in want.items() if k != "params"}


def test_a_sharded_step_is_published_whole(runs):
    """Only the step directory, no staging left behind; every parameter of
    the whole model saved once, under its global name and shape, with both
    moments and its step count."""
    import json

    import torch.distributed.checkpoint as dcp

    for name in ("moe_dp2_ep2", "pipeline_dp2_pp2"):
        root = pathlib.Path(runs["roots"][name])
        assert sorted(p.name for p in root.iterdir()) == [str(STEPS)]
        doc = json.loads((root / str(STEPS) / "sharded.json").read_text())
        assert doc["mesh"] == {"dp": 2, "tp": 1, "sp": 1, "pp": 1, "ep": 1, **SAVES[name][1]}
        saved = dcp.FileSystemReader(str(root / str(STEPS))).read_metadata().state_dict_metadata
        want = Bert(BertConfig(**SAVES[name][2]), device="cpu").state_dict()
        assert sorted(saved) == sorted(f"{part}{k}{leaf}" for k in want for part, leaf in (
            ("model.", ""), ("optim.", ".exp_avg"), ("optim.", ".exp_avg_sq"),
            ("optim.", ".step")))
        for k, v in want.items():
            assert tuple(saved[f"model.{k}"].size) == tuple(v.shape), k
            assert tuple(saved[f"optim.{k}.exp_avg"].size) == tuple(v.shape), k


def test_a_whole_model_step_refuses_a_plan(tmp_path):
    m = MLP(4, hidden=8, device="cpu")
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(1, m.state_dict(), adam(m.parameters(), LR).state_dict())
    with pytest.raises(ValueError, match="whole model"):
        ckpt.restore_latest(like=(m.state_dict(), {}), plan=object())


def test_a_sharded_step_needs_a_template(runs):
    with pytest.raises(ValueError, match="like="):
        TrainCheckpointer(runs["roots"]["moe_dp2_ep2"]).restore_latest()


def _sequence(ckpt, bump, params, opt_state) -> dict:
    """The reference's ``TestTrainCheckpoint`` sequence
    (``tests/test_models_parallel.py:349-381``), one step further: three
    saves at max_to_keep 2, the middle and last with bumped params."""
    ckpt.save(1, params, opt_state)
    ckpt.save(2, bump(params), opt_state)
    ckpt.save(3, bump(bump(params)), opt_state)
    return {"latest": ckpt.latest_step()}


def test_step_sequence_matches_the_reference(tmp_path):
    import jax
    import optax

    from lakesoul_tpu.models.checkpoint import TrainCheckpointer as RefCheckpointer
    from lakesoul_tpu.models.mlp import init_mlp_params
    from lakesoul_tpu_torch.models import convert

    jparams = init_mlp_params(jax.random.key(0), 4)
    tx = optax.adam(1e-3)
    ref = RefCheckpointer(str(tmp_path / "ref"), max_to_keep=2)
    try:
        want = _sequence(ref, lambda p: jax.tree.map(lambda x: x + 1.0, p),
                         jparams, tx.init(jparams))
        want["kept"] = sorted(ref._mngr.all_steps())
        jp, _, want["restored"] = ref.restore_latest(like=(jparams, tx.init(jparams)))
    finally:
        ref.close()

    m = MLP(4, device="cpu")
    m.load_state_dict(convert.from_reference_params(jparams))
    opt = adam(m.parameters(), 1e-3)
    port = TrainCheckpointer(str(tmp_path / "port"), max_to_keep=2)
    got = _sequence(port, lambda p: {k: v + 1.0 for k, v in p.items()},
                    m.state_dict(), opt.state_dict())
    got["kept"] = sorted(int(p.name) for p in (tmp_path / "port").iterdir())
    params, _, got["restored"] = port.restore_latest(like=(m.state_dict(), opt.state_dict()))
    assert got == want == {"latest": 3, "kept": [2, 3], "restored": 3}
    flat = convert._flatten(jax.tree.map(np.asarray, jp))
    m.load_state_dict(params)
    for k, v in convert._flatten(convert.to_reference_params(m)).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)

