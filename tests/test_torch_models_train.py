"""The port's MLP, train steps, optimizers, init, weight converters and
checkpointer against the JAX package, on the CPU.

Tolerances: MLP logits and loss rtol 1e-5 (atol 1e-6), one Adam step's
params rtol 1e-5 (atol 1e-6); optimizer params after three steps on the same
gradients rtol 1e-6, atol 3 · lr · 1e-5: optax takes Adam's bias
correction 1 − β₂ᵗ in float32 (0.999 is not exact there: 1.3e-5 relative at
t = 1), torch in float64, so each update of size ~lr differs by up to
~1e-5 · lr; converters and checkpoints bit for bit;
init: each leaf's std within 5 % of the reference's (leaves of at least
4,096 draws, so the std's own sampling error is ~1 %).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lakesoul_tpu.models import bert as JB
from lakesoul_tpu.models import mlp as JM
from lakesoul_tpu.models import resnet as JR
from lakesoul_tpu.models.train import make_mlp_train_step as ref_mlp_step
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models import (
    MLP,
    Bert,
    BertConfig,
    ResNet,
    ResNetConfig,
    TrainCheckpointer,
    adam,
    adamw,
    convert,
    make_bert_train_state,
    make_bert_train_step,
    make_mlp_train_step,
    make_resnet_train_step,
    mlp_forward,
    mlp_loss,
    sgd,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mlp_inputs(in_dim, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, in_dim)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("layers", [2, 3])
def test_mlp_forward_and_loss(layers):
    params = JM.init_mlp_params(jax.random.key(layers), 4, hidden=64, layers=layers)
    m = MLP(4, hidden=64, layers=layers, device="cpu")
    m.load_state_dict(convert.from_reference_params(params))
    x, y = _mlp_inputs(4)
    got = mlp_forward(m, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JM.mlp_forward(params, x)), rtol=1e-5, atol=1e-6)
    loss = mlp_loss(m, torch.from_numpy(x), torch.from_numpy(y)).detach()
    np.testing.assert_allclose(float(loss), float(JM.mlp_loss(params, x, y)), rtol=1e-5)


@pytest.mark.parametrize("layers", [2, 3])
def test_mlp_adam_step_matches_the_references_step(layers):
    """``make_mlp_train_step`` + ``adam(1e-2)`` against the reference's
    ``make_mlp_train_step(optax.adam(1e-2))``: two steps."""
    params = JM.init_mlp_params(jax.random.key(0), 4, hidden=64, layers=layers)
    m = MLP(4, hidden=64, layers=layers, device="cpu")
    m.load_state_dict(convert.from_reference_params(params))
    tx = optax.adam(1e-2)
    ref_step, _ = ref_mlp_step(tx)
    state = tx.init(params)
    step = make_mlp_train_step(m, adam(m.parameters(), 1e-2), device="cpu")
    for seed in (1, 2):
        x, y = _mlp_inputs(4, seed=seed)
        params, state, want = ref_step(params, state, x, y)
        got = step(x, y)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    mine = convert._flatten(convert.to_reference_params(m))
    for k, v in convert._flatten(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_allclose(mine[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax_over_three_steps(name):
    rng = np.random.default_rng(5)
    shapes = [(17, 9), (9,), (3, 4, 5)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0**-k for k, s in enumerate(shapes)]
             for _ in range(3)]
    lr = 1e-2
    tx = {"adam": optax.adam, "adamw": optax.adamw, "sgd": optax.sgd}[name](lr)
    params, state = [jnp.asarray(p) for p in p0], None
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, updates)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = {"adam": adam, "adamw": adamw, "sgd": sgd}[name](tp, lr)
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for p, want in zip(tp, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=3 * lr * 1e-5)


def test_adamw_default_weight_decay_is_optaxs():
    p = [torch.nn.Parameter(torch.ones(3))]
    assert adamw(p, 1e-3).defaults["weight_decay"] == 1e-4
    assert torch.optim.AdamW(p, 1e-3).defaults["weight_decay"] != 1e-4  # why the helper exists


def _models():
    return {
        "mlp": lambda: MLP(5, hidden=16, layers=3, device="cpu"),
        "resnet": lambda: ResNet(ResNetConfig(num_classes=10, width=8), device="cpu"),
        "bert": lambda: Bert(BertConfig.tiny(), device="cpu"),
    }


@pytest.mark.parametrize("kind", ["mlp", "resnet", "bert"])
def test_converters_round_trip_bit_exactly(kind):
    m = _models()[kind]()
    tree = convert.to_reference_params(m)
    sd = convert.from_reference_params(tree)
    assert set(sd) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    again = convert._flatten(convert.to_reference_params(_load(_models()[kind](), sd)))
    for k, v in convert._flatten(tree).items():
        np.testing.assert_array_equal(again[k], v)


def _load(m, sd):
    m.load_state_dict(sd)
    return m


def test_converted_trees_have_the_references_structure():
    """Same keys, shapes and dtypes as the reference's own init, for each
    model (ResNet at width 8, BERT tiny, MLP 5 → 16 → 16 → 2)."""
    refs = {
        "mlp": JM.init_mlp_params(jax.random.key(0), 5, hidden=16, layers=3),
        "resnet": jax.eval_shape(functools.partial(
            JR.init_resnet_params, JR.ResNetConfig(num_classes=10, width=8)), jax.random.key(0)),
        "bert": jax.eval_shape(functools.partial(JB.init_bert_params, JB.BertConfig.tiny()),
                               jax.random.key(0)),
    }
    for kind, make in _models().items():
        mine = convert._flatten(convert.to_reference_params(make()))
        want = {k: v for k, v in _flat_shapes(refs[kind]).items()}
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == want, kind


def _flat_shapes(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), np.dtype(v.dtype))
    return out


def _std_close(mine: np.ndarray, want_std: float, key: str):
    if want_std == 0.0:
        assert mine.std() == 0.0, key
    else:
        assert abs(mine.std() / want_std - 1) < 0.05, (key, mine.std(), want_std)


def test_bert_init_has_the_references_distributions():
    cfg = BertConfig(vocab_size=4096, hidden=128, layers=2, heads=4, ff=256, max_len=128)
    ref = convert._flatten(jax.tree.map(np.asarray, jax.jit(functools.partial(
        JB.init_bert_params, JB.BertConfig(**cfg.__dict__)))(jax.random.key(0))))
    mine = convert._flatten(convert.to_reference_params(Bert(cfg, device="cpu")))
    for k, v in ref.items():
        _std_close(mine[k], float(v.std()), k)
        np.testing.assert_allclose(mine[k].mean(), v.mean(), atol=0.05 * max(v.std(), 1e-12))


def test_mlp_init_has_the_references_distributions():
    ref = convert._flatten(jax.tree.map(np.asarray, JM.init_mlp_params(
        jax.random.key(0), 128, hidden=256, out_dim=64, layers=3)))
    mine = convert._flatten(convert.to_reference_params(
        MLP(128, hidden=256, out_dim=64, layers=3, device="cpu")))
    for k, v in ref.items():
        _std_close(mine[k], float(v.std()), k)


def test_resnet_init_has_the_references_distributions():
    """At full width (every conv leaf ≥ 4,096 draws): each conv leaf
    against the reference's ``_conv_init`` of its shape, the head against
    the reference's normal × 0.01, BN scale 1 and bias 0 exactly."""
    mine = convert._flatten(convert.to_reference_params(ResNet(ResNetConfig(), device="cpu")))
    draws = {}
    for k, v in mine.items():
        if v.ndim == 4:
            if v.shape not in draws:
                draws[v.shape] = float(np.asarray(JR._conv_init(jax.random.key(1), v.shape)).std())
            _std_close(v, draws[v.shape], k)
        elif k == "head.w":
            _std_close(v, 0.01, k)
        else:
            want = 1.0 if k.endswith("scale") else 0.0
            assert (v == want).all(), k


def test_checkpointer_save_latest_restore_and_prune(tmp_path):
    m = MLP(4, hidden=8, device="cpu")
    opt = adam(m.parameters(), 1e-2)
    step = make_mlp_train_step(m, opt, device="cpu")
    x, y = _mlp_inputs(4)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest()
    for i in range(1, 5):
        step(x, y)
        ckpt.save(i * 10, m.state_dict(), opt.state_dict())
    assert ckpt.latest_step() == 40
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["30", "40"]
    params, opt_state, at = ckpt.restore_latest(like=(m.state_dict(), opt.state_dict()))
    assert at == 40
    for k, v in m.state_dict().items():
        assert torch.equal(params[k], v), k
    ckpt.close()


def test_a_restored_run_continues_bit_for_bit(tmp_path):
    """Train 2 steps, checkpoint, train 2 more; a fresh model and optimizer
    restored from the checkpoint take the same 2 steps to the same bits."""
    x, y = _mlp_inputs(4)
    m = MLP(4, hidden=8, device="cpu")
    opt = adam(m.parameters(), 1e-2)
    step = make_mlp_train_step(m, opt, device="cpu")
    for _ in range(2):
        step(x, y)
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(2, m.state_dict(), opt.state_dict())
    want = [float(step(x, y)) for _ in range(2)]
    m2 = MLP(4, hidden=8, seed=9, device="cpu")
    opt2 = adam(m2.parameters(), 1e-2)
    params, opt_state, _ = ckpt.restore_latest(like=(m2.state_dict(), opt2.state_dict()))
    m2.load_state_dict(params)
    opt2.load_state_dict(opt_state)
    step2 = make_mlp_train_step(m2, opt2, device="cpu")
    assert [float(step2(x, y)) for _ in range(2)] == want
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v), k


def test_restore_rejects_a_template_of_another_shape(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(1, MLP(4, hidden=8, device="cpu").state_dict(), {})
    with pytest.raises(ValueError):
        ckpt.restore_latest(like=(MLP(4, hidden=16, device="cpu").state_dict(), {}))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "mlp", "resnet", "bert", "bert_state", "mlp_step", "resnet_step", "bert_step"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, no_card):
    cpu = {"mlp": lambda: MLP(4, hidden=8, device="cpu"),
           "resnet": lambda: ResNet(ResNetConfig(num_classes=10, width=8), device="cpu"),
           "bert": lambda: Bert(BertConfig.tiny(), device="cpu")}
    calls = {
        "mlp": lambda: MLP(4),
        "resnet": lambda: ResNet(ResNetConfig(num_classes=10, width=8)),
        "bert": lambda: Bert(BertConfig.tiny()),
        "bert_state": lambda: make_bert_train_state(BertConfig.tiny()),
        "mlp_step": lambda: make_mlp_train_step(cpu["mlp"](), None),
        "resnet_step": lambda: make_resnet_train_step(cpu["resnet"](), None),
        "bert_step": lambda: make_bert_train_step(cpu["bert"](), None),
    }
    with pytest.raises(ConfigError, match="CUDA is not available"):
        calls[entry]()


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_titanic_copy_equals_the_examples_table():
    import chip_smoke

    table = _example("titanic_mlp").make_synthetic_titanic()
    mine = chip_smoke.make_synthetic_titanic()
    assert list(mine) == table.column_names
    for c in table.column_names:
        want = table.column(c).to_numpy()
        assert mine[c].dtype == want.dtype and np.array_equal(mine[c], want), c


def test_the_titanic_step_reaches_the_examples_accuracy_on_the_cpu():
    """chip_smoke's mlp phase, as it drives the port, on the CPU."""
    import chip_smoke

    data = chip_smoke.make_synthetic_titanic()
    m = MLP(4, hidden=64, device="cpu")
    step = make_mlp_train_step(m, adam(m.parameters(), chip_smoke.TITANIC_LR), device="cpu")
    for _ in range(chip_smoke.TITANIC_EPOCHS):
        for lo in range(0, chip_smoke.TITANIC_ROWS, chip_smoke.TITANIC_BATCH):
            cols = {c: v[lo:lo + chip_smoke.TITANIC_BATCH] for c, v in data.items()}
            step(chip_smoke.titanic_features(cols), cols["survived"])
    pred = m(torch.from_numpy(chip_smoke.titanic_features(data))).argmax(1).numpy()
    assert (pred == data["survived"]).mean() > chip_smoke.TITANIC_FLOOR


def test_flop_counts_from_the_models_shapes():
    """ResNet-50 at 224²: 4.09 G multiply-adds a forward (the published
    ~4.1 G); BERT-base: the encoder's 85.0 M matmul params."""
    import chip_smoke

    per_image = chip_smoke.resnet_flops(ResNet(ResNetConfig(), device="cpu"), 224)
    assert abs(per_image / 6 / 4.09e9 - 1) < 0.01
    cfg = BertConfig.base()
    per_token = chip_smoke.bert_flops(cfg, 1, 128)
    encoder = 12 * (4 * 768 * 768 + 2 * 768 * 3072)
    assert encoder == 84_934_656
    assert per_token == 6 * encoder + 12 * 128 * 768 * 12 + 6 * 30522 * 768
