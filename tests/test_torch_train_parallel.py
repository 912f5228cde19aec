"""The port's sharded train steps against the JAX package's, on the CPU.

Each case runs the same numpy-seeded batch from the same weights (the
port's init carried to the reference's tree) through the reference's GSPMD
step on its mesh of the shape (``tests/conftest.py``'s 8 CPU devices) and
through the port's step on gloo ranks of that shape (``parallel/launch.py``;
one spawn per world size for the module: 8, 4 and 2 ranks).  Held: the
first step's loss, every gathered gradient of it, and the gathered
parameters after three SGD steps (updates, not only losses).

- BERT dp2·tp2·sp2 with ring attention and with Ulysses (rows of lengths 32,
  20, 9 and 32, so one sequence shard of a row is all padding; ranks hold
  different label counts: the MLM loss is a global mean);
- MoE BERT (4 experts, capacity factor 0.5, so capacity binds) dp2·ep2 and
  dp2·sp2·ep2 (global token order over dp and sp, the aux's global means);
- BERT pipelined dp2·pp2, four microbatches, against the reference's
  pipelined step and its scan-encoder gradient;
- ResNet dp 4 (the batch norm over the global batch) and the MLP dp 2.

Tolerances: loss rtol 1e-5; gradients and parameters rtol 1e-4, atol 1e-6
(float32 sums over ranks and blocks in other orders).  ResNet: see the
note above its tests.
"""

import functools
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lakesoul_tpu.models import bert as JB
from lakesoul_tpu.models import mlp as JMLP
from lakesoul_tpu.models import resnet as JR
from lakesoul_tpu.models import train as JT
from lakesoul_tpu.parallel.mesh import make_mesh as ref_mesh
from lakesoul_tpu.parallel.ring_attention import make_ring_attention as ref_ring
from lakesoul_tpu.parallel.ulysses import make_ulysses_attention as ref_ulysses
from lakesoul_tpu_torch.models import convert
from lakesoul_tpu_torch.models.bert import Bert, BertConfig
from lakesoul_tpu_torch.models.mlp import MLP
from lakesoul_tpu_torch.models.resnet import ResNet, ResNetConfig
from lakesoul_tpu_torch.parallel.launch import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)
STEPS, BERT_LR = 3, 0.1
DENSE = dict(vocab_size=128, hidden=64, layers=2, heads=4, ff=128, max_len=32, dtype="float32")
MOE = dict(vocab_size=128, hidden=32, layers=2, heads=4, ff=64, max_len=16, dtype="float32",
           n_experts=4, capacity_factor=0.5)
PIPE = dict(vocab_size=128, hidden=32, layers=4, heads=4, ff=64, max_len=16, dtype="float32")


def _batch(B, T, lengths, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    labels = np.where(mask & (rng.random((B, T)) < 0.25), rng.integers(0, 128, (B, T)), -100)
    return ids, labels.astype(np.int32), mask


# name → (world, mesh, config, mode, batch)
CASES = {
    "dp2_tp2_sp2_ring": (8, dict(dp=2, tp=2, sp=2), DENSE, "ring",
                         _batch(4, 32, (32, 20, 9, 32), 0)),
    "dp2_tp2_sp2_ulysses": (8, dict(dp=2, tp=2, sp=2), DENSE, "ulysses",
                            _batch(4, 32, (32, 20, 9, 32), 0)),
    "moe_dp2_sp2_ep2": (8, dict(dp=2, tp=1, sp=2, ep=2), MOE, "ring",
                        _batch(4, 16, (16, 12, 16, 5), 1)),
    "moe_dp2_ep2": (4, dict(dp=2, tp=1, sp=1, ep=2), MOE, "ring",
                    _batch(8, 16, (16,) * 6 + (7, 16), 2)),
    "pipeline_dp2_pp2": (4, dict(dp=2, tp=1, sp=1, pp=2), PIPE, "pipeline",
                         _batch(8, 16, (16, 16, 11, 16, 3, 16, 16, 16), 3)),
}
RESNET = dict(num_classes=10, width=8, dtype="float32")
RESNET64 = {**RESNET, "dtype": "float64"}
RESNET_DP, RESNET_LR = 4, 0.05
MLP_DP, MLP_IN, MLP_HIDDEN, MLP_LR = 2, 4, 64, 0.05


def _resnet_batch():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def _mlp_batch():
    rng = np.random.default_rng(5)
    return rng.normal(size=(32, MLP_IN)).astype(np.float32), rng.integers(0, 2, 32).astype(np.int32)


def _port_case(name):
    world, mesh, cfg, mode, batch = CASES[name]
    return (name, mesh, cfg, mode, batch, BERT_LR, STEPS)


@pytest.fixture(scope="module")
def port():
    out = {}
    for world in (8, 4):
        calls = [("bert", ([_port_case(n) for n, c in CASES.items() if c[0] == world],))]
        if world == RESNET_DP:
            calls += [("resnet", (RESNET_DP, cfg, *_resnet_batch(), RESNET_LR, STEPS))
                      for cfg in (RESNET64, RESNET)]
        res = run_ranks("torch_parallel_jobs:many", world, (calls,), sys_path=(TESTS,))
        out.update(res[0][0])
        if world == RESNET_DP:
            out["resnet64"], out["resnet32"] = res[0][1:]
            out["resnet_ranks"] = [r[1] for r in res]
    (mlp,), *rest = run_ranks("torch_parallel_jobs:many", MLP_DP,
                              ([("mlp", (MLP_DP, MLP_IN, MLP_HIDDEN, *_mlp_batch(), MLP_LR,
                                         STEPS))],), sys_path=(TESTS,))
    out["mlp"] = mlp
    out["mlp_ranks"] = [mlp] + [r[0] for r in rest]
    return out


def _tree_flat(tree) -> dict:
    return convert._flatten(jax.tree.map(np.asarray, jax.device_get(tree)))


@functools.cache
def _reference(name):
    world, mesh_sizes, cfg_fields, mode, (ids, labels, mask) = CASES[name]
    plan = ref_mesh(jax.devices()[:world], **mesh_sizes)
    cfg = JB.BertConfig(**cfg_fields)
    params = convert.to_reference_params(Bert(BertConfig(**cfg_fields), device="cpu"))
    rules = JB.param_sharding_rules(plan, n_experts=cfg.n_experts)
    if mode == "pipeline":  # make_bert_pipeline_train_state's layout
        for leaf in ("wq", "wk", "wv", "wo", "w1", "w2", "b1", "b2"):
            rules["layers"][leaf] = P("pp", *rules["layers"][leaf][1:])
        for ln in ("ln1", "ln2"):
            rules["layers"][ln] = {"scale": P("pp", None), "bias": P("pp", None)}
    shardings = JT._specs_to_shardings(plan.mesh, rules)
    params = jax.device_put(params, shardings)
    attention_fn = None
    if plan.sp > 1:
        attention_fn = (ref_ring if mode == "ring" else ref_ulysses)(plan.mesh)
    ep_sharding = NamedSharding(plan.mesh, P("ep", None, None)) if plan.ep > 1 else None
    loss_fn = functools.partial(JB.bert_mlm_loss, cfg=cfg, attention_fn=attention_fn,
                                moe_ep_sharding=ep_sharding)
    bsh = NamedSharding(plan.mesh, P("dp") if mode == "pipeline" else P("dp", "sp"))
    batch = [jax.device_put(a, bsh) for a in (ids, labels, mask)]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *batch)
    tx = optax.sgd(BERT_LR)
    opt_state = JT._place_opt_state(tx.init(params), plan.mesh)
    if mode == "pipeline":
        step = JT.make_bert_pipeline_train_step(cfg, plan, tx, shardings, n_micro=4)
    else:
        step = JT.make_bert_train_step(cfg, plan, tx, shardings, sequence_parallel=mode)
    losses = []
    for _ in range(STEPS):
        params, opt_state, l = step(params, opt_state, *batch)
        losses.append(float(l))
    return {"loss": float(loss), "losses": losses, "grads": _tree_flat(grads),
            "params": _tree_flat(params)}


def _port_flat(tree: dict) -> dict:
    return convert._flatten(convert.bert_reference_tree(tree))


def _leaves(cfg_fields):
    return sorted(convert._flatten(convert.to_reference_params(
        Bert(BertConfig(**cfg_fields), device="cpu"))))


@pytest.mark.parametrize("name", list(CASES))
def test_first_loss(name, port):
    np.testing.assert_allclose(port[name]["losses"][0], _reference(name)["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_three_step_losses(name, port):
    np.testing.assert_allclose(port[name]["losses"], _reference(name)["losses"], rtol=1e-5)


GRAD_CASES = [(n, leaf) for n, c in CASES.items() for leaf in _leaves(c[2])]


@pytest.mark.parametrize("name,leaf", GRAD_CASES)
def test_gathered_gradient(name, leaf, port):
    got = _port_flat(port[name]["grads"])[leaf]
    want = _reference(name)["grads"][leaf]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,leaf", GRAD_CASES)
def test_gathered_params_after_three_sgd_steps(name, leaf, port):
    got = _port_flat(port[name]["params"])[leaf]
    np.testing.assert_allclose(got, _reference(name)["params"][leaf], rtol=1e-4, atol=1e-6)


def test_pipelined_loss_is_the_scan_encoders(port):
    """Pipelining is a schedule, not a model: the first pipelined loss is
    the plain single-device loss on the same weights (``bert.py:234-237``)."""
    world, _, cfg_fields, _, (ids, labels, mask) = CASES["pipeline_dp2_pp2"]
    m = Bert(BertConfig(**cfg_fields), device="cpu")
    from lakesoul_tpu_torch.models.bert import bert_mlm_loss

    want = float(bert_mlm_loss(m, *(torch.from_numpy(a) for a in (ids, labels, mask))))
    np.testing.assert_allclose(port["pipeline_dp2_pp2"]["losses"][0], want, rtol=1e-5)


def test_moe_capacity_binds_in_its_cases():
    from lakesoul_tpu_torch.parallel.moe import moe_capacity

    for name in ("moe_dp2_sp2_ep2", "moe_dp2_ep2"):
        _, _, cfg, _, (ids, _, _) = CASES[name]
        assert moe_capacity(ids.size, cfg["n_experts"], cfg["capacity_factor"]) * cfg[
            "n_experts"] < ids.size


# ------------------------------------------------------------ ResNet and MLP
# ResNet-50 at width 8 on 32² images normalises its last stage's 1 × 1 maps
# over the batch alone, which amplifies float32 rounding: reordering the
# batch moves the reference's own float32 gradients by up to ~4e-4 of a
# leaf's largest value (``tests/test_torch_models_resnet.py`` holds the
# single-device port within 3x that spread).  So the dp-4 step's exactness
# (global batch statistics, the gradient sum, the global mean) is held at
# float64, parameters and compute, against the port's single-device step at
# the training bar; and its float32 gradients against the reference's
# within 1e-4 · max |g| plus 3x the reference's own spread over 4
# reorderings of the batch.


@functools.cache
def _resnet_reference():
    images, labels = _resnet_batch()
    cfg = JR.ResNetConfig(**RESNET)
    params = convert.to_reference_params(ResNet(ResNetConfig(**RESNET), device="cpu"))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, x, y: JR.resnet_loss(p, x, y, cfg=cfg)))
    loss, grads = grad_fn(params, images, labels)
    grads = _tree_flat(grads)
    spread = {k: np.zeros(()) for k in grads}
    n = len(labels)
    for perm in [np.roll(np.arange(n), s) for s in (1, 3, 5)] + [np.arange(n)[::-1]]:
        other = _tree_flat(grad_fn(params, images[perm], labels[perm])[1])
        spread = {k: np.maximum(spread[k], np.abs(other[k] - grads[k]).max()) for k in grads}
    return {"loss": float(loss), "grads": grads, "spread": spread}


@functools.cache
def _resnet_single():
    """The port's single-device step at float64: its first gradients, three steps."""
    from lakesoul_tpu_torch.models.train import make_resnet_train_step, sgd

    m = ResNet(ResNetConfig(**RESNET64), device="cpu").double()
    step = make_resnet_train_step(m, sgd(m.parameters(), RESNET_LR), device="cpu")
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(float(step(*_resnet_batch())))
        if i == 0:
            grads = {n: p.grad.numpy().copy() for n, p in m.named_parameters()}
    return {"losses": losses, "grads": grads,
            "params": {n: p.detach().numpy().copy() for n, p in m.named_parameters()}}


def test_resnet_dp4_losses(port):
    np.testing.assert_allclose(port["resnet64"]["losses"], _resnet_single()["losses"], rtol=1e-5)
    np.testing.assert_allclose(port["resnet32"]["losses"][0], _resnet_reference()["loss"],
                               rtol=1e-5)


RESNET_LEAVES = sorted(n for n, _ in ResNet(ResNetConfig(**RESNET), device="cpu").named_parameters())


@pytest.mark.parametrize("leaf", RESNET_LEAVES)
def test_resnet_dp4_gradient(leaf, port):
    np.testing.assert_allclose(port["resnet64"]["grads"][leaf], _resnet_single()["grads"][leaf],
                               rtol=1e-4, atol=1e-6)
    ref = _resnet_reference()
    want = _port_resnet_leaf(leaf, ref["grads"])
    np.testing.assert_allclose(port["resnet32"]["grads"][leaf], want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 3 * ref["spread"][leaf])


@pytest.mark.parametrize("leaf", RESNET_LEAVES)
def test_resnet_dp4_params_after_three_sgd_steps(leaf, port):
    np.testing.assert_allclose(port["resnet64"]["params"][leaf], _resnet_single()["params"][leaf],
                               rtol=1e-4, atol=1e-6)


def _port_resnet_leaf(leaf: str, flat_ref: dict) -> np.ndarray:
    v = flat_ref[leaf]
    return v.transpose(convert.HWIO_TO_OIHW) if v.ndim == 4 else v


def test_resnet_dp4_every_rank_steps_the_same(port):
    for r in port["resnet_ranks"][1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, port["resnet64"]["params"][k])


@functools.cache
def _mlp_reference():
    x, y = _mlp_batch()
    params = convert.to_reference_params(MLP(MLP_IN, hidden=MLP_HIDDEN, device="cpu"))
    loss, grads = jax.value_and_grad(JMLP.mlp_loss)(params, x, y)
    tx = optax.sgd(MLP_LR)
    step, _ = JT.make_mlp_train_step(tx)
    state = tx.init(params)
    losses = []
    for _ in range(STEPS):
        params, state, l = step(params, state, x, y)
        losses.append(float(l))
    flat = lambda t: {f"layers.{k}": v for k, v in _tree_flat(t).items()}  # noqa: E731
    return {"loss": float(loss), "losses": losses, "grads": flat(grads), "params": flat(params)}


def test_mlp_dp2_losses(port):
    np.testing.assert_allclose(port["mlp"]["losses"], _mlp_reference()["losses"], rtol=1e-5)


@pytest.mark.parametrize("leaf", ["layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b"])
def test_mlp_dp2_gradient_and_params(leaf, port):
    ref = _mlp_reference()
    np.testing.assert_allclose(port["mlp"]["grads"][leaf], ref["grads"][leaf], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(port["mlp"]["params"][leaf], ref["params"][leaf], rtol=1e-4,
                               atol=1e-6)
    for r in port["mlp_ranks"][1:]:
        np.testing.assert_array_equal(r["params"][leaf], port["mlp"]["params"][leaf])
