"""The port's BERT MLM encoder against the JAX package's, on the CPU, on
``BertConfig.tiny()`` (vocab 1024, hidden 128, 2 layers, 4 heads, ff 256)
and the same weights (the port's init carried to the reference's tree by
``models/convert.py``).

Batch 3 × 32 tokens, seeded: row lengths 32, 20 and 0 (a fully padded
row), 15 % of the valid positions labelled, the rest −100.

Tolerances: float32 — logits and loss rtol 1e-4 (atol 1e-4 · max |logit|),
each gradient leaf 1e-4 · max |g| + rtol 1e-4; layer norm, GELU and
attention 1e-5 · max |value| at float32, two bf16 ulps (2⁻⁶ relative) at
bf16; bf16 forward and loss within 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lakesoul_tpu.models import bert as JB
from lakesoul_tpu_torch.models import bert as TB
from lakesoul_tpu_torch.models import convert
from lakesoul_tpu_torch.models.train import (
    make_bert_pipeline_train_state,
    make_bert_train_state,
    make_bert_train_step,
)

B, T = 3, 32
LENGTHS = (32, 20, 0)


def _cfg(dtype="float32"):
    return TB.BertConfig(**{**TB.BertConfig.tiny().__dict__, "dtype": dtype})


def _jcfg(dtype="float32"):
    return JB.BertConfig(**{**JB.BertConfig.tiny().__dict__, "dtype": dtype})


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, size=(B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.array(LENGTHS)[:, None]
    labels = np.where(mask & (rng.random((B, T)) < 0.15), rng.integers(0, 1024, (B, T)), -100)
    labels[0, 0] = 7  # at least one label
    return ids, labels.astype(np.int32), mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel: float):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
def test_layer_norm_eps_1e6(dtype, rel):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 7, 128)) * 1e-3).astype(np.float32)  # var ~1e-6: eps shows
    scale, bias = rng.normal(size=128).astype(np.float32), rng.normal(size=128).astype(np.float32)
    want = JB._layer_norm(jnp.asarray(x, dtype), scale, bias)
    p = TB._LN(128)
    p.scale.data, p.bias.data = _t(scale), _t(bias)
    got = TB.layer_norm(_t(x).to(getattr(torch, dtype)), p)
    assert got.dtype == getattr(torch, dtype)
    _close(got.detach().float(), want.astype(jnp.float32), rel)
    eps5 = torch.nn.functional.layer_norm(_t(x), (128,), p.scale, p.bias, 1e-5)
    assert not torch.allclose(eps5, TB.layer_norm(_t(x), p), atol=1e-2)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
def test_gelu_is_the_tanh_approximation(dtype, rel):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x, dtype))
    got = torch.nn.functional.gelu(_t(x).to(getattr(torch, dtype)), approximate="tanh")
    _close(got.float(), want.astype(jnp.float32), rel)
    exact = torch.nn.functional.gelu(_t(x))
    assert not torch.allclose(exact, torch.nn.functional.gelu(_t(x), approximate="tanh"),
                              atol=1e-4)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
def test_attention_mask_fill_and_a_fully_padded_row(dtype, rel):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(B, 4, T, 32)).astype(np.float32) for _ in range(3))
    _, _, mask = _batch()
    jd = jnp.dtype(dtype)
    want = JB.default_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask))
    td = getattr(torch, dtype)
    got = TB.default_attention(*(_t(a).to(td) for a in (q, k, v)), _t(mask))
    assert got.dtype == td
    _close(got.float(), want.astype(jnp.float32), rel)
    # the padded row attends uniformly: the mean of v over every position
    assert bool(torch.isfinite(got).all())
    uniform = _t(v).to(td).float().mean(dim=2)[2]
    torch.testing.assert_close(got[2].float(), uniform[:, None, :].expand(4, T, 32),
                               rtol=rel, atol=rel)


def test_masked_nll_ignores_every_negative_label():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(B, T, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.5] = -100
    labels[0, :3] = -1  # any negative label is ignored, not only -100
    want = JB.masked_nll(jnp.asarray(logits), jnp.asarray(labels))
    got = TB.masked_nll(_t(logits), _t(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_masked_nll_of_an_all_ignored_batch_is_zero():
    logits = np.random.default_rng(4).normal(size=(2, 5, 9)).astype(np.float32)
    labels = np.full((2, 5), -100, np.int32)
    assert float(JB.masked_nll(jnp.asarray(logits), jnp.asarray(labels))) == 0.0
    got = TB.masked_nll(_t(logits), _t(labels))
    assert float(got) == 0.0 and bool(torch.isfinite(got))


def _plan(pp: int):
    from lakesoul_tpu.parallel.mesh import MeshPlan as JPlan
    from lakesoul_tpu_torch.parallel.mesh import MeshPlan as TPlan

    # every guard raises before the mesh is read
    return JPlan(mesh=None, dp=1, tp=1, sp=1, pp=pp), TPlan(mesh=None, dp=1, tp=1, sp=1, pp=pp)


def test_moe_configs_raise():
    """MoE configs build now (below); the layout the reference rejects for
    them, the pipeline's (``train.py:148-152``), raises here too."""
    with pytest.raises(ValueError, match="pipeline layout does not support MoE configs"):
        make_bert_pipeline_train_state(_moe_cfg(), _plan(1)[1])


@pytest.mark.parametrize("layers,n_experts,pp", [(2, 4, 1), (3, 0, 2), (3, 2, 2)],
                         ids=["moe", "split", "both"])
def test_pipeline_state_guards_raise_the_reference_message(layers, n_experts, pp):
    """The reference checks the split over pp first, then MoE
    (``lakesoul_tpu/models/train.py:144-151``): a config failing both
    raises the split's message in both packages."""
    from lakesoul_tpu.models import train as JT

    jplan, tplan = _plan(pp)
    over = {"layers": layers, "n_experts": n_experts}
    with pytest.raises(ValueError) as want:
        JT.make_bert_pipeline_train_state(JB.BertConfig(**{**_jcfg().__dict__, **over}), jplan)
    with pytest.raises(ValueError) as got:
        make_bert_pipeline_train_state(TB.BertConfig(**{**_cfg().__dict__, **over}), tplan)
    assert str(got.value) == str(want.value)


def _moe_cfg(dtype="float32"):
    # 96 tokens over 4 experts at capacity factor 1.0: C = 24, so it binds
    return TB.BertConfig(**{**_cfg(dtype).__dict__, "n_experts": 4, "capacity_factor": 1.0})


@pytest.fixture(scope="module")
def moe_reference():
    """The reference's MoE BERT (``bert.py:163-175, 262-264``) on the port's
    init carried across: logits, aux and loss at float32 and bf16, and the
    float32 gradients."""
    params = convert.to_reference_params(TB.Bert(_moe_cfg(), device="cpu"))
    ids, labels, mask = _batch()
    out = {"params": params}
    for dtype in ("float32", "bfloat16"):
        jcfg = JB.BertConfig(**{**_jcfg(dtype).__dict__, "n_experts": 4, "capacity_factor": 1.0})

        def loss(p, jcfg=jcfg):
            logits, aux = JB.bert_forward(p, ids, mask, cfg=jcfg, with_aux=True)
            return JB.bert_mlm_loss(p, ids, labels, mask, cfg=jcfg), (logits, aux)

        (l, (logits, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[dtype] = dict(loss=float(l), logits=np.asarray(logits), aux=float(aux),
                          grads=convert._flatten(jax.tree.map(np.asarray, g)))
    return out


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_moe_bert_forward_and_loss(dtype, rel, moe_reference):
    m = _port(moe_reference["params"], dtype, _moe_cfg(dtype))
    ids, labels, mask = _batch()
    logits, aux = TB.bert_forward(m, _t(ids), _t(mask), with_aux=True)
    want = moe_reference[dtype]
    _close(logits.detach().numpy(), want["logits"], rel)
    np.testing.assert_allclose(float(aux.detach()), want["aux"],
                               rtol=1e-5 if dtype == "float32" else rel)
    loss = TB.bert_mlm_loss(m, _t(ids), _t(labels), _t(mask))
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=rel)


def _moe_leaves():
    return sorted(convert._flatten(convert.to_reference_params(TB.Bert(_moe_cfg(), device="cpu"))))


@pytest.mark.parametrize("leaf", _moe_leaves())
def test_moe_bert_f32_gradient(leaf, moe_reference):
    m = _port(moe_reference["params"], "float32", _moe_cfg())
    ids, labels, mask = _batch()
    TB.bert_mlm_loss(m, _t(ids), _t(labels), _t(mask)).backward()
    view = TB.Bert(m.cfg, device="cpu")
    view.load_state_dict({n: p.grad for n, p in m.named_parameters()})
    got = convert._flatten(convert.to_reference_params(view))[leaf]
    want = moe_reference["float32"]["grads"][leaf]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_moe_weights_cross_bit_for_bit(moe_reference):
    params = moe_reference["params"]
    assert params["layers"]["moe"]["w1"].shape == (2, 4, 128, 256)
    back = convert.to_reference_params(_port(params, "float32", _moe_cfg()))
    for k, v in convert._flatten(params).items():
        np.testing.assert_array_equal(convert._flatten(back)[k], v, err_msg=k)


def _labels(case: str):
    ids, labels, mask = _batch()
    if case == "none":
        labels = np.full_like(labels, -100)
    elif case in ("every", "one_row_unlabelled"):
        labels = ids.copy()
        if case == "one_row_unlabelled":
            labels[1] = -100
    return ids, labels, mask


@pytest.mark.parametrize("case", ["mask_15", "none", "every", "one_row_unlabelled", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_loss_path_heads_only_the_labelled_rows_as_the_full_logits_do(dtype, case):
    """``bert_mlm_loss`` gathers the labelled rows before the head; its loss
    and every leaf's gradient are the full logits' (``bert_forward`` and
    ``masked_nll``, the MoE term added alike) to float32 rounding: the head
    acts row by row, only the order of float32 sums differs.  ``mask_15``
    has the fully padded row 2 with no label; with none labelled the loss is
    0 and every gradient finite."""
    cfg = _moe_cfg(dtype) if case == "moe" else _cfg(dtype)
    ids, labels, mask = _labels(case)

    def loss_and_grads(gathered: bool):
        m = TB.Bert(cfg, seed=5, device="cpu")
        if gathered:
            loss = TB.bert_mlm_loss(m, _t(ids), _t(labels), _t(mask))
        else:
            logits, aux = TB.bert_forward(m, _t(ids), _t(mask), with_aux=True)
            loss = TB.masked_nll(logits, _t(labels))
            if cfg.n_experts:
                loss = loss + cfg.moe_aux_weight * aux
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    (loss, grads), (want_loss, want) = loss_and_grads(True), loss_and_grads(False)
    if case == "none":
        assert float(loss) == 0.0
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        torch.testing.assert_close(g, want[k], rtol=1e-5, atol=1e-5 * float(want[k].abs().max()),
                                   msg=k)


@pytest.fixture(scope="module")
def reference():
    """The port's init carried to the reference's tree; the reference's
    f32 loss, logits and gradients and its bf16 loss and logits."""
    params = convert.to_reference_params(TB.Bert(_cfg(), device="cpu"))
    ids, labels, mask = _batch()

    def loss_logits(p, cfg):
        logits = JB.bert_forward(p, ids, mask, cfg=cfg)
        return JB.masked_nll(logits, labels), logits

    (loss, logits), g = jax.jit(jax.value_and_grad(
        functools.partial(loss_logits, cfg=_jcfg()), has_aux=True))(params)
    loss16, logits16 = jax.jit(functools.partial(loss_logits, cfg=_jcfg("bfloat16")))(params)
    return dict(params=params, loss=float(loss), logits=np.asarray(logits),
                grads=convert._flatten(jax.tree.map(np.asarray, g)), loss16=float(loss16),
                logits16=np.asarray(logits16))


def _port(params, dtype="float32", cfg=None) -> TB.Bert:
    m = TB.Bert(cfg or _cfg(dtype), device="cpu")
    m.load_state_dict(convert.from_reference_params(params))
    return m


@pytest.fixture(scope="module")
def port_f32(reference):
    m = _port(reference["params"])
    ids, labels, mask = _batch()
    logits = TB.bert_forward(m, _t(ids), _t(mask))
    loss = TB.masked_nll(logits, _t(labels))
    loss.backward()
    view = TB.Bert(m.cfg, device="cpu")
    view.load_state_dict({n: p.grad for n, p in m.named_parameters()})
    grads = convert._flatten(convert.to_reference_params(view))
    return dict(loss=float(loss.detach()), logits=logits.detach().numpy(), grads=grads)


def test_f32_logits(reference, port_f32):
    assert port_f32["logits"].shape == (B, T, 1024)
    _close(port_f32["logits"], reference["logits"], 1e-4)


def test_f32_loss(reference, port_f32):
    np.testing.assert_allclose(port_f32["loss"], reference["loss"], rtol=1e-4)


def test_bf16_forward_and_loss(reference):
    m = _port(reference["params"], "bfloat16")
    ids, labels, mask = _batch()
    logits = TB.bert_forward(m, _t(ids), _t(mask))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    _close(logits.detach().numpy(), reference["logits16"], 2e-2)
    np.testing.assert_allclose(float(TB.masked_nll(logits, _t(labels))), reference["loss16"],
                               rtol=2e-2)


def _leaves():
    p = convert.to_reference_params(TB.Bert(_cfg(), device="cpu"))
    return sorted(convert._flatten(p))


@pytest.mark.parametrize("leaf", _leaves())
def test_f32_gradient(leaf, reference, port_f32):
    got, want = port_f32["grads"][leaf], reference["grads"][leaf]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_tied_tok_emb_gradient_sums_the_gather_and_the_head(reference, port_f32):
    """``tok_emb``'s gradient is the head's share (every row) plus the
    gather's (the rows of tokens at attended positions): the head's share
    alone, taken with the gather detached, is exactly the unseen rows'."""
    ids, labels, mask = _batch()
    m = _port(reference["params"])
    x = torch.nn.functional.embedding(_t(ids).long(), m.tok_emb.detach()) + m.pos_emb[:T][None]
    x = TB.layer_norm(x, m.emb_ln)
    for lp in m.layers:
        x, _ = TB.bert_layer(x, lp, _t(mask), cfg=m.cfg)
    TB.masked_nll(TB.bert_head(m, x), _t(labels)).backward()
    head = m.tok_emb.grad.numpy()
    full = port_f32["grads"]["tok_emb"]
    seen = np.zeros(1024, bool)
    seen[ids.ravel()] = True
    np.testing.assert_array_equal(full[~seen], head[~seen])
    assert np.abs(head[~seen]).max() > 0  # tied: the head reaches every row
    # tokens at attended positions get a gather share; those only at padded
    # positions (no label, never attended) get none
    live = np.zeros(1024, bool)
    live[ids[mask]] = True
    gather = full - head
    assert (np.abs(gather[live]).max(axis=1) > 1e-4 * np.abs(full).max()).all()
    assert np.abs(gather[seen & ~live]).max() < 1e-6 * np.abs(full).max()


@pytest.mark.parametrize("case", ["optimizer", "step"])
def test_one_adamw_step_matches_optax(case, reference):
    """``make_bert_train_state``'s AdamW (lr 1e-4, weight decay 1e-4)
    against ``optax.adamw(1e-4)``.

    ``optimizer``: both are fed the reference's gradients (set as ``.grad``,
    then ``opt.step()``), so two optimizers meet identical input.  The first
    Adam step moves each param by lr · g / (|g| + 1e-8), which magnifies a
    gradient's last bits where |g| is near 1e-8: fed each framework's own
    gradients, one element in 65,536 of ``layers.w2`` moved 1.34e-6 apart.
    ``step``: the port's train step takes the loss and the gradients of the
    same batch itself, held against the reference's as ``test_f32_gradient``
    holds them."""
    params = reference["params"]
    model, opt = make_bert_train_state(_cfg(), device="cpu")
    model.load_state_dict(convert.from_reference_params(params))
    if case == "step":
        ids, labels, mask = _batch()
        loss = make_bert_train_step(model, opt, device="cpu")(ids, labels, mask)
        np.testing.assert_allclose(float(loss), reference["loss"], rtol=1e-4)
        view = TB.Bert(model.cfg, device="cpu")
        view.load_state_dict({n: p.grad for n, p in model.named_parameters()})
        grads = convert._flatten(convert.to_reference_params(view))
        assert sorted(grads) == sorted(reference["grads"])
        for k, want in reference["grads"].items():
            np.testing.assert_allclose(grads[k], want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(), err_msg=k)
        return
    tx = optax.adamw(1e-4)
    updates, _ = tx.update(convert._unflatten(reference["grads"]), tx.init(params), params)
    want = convert._flatten(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    grads = convert.from_reference_params(convert._unflatten(reference["grads"]))
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()
    got = convert._flatten(convert.to_reference_params(model))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        # ±lr wherever |g| >> 1e-8: the port must agree on every sign; atol 1 % of lr
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
