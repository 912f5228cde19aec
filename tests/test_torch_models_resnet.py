"""The port's ResNet-50 against the JAX package's, on the CPU, on the same
weights (carried by ``models/convert.py``).

Sizes: 32² images (even, where XLA's SAME pads asymmetrically at stride 2
and ``padding=k // 2`` shifts every window) and 33² (odd, where it pads
symmetrically).  Width 8, 10 classes, batch 8, depth 50.  The weights are
the port's init carried to the reference's tree (the reference's own init
compiles a random draw per leaf, slower than this whole file);
``test_torch_models_train.py`` holds the two inits' distributions.

Tolerances:
- each SAME conv, forward and gradients: rtol 1e-5, atol 1e-5 · max |value|
  (float32 sums of up to 7·7·8 terms, or of every output position, taken
  in another order); the −inf max-pool: exact forward, gradient 1e-6;
- ``bn`` at float32: forward rtol 1e-5 (atol 1e-5), gradients 1e-4
  (sums over N·H·W); at bf16 one ulp (2⁻⁷ relative);
- loss at float32: rtol 1e-4; loss at bf16: 2e-2 relative;
- logits at float32: 1e-4 · (|logit| + max |logit|) plus 3× the reference's
  own spread (below);
- parameter gradients at float32: 1e-4 · max |g| plus 3× the reference's
  own spread.  The spread is the largest difference between the
  reference's result for the batch and for four reorderings of it.  A
  randomly initialised 50-layer net with batch statistics amplifies
  float32 rounding: a reordered batch moves the reference's own deep
  gradients by percents, and at 32² its last stage normalises 1 × 1 maps
  over the batch alone, which moves its logits by more than 1e-4.  A
  fixed rtol cannot hold those; the port must agree with the reference as
  closely as the reference agrees with itself (3×: two independent
  roundings, and a margin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lakesoul_tpu.models import resnet as JR
from lakesoul_tpu_torch.models import convert
from lakesoul_tpu_torch.models import resnet as TR
from lakesoul_tpu_torch.models.train import make_resnet_train_step, sgd

SIZES = (32, 33)
BATCH, CLASSES, WIDTH = 8, 10, 8
LEAVES = ("stem.conv", "stages.0.0.conv2", "stages.3.0.proj", "head.w")  # chip_smoke's four
SPREAD_FACTOR = 3.0
LR = 0.05


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_same_conv_matches_lax_forward_and_gradients(k, stride, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 6)).astype(np.float32)
    up = rng.normal(size=(2, -(-size // stride), -(-size // stride), 6)).astype(np.float32)

    def ref(x, w):
        y = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.sum(y * up), y

    (_, want), (gx, gw) = jax.value_and_grad(ref, argnums=(0, 1), has_aux=True)(x, w)
    xt = _nchw(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(convert.HWIO_TO_OIHW).copy()).requires_grad_()
    got = TR.conv(xt, wt, stride)
    (got * _nchw(up)).sum().backward()
    for t, j in ((_nhwc(got), want), (_nhwc(xt.grad), gx),
                 (wt.grad.numpy().transpose(convert.OIHW_TO_HWIO), gw)):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2)])
def test_symmetric_padding_shifts_windows_at_even_sizes_only(k, stride):
    """The trap the explicit split avoids: ``padding=k // 2`` equals SAME at
    33² and not at 32²."""
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.normal(size=(4, 3, k, k)).astype(np.float32))
    for size, same in ((32, False), (33, True)):
        x = torch.from_numpy(rng.normal(size=(1, 3, size, size)).astype(np.float32))
        naive = torch.nn.functional.conv2d(x, w, stride=stride, padding=k // 2)
        assert torch.allclose(naive, TR.conv(x, w, stride), atol=1e-5) is same


@pytest.mark.parametrize("size", SIZES)
def test_max_pool_matches_reduce_window_forward_and_gradient(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    n = -(-size // 2)
    up = rng.normal(size=(2, n, n, 5)).astype(np.float32)

    def ref(x):
        y = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        return jnp.sum(y * up), y

    (_, want), gx = jax.value_and_grad(ref, has_aux=True)(x)
    xt = _nchw(x).requires_grad_()
    got = TR.max_pool(xt)
    (got * _nchw(up)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=0)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1))])
def test_same_pads_are_xlas_split(size, k, stride, pads):
    assert TR.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 5, 5, 8)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    up = rng.normal(size=(4, 5, 5, 8)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def ref(x, s, b):
        y = JR._bn(x.astype(jdt), {"scale": s, "bias": b})
        return jnp.sum(y.astype(jnp.float32) * up), y

    (_, want), grads = jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)
    p = TR._BN(8)
    p.scale.data, p.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    xt = _nchw(x).requires_grad_()
    got = TR.bn(xt.to(getattr(torch, dtype)), p)
    assert got.dtype == getattr(torch, dtype)
    (got.float() * _nchw(up)).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
        for g, t in zip(grads, (_nhwc(xt.grad), p.scale.grad.numpy(), p.bias.grad.numpy())):
            np.testing.assert_allclose(t, np.asarray(g), rtol=1e-4, atol=1e-4)
    else:
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(_nhwc(got.float()), want, rtol=2.0**-7, atol=2.0**-7)


def _data(size: int, seed: int = 0):
    rng = np.random.default_rng(seed + size)
    x = rng.normal(size=(BATCH, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return x, y


def _grads(m: TR.ResNet) -> dict:
    """The model's gradients laid out as the reference's param tree, flat."""
    view = TR.ResNet(m.cfg, device="cpu")
    view.load_state_dict({n: p.grad for n, p in m.named_parameters()})
    return convert._flatten(convert.to_reference_params(view))


def _port(params, dtype: str) -> TR.ResNet:
    m = TR.ResNet(TR.ResNetConfig(num_classes=CLASSES, width=WIDTH, dtype=dtype), device="cpu")
    m.load_state_dict(convert.from_reference_params(params))
    return m


@pytest.fixture(scope="module")
def reference():
    """The port's init (seed 0) carried to the JAX package's tree, and per
    size the reference's f32 loss, logits and gradients on it, the spread
    of its logits and gradients over four reorderings of the batch, and
    its bf16 loss."""
    out = {}
    cfg32 = JR.ResNetConfig(num_classes=CLASSES, width=WIDTH, dtype="float32")
    cfg16 = JR.ResNetConfig(num_classes=CLASSES, width=WIDTH, dtype="bfloat16")
    params = convert.to_reference_params(
        TR.ResNet(TR.ResNetConfig(num_classes=CLASSES, width=WIDTH, dtype="float32"),
                  device="cpu"))

    def loss_logits(p, x, y):
        logits = JR.resnet_forward(p, x, cfg=cfg32)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1)), logits

    grad_fn = jax.jit(jax.value_and_grad(loss_logits, has_aux=True))
    loss16 = jax.jit(lambda p, x, y: JR.resnet_loss(p, x, y, cfg=cfg16))
    for size in SIZES:
        x, y = _data(size)
        (loss, logits), g = grad_fn(params, x, y)
        logits = np.asarray(logits)
        grads = convert._flatten(jax.tree.map(np.asarray, g))
        spread = dict.fromkeys(grads, 0.0)
        spread_logits = np.zeros_like(logits)
        for r in range(1, 5):
            perm = np.roll(np.arange(BATCH), r)[::(-1 if r % 2 else 1)]
            (_, lp), gp = grad_fn(params, x[perm], y[perm])
            spread_logits[perm] = np.maximum(spread_logits[perm], np.abs(np.asarray(lp) - logits[perm]))
            for k, v in convert._flatten(jax.tree.map(np.asarray, gp)).items():
                spread[k] = max(spread[k], float(np.abs(v - grads[k]).max()))
        out[size] = dict(x=x, y=y, loss=float(loss), logits=logits, grads=grads,
                         spread=spread, spread_logits=spread_logits,
                         loss16=float(loss16(params, x, y)))
    return params, out


@pytest.fixture(scope="module")
def port_f32(reference):
    """Per size: the port's f32 model on the reference's weights, after one
    backward pass of its loss, and its logits."""
    params, ref = reference
    out = {}
    for size in SIZES:
        m = _port(params, "float32")
        x, y = torch.from_numpy(ref[size]["x"]), torch.from_numpy(ref[size]["y"])
        logits = TR.resnet_forward(m, x)
        TR.resnet_loss(m, x, y).backward()
        out[size] = (m, logits.detach().numpy())
    return out


def _grad_tol(ref, key):
    g = ref["grads"][key]
    return 1e-4 * float(np.abs(g).max()) + SPREAD_FACTOR * ref["spread"][key]


@pytest.mark.parametrize("size", SIZES)
def test_f32_logits_and_loss(size, reference, port_f32):
    _, ref = reference
    m, logits = port_f32[size]
    r = ref[size]
    assert logits.shape == (BATCH, CLASSES) and logits.dtype == np.float32
    want = r["logits"]
    tol = 1e-4 * (np.abs(want) + np.abs(want).max()) + SPREAD_FACTOR * r["spread_logits"]
    assert (np.abs(logits - want) <= tol).all(), np.abs(logits - want).max()
    loss = TR.resnet_loss(m, torch.from_numpy(r["x"]), torch.from_numpy(r["y"])).detach()
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-4)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("leaf", LEAVES)
def test_f32_gradients(leaf, size, reference, port_f32):
    _, ref = reference
    m, _ = port_f32[size]
    got = _grads(m)[leaf]
    want = ref[size]["grads"][leaf]
    np.testing.assert_allclose(got, want, rtol=0, atol=_grad_tol(ref[size], leaf))


@pytest.mark.parametrize("size", SIZES)
def test_f32_every_gradient_within_the_references_spread(size, reference, port_f32):
    _, ref = reference
    m, _ = port_f32[size]
    got = _grads(m)
    assert set(got) == set(ref[size]["grads"])
    bad = [k for k, v in got.items()
           if np.abs(v - ref[size]["grads"][k]).max() > _grad_tol(ref[size], k)]
    assert not bad, bad


@pytest.mark.parametrize("size", SIZES)
def test_bf16_loss(size, reference):
    params, ref = reference
    m = _port(params, "bfloat16")
    r = ref[size]
    logits = TR.resnet_forward(m, torch.from_numpy(r["x"]))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    loss = TR.resnet_loss(m, torch.from_numpy(r["x"]), torch.from_numpy(r["y"]))
    np.testing.assert_allclose(float(loss), r["loss16"], rtol=2e-2)


@pytest.mark.parametrize("size", SIZES)
def test_one_sgd_step_matches_optax(size, reference):
    """optax.sgd(0.05) on the reference's gradients against the port's
    step: the params may differ by lr × the gradient tolerance."""
    params, ref = reference
    r = ref[size]
    tx = optax.sgd(LR)
    grads = convert._unflatten(r["grads"])
    updates, _ = tx.update(grads, tx.init(params), params)
    want = convert._flatten(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    m = _port(params, "float32")
    step = make_resnet_train_step(m, sgd(m.parameters(), LR), device="cpu")
    loss = step(r["x"], r["y"])
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-4)
    got = convert._flatten(convert.to_reference_params(m))
    bad = [k for k, v in got.items()
           if np.abs(v - want[k]).max() > LR * _grad_tol(r, k) + 1e-6 * np.abs(want[k]).max()]
    assert not bad, bad
