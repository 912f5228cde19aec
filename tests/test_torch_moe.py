"""The port's Switch MoE FFN (``parallel/moe.py``) against the JAX package's,
on the CPU, on the same numpy-seeded tokens and weights.

One process: out and aux at float32 and bf16, capacity drops (first come
keeps, an overflow token gives exactly 0), a capacity that binds on random
routing, the single-expert parity with a dense FFN, gradients against
``jax.grad``, and that no [N, E, C] tensor is made.  Sharded: 8 gloo ranks
(one spawn for the module) split the tokens over dp and sp and the experts
over ep, at a capacity that binds, against the reference's ``moe_ffn`` of
the whole batch.

Tolerances: float32 out rtol 1e-5 (atol 1e-5 · max |out|), aux rtol 1e-6;
bf16 out two bf16 ulps of the largest value (2⁻⁶), aux rtol 1e-6 (the
router runs in float32 on both); gradients rtol 1e-4, atol 1e-6 (the
training tests' bar); drops exactly.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lakesoul_tpu.parallel import moe as JM
from lakesoul_tpu_torch.parallel import moe as TM
from lakesoul_tpu_torch.parallel.launch import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)
KEYS = ("gate_w", "w1", "b1", "w2", "b2")


def _inputs(N, h, f, E, seed=0, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, h)).astype(np.float32)
    p = {"gate_w": (rng.normal(size=(h, E)) * gate_scale).astype(np.float32),
         "w1": (rng.normal(size=(E, h, f)) * 0.1).astype(np.float32),
         "b1": (rng.normal(size=(E, f)) * 0.1).astype(np.float32),
         "w2": (rng.normal(size=(E, f, h)) * 0.1).astype(np.float32),
         "b2": (rng.normal(size=(E, h)) * 0.1).astype(np.float32)}
    cot = rng.normal(size=(N, h)).astype(np.float32)
    return x, p, cot


def _ref(x, p, cf, dtype=jnp.float32):
    out, aux = JM.moe_ffn(jnp.asarray(x, dtype), *(jnp.asarray(p[k]) for k in KEYS),
                          capacity_factor=cf, ep_sharding=None)
    return np.asarray(out.astype(jnp.float32)), float(aux)


def _port(x, p, cf, dtype=torch.float32):
    out, aux = TM.moe_ffn(torch.from_numpy(x).to(dtype), *(torch.from_numpy(p[k]) for k in KEYS),
                          capacity_factor=cf)
    assert out.dtype == dtype and aux.dtype == torch.float32
    return out.float().numpy(), float(aux)


@pytest.mark.parametrize("cf", [1.25, 0.5, 4.0])
def test_f32_matches_the_reference(cf):
    x, p, _ = _inputs(64, 16, 32, 4)
    (got, aux), (want, want_aux) = _port(x, p, cf), _ref(x, p, cf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_bf16_matches_the_reference(cf):
    x, p, _ = _inputs(64, 16, 32, 4, seed=1)
    (got, aux), (want, want_aux) = _port(x, p, cf, torch.bfloat16), _ref(x, p, cf, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2.0**-6, atol=2.0**-6 * np.abs(want).max())
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_capacity_drops_overflow_first_come_keeps():
    """All tokens to expert 2, capacity N/E: the first N/E keep, the rest give
    exactly zero (the reference's ``test_moe_capacity_drops_overflow``)."""
    N, h, E = 16, 8, 4
    x = np.ones((N, h), np.float32)
    p = {"gate_w": np.zeros((h, E), np.float32), "w1": np.full((E, h, h), 0.1, np.float32),
         "b1": np.zeros((E, h), np.float32), "w2": np.full((E, h, h), 0.1, np.float32),
         "b2": np.zeros((E, h), np.float32)}
    p["gate_w"][:, 2] = 1.0
    got, _ = _port(x, p, 1.0)
    want, _ = _ref(x, p, 1.0)
    kept = np.abs(got).sum(axis=1) > 0
    assert kept.sum() == N // E and kept[:N // E].all()
    np.testing.assert_array_equal(got[~kept], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_a_binding_capacity_drops_what_the_reference_drops():
    x, p, _ = _inputs(64, 16, 32, 4, seed=2, gate_scale=3.0)  # skewed routing
    got, _ = _port(x, p, 0.5)
    want, _ = _ref(x, p, 0.5)
    assert ((np.abs(want).sum(1) == 0) == (np.abs(got).sum(1) == 0)).all()
    assert (np.abs(want).sum(1) == 0).sum() >= 64 - 4 * TM.moe_capacity(64, 4, 0.5)


def test_single_expert_is_the_dense_ffn():
    """E = 1 with ample capacity: the router's softmax over one expert gates
    at exactly 1, so the MoE is the dense tanh-GELU FFN."""
    x, p, _ = _inputs(32, 8, 16, 1, seed=3)
    got, _ = _port(x, p, 2.0)
    dense = torch.nn.functional.gelu(torch.from_numpy(x @ p["w1"][0] + p["b1"][0]),
                                     approximate="tanh").numpy() @ p["w2"][0] + p["b2"][0]
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _ref(x, p, 2.0)[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_gradients_match_jax_grad(cf):
    """d(Σ out · cot + aux) with respect to x and every parameter."""
    x, p, cot = _inputs(64, 16, 32, 4, seed=4)

    def ref_loss(x, p):
        out, aux = JM.moe_ffn(x, *(p[k] for k in KEYS), capacity_factor=cf, ep_sharding=None)
        return jnp.sum(out * cot) + aux

    gx, gp = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), {k: jnp.asarray(v)
                                                                 for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out, aux = TM.moe_ffn(tx, *(tp[k] for k in KEYS), capacity_factor=cf)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    for name, got, want in [("x", tx.grad, gx)] + [(k, tp[k].grad, gp[k]) for k in KEYS]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_dense_dispatch_tensor_is_made():
    """The reference's dispatch and combine are [N, E, C]; the port's
    largest tensor, forward and backward, is the [E, C, f] hidden."""
    N, h, f, E, cf = 512, 8, 16, 8, 1.25
    C = TM.moe_capacity(N, E, cf)
    x, p, cot = _inputs(N, h, f, E, seed=5)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    with _Sizes() as sizes:
        out, aux = TM.moe_ffn(torch.from_numpy(x), *(tp[k] for k in KEYS), capacity_factor=cf)
        ((out * torch.from_numpy(cot)).sum() + aux).backward()
    assert sizes.largest == E * C * f < N * E * C


# ------------------------------------------------------------------ sharded
B, T, H, F, E = 8, 8, 16, 32, 8
MESHES = {"dp2_sp2_ep2": dict(dp=2, tp=1, sp=2, ep=2), "dp4_ep2": dict(dp=4, tp=1, sp=1, ep=2),
          "ep8": dict(dp=1, tp=1, sp=1, ep=8), "dp8": dict(dp=8, tp=1, sp=1, ep=1)}
SHARDED_CF = 0.5  # C = 4 of 64 tokens over 8 experts: capacity binds


@pytest.fixture(scope="module")
def sharded():
    x, p, cot = _inputs(B * T, H, F, E, seed=6, gate_scale=3.0)
    x3, cot3 = x.reshape(B, T, H), cot.reshape(B, T, H)
    res = run_ranks("torch_parallel_jobs:many", 8,
                    ([("moe_sharded", (m, x3, p, SHARDED_CF, cot3)) for m in MESHES.values()],),
                    sys_path=(TESTS,))[0]

    def ref_loss(x, p):
        out, aux = JM.moe_ffn(x, *(p[k] for k in KEYS), capacity_factor=SHARDED_CF,
                              ep_sharding=None)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    ref = {"out": np.asarray(out).reshape(B, T, H), "aux": float(aux),
           "dx": np.asarray(gx).reshape(B, T, H), "grads": {k: np.asarray(v) for k, v in gp.items()}}
    return dict(zip(MESHES, res)), ref


def test_the_sharded_batch_drops_tokens(sharded):
    _, ref = sharded
    assert (np.abs(ref["out"]).sum(-1) == 0).sum() >= B * T - E * TM.moe_capacity(B * T, E, SHARDED_CF)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_out_and_aux_are_the_whole_batchs(mesh, sharded):
    got, ref = sharded[0][mesh], sharded[1]
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["out"]).max())
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-6)


@pytest.mark.parametrize("what", ["dx", *KEYS])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_gradients_are_the_whole_batchs(mesh, what, sharded):
    """Replicated ``gate_w`` included: the single-device gradient, not ep
    times it or a part of it."""
    got, ref = sharded[0][mesh], sharded[1]
    g = got["dx"] if what == "dx" else got["grads"][what]
    want = ref["dx"] if what == "dx" else ref["grads"][what]
    np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6)
