"""The port's parallel layer against the JAX package's, on the CPU: ring and
Ulysses attention, the GPipe primitive, the mesh's factorisation and the
differentiable collectives.

The port runs on 8 gloo ranks, each a process (``parallel/launch.py``:
a ``FileStore`` in a temporary directory, ``init_process_group(timeout=)``
60 s, the ranks killed at a deadline), spawned once for this module; the
reference runs on its own mesh of the same shape over ``tests/conftest.py``'s
8 CPU devices.  Both take the same numpy-seeded inputs.

Tolerances: attention outputs and the gradients of Σ out · cot with
respect to q, k and v, atol 2e-5 (the reference's own bar for ring against
full attention, ``tests/test_models_parallel.py``) plus rtol 1e-5; the
pipeline primitive and the collectives exactly (sums of a few float32
values, taken in one order, or copies).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lakesoul_tpu.parallel.mesh import make_mesh as ref_mesh
from lakesoul_tpu.parallel.pipeline import make_pipeline as ref_pipeline
from lakesoul_tpu.parallel.ring_attention import make_ring_attention as ref_ring
from lakesoul_tpu.parallel.ulysses import make_ulysses_attention as ref_ulysses
from lakesoul_tpu_torch.parallel.launch import run_ranks
from lakesoul_tpu_torch.parallel.mesh import _factor, _sizes

TESTS = str(pathlib.Path(__file__).resolve().parent)
WORLD, PP, N_MICRO, WIDTH = 8, 8, 5, 4


def _qkvm(B, H, T, D, seed, pad=0, padded_from=None):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), dtype=bool)
    if pad:
        mask[:, -pad:] = False
    if padded_from is not None:
        mask[:, padded_from:] = False  # whole later shards padded
    return q, k, v, mask, cot


# name → (mesh, kind, inputs)
CASES = {
    "ring_sp8": (dict(dp=1, tp=1, sp=8), "ring", _qkvm(2, 4, 64, 16, 0, pad=7)),
    "ring_sp8_fully_padded_shard": (dict(dp=1, tp=1, sp=8), "ring",
                                    _qkvm(1, 2, 32, 8, 1, padded_from=16)),
    "ring_dp2_sp4": (dict(dp=2, tp=1, sp=4), "ring", _qkvm(2, 4, 32, 8, 2, pad=3)),
    "ulysses_sp8_8_heads": (dict(dp=1, tp=1, sp=8), "ulysses", _qkvm(2, 8, 64, 16, 0, pad=7)),
    "ulysses_dp2_sp4": (dict(dp=2, tp=1, sp=4), "ulysses", _qkvm(2, 4, 32, 8, 2, pad=3)),
}
RAISES = ("ulysses_heads_not_divisible", dict(dp=1, tp=1, sp=8), "ulysses",
          _qkvm(1, 4, 16, 8, 3))


@pytest.fixture(scope="module")
def port_all():
    """Every rank's results (the collectives differ by rank)."""
    cases = [(name, mesh, kind, *inputs) for name, (mesh, kind, inputs)
             in {**CASES, RAISES[0]: RAISES[1:]}.items()]
    return run_ranks(
        "torch_parallel_jobs:many", WORLD,
        ([("attention", (cases,)), ("pipeline_primitive", (PP, N_MICRO, WIDTH)),
          ("collective_grads", (0,))],),
        sys_path=(TESTS,))


@functools.cache
def _reference(name):
    mesh_sizes, kind, (q, k, v, mask, cot) = CASES[name]
    plan = ref_mesh(jax.devices(), **mesh_sizes)
    fn = (ref_ring if kind == "ring" else ref_ulysses)(plan.mesh)

    def loss(q, k, v):
        out = fn(q, k, v, jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, out), (dq, dk, dv) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("name", list(CASES))
def test_attention_matches_the_reference(name, what, port_all):
    got = port_all[0][0][name][what]
    want = np.asarray(_reference(name)[what])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_every_rank_holds_the_same_gathered_attention(port_all):
    for rank in port_all[1:]:
        for name in CASES:
            np.testing.assert_array_equal(rank[0][name]["out"], port_all[0][0][name]["out"])


def test_a_fully_padded_shard_gives_no_nan(port_all):
    out = port_all[0][0]["ring_sp8_fully_padded_shard"]
    assert all(np.isfinite(v).all() for v in out.values())


def test_ring_equals_ulysses_on_one_mesh(port_all):
    got = port_all[0][0]
    np.testing.assert_allclose(got["ring_dp2_sp4"]["out"], got["ulysses_dp2_sp4"]["out"],
                               atol=2e-5)


def test_ulysses_raises_when_sp_does_not_divide_the_heads(port_all):
    assert port_all[0][0][RAISES[0]] == {"raised": "ulysses needs heads (4) divisible by sp (8)"}


def test_pipeline_primitive_stages_compose(port_all):
    """Stage i adds 10^i: every microbatch sees every stage once, in order;
    the outputs match the reference's ``make_pipeline`` on its pp=8 mesh."""
    plan = ref_mesh(jax.devices(), dp=1, tp=1, sp=1, pp=PP)
    adds = jnp.asarray([[10.0 ** i] for i in range(PP)])
    pipe = ref_pipeline(plan.mesh, lambda p, inp: {"x": inp["x"] + p[0]})
    want = np.asarray(jax.jit(pipe)(adds, {"x": jnp.zeros((N_MICRO, WIDTH))})["x"])
    np.testing.assert_array_equal(want, np.full((N_MICRO, WIDTH),
                                                sum(10.0 ** i for i in range(PP))))
    for rank in port_all:
        pipe_out = rank[1]
        np.testing.assert_array_equal(pipe_out["out"], want)
        np.testing.assert_array_equal(pipe_out["mask"], np.ones((N_MICRO, WIDTH), np.int32))


def test_pipeline_backward_is_the_reverse_pipeline(port_all):
    """d/dx Σ out · cot = cot (only stage 0 reads x; every stage's share is
    summed back), and each stage's addend gets Σ cot: once per microbatch."""
    cot = np.arange(1.0, N_MICRO * WIDTH + 1).reshape(N_MICRO, WIDTH)
    for rank in port_all:
        np.testing.assert_array_equal(rank[1]["dx"], cot)
        np.testing.assert_array_equal(rank[1]["dadd"].reshape(-1),
                                      np.full(PP, cot.sum(), np.float32))


def _coll(port_all, name):
    return [r[2][name] for r in port_all]


def test_ring_shift_forward_and_backward(port_all):
    rs = _coll(port_all, "ring_shift")
    for r, got in enumerate(rs):
        np.testing.assert_array_equal(got["y"], rs[(r - 1) % WORLD]["x"])
        # the transpose: the reverse rotation
        np.testing.assert_array_equal(got["dx"], rs[(r + 1) % WORLD]["c"])


def test_all_to_all_forward_and_backward(port_all):
    rs = _coll(port_all, "all_to_all")
    for r, got in enumerate(rs):
        want = np.concatenate([s["x"][2 * r:2 * r + 2] for s in rs], axis=1)
        np.testing.assert_array_equal(got["y"], want)
        want_dx = np.concatenate([rs[j]["c"][:, 3 * r:3 * r + 3] for j in range(WORLD)], axis=0)
        np.testing.assert_array_equal(got["dx"], want_dx)


def test_all_gather_backward_sums_every_ranks_slice(port_all):
    rs = _coll(port_all, "all_gather")
    for r, got in enumerate(rs):
        np.testing.assert_array_equal(got["y"], np.concatenate([s["x"] for s in rs], axis=1))
        want = sum(s["c"][:, 3 * r:3 * r + 3].astype(np.float64) for s in rs)
        np.testing.assert_allclose(got["dx"], want, rtol=1e-6, atol=1e-6)


def test_the_megatron_pair_and_its_composition(port_all):
    total_x = {n: sum(s["x"].astype(np.float64) for s in _coll(port_all, n))
               for n in ("all_reduce_sum", "reduce_from")}
    for n, dx_of in (("all_reduce_sum", lambda rs, r: sum(s["c"].astype(np.float64) for s in rs)),
                     ("copy_to", lambda rs, r: sum(s["c"].astype(np.float64) for s in rs)),
                     ("reduce_from", lambda rs, r: rs[r]["c"])):
        rs = _coll(port_all, n)
        for r, got in enumerate(rs):
            want_y = got["x"] if n == "copy_to" else total_x[n]
            np.testing.assert_allclose(got["y"], want_y, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["dx"], dx_of(rs, r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 32])
def test_factor_is_the_references(n):
    from lakesoul_tpu.parallel.mesh import _factor as ref_factor

    assert _factor(n) == ref_factor(n)


@pytest.mark.parametrize("n,kw", [(8, dict(dp=3, tp=1, sp=1)), (8, dict(pp=3)),
                                  (8, dict(dp=2, tp=2, sp=2, pp=2))])
def test_mesh_size_errors_keep_the_references_words(n, kw):
    with pytest.raises(ValueError) as ours:
        _sizes(n, kw.get("dp"), kw.get("tp"), kw.get("sp"), kw.get("pp"), kw.get("ep"))
    with pytest.raises(ValueError) as theirs:
        ref_mesh(jax.devices()[:n], **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n,kw,want", [(8, {}, (2, 2, 2, 1, 1)),
                                       (8, dict(pp=2), (2, 2, 1, 2, 1)),
                                       (8, dict(dp=2, tp=2), (2, 2, 2, 1, 1)),
                                       (4, dict(dp=2, ep=2), (2, 1, 1, 1, 2))])
def test_mesh_sizes_are_the_references(n, kw, want):
    got = _sizes(n, kw.get("dp"), kw.get("tp"), kw.get("sp"), kw.get("pp"), kw.get("ep"))
    plan = ref_mesh(jax.devices()[:n], **kw)
    assert got == want == (plan.dp, plan.tp, plan.sp, plan.pp, plan.ep)


def test_make_mesh_without_a_card_raises():
    from lakesoul_tpu_torch.errors import ConfigError
    from lakesoul_tpu_torch.parallel.mesh import make_mesh

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device_type=None is valid here")
    with pytest.raises(ConfigError, match="CUDA is not available"):
        make_mesh()


def test_a_hung_collective_fails_at_the_deadline_with_each_ranks_stack():
    import time

    t = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out") as e:
        run_ranks("torch_parallel_jobs:hang", 2, deadline_s=30, sys_path=(TESTS,))
    assert time.monotonic() - t < 60
    assert "Timeout" in str(e.value) and "hang" in str(e.value)  # where rank 0 waited


def test_a_failing_rank_fails_the_run_with_its_traceback():
    with pytest.raises(RuntimeError, match="failed") as e:
        run_ranks("torch_parallel_jobs:fail_on", 3, (1,), sys_path=(TESTS,))
    assert "rank 1 fails on purpose" in str(e.value)
    assert run_ranks("torch_parallel_jobs:fail_on", 3, (5,), sys_path=(TESTS,)) == [0, 1, 2]
