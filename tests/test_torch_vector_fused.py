"""The batch kernel's tensor-core design and its fused estimate mode, held
against the JAX package on the CPU.

- ``split_bf16x3`` (the split the kernel makes of its queries in its
  prologue) reconstructs every f32 query exactly: hi + mid + lo == q.
- Three bf16 products over the planes, summed in f32, give the reference's
  ``packed_dot_batch_pallas`` (interpret mode) at rtol 1e-5, atol 1e-4:
  bits are exact in bf16, so only the order of the f32 sums differs.
- ``packed_estimate_batch`` on CPU tensors equals, transposed, the
  estimate of the reference's ``_fused_search_resident_batch``
  (``lakesoul_tpu/vector/kernels.py:319-331``, its ``use_pallas=False``
  arithmetic rebuilt in jnp here), with masked entries exactly +inf.  Each
  estimate is a sum of terms that cancel (norm², csq and
  2·norm·dot/factor, dot itself a sum over bits), so the tolerance is
  |port - reference| <= 1e-4 + 1e-5 · (the magnitude of those terms), as
  ``chip_smoke.py``'s ``ragged_check`` states it.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds both
modes against these plain versions there).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lakesoul_tpu.vector.kernels import packed_dot_batch_pallas
from lakesoul_tpu.vector.rabitq import unpack_bits_jnp
from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.vector import kernels as K

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Fails the test if anything tries to build or load a CUDA kernel."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _queries(nq, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 1 / math.sqrt(512), 1.0, 37.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16x3_is_exact(seed, scale):
    q = torch.from_numpy(_queries(64, 512, seed, scale))
    hi, mid, lo = K.split_bf16x3(q)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.double() + mid.double()) + lo.double()
    np.testing.assert_array_equal(back.numpy(), q.double().numpy())
    # the planes carry all 24 mantissa bits: mid and lo are small remainders
    assert bool((mid.float().abs() <= q.abs() * 2.0**-8).all())
    assert bool((lo.float().abs() <= q.abs() * 2.0**-16).all())


@pytest.mark.parametrize("nq", [1, 13, 17])
@pytest.mark.parametrize("d", [64, 100, 512])
def test_three_bf16_products_match_pallas(d, nq, no_cuda_build):
    rng = np.random.default_rng(d * 7 + nq)
    n, d8 = 300, (d + 7) // 8
    codes = rng.integers(0, 256, size=(n, d8), dtype=np.uint8)
    q = _queries(nq, d, d + nq)
    bits = K.unpack_bits(torch.from_numpy(codes), d)  # exact in bf16: 0 or 1
    assert bool((bits.to(torch.bfloat16).float() == bits).all())
    got = sum(bits @ plane.float().T for plane in K.split_bf16x3(torch.from_numpy(q)))
    want = np.asarray(packed_dot_batch_pallas(jnp.asarray(codes), jnp.asarray(q), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _bundle(n, d, nq, nlist, seed, n_pad_rows=0):
    """A seeded resident bundle as ``_get_device_bundle`` lays it out: rows
    sorted by cluster, then pad rows (codes 0, PAD_NORM, PAD_FACTOR, cdc 0,
    cluster 0); per (cluster, query) tables as ``_dispatch_resident`` makes
    them, about a third of the pairs probed."""
    rng = np.random.default_rng(seed)
    d8 = (d + 7) // 8
    codes = rng.integers(0, 256, size=(n, d8), dtype=np.uint8)
    norms = rng.uniform(0.2, 2.0, n).astype(np.float32)
    factors = rng.uniform(0.6, 0.95, n).astype(np.float32)
    cdc = rng.normal(size=n).astype(np.float32)
    cluster = np.sort(rng.integers(0, nlist, n)).astype(np.int64)
    if n_pad_rows:
        codes = np.concatenate([codes, np.zeros((n_pad_rows, d8), np.uint8)])
        norms = np.concatenate([norms, np.full(n_pad_rows, K.PAD_NORM, np.float32)])
        factors = np.concatenate([factors, np.full(n_pad_rows, K.PAD_FACTOR, np.float32)])
        cdc = np.concatenate([cdc, np.zeros(n_pad_rows, np.float32)])
        cluster = np.concatenate([cluster, np.zeros(n_pad_rows, np.int64)])
    q_glob = _queries(nq, d, seed + 1, 1 / math.sqrt(d))
    probe = rng.random((nlist, nq)) < 0.35
    probe[0, 0] = True  # pad rows are scored for query 0
    csq = rng.uniform(0, 4, (nlist, nq)).astype(np.float32)
    csum = rng.normal(size=(nlist, nq)).astype(np.float32)
    return codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum


def _reference_estimate(codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum, d):
    """``_fused_search_resident_batch``'s estimate (kernels.py:319-331)."""
    j = {k: jnp.asarray(v) for k, v in dict(
        codes=codes, q=q_glob, norms=norms, factors=factors, cdc=cdc, cluster=cluster,
        probe=probe, csq=csq, csum=csum).items()}
    bits = unpack_bits_jnp(j["codes"], q_glob.shape[1])
    bq = bits @ j["q"].T
    csq_r, csum_r = j["csq"][j["cluster"]], j["csum"][j["cluster"]]
    dot = (2.0 * (j["cdc"][:, None] - bq) - csum_r) / jnp.sqrt(jnp.asarray(d, jnp.float32))
    est = j["norms"][:, None] ** 2 + csq_r + 2.0 * j["norms"][:, None] * dot / j["factors"][:, None]
    est = jnp.where(j["probe"][j["cluster"]], est, jnp.inf)
    # the magnitude of the terms each estimate sums
    mag = (bits @ jnp.abs(j["q"]).T)
    dot_mag = (2.0 * (jnp.abs(j["cdc"])[:, None] + mag) + jnp.abs(csum_r)) / math.sqrt(d)
    scale = (j["norms"][:, None] ** 2 + jnp.abs(csq_r)
             + 2.0 * j["norms"][:, None] * dot_mag / jnp.abs(j["factors"])[:, None])
    return np.asarray(est), np.asarray(scale)


@pytest.mark.parametrize("nq", [1, 13, 17, 256])
@pytest.mark.parametrize("d", [64, 100, 512])
def test_estimate_batch_matches_reference(d, nq, no_cuda_build):
    arrays = _bundle(200, d, nq, nlist=9, seed=d + nq, n_pad_rows=56)
    want, scale = _reference_estimate(*arrays, d=d)
    before = K.packed_dot_batch.launches
    got = K.packed_estimate_batch(*(torch.from_numpy(a) for a in arrays), d=d).numpy()
    assert K.packed_dot_batch.launches == before  # the plain path launches nothing
    assert got.shape == (nq, 256) and got.dtype == np.float32
    want, scale = want.T, scale.T
    masked = np.isinf(want)
    assert masked.any() and (~masked).any()
    np.testing.assert_array_equal(got[masked], np.float32(np.inf))
    assert np.isfinite(got[~masked]).all()
    err = np.abs(got[~masked] - want[~masked])
    assert (err <= ATOL + RTOL * scale[~masked]).all(), err.max()


def test_estimate_batch_is_the_resident_search_arithmetic(no_cuda_build):
    """The plain version is today's CPU arithmetic, transposed: bitwise."""
    t = [torch.from_numpy(a) for a in _bundle(150, 128, 24, nlist=5, seed=3)]
    codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum = t
    bq = K.packed_dot_batch_torch(codes, q_glob)
    est = K._estimate(bq, norms[:, None], factors[:, None], cdc[:, None], csq[cluster],
                      csum[cluster], 128)
    est = est.masked_fill(~probe[cluster], math.inf)
    got = K.packed_estimate_batch(*t, d=128)
    assert got.is_contiguous()
    torch.testing.assert_close(got, est.T, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["cluster_dtype", "mask_shape", "mask_dtype", "table_shape",
                                  "row_shape", "contiguity", "query_group", "cluster_id_past_nlist",
                                  "cluster_id_negative"])
def test_estimate_batch_rejects_bad_inputs(case, no_cuda_build):
    t = [torch.from_numpy(a) for a in _bundle(40, 64, 5, nlist=3, seed=1)]
    kw = {"d": 64}
    if case == "cluster_dtype":
        t[5] = t[5].to(torch.int32)
    elif case == "cluster_id_past_nlist":
        t[5][-1] = 3  # the kernel would read past the [nlist, nq] tables
    elif case == "cluster_id_negative":
        t[5][0] = -1  # torch indexing would wrap it to the last cluster
    elif case == "mask_shape":
        t[6] = t[6][:, :4]
    elif case == "mask_dtype":
        t[6] = t[6].to(torch.uint8)
    elif case == "table_shape":
        t[7] = t[7][:2]
    elif case == "row_shape":
        t[2] = t[2][:39]
    elif case == "contiguity":
        t[8] = torch.zeros((5, 3)).T
    elif case == "query_group":
        kw["query_group"] = 8
    with pytest.raises(ValueError):
        K.packed_estimate_batch(*t, **kw)


def test_launcher_enters_the_device_only_when_it_is_not_current(monkeypatch):
    """``_build.entry``: one binding, the call on the current stream, the
    device context only for another device, and a refused launch raises."""
    calls, entered = [], []

    class Fn:
        argtypes = restype = None

        def __call__(self, *args):
            calls.append(args)
            return 7 if args[0] == "refuse" else 0

    class Lib:
        ls_kernel = Fn()

        class ls_cuda_error_string:  # noqa: N801 - a C symbol's name
            def __new__(cls, err):
                return f"error {err}".encode()

    @contextlib.contextmanager
    def device_ctx(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "current_stream", lambda index: 1234 + index)
    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    launch = _build.entry(Lib, "ls_kernel", [int])
    assert Lib.ls_kernel.restype is not None and len(Lib.ls_kernel.argtypes) == 2
    launch(torch.device("cuda:0"), "a")
    launch(torch.device("cuda"), "b")
    assert not entered and calls == [("a", 1234), ("b", 1234)]
    launch(torch.device("cuda:1"), "c")
    assert entered == [torch.device("cuda:1")] and calls[-1] == ("c", 1235)
    with pytest.raises(RuntimeError, match="ls_kernel launch failed: error 7"):
        launch(torch.device("cuda:0"), "refuse")


def test_resident_batch_search_runs_the_fused_mode(monkeypatch, no_cuda_build):
    """``_fused_search_resident_batch`` takes its [Q, N] estimates from
    ``packed_estimate_batch`` and its top-k along the last axis."""
    t = [torch.from_numpy(a) for a in _bundle(120, 64, 6, nlist=4, seed=5)]
    seen = []
    real = K.packed_estimate_batch

    def spy(*a, **k):
        seen.append(len(a))
        return real(*a, **k)

    monkeypatch.setattr(K, "packed_estimate_batch", spy)
    codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum = t
    dists, idx = K._fused_search_resident_batch(codes, norms, factors, cdc, cluster, probe, csq,
                                                csum, q_glob, None, None, d=64, s=10, k=5,
                                                do_rerank=False)
    assert seen == [9]
    est = real(*t, d=64)
    want_d, want_i = torch.topk(est, 5, dim=1, largest=False, sorted=True)
    torch.testing.assert_close(dists, want_d, rtol=0, atol=0)
    assert torch.equal(idx, want_i)
