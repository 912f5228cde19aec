"""The port's ``packed_scan`` and ``bruteforce_topk`` against the JAX
package's kernels, on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version
(``rabitq.estimate_distances``, the reference's own twin, and the body of
``_bruteforce_jnp``); the JAX side runs its Pallas kernels in interpret
mode and its jnp twins.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them against the same plain versions there).

Tolerance: rtol 1e-5, atol 1e-4 — float32 sums of up to 512 terms taken in
another order; the estimator's and the exact distance's terms reach ~1e3
and cancel, so the absolute floor carries a few ulp of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lakesoul_tpu.vector import kernels as JK
from lakesoul_tpu.vector.rabitq import estimate_distances as jax_estimate
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


def _scan_inputs(n, d, seed=0):
    rng = np.random.default_rng(seed + n + 7 * d)
    d8 = (d + 7) // 8
    codes = rng.integers(0, 256, size=(n, d8), dtype=np.uint8)
    norms = (rng.random(n) * 4).astype(np.float32)
    factors = (rng.random(n) * 0.5 + 0.5).astype(np.float32)
    q = rng.normal(size=d).astype(np.float32)
    return codes, norms, factors, q


@pytest.mark.parametrize("d", [32, 64, 100, 128])
@pytest.mark.parametrize("n", [1, 700, 1537])
def test_packed_scan_matches_pallas_and_estimator(n, d, no_cuda_build):
    codes, norms, factors, q = _scan_inputs(n, d)
    before = K.packed_scan.launches
    got = K.packed_scan(*(torch.from_numpy(a) for a in (codes, norms, factors, q)), d=d).numpy()
    assert K.packed_scan.launches == before  # the plain path launches nothing
    j = [jnp.asarray(a) for a in (codes, norms, factors, q)]
    pallas = np.asarray(JK.packed_scan_pallas(*j, d=d, interpret=True))
    twin = np.asarray(jax_estimate(*j, d=d))
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, twin, rtol=RTOL, atol=ATOL)


def test_packed_scan_short_query_reads_as_zero_padded(no_cuda_build):
    """A query shorter than the code bits (96 of 104) counts as zero-padded,
    and d — not the query's length — scales the estimate, as in the TPU
    body."""
    codes, norms, factors, q = _scan_inputs(300, 100)
    q = q[:96].copy()
    got = K.packed_scan(*(torch.from_numpy(a) for a in (codes, norms, factors, q)), d=100).numpy()
    want = np.asarray(JK.packed_scan_pallas(*(jnp.asarray(a) for a in (codes, norms, factors, q)),
                                            d=100, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [32, 100, 128])
def test_packed_scan_empty(d, no_cuda_build):
    codes, norms, factors, q = _scan_inputs(0, d)
    assert K.packed_scan(*(torch.from_numpy(a) for a in (codes, norms, factors, q)),
                         d=d).shape == (0,)


def _bf_inputs(n, dd, seed=0):
    rng = np.random.default_rng(seed + n + 3 * dd)
    return (rng.normal(size=(n, dd)).astype(np.float32) * 2,
            rng.normal(size=dd).astype(np.float32))


@pytest.mark.parametrize("dd", [32, 64, 100, 128])
@pytest.mark.parametrize("n", [1, 700, 3000])
def test_bruteforce_distances_match_pallas_and_jnp(n, dd, no_cuda_build):
    x, q = _bf_inputs(n, dd)
    before = K.bruteforce_distances.launches
    got = K.bruteforce_distances(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    assert K.bruteforce_distances.launches == before
    pallas = np.asarray(JK.bruteforce_distances_pallas(jnp.asarray(x), jnp.asarray(q),
                                                       interpret=True))
    twin = np.asarray(JK._bruteforce_jnp(jnp.asarray(x), jnp.asarray(q)))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, twin, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 10, 5000])
@pytest.mark.parametrize("dd", [32, 100])
def test_bruteforce_topk_matches_jax(k, dd, no_cuda_build):
    x, q = _bf_inputs(3000, dd, seed=k)
    dists, idx = K.bruteforce_topk(torch.from_numpy(x), torch.from_numpy(q), k)
    kk = min(k, len(x))
    # the Pallas kernel in interpret mode + a top-k (the reference's
    # bruteforce_topk(pallas=True) compiles for the TPU only), and the jnp path
    pd = np.asarray(JK.bruteforce_distances_pallas(jnp.asarray(x), jnp.asarray(q), interpret=True))
    order = np.argsort(pd, kind="stable")[:kk]
    jd, ji = JK.bruteforce_topk(x, q, k, pallas=False)
    for want_d, want_i in ((pd[order], order), (np.asarray(jd), np.asarray(ji))):
        assert dists.shape == (kk,) and want_d.shape == (kk,)
        np.testing.assert_allclose(dists.numpy(), want_d, rtol=RTOL, atol=ATOL)
        # ids equal except where the reference's distances tie within ATOL
        for i in np.flatnonzero(idx.numpy() != want_i):
            tie = np.abs(want_d - want_d[i]) <= ATOL
            tie[i] = False
            assert tie.any(), (i, idx.numpy()[i], want_i[i])


@pytest.mark.parametrize("case", ["dtype", "shape", "width", "contiguity", "device"])
def test_new_wrappers_reject_bad_inputs(case):
    codes = torch.zeros((4, 8), dtype=torch.uint8)
    norms, factors = torch.ones(4), torch.ones(4)
    q = torch.zeros(64)
    x = torch.zeros((4, 64))
    if case == "dtype":
        norms, x = norms.double(), x.double()
    elif case == "shape":
        factors, q = torch.ones(5), torch.zeros(63)
    elif case == "width":
        q = torch.zeros(65)
    elif case == "contiguity":
        norms, x = torch.ones(8)[::2], torch.zeros((64, 4)).T
    elif case == "device":  # neither cpu nor cuda: no fallback
        codes, norms, factors, q, x = (t.to("meta") for t in (codes, norms, factors, q, x))
    with pytest.raises(ValueError):
        K.packed_scan(codes, norms, factors, q, d=64)
    with pytest.raises(ValueError):
        K.bruteforce_distances(x, q)


def test_build_lists_every_kernel_source():
    """Every CUDA source the port loads is in the build list, and the shared
    header is part of each library's hash."""
    assert _build.SOURCES == ("packed_dot", "ragged_score", "bruteforce")
    assert (_build.CSRC / "ls_common.cuh").exists()
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").read_text().count('#include "ls_common.cuh"') == 1
