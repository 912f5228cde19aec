"""The port's packed-code products against the JAX package's kernels, on the
CPU.

``packed_dot`` / ``packed_dot_batch`` on a CPU tensor take their plain
PyTorch versions (unpack, then matmul); the JAX side runs its Pallas kernels
in interpret mode, as ``tests/test_vector.py`` does, and its jnp twin.  The
CUDA kernels themselves run only on the card (``chip_smoke.py`` holds them
against the same plain versions there).

Tolerance: rtol 1e-5, atol 1e-4 — float32 sums of up to 512 terms taken in
another order; the queries are standard normal, so sums reach ~30 and a few
ulp of difference is ~1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lakesoul_tpu.vector.kernels import (
    _packed_dot_jnp,
    packed_dot_batch_pallas,
    packed_dot_pallas,
)
from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.vector import kernels as K
from lakesoul_tpu_torch.analysis.arm import armed

RTOL, ATOL = 1e-5, 1e-4


def _inputs(n, d, nq, seed=0):
    rng = np.random.default_rng(seed + n + 7 * d + 31 * nq)
    d8 = (d + 7) // 8
    codes = rng.integers(0, 256, size=(n, d8), dtype=np.uint8)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    return codes, q


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Fails the test if anything tries to build or load a CUDA kernel."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("d", [64, 100, 512])
@pytest.mark.parametrize("n", [1, 700, 1537])
def test_packed_dot_matches_pallas_and_jnp(n, d, no_cuda_build):
    codes, q = _inputs(n, d, 1)
    before = K.packed_dot.launches
    got = K.packed_dot(torch.from_numpy(codes), torch.from_numpy(q[0])).numpy()
    assert K.packed_dot.launches == before  # the plain path launches nothing
    pallas = np.asarray(packed_dot_pallas(jnp.asarray(codes), jnp.asarray(q[0]), interpret=True))
    twin = np.asarray(_packed_dot_jnp(jnp.asarray(codes), jnp.asarray(q[0])))
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, twin, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nq", [1, 8, 13, 17])
@pytest.mark.parametrize("d", [64, 100, 512])
@pytest.mark.parametrize("n", [1, 700, 1537])
def test_packed_dot_batch_matches_pallas(n, d, nq, no_cuda_build):
    codes, q = _inputs(n, d, nq)
    before = K.packed_dot_batch.launches
    got = K.packed_dot_batch(torch.from_numpy(codes), torch.from_numpy(q)).numpy()
    assert K.packed_dot_batch.launches == before
    want = np.asarray(packed_dot_batch_pallas(jnp.asarray(codes), jnp.asarray(q), interpret=True))
    assert got.shape == (n, nq) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [64, 100, 512])
def test_empty_code_set(d, no_cuda_build):
    """N = 0: the reference's callers return early (index.py search and
    _get_device_bundle) and its kernels do not take an empty grid; the port's
    wrappers return empty results of the right shape."""
    codes, q = _inputs(0, d, 8)
    assert K.packed_dot(torch.from_numpy(codes), torch.from_numpy(q[0])).shape == (0,)
    assert K.packed_dot_batch(torch.from_numpy(codes), torch.from_numpy(q)).shape == (0, 8)


def test_bits_past_d_get_zero_weight():
    """d = 100 in 13 bytes: the last byte's 4 low bits stand past d and must
    not count, whatever they hold."""
    codes = np.full((3, 13), 0xFF, np.uint8)
    q = np.ones((2, 100), np.float32)
    np.testing.assert_array_equal(
        K.packed_dot_batch(torch.from_numpy(codes), torch.from_numpy(q)).numpy(),
        np.full((3, 2), 100.0, np.float32),
    )


@pytest.mark.parametrize(
    "nq, group", [(1, 16), (8, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (256, 64)]
)
def test_batch_query_tile_is_the_narrowest_that_holds_nq(nq, group):
    assert K.pick_query_group(nq) == group


def test_forced_query_tile_must_exist(no_cuda_build):
    codes, q = _inputs(5, 64, 3)
    with pytest.raises(ValueError, match="query_group"):
        K.packed_dot_batch(torch.from_numpy(codes), torch.from_numpy(q), query_group=1)


@pytest.mark.parametrize("case", ["dtype", "shape", "width", "contiguity", "device"])
def test_wrapper_rejects_bad_inputs(case):
    codes = torch.zeros((4, 8), dtype=torch.uint8)
    qb = torch.zeros((2, 64), dtype=torch.float32)  # packed_dot_batch's query
    q1 = torch.zeros(64, dtype=torch.float32)  # packed_dot's query
    if case == "dtype":
        codes = codes.to(torch.int32)
    elif case == "shape":
        qb, q1 = qb[None], qb
    elif case == "width":
        qb, q1 = torch.zeros((2, 65)), torch.zeros(65)
    elif case == "contiguity":
        qb, q1 = torch.zeros((64, 2)).T, torch.zeros(128)[::2]
    elif case == "device":  # neither cpu nor cuda: no fallback
        codes, qb, q1 = codes.to("meta"), qb.to("meta"), q1.to("meta")
    with pytest.raises(ValueError):
        K.packed_dot_batch(codes, qb)
    with pytest.raises(ValueError):
        K.packed_dot(codes, q1)


def test_build_needs_nvcc_and_names_its_sources(monkeypatch, tmp_path):
    """The build reads csrc/ only, keys the library on source + flags, and
    without a CUDA toolkit raises instead of falling back."""
    assert all((_build.CSRC / f"{s}.cu").exists() for s in _build.SOURCES)
    path = _build.library_path("packed_dot")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    from lakesoul_tpu_torch.errors import ConfigError

    with pytest.raises(ConfigError, match="nvcc"):
        _build.build()


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
