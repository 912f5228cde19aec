"""The single-query kernel's nibble-table design and its fused estimate
mode, held against the JAX package on the CPU.

- A numpy model of the kernel's arithmetic (``packed_dot.cu``,
  ``packed_dot_kernel``): 16-entry tables T_k[v] = the sum of q[4k + j]
  over the bits j of v, MSB first (a byte's high nibble is table 2p, its
  low nibble 2p + 1), zero weight past d, built in the kernel's layout;
  then a row's 2·d8 lookups summed in the kernel's order.  It gives the
  reference's ``packed_dot_pallas`` (interpret mode) at rtol 1e-5,
  atol 1e-4: only the order of the f32 sums differs.
- ``packed_estimate`` on CPU tensors equals the estimate of the
  reference's ``_fused_search_resident`` (``lakesoul_tpu/vector/
  kernels.py:268-277``, rebuilt in jnp here around ``packed_dot_pallas``
  in interpret mode), with masked entries exactly +inf.  Each estimate is a
  sum of terms that cancel (norm², csq and 2·norm·dot/factor, dot itself a
  sum over bits), so the tolerance is |port − reference| <= 1e-4 + 1e-5 ·
  (norm² + |csq| + 2·norm/|factor| · (2·|cdc| + 2·bits·|q| + |csum|)/√d),
  as ``tests/test_torch_vector_fused.py`` states it for the batch.
- The resident single search runs ``packed_estimate`` and still answers as
  the JAX package does.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds both
modes against these plain versions there).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lakesoul_tpu.vector.config import VectorIndexConfig as JaxConfig
from lakesoul_tpu.vector.index import IvfRabitqIndex as JaxIndex
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu.vector.kernels import packed_dot_pallas
from lakesoul_tpu.vector.rabitq import unpack_bits_jnp
from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams
from lakesoul_tpu_torch.vector import kernels as K
from test_torch_vector_index import _data, assert_same_topk, jax_state

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Fails the test if anything tries to build or load a CUDA kernel."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


# --------------------------------------------------------------------------
# the nibble-table arithmetic
# --------------------------------------------------------------------------


def nibble_tables(q: np.ndarray, d8: int) -> np.ndarray:
    """The kernel's tables [32 · words, 16] f32 (words = ⌈d8 / 16⌉): table k
    covers dims 4k..4k+3, entry v sums q over the bits of v, bit 3 − j for
    dim 4k + j, j ascending from 0; dims at or past len(q) weigh 0."""
    words = (d8 + 15) // 16
    qz = np.zeros(32 * words * 4, np.float32)
    qz[: len(q)] = q
    t = np.zeros((32 * words, 16), np.float32)
    for v in range(16):
        for j in range(4):
            if (v >> (3 - j)) & 1:
                t[:, v] += qz[j::4]
    return t


def nibble_dot(codes: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """A row's sum in the kernel's order: four f32 sums (byte parity ×
    nibble), bytes ascending in each, then (s0 + s1) + (s2 + s3)."""
    n, d8 = codes.shape
    acc = np.zeros((4, n), np.float32)
    for p in range(d8):
        hi, lo = codes[:, p] >> 4, codes[:, p] & 15
        acc[2 * (p & 1)] += tables[2 * p][hi]
        acc[2 * (p & 1) + 1] += tables[2 * p + 1][lo]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 300, 1537])
@pytest.mark.parametrize("d", [100, 512])
def test_nibble_tables_match_pallas(d, n, seed):
    rng = np.random.default_rng(seed * 1000 + d + n)
    d8 = (d + 7) // 8
    codes = rng.integers(0, 256, size=(n, d8), dtype=np.uint8)
    q = rng.normal(size=d).astype(np.float32)
    got = nibble_dot(codes, nibble_tables(q, d8))
    want = np.asarray(packed_dot_pallas(jnp.asarray(codes), jnp.asarray(q), interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_nibble_layout_is_msb_first_with_zero_weight_past_d():
    """Bit 7 of byte p stands for dim 8p (table 2p, entry 8); bit 0 for
    dim 8p + 7 (table 2p + 1, entry 1).  At d = 100 (d8 = 13) the last
    byte's low nibble, dims 100-103, weighs nothing, and the tables the
    kernel keeps for its 16-byte word past the 13 bytes are all zero."""
    q = np.arange(1, 101, dtype=np.float32)  # q[i] = i + 1
    t = nibble_tables(q, 13)
    assert t.shape == (32, 16)
    assert t[0, 8] == q[0] and t[0, 1] == q[3] and t[1, 8] == q[4] and t[1, 1] == q[7]
    assert t[24, 15] == q[96] + q[97] + q[98] + q[99]
    assert not t[25:].any()
    codes = np.zeros((3, 13), np.uint8)
    codes[0, 0] = 0x80
    codes[1, 12] = 0x0F  # dims 100-103 only
    codes[2, 12] = 0xFF
    np.testing.assert_array_equal(nibble_dot(codes, t), [1.0, 0.0, 97 + 98 + 99 + 100])


# --------------------------------------------------------------------------
# the estimate mode
# --------------------------------------------------------------------------


def _bundle(n, d, nlist, share, seed, n_pad_rows=0):
    """A seeded resident bundle as ``_get_device_bundle`` lays it out: rows
    sorted by cluster, then pad rows (codes 0, PAD_NORM, PAD_FACTOR, cdc 0,
    cluster 0); per-cluster tables as ``_search_device_resident`` makes
    them, ``share`` of the clusters probed (at least one, and one not)."""
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
    q_glob = (rng.normal(size=d) / math.sqrt(d)).astype(np.float32)
    probe = rng.random(nlist) < share
    probe[cluster[0]], probe[cluster[-1 - n_pad_rows]] = True, False
    csq = rng.uniform(0, 4, nlist).astype(np.float32)
    csum = rng.normal(size=nlist).astype(np.float32)
    return codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum


def _reference_estimate(codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum, d):
    """``_fused_search_resident``'s estimate (kernels.py:268-277), bq from
    ``packed_dot_pallas`` in interpret mode; and the magnitude of the terms
    each estimate sums."""
    j = {k: jnp.asarray(v) for k, v in dict(
        codes=codes, q=q_glob, norms=norms, factors=factors, cdc=cdc, cluster=cluster,
        probe=probe, csq=csq, csum=csum).items()}
    bq = packed_dot_pallas(j["codes"], j["q"], interpret=True)
    csq_r, csum_r = j["csq"][j["cluster"]], j["csum"][j["cluster"]]
    dot = (2.0 * (j["cdc"] - bq) - csum_r) / jnp.sqrt(jnp.asarray(d, jnp.float32))
    est = j["norms"] * j["norms"] + csq_r + 2.0 * j["norms"] * dot / j["factors"]
    est = jnp.where(j["probe"][j["cluster"]], est, jnp.inf)
    mag = unpack_bits_jnp(j["codes"], len(q_glob)) @ jnp.abs(j["q"])
    dot_mag = (2.0 * (jnp.abs(j["cdc"]) + mag) + jnp.abs(csum_r)) / math.sqrt(d)
    scale = j["norms"] ** 2 + jnp.abs(csq_r) + 2.0 * j["norms"] * dot_mag / jnp.abs(j["factors"])
    return np.asarray(est), np.asarray(scale)


@pytest.mark.parametrize("share", [0.03, 0.5])
@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("d", [64, 100, 512])
def test_estimate_matches_reference(d, n, share, no_cuda_build):
    arrays = _bundle(n, d, nlist=64, share=share, seed=d + n, n_pad_rows=24)
    want, scale = _reference_estimate(*arrays, d=d)
    before = K.packed_dot.launches
    got = K.packed_estimate(*(torch.from_numpy(a) for a in arrays), d=d).numpy()
    assert K.packed_dot.launches == before  # the plain path launches nothing
    assert got.shape == (n + 24,) and got.dtype == np.float32
    masked = np.isinf(want)
    assert masked.any() and (~masked).any()
    np.testing.assert_array_equal(got[masked], np.float32(np.inf))
    assert np.isfinite(got[~masked]).all()
    err = np.abs(got[~masked] - want[~masked])
    assert (err <= ATOL + RTOL * scale[~masked]).all(), err.max()


def test_estimate_is_the_resident_search_arithmetic(no_cuda_build):
    """The plain version is the resident search's CPU arithmetic: bitwise."""
    t = [torch.from_numpy(a) for a in _bundle(300, 128, nlist=7, share=0.4, seed=3)]
    codes, q_glob, norms, factors, cdc, cluster, probe, csq, csum = t
    bq = K.packed_dot_torch(codes, q_glob)
    est = K._estimate(bq, norms, factors, cdc, csq[cluster], csum[cluster], 128)
    est = est.masked_fill(~probe[cluster], math.inf)
    torch.testing.assert_close(K.packed_estimate(*t, d=128), est, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["cluster_dtype", "mask_shape", "mask_dtype", "table_shape",
                                  "row_shape", "query_shape", "contiguity",
                                  "cluster_id_past_nlist", "cluster_id_negative"])
def test_estimate_rejects_bad_inputs(case, no_cuda_build):
    t = [torch.from_numpy(a) for a in _bundle(40, 64, nlist=3, share=0.5, seed=1)]
    if case == "cluster_dtype":
        t[5] = t[5].to(torch.int32)
    elif case == "cluster_id_past_nlist":
        t[5][-1] = 3  # the kernel would read past the [nlist] tables
    elif case == "cluster_id_negative":
        t[5][0] = -1  # torch indexing would wrap it to the last cluster
    elif case == "mask_shape":
        t[6] = t[6][None]  # the batch kernel's [nlist, nq]
    elif case == "mask_dtype":
        t[6] = t[6].to(torch.uint8)
    elif case == "table_shape":
        t[7] = t[7][:2]
    elif case == "row_shape":
        t[2] = t[2][:39]
    elif case == "query_shape":
        t[1] = t[1][None]
    elif case == "contiguity":
        t[8] = torch.zeros(6)[::2]
    with pytest.raises(ValueError):
        K.packed_estimate(*t, d=64)


def test_estimate_of_no_rows(no_cuda_build):
    t = [torch.from_numpy(a) for a in _bundle(5, 64, nlist=2, share=0.5, seed=2)]
    for i in (0, 2, 3, 4, 5):
        t[i] = t[i][:0]
    assert K.packed_estimate(*t, d=64).shape == (0,)


# --------------------------------------------------------------------------
# the resident single search
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rot, dim", [("fht", 100), ("matrix", 100)])
def test_resident_search_runs_the_estimate_mode(rot, dim, monkeypatch, no_cuda_build):
    """``search`` with the resident cache takes its estimates from one
    ``packed_estimate`` call a query and answers as the JAX package does."""
    x, ids, q = _data(dim)
    ref = JaxIndex.train(x, ids, JaxConfig("v", dim, nlist=16, rotator=rot, seed=5),
                         keep_raw=True)
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    ref.enable_device_cache()
    port.enable_device_cache()
    calls = []
    real = K.packed_estimate

    def spy(*a, **k):
        calls.append(a[6].sum().item())  # clusters probed
        return real(*a, **k)

    monkeypatch.setattr(K, "packed_estimate", spy)
    params = dict(top_k=10, nprobe=4, rerank_depth=40)
    for qi in q[:6]:
        assert_same_topk(*ref.search(qi, JaxParams(**params)),
                         *port.search(qi, SearchParams(**params)))
    assert calls == [4] * 6
