"""The port's ex-codes (``total_bits`` 2-16) against the JAX package's, on
the CPU: the quantizer, an index trained by the reference and carried over
with no math (``IvfRabitqIndex.from_state``, and manifests written by each
package and read by the other), inserts and merges, the endpoint, the
missing-scales raise, and a k-means that gives the same bits on every run.
The JAX side runs as on any CPU: its jnp path.

Tolerances.  Codes: equal, except that at most 0.1 % may sit one level
apart and none further — the two packages' norms (and, for the matrix
rotator, rotations) differ in their last bits, so a code that sits on a .5
boundary can round either way (at 16 bits ~1e-4 of them do, none below).
Scales, norms and factors: rtol 1e-5.  ``code_dot_c`` sums terms
u_hat·P(c): |port - reference| <= 1e-4 + 1e-5 · Σ|u_hat · P(c)| (the form
of the estimate checks).  Search results: ``assert_same_topk`` of
``test_torch_vector_index`` (ids equal except ties within 1e-5; distances
at rtol 1e-5 with an absolute floor of 1e-5 of the list's largest).
"""

import numpy as np
import pytest
import torch

from lakesoul_tpu.errors import VectorIndexError as JaxVectorIndexError
from lakesoul_tpu.vector import kmeans as jax_kmeans
from lakesoul_tpu.vector.config import VectorIndexConfig as JaxConfig
from lakesoul_tpu.vector.index import IvfRabitqIndex as JaxIndex
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore
from lakesoul_tpu.vector.rabitq import RabitqQuantizer as JaxQuantizer
from lakesoul_tpu.vector.serving import AnnEndpoint as JaxEndpoint
from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.vector import AnnEndpoint, IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.vector import kmeans as port_kmeans
from lakesoul_tpu_torch.vector.manifest import ManifestStore
from lakesoul_tpu_torch.vector.rabitq import RabitqQuantizer
from test_torch_vector_index import _data, assert_same_topk, jax_state

CODE_SHARE = 1e-3  # codes one level apart, at most
RTOL, ATOL = 1e-5, 1e-4
BITS = (2, 4, 8, 9)  # 9: int16 codes
P = dict(top_k=10, nprobe=4, rerank_depth=40)


def _quantize_both(rot, dim, bits, seed=1):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(1500, dim)) * 3).astype(np.float32)
    c = rng.normal(size=dim).astype(np.float32)
    ref = JaxQuantizer(dim, rotator=rot, seed=3)
    port = RabitqQuantizer(dim, rotator=rot, seed=3, device="cpu")
    want = ref.quantize_ex(v, c, bits)
    got = [t.numpy() for t in port.quantize_ex(torch.from_numpy(v), torch.from_numpy(c), bits)]
    return ref, v, c, want, got


@pytest.mark.parametrize("bits", [2, 4, 8, 9, 16])
@pytest.mark.parametrize("rot,dim", [("fht", 100), ("matrix", 100)])
def test_quantize_ex_matches_reference(rot, dim, bits):
    ref, v, c, want, got = _quantize_both(rot, dim, bits)
    codes_r, scales_r, norms_r, factors_r, cdc_r = want
    codes_p, scales_p, norms_p, factors_p, cdc_p = got
    assert codes_p.dtype == codes_r.dtype == (np.int8 if bits <= 8 else np.int16)
    assert codes_p.shape == codes_r.shape == (len(v), ref.padded_dim)
    step = np.abs(codes_p.astype(np.int64) - codes_r.astype(np.int64))
    assert step.max() <= 1 and (step > 0).mean() <= CODE_SHARE, (step.max(), (step > 0).mean())
    qmax = 2 ** (bits - 1) - 1
    assert np.abs(codes_p).max() <= qmax
    for a, b in ((scales_p, scales_r), (norms_p, norms_r), (factors_p, factors_r)):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    terms = np.abs(codes_r * scales_r[:, None]) @ np.abs(ref.rotate(c))
    assert (np.abs(cdc_p - cdc_r) <= ATOL + RTOL * terms).all()


@pytest.mark.parametrize("bits", [1, 17])
def test_quantize_ex_rejects_bits_out_of_range(bits):
    with pytest.raises(JaxVectorIndexError, match=r"\[2, 16\]"):
        JaxQuantizer(16).quantize_ex(np.zeros((1, 16), np.float32), np.zeros(16, np.float32), bits)
    with pytest.raises(VectorIndexError, match=r"\[2, 16\]"):
        RabitqQuantizer(16, device="cpu").quantize_ex(torch.zeros(1, 16), torch.zeros(16), bits)


@pytest.mark.parametrize("bits", [4, 9])
def test_empty_cluster_has_the_reference_layout(bits):
    ref = JaxIndex(JaxConfig("v", 100, nlist=2, total_bits=bits))
    port = IvfRabitqIndex(VectorIndexConfig("v", 100, nlist=2, total_bits=bits), device="cpu")
    want = ref._make_cluster(np.zeros((0, 100), np.float32), np.zeros(0, np.uint64),
                             np.zeros(100, np.float32))
    got = port._make_cluster(torch.zeros(0, 100), np.zeros(0, np.uint64), torch.zeros(100))
    for f in ("codes", "norms", "factors", "code_dot_c", "scales", "raw"):
        a, b = getattr(want, f), getattr(got, f).numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f


# ------------------------------------------------- a reference index carried
@pytest.fixture(scope="module", params=BITS, ids=lambda b: f"bits{b}")
def pair(request):
    """(jax index, port index, queries): an ex index the reference trained,
    with a delta segment, carried into the port by ``from_state``."""
    x, ids, q = _data(64)
    ref = JaxIndex.train(x[:1300], ids[:1300],
                         JaxConfig("v", 64, nlist=16, total_bits=request.param, seed=5))
    ref.insert_batch(x[1300:], ids[1300:])
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    return ref, port, q


@pytest.fixture(params=[False, True], ids=["nocache", "cache"])
def cached_pair(request, pair):
    ref, port, q = pair
    for ix in (ref, port):
        ix._device_cache_enabled = request.param
    return ref, port, q


def test_carried_state_is_the_reference_arrays(pair):
    ref, port, _ = pair
    bits = ref.config.total_bits
    for a, b in zip(ref.clusters + sum(ref.deltas, []), port.clusters + sum(port.deltas, [])):
        assert b.codes.dtype == (torch.int8 if bits <= 8 else torch.int16)
        for f in ("codes", "norms", "factors", "code_dot_c", "scales", "raw"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(a, f))


def test_search(cached_pair):
    ref, port, q = cached_pair
    for qi in q[:8]:
        assert_same_topk(*ref.search(qi, JaxParams(**P)), *port.search(qi, SearchParams(**P)))


def test_search_without_rerank(cached_pair):
    ref, port, q = cached_pair
    for qi in q[:4]:
        assert_same_topk(*ref.search(qi, JaxParams(**P), rerank=False),
                         *port.search(qi, SearchParams(**P), rerank=False))


@pytest.mark.parametrize("nq", [1, 8, 300])
def test_batch_search(pair, nq):
    ref, port, q = pair
    ref.enable_device_cache()
    port.enable_device_cache()
    r_ids, r_d = ref.batch_search(q[:nq], JaxParams(**P))
    g_ids, g_d = port.batch_search(q[:nq], SearchParams(**P))
    assert len(g_ids) == len(g_d) == nq
    for a, b, c, d in zip(r_ids, r_d, g_ids, g_d):
        assert_same_topk(a, b, c, d)


def test_search_async_and_endpoint(pair):
    ref, port, q = pair
    ref.enable_device_cache()
    port.enable_device_cache()
    resolvers = [port.search_async(qi, SearchParams(**P)) for qi in q[:4]]
    for qi, resolve in reversed(list(zip(q[:4], resolvers))):
        assert_same_topk(*ref.search_async(qi, JaxParams(**P))(), *resolve())
    with AnnEndpoint(port, SearchParams(**P), max_wait_ms=20.0, name="port-ex") as ep, \
            JaxEndpoint(ref, JaxParams(**P), max_wait_ms=20.0, name="jax-ex") as jep:
        futs = [(ep.submit(qi), jep.submit(qi)) for qi in q[:12]]
        for got, want in futs:
            assert_same_topk(*want.result(timeout=60), *got.result(timeout=60))


def test_a_query_alone_and_in_a_batch(pair):
    """A query's answer does not depend on the batch: the resident ex product
    is taken in float64, so its float32 values are the same."""
    _, port, q = pair
    port.enable_device_cache()
    ids, dists = port.batch_search(q[:256], SearchParams(**P))
    for i in (0, 7, 255):
        one_ids, one_d = port.batch_search(q[i:i + 1], SearchParams(**P))
        np.testing.assert_array_equal(one_ids[0], ids[i])
        np.testing.assert_array_equal(one_d[0], dists[i])


@pytest.mark.parametrize("bits", [4, 9])
def test_insert_and_merge_match_reference(bits):
    x, ids, q = _data(64, seed=1)
    ref = JaxIndex.train(x[:1000], ids[:1000], JaxConfig("v", 64, nlist=8, total_bits=bits))
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    ref.insert_batch(x[1000:], ids[1000:])
    port.insert_batch(x[1000:], ids[1000:])
    assert port.num_vectors == ref.num_vectors == 1500
    for c in range(8):
        assert len(port.deltas[c]) == len(ref.deltas[c])
        for a, b in zip(ref.deltas[c], port.deltas[c]):
            np.testing.assert_array_equal(b.ids, a.ids)
            step = np.abs(b.codes.numpy().astype(np.int64) - a.codes.astype(np.int64))
            assert step.max(initial=0) <= 1 and (step > 0).mean() <= CODE_SHARE
            np.testing.assert_allclose(b.scales.numpy(), a.scales, rtol=RTOL)
    for qi in q[:6]:
        assert_same_topk(*ref.search(qi, JaxParams(**P)), *port.search(qi, SearchParams(**P)))
    ref.merge_deltas()
    port.merge_deltas()
    assert all(not d for d in port.deltas)
    for a, b in zip(ref.clusters, port.clusters):
        np.testing.assert_array_equal(b.ids, a.ids)
        assert len(b.scales) == len(a.scales) == len(a.ids)
    ref.enable_device_cache()
    port.enable_device_cache()
    r_ids, r_d = ref.batch_search(q[:16], JaxParams(**P))
    g_ids, g_d = port.batch_search(q[:16], SearchParams(**P))
    for a, b, c, d in zip(r_ids, r_d, g_ids, g_d):
        assert_same_topk(a, b, c, d)


# --------------------------------------------------------------- manifests
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ex_manifest_opens_in_the_other_package(tmp_path, writer, bits):
    x, ids, q = _data(64, seed=3)
    ref = JaxIndex.train(x[:1200], ids[:1200], JaxConfig("v", 64, nlist=8, total_bits=bits))
    ref.insert_batch(x[1200:], ids[1200:])  # delta segments ride along
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    if writer == "jax":
        JaxManifestStore(str(tmp_path)).write_index(ref)
        got, want = ManifestStore(tmp_path).read_latest(device="cpu"), ref
    else:
        ManifestStore(tmp_path).write_index(port)
        got, want = port, JaxManifestStore(str(tmp_path)).read_latest()
    assert got.config.total_bits == want.config.total_bits == bits
    for a, b in zip(want.clusters + sum(want.deltas, []), got.clusters + sum(got.deltas, [])):
        for f in ("codes", "scales", "norms", "factors", "ids", "code_dot_c", "raw"):
            b_f = getattr(b, f)
            np.testing.assert_array_equal(b_f if isinstance(b_f, np.ndarray) else b_f.numpy(),
                                          getattr(a, f))
    for qi in q[:6]:
        assert_same_topk(*want.search(qi, JaxParams(**P)), *got.search(qi, SearchParams(**P)))


def test_legacy_ex_manifest_without_scales_opens_as_one_bit(tmp_path):
    """A shard written when ``total_bits > 1`` was accepted but only 1-bit
    quantization existed has no scales: both packages read it as 1-bit."""
    x, ids, q = _data(64, n=600)
    legacy = JaxIndex.train(x, ids, JaxConfig("v", 64, nlist=4, total_bits=1))
    legacy.config = JaxConfig("v", 64, nlist=4, total_bits=4)
    JaxManifestStore(str(tmp_path)).write_index(legacy)
    got = ManifestStore(tmp_path).read_latest(device="cpu")
    want = JaxManifestStore(str(tmp_path)).read_latest()
    assert got.config.total_bits == want.config.total_bits == 1
    assert all(c.scales is None for c in got.clusters)
    for qi in q[:4]:
        assert_same_topk(*want.search(qi, JaxParams(**P)), *got.search(qi, SearchParams(**P)))


@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
def test_ex_segment_without_scales_raises(cache):
    """An ex config whose segments carry no scales loads, and its search
    raises, resident or not, as the reference's does."""
    x, ids, q = _data(64, n=600)
    ref = JaxIndex.train(x, ids, JaxConfig("v", 64, nlist=4, total_bits=4))
    state = jax_state(ref)
    for seg in state["clusters"]:
        seg["scales"] = None
    for c in ref.clusters:
        c.scales = None
    port = IvfRabitqIndex.from_state(state, device="cpu")
    if cache:
        ref.enable_device_cache()
        port.enable_device_cache()
    with pytest.raises(JaxVectorIndexError, match="no scales"):
        ref.search(q[0], JaxParams(**P))
    with pytest.raises(VectorIndexError, match="no scales"):
        port.search(q[0], SearchParams(**P))
    with pytest.raises(VectorIndexError, match="no scales"):
        port.batch_search(q[:300], SearchParams(**P))


# ------------------------------------------------------------------ k-means
def test_kmeans_gives_the_same_bits_twice(monkeypatch):
    """Two runs from one seed give bitwise-equal centroids and assignments,
    with the one-hot update split over several row chunks."""
    monkeypatch.setattr(port_kmeans, "_ASSIGN_CHUNK", 700)
    x, _, _ = _data(32, n=3000, centers=16, seed=9)
    c1, a1 = port_kmeans.kmeans(torch.from_numpy(x), 16, iters=10, seed=4)
    c2, a2 = port_kmeans.kmeans(torch.from_numpy(x), 16, iters=10, seed=4)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


@pytest.mark.parametrize("chunk", [64, 300])  # 300: a short last chunk
def test_chunked_kmeans_matches_reference(monkeypatch, chunk):
    monkeypatch.setattr(port_kmeans, "_ASSIGN_CHUNK", chunk)
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(6, 16)).astype(np.float32) * 10
    x = (centers[rng.integers(0, 6, 1000)] + rng.normal(size=(1000, 16))).astype(np.float32)
    ref_c, ref_a = jax_kmeans.kmeans(x, 6, iters=8, seed=2)
    c, a = port_kmeans.kmeans(torch.from_numpy(x), 6, iters=8, seed=2)
    np.testing.assert_allclose(c.numpy(), ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a.numpy(), ref_a)


def test_segment_sums_equal_index_add():
    """The chunked one-hot update sums exactly what a segment sum would."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-8, 8, (500, 8)).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, 5, 500))
    want = torch.zeros(7, 8).index_add_(0, assign, x)
    assert torch.equal(port_kmeans._segment_sums(x, assign, 7), want)  # integers: exact


def test_train_is_reproducible_and_keeps_the_reference_clusters():
    x, ids, _ = _data(64, n=1200, centers=8, seed=7)
    cfg = dict(dim=64, nlist=8, seed=11, total_bits=4)
    ref = JaxIndex.train(x, ids, JaxConfig("v", **cfg))
    a = IvfRabitqIndex.train(x, ids, VectorIndexConfig("v", **cfg), device="cpu")
    b = IvfRabitqIndex.train(x, ids, VectorIndexConfig("v", **cfg), device="cpu")
    for ca, cb, cr in zip(a.clusters, b.clusters, ref.clusters):
        np.testing.assert_array_equal(ca.ids, cr.ids)
        for f in ("codes", "scales", "norms", "factors", "code_dot_c"):
            assert torch.equal(getattr(ca, f), getattr(cb, f)), f
