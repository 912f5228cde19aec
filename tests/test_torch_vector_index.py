"""The port's IVF-RaBitQ index against the JAX package's, on the CPU.

An index is built with the JAX package and carried into the port with no
math — through ``IvfRabitqIndex.from_state`` and through the manifest
reader after ``ManifestStore.write_index`` — and the two answer the same
seeded queries.  The JAX side runs as on any CPU: its jnp path.

Tolerances: result ids must be equal except where two distances tie within
1e-5 (relative); distances agree at rtol 1e-5, with an absolute floor of
1e-5 times the largest distance in the list (never under 1e-4).  Both sides
compute in float32 but in another summation order (BLAS vs torch matmuls,
numpy vs torch reductions).  Each distance is a sum of terms as large as
the list's largest distance that cancel (``||r||² + ||xc||² - 2<r, q>``),
so its rounding error scales with those terms, not with its own value: a
near-zero estimate at the head of a list carries the error of the ~1e2
terms it came from.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lakesoul_tpu.vector.config import VectorIndexConfig as JaxConfig
from lakesoul_tpu.vector.index import IvfRabitqIndex as JaxIndex
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore
from lakesoul_tpu_torch.errors import ConfigError, VectorIndexError
from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.vector.manifest import ManifestStore
from lakesoul_tpu_torch.vector.oracle import exact_topk, recall_at_k
from lakesoul_tpu_torch.analysis.arm import armed

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5

# (rotator, dim): fht pads 100 → 128 dims; matrix keeps 100 dims, so codes
# have d8 = 13 and the last byte carries 4 bits past d
LAYOUTS = [("fht", 100), ("matrix", 100)]


def _data(dim, n=1500, centers=12, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim)).astype(np.float32) * 3.0
    x = c[rng.integers(0, centers, n)] + rng.normal(size=(n, dim)).astype(np.float32)
    q = c[rng.integers(0, centers, 300)] + rng.normal(size=(300, dim)).astype(np.float32)
    ids = (np.arange(n, dtype=np.uint64) * 7 + 3).astype(np.uint64)
    return x.astype(np.float32), ids, q.astype(np.float32)


def jax_state(idx) -> dict:
    """A JAX-built index as the port's state dict: the same fields."""
    return {
        "config": idx.config.encode(),
        "keep_raw": idx.keep_raw,
        "centroids": idx.centroids,
        "clusters": [dataclasses.asdict(c) for c in idx.clusters],
        "deltas": [[dataclasses.asdict(s) for s in ds] for ds in idx.deltas],
    }


def assert_same_topk(ids_ref, d_ref, ids_got, d_got):
    ids_ref, ids_got = np.asarray(ids_ref), np.asarray(ids_got)
    d_ref, d_got = np.asarray(d_ref, np.float64), np.asarray(d_got, np.float64)
    assert ids_ref.shape == ids_got.shape, (ids_ref, ids_got)
    atol = max(ATOL, RTOL * float(np.abs(d_ref).max(initial=0.0)))
    np.testing.assert_allclose(d_got, d_ref, rtol=RTOL, atol=atol)
    for i in np.flatnonzero(ids_ref != ids_got):
        tie = np.abs(d_ref - d_ref[i]) <= TIE * max(1.0, abs(d_ref[i]))
        tie[i] = False
        assert tie.any(), f"id {ids_got[i]} != {ids_ref[i]} at rank {i} without a tie: {d_ref}"


@pytest.fixture(scope="module", params=[(lay, keep) for lay in LAYOUTS for keep in (True, False)],
                ids=lambda p: f"{p[0][0]}-raw{int(p[1])}")
def pair(request):
    """(jax index, port index, queries) built once per layout × keep_raw."""
    (rot, dim), keep_raw = request.param
    x, ids, q = _data(dim)
    ref = JaxIndex.train(x, ids, JaxConfig("v", dim, nlist=16, rotator=rot, seed=5),
                         keep_raw=keep_raw)
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    return ref, port, q


@pytest.fixture(params=[False, True], ids=["nocache", "cache"])
def cached_pair(request, pair):
    ref, port, q = pair
    if request.param:
        ref.enable_device_cache()
        port.enable_device_cache()
    else:
        ref._device_cache_enabled = False
        port._device_cache_enabled = False
    return ref, port, q


P = dict(top_k=10, nprobe=4, rerank_depth=40)


class TestCarriedIndex:
    def test_search(self, cached_pair):
        ref, port, q = cached_pair
        for qi in q[:8]:
            assert_same_topk(*ref.search(qi, JaxParams(**P)), *port.search(qi, SearchParams(**P)))

    def test_search_without_rerank(self, cached_pair):
        ref, port, q = cached_pair
        for qi in q[:4]:
            assert_same_topk(*ref.search(qi, JaxParams(**P), rerank=False),
                             *port.search(qi, SearchParams(**P), rerank=False))

    def test_search_filtered(self, cached_pair):
        ref, port, q = cached_pair
        allowed = np.arange(3, 1500 * 7, 14, dtype=np.uint64)  # every other row
        for qi in q[:4]:
            got_ids, got_d = port.search_filtered(qi, allowed, SearchParams(**P))
            assert np.isin(got_ids, allowed).all()
            assert_same_topk(*ref.search_filtered(qi, allowed, JaxParams(**P)), got_ids, got_d)

    @pytest.mark.parametrize("nq", [1, 8, 300])
    def test_batch_search(self, cached_pair, nq):
        ref, port, q = cached_pair
        r_ids, r_d = ref.batch_search(q[:nq], JaxParams(**P))
        g_ids, g_d = port.batch_search(q[:nq], SearchParams(**P))
        assert len(g_ids) == len(g_d) == nq
        for a, b, c, d in zip(r_ids, r_d, g_ids, g_d):
            assert_same_topk(a, b, c, d)

    def test_search_async(self, cached_pair):
        ref, port, q = cached_pair
        resolvers = [port.search_async(qi, SearchParams(**P)) for qi in q[:4]]
        # resolved out of dispatch order, as a pipelining client may
        for qi, resolve in reversed(list(zip(q[:4], resolvers))):
            assert_same_topk(*ref.search_async(qi, JaxParams(**P))(), *resolve())


@pytest.mark.parametrize("rot,dim", LAYOUTS)
def test_insert_and_merge_match_reference(rot, dim):
    x, ids, q = _data(dim, seed=1)
    ref = JaxIndex.train(x[:1000], ids[:1000], JaxConfig("v", dim, nlist=8, rotator=rot))
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    ref.insert_batch(x[1000:], ids[1000:])
    port.insert_batch(x[1000:], ids[1000:])
    assert port.num_vectors == ref.num_vectors == 1500
    for c in range(8):
        assert len(port.deltas[c]) == len(ref.deltas[c])
        for a, b in zip(ref.deltas[c], port.deltas[c]):
            np.testing.assert_array_equal(b.ids, a.ids)
            # identical rotations on the CPU (fht) give identical sign bits;
            # the matrix rotator's matmul may round a near-zero coordinate
            # the other way, so there only allclose norms are held
            if rot == "fht":
                np.testing.assert_array_equal(b.codes.numpy(), a.codes)
            np.testing.assert_allclose(b.norms.numpy(), a.norms, rtol=RTOL)
    p = SearchParams(**P)
    for qi in q[:6]:
        assert_same_topk(*ref.search(qi, JaxParams(**P)), *port.search(qi, p))
    ref.merge_deltas()
    port.merge_deltas()
    assert all(not d for d in port.deltas)
    for a, b in zip(ref.clusters, port.clusters):
        np.testing.assert_array_equal(b.ids, a.ids)
    ref.enable_device_cache()
    port.enable_device_cache()
    r_ids, r_d = ref.batch_search(q[:16], JaxParams(**P))
    g_ids, g_d = port.batch_search(q[:16], p)
    for a, b, c, d in zip(r_ids, r_d, g_ids, g_d):
        assert_same_topk(a, b, c, d)


def test_tune_nprobe_matches_reference():
    x, ids, q = _data(64, n=2000, centers=40, seed=2)
    ref = JaxIndex.train(x, ids, JaxConfig("v", 64, nlist=32, seed=9))
    port = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    ref.enable_device_cache()
    port.enable_device_cache()
    kw = dict(target_recall=0.9, top_k=10, rerank_depth=40, max_queries=64)
    want, got = ref.tune_nprobe(q, **kw), port.tune_nprobe(q, **kw)
    assert got["nprobe"] == want["nprobe"]
    assert got["target_met"] == want["target_met"]
    assert [n for n, _ in got["measured"]] == [n for n, _ in want["measured"]]
    np.testing.assert_allclose([r for _, r in got["measured"]],
                               [r for _, r in want["measured"]], atol=0.02)


@pytest.mark.parametrize("rot,dim", LAYOUTS)
def test_manifest_reader_carries_reference_index(tmp_path, rot, dim):
    x, ids, q = _data(dim, seed=3)
    ref = JaxIndex.train(x[:1200], ids[:1200], JaxConfig("v", dim, nlist=8, rotator=rot))
    ref.insert_batch(x[1200:], ids[1200:])  # delta segments ride along
    JaxManifestStore(str(tmp_path)).write_index(ref)
    store = ManifestStore(tmp_path)
    assert store.exists() and store.latest_generation() == 1
    port = store.read_latest(device="cpu")
    direct = IvfRabitqIndex.from_state(jax_state(ref), device="cpu")
    for a, b in zip(port.state()["clusters"] + sum(port.state()["deltas"], []),
                    direct.state()["clusters"] + sum(direct.state()["deltas"], [])):
        for f in ("codes", "norms", "factors", "ids", "code_dot_c", "raw"):
            np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(port.centroids.numpy(), ref.centroids)
    for qi in q[:6]:
        assert_same_topk(*ref.search(qi, JaxParams(**P)), *port.search(qi, SearchParams(**P)))


def test_manifest_reader_rejects_corruption(tmp_path):
    x, ids, _ = _data(64, n=300)
    JaxManifestStore(str(tmp_path)).write_index(JaxIndex.train(x, ids, JaxConfig("v", 64, nlist=4)))
    seg = next((tmp_path / "segments").iterdir())
    blob = bytearray(seg.read_bytes())
    blob[-1] ^= 0xFF
    seg.write_bytes(bytes(blob))
    with pytest.raises(VectorIndexError, match="CRC"):
        ManifestStore(tmp_path).read_latest(device="cpu")


def test_state_round_trip_is_exact():
    x, ids, q = _data(64, seed=4)
    a = IvfRabitqIndex.train(x[:1000], ids[:1000], VectorIndexConfig("v", 64, nlist=8),
                             device="cpu")
    a.insert_batch(x[1000:], ids[1000:])
    b = IvfRabitqIndex.from_state(a.state(), device="cpu")
    p = SearchParams(**P)
    for qi in q[:4]:
        ia, da = a.search(qi, p)
        ib, db = b.search(qi, p)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)


def test_port_train_search_recall():
    """Port-only build on the CPU: train → search with a recall@10 floor."""
    x, ids, q = _data(64, n=3000, centers=16, seed=6)
    idx = IvfRabitqIndex.train(x, ids, VectorIndexConfig("v", 64, nlist=16), device="cpu")
    assert idx.num_vectors == 3000
    truth = exact_topk(x, ids, q[:64], 10)
    idx.enable_device_cache()
    got, _ = idx.batch_search(q[:64], SearchParams(top_k=10, nprobe=16, rerank_depth=100))
    assert recall_at_k(truth, got) >= 0.9
    got1, _ = idx.batch_search(q[:64], SearchParams(top_k=10, nprobe=4, rerank_depth=100))
    assert recall_at_k(truth, got1) >= 0.6


def test_port_kmeans_train_matches_reference_clusters():
    """Same seed, same init draw: the port's train gives the reference's
    clusters on separated data."""
    x, ids, _ = _data(64, n=1200, centers=8, seed=7)
    cfg = dict(dim=64, nlist=8, seed=11)
    ref = JaxIndex.train(x, ids, JaxConfig("v", **cfg))
    port = IvfRabitqIndex.train(x, ids, VectorIndexConfig("v", **cfg), device="cpu")
    np.testing.assert_allclose(port.centroids.numpy(), ref.centroids, rtol=1e-4, atol=1e-4)
    for a, b in zip(ref.clusters, port.clusters):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.codes.numpy(), a.codes)


def test_entry_points_raise_without_cuda():
    cfg = VectorIndexConfig("v", 16, nlist=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(ConfigError, match="CUDA"):
        IvfRabitqIndex(cfg)
    with pytest.raises(ConfigError, match="CUDA"):
        IvfRabitqIndex.train(np.zeros((4, 16), np.float32), np.arange(4), cfg)


def test_ex_codes_not_ported():
    """Named for the raise the port once had for ``total_bits > 1``; ex-codes
    are ported, so it holds that an ex config trains and searches on the CPU,
    resident and not, with int8 codes at 4 bits and int16 at 9."""
    x, ids, q = _data(64, n=1200, centers=8, seed=8)
    for bits, dtype in ((4, torch.int8), (9, torch.int16)):
        idx = IvfRabitqIndex.train(x, ids, VectorIndexConfig("v", 64, nlist=8, total_bits=bits),
                                   device="cpu")
        assert idx.clusters[0].codes.dtype == dtype and idx.clusters[0].codes.shape[1] == 64
        truth = exact_topk(x, ids, q[:16], 10)
        p = SearchParams(top_k=10, nprobe=8, rerank_depth=100)
        got = [idx.search(qi, p)[0] for qi in q[:16]]
        assert recall_at_k(truth, got) >= 0.95
        idx.enable_device_cache()
        assert recall_at_k(truth, idx.batch_search(q[:16], p)[0]) >= 0.95


def test_untrained_and_bad_shapes_raise():
    cfg = VectorIndexConfig("v", 16, nlist=2)
    with pytest.raises(VectorIndexError, match="not trained"):
        IvfRabitqIndex(cfg, device="cpu").search(np.zeros(16, np.float32))
    with pytest.raises(VectorIndexError, match="expected"):
        IvfRabitqIndex.train(np.zeros((4, 8), np.float32), np.arange(4), cfg, device="cpu")


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
