"""The port's sharded ANN plane against the JAX package's, on the CPU.

A plane directory is the carry between the packages: a plane the JAX
``ShardedAnnBuilder`` wrote is opened by the port and searched like the JAX
``AnnPlane`` searches it (host path, and Pallas kernel in interpret mode),
and a plane the port wrote is opened and searched identically by the JAX
package.  Then the port's own builder (resume, shard-exact rows, generation
bump, mid-build refusal, pinned generations), its 1-vs-3-shard parity and
its ``ShardedAnnEndpoint``, as ``tests/test_annplane.py`` holds the
reference's.

Tolerance: ids equal except where two distances tie within 1e-5
(relative); distances allclose at rtol 1e-4, atol 1e-4.  Both packages
compute in float32 in another summation order, and the candidate shortlist
is cut by estimates that carry that rounding.  Within the port an answer
does not depend on the batch it rides in (probe and re-rank distances are
taken in float64), so those tests assert exact equality, as the
reference's own test does.
"""

import threading

import numpy as np
import pytest
import torch

from lakesoul_tpu.annplane import AnnPlane as JaxPlane
from lakesoul_tpu.annplane import AnnPlaneConfig as JaxPlaneConfig
from lakesoul_tpu.annplane import ShardedAnnBuilder as JaxBuilder
from lakesoul_tpu.errors import VectorIndexError as JaxVectorIndexError
from lakesoul_tpu.vector.config import VectorIndexConfig as JaxConfig
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu_torch import _build
from lakesoul_tpu_torch.annplane import (
    AnnPlane,
    AnnPlaneConfig,
    PlaneManifestStore,
    ShardedAnnBuilder,
    ShardedAnnEndpoint,
)
from lakesoul_tpu_torch.annplane.build import shard_root
from lakesoul_tpu_torch.errors import ConfigError, OverloadedError, VectorIndexError
from lakesoul_tpu_torch.runtime import atomicio
from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.vector.manifest import ManifestStore, _crc_unwrap
from lakesoul_tpu_torch.vector.oracle import exact_topk, recall_at_k

RTOL, ATOL, TIE = 1e-4, 1e-4, 1e-5
CPU = "cpu"
MIXED = np.array([1, 2, 6, 24, 3, 4, 5, 6, 48, 1, 16, 8], np.int64)


@pytest.fixture(autouse=True)
def no_cuda_build(monkeypatch):
    """Fails the test if anything tries to build or load a CUDA kernel: on
    the CPU the plane runs the kernels' plain versions only."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach a CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def make_corpus(n=6_000, d=32, modes=64, seed=0, spread=3.0, nq=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(modes, d)).astype(np.float32) * spread
    vecs = centers[rng.integers(0, modes, n)] + rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, modes, nq)] + rng.normal(size=(nq, d)).astype(np.float32)
    return vecs.astype(np.float32), np.arange(n, dtype=np.uint64), queries.astype(np.float32)


def stream(vecs, ids, batch=1_500):
    for lo in range(0, len(ids), batch):
        yield vecs[lo : lo + batch], ids[lo : lo + batch]


def port_config(d=32, *, rows_per_shard=2_000, nlist=16, keep_raw=True, **kw):
    index = VectorIndexConfig(column="e", dim=d, nlist=nlist, total_bits=1, **kw)
    probe = AnnPlaneConfig(index=index, shard_budget_bytes=1 << 30, keep_raw=keep_raw)
    return AnnPlaneConfig(index=index, shard_budget_bytes=rows_per_shard * probe.bytes_per_vector(),
                          keep_raw=keep_raw)


def jax_config(cfg: AnnPlaneConfig) -> JaxPlaneConfig:
    return JaxPlaneConfig(index=JaxConfig.parse(cfg.index.encode()),
                          shard_budget_bytes=cfg.budget_bytes, keep_raw=cfg.keep_raw)


def assert_same_topk(ids_ref, d_ref, ids_got, d_got):
    ids_ref, ids_got = np.asarray(ids_ref), np.asarray(ids_got)
    d_ref, d_got = np.asarray(d_ref, np.float64), np.asarray(d_got, np.float64)
    assert ids_ref.shape == ids_got.shape, (ids_ref, ids_got)
    np.testing.assert_allclose(d_got, d_ref, rtol=RTOL, atol=ATOL)
    for i in np.flatnonzero(ids_ref != ids_got):
        tie = np.abs(d_ref - d_ref[i]) <= TIE * max(1.0, abs(d_ref[i]))
        tie[i] = False
        assert tie.any(), f"id {ids_got[i]} != {ids_ref[i]} at rank {i} without a tie: {d_ref}"


def assert_same_results(ref, got):
    (ids_r, d_r), (ids_g, d_g) = ref, got
    assert len(ids_r) == len(ids_g)
    for q in range(len(ids_r)):
        assert_same_topk(ids_r[q], d_r[q], ids_g[q], d_g[q])


# (rotator, dim, keep_raw): fht pads 100 → 128; matrix keeps d = 100
LAYOUTS = [("fht", 32, True), ("matrix", 100, True), ("fht", 64, False), ("fht", 128, True)]


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda p: f"{p[0]}-{p[1]}-raw{p[2]}")
def jax_built(request, tmp_path_factory):
    """A 1-bit, 3-shard plane built by the JAX package."""
    rotator, d, keep_raw = request.param
    vecs, ids, queries = make_corpus(d=d)
    cfg = port_config(d, keep_raw=keep_raw, rotator=rotator)
    root = str(tmp_path_factory.mktemp("jaxplane") / "p")
    JaxBuilder(root, jax_config(cfg)).build(stream(vecs, ids))
    return root, cfg, vecs, ids, queries


@pytest.fixture(scope="module")
def port_built(tmp_path_factory):
    """A 1-bit, 3-shard plane built by the port on the CPU, opened by it."""
    vecs, ids, queries = make_corpus(seed=1)
    cfg = port_config()
    root = str(tmp_path_factory.mktemp("portplane") / "p")
    manifest = ShardedAnnBuilder(root, cfg, device=CPU).build(stream(vecs, ids))
    return root, cfg, AnnPlane.open(root, device=CPU), manifest, vecs, ids, queries


# ---------------------------------------------------------------- (d) config
CONFIG_GRID = [
    dict(dim=d, nlist=nl, total_bits=tb, rotator=rot, keep_raw=kr, budget=budget)
    for d, rot in ((16, "fht"), (100, "fht"), (100, "matrix"), (128, "identity"))
    for nl, tb in ((8, 1), (512, 1), (64, 4), (16, 9))
    for kr in (True, False)
    for budget in (1 << 20, 768 << 20)
]


@pytest.mark.parametrize("c", CONFIG_GRID[::3] + CONFIG_GRID[1::7],
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_config_matches_jax(c):
    kw = dict(column="e", dim=c["dim"], nlist=c["nlist"], total_bits=c["total_bits"],
              rotator=c["rotator"])
    port = AnnPlaneConfig(index=VectorIndexConfig(**kw), shard_budget_bytes=c["budget"],
                          keep_raw=c["keep_raw"])
    ref = JaxPlaneConfig(index=JaxConfig(**kw), shard_budget_bytes=c["budget"],
                         keep_raw=c["keep_raw"])
    assert port.bytes_per_vector() == ref.bytes_per_vector()
    assert port.rows_per_shard() == ref.rows_per_shard()
    assert port.digest() == ref.digest()


@pytest.mark.parametrize("raw, match", [("bogus", "must be an integer"),
                                        ("0", "must be positive"), ("-5", "must be positive")])
def test_env_budget_errors_match_jax(monkeypatch, raw, match):
    monkeypatch.setenv("LAKESOUL_ANN_SHARD_BUDGET_BYTES", raw)
    with pytest.raises(VectorIndexError, match=match) as port:
        AnnPlaneConfig(index=VectorIndexConfig(column="e", dim=16))
    with pytest.raises(JaxVectorIndexError) as ref:
        JaxPlaneConfig(index=JaxConfig(column="e", dim=16))
    assert str(port.value) == str(ref.value)


def test_env_budget_and_too_small_budget(monkeypatch):
    monkeypatch.setenv("LAKESOUL_ANN_SHARD_BUDGET_BYTES", "12345678")
    assert AnnPlaneConfig(index=VectorIndexConfig(column="e", dim=16)).budget_bytes == 12345678
    with pytest.raises(VectorIndexError, match="cannot hold"):
        AnnPlaneConfig(index=VectorIndexConfig(column="e", dim=128), shard_budget_bytes=64)


# --------------------------------------- (e) JAX-built plane opened by the port
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_port_opens_jax_plane_and_searches_alike(jax_built, mixed):
    root, cfg, _, _, queries = jax_built
    plane = AnnPlane.open(root, device=CPU)
    assert len(plane.shards) == 3
    nprobes = MIXED if mixed else None
    got = plane.batch_search(queries, SearchParams(top_k=10, nprobe=6, rerank_depth=40),
                             nprobes=nprobes)
    jp = JaxParams(top_k=10, nprobe=6, rerank_depth=40)
    for kw in (dict(use_pallas=False), dict(use_pallas=True, pallas_interpret=True)):
        ref = JaxPlane.open(root, **kw).batch_search(queries, jp, nprobes=nprobes)
        assert_same_results(ref, got)


def test_port_open_counts_and_layout(jax_built):
    root, cfg, vecs, _, _ = jax_built
    plane = AnnPlane.open(root, device=CPU)
    ref = JaxPlane.open(root, use_pallas=False)
    assert plane.num_vectors == ref.num_vectors == len(vecs)
    for s, r in zip(plane.shards, ref.shards):
        np.testing.assert_array_equal(s.tile_start, r.tile_start)
        np.testing.assert_array_equal(s.tile_count, r.tile_count)
        np.testing.assert_array_equal(s.row_count, r.row_count)
        np.testing.assert_array_equal(s.ids, r.ids)
        np.testing.assert_array_equal(s.codes.numpy(), r.codes)
        for f in ("a", "b", "h"):
            np.testing.assert_allclose(getattr(s, f).numpy(), getattr(r, f), rtol=1e-6)
        assert (s.raw is None) == (r.raw is None)
        if s.raw is not None:
            np.testing.assert_array_equal(s.raw.numpy(), r.raw)


# --------------------------------------- (f) port-built plane opened by JAX
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_jax_opens_port_plane_and_searches_alike(port_built, mixed):
    root, _, plane, _, _, _, queries = port_built
    nprobes = MIXED if mixed else None
    got = plane.batch_search(queries, SearchParams(top_k=10, nprobe=6, rerank_depth=40),
                             nprobes=nprobes)
    ref = JaxPlane.open(root, use_pallas=False).batch_search(
        queries, JaxParams(top_k=10, nprobe=6, rerank_depth=40), nprobes=nprobes)
    assert_same_results(ref, got)


def test_port_manifest_is_the_jax_layout(port_built):
    root, cfg, _, manifest, vecs, _, _ = port_built
    from lakesoul_tpu.annplane import PlaneManifestStore as JaxStore
    from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore

    assert JaxStore(root).read() == manifest == PlaneManifestStore(root).read()
    assert manifest["config_digest"] == jax_config(cfg).digest()
    for e in manifest["shards"]:
        j = JaxManifestStore(shard_root(root, e["shard"])).read_at(e["generation"])
        p = ManifestStore(shard_root(root, e["shard"])).read_at(e["generation"], device=CPU)
        assert j.num_vectors == p.num_vectors == e["num_vectors"]


def test_jax_builder_resumes_a_port_plane(tmp_path):
    """A build the port left mid-way is resumed shard-exact by the JAX
    builder: same digest, shard 0 is not rebuilt."""
    vecs, ids, _ = make_corpus()
    cfg = port_config()
    root = str(tmp_path / "p")

    def broken():
        yield vecs[:2_500], ids[:2_500]
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        ShardedAnnBuilder(root, cfg, device=CPU).build(broken())
    partial = PlaneManifestStore(root).read()
    assert len(partial["shards"]) == 1 and not partial["complete"]
    m = JaxBuilder(root, jax_config(cfg)).build(stream(vecs, ids))
    assert m["complete"] and len(m["shards"]) == 3
    assert m["shards"][0] == partial["shards"][0]


# --------------------------------------------------- (g) the port's builder
class TestBuilder:
    def test_multi_shard_build_rows_exact(self, tmp_path):
        vecs, ids, _ = make_corpus(n=5_000)
        m = ShardedAnnBuilder(str(tmp_path / "p"), port_config(), device=CPU).build(
            stream(vecs, ids))
        assert m["complete"] and m["total_rows"] == 5_000
        assert [s["row_start"] for s in m["shards"]] == [0, 2_000, 4_000]
        assert [s["row_end"] for s in m["shards"]] == [2_000, 4_000, 5_000]
        assert sum(s["num_vectors"] for s in m["shards"]) == 5_000

    def test_sampled_shard_trains_on_a_sample_then_inserts(self, tmp_path):
        """A shard larger than ``train_sample_rows`` trains on the
        reference's numpy sample and inserts every row: same centroids and
        rows as the JAX builder's shard."""
        vecs, ids, queries = make_corpus(n=3_000)
        base = port_config(rows_per_shard=3_000)
        cfg = AnnPlaneConfig(index=base.index, shard_budget_bytes=base.budget_bytes,
                             train_sample_rows=1_000)
        jcfg = JaxPlaneConfig(index=JaxConfig.parse(cfg.index.encode()),
                              shard_budget_bytes=cfg.budget_bytes, train_sample_rows=1_000)
        ShardedAnnBuilder(str(tmp_path / "p"), cfg, device=CPU).build(stream(vecs, ids))
        JaxBuilder(str(tmp_path / "j"), jcfg).build(stream(vecs, ids))
        p = ManifestStore(shard_root(str(tmp_path / "p"), 0)).read_latest(device=CPU)
        from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore

        j = JaxManifestStore(shard_root(str(tmp_path / "j"), 0)).read_latest()
        np.testing.assert_allclose(p.centroids.numpy(), j.centroids, rtol=1e-5, atol=1e-5)
        assert [len(c.ids) for c in p.clusters] == [len(c.ids) for c in j.clusters]
        for pc, jc in zip(p.clusters, j.clusters):
            np.testing.assert_array_equal(pc.ids, jc.ids)
            np.testing.assert_array_equal(pc.codes.numpy(), jc.codes)
        params = SearchParams(top_k=10, nprobe=8, rerank_depth=60)
        assert_same_results(
            JaxPlane.open(str(tmp_path / "j"), use_pallas=False).batch_search(
                queries, JaxParams(top_k=10, nprobe=8, rerank_depth=60)),
            AnnPlane.open(str(tmp_path / "p"), device=CPU).batch_search(queries, params),
        )

    def test_interrupted_build_resumes_shard_exact(self, tmp_path):
        vecs, ids, queries = make_corpus(n=5_000)
        cfg = port_config()
        root = str(tmp_path / "p")
        builder = ShardedAnnBuilder(root, cfg, device=CPU)

        class Boom(Exception):
            pass

        def broken():
            yield vecs[:2_000], ids[:2_000]
            yield vecs[2_000:3_000], ids[2_000:3_000]
            raise Boom()

        with pytest.raises(Boom):
            builder.build(broken())
        partial = PlaneManifestStore(root).read()
        # only COMPLETE shards are durable; the half-buffered second shard
        # never became visible
        assert not partial["complete"] and len(partial["shards"]) == 1
        assert partial["shards"][0]["row_end"] == 2_000
        m = builder.build(stream(vecs, ids))
        assert m["complete"] and len(m["shards"]) == 3
        assert m["shards"][0]["generation"] == partial["shards"][0]["generation"]
        fresh_root = str(tmp_path / "fresh")
        fresh = ShardedAnnBuilder(fresh_root, cfg, device=CPU).build(stream(vecs, ids))
        span = [(s["row_start"], s["row_end"], s["num_vectors"]) for s in m["shards"]]
        assert span == [(s["row_start"], s["row_end"], s["num_vectors"]) for s in fresh["shards"]]
        params = SearchParams(top_k=10, nprobe=8)
        a = AnnPlane.open(root, device=CPU).batch_search(queries, params)
        b = AnnPlane.open(fresh_root, device=CPU).batch_search(queries, params)
        for q in range(len(queries)):
            np.testing.assert_array_equal(a[0][q], b[0][q])
            np.testing.assert_allclose(a[1][q], b[1][q], rtol=1e-5, atol=1e-5)

    def test_config_change_forces_fresh_generation(self, tmp_path):
        vecs, ids, _ = make_corpus(n=4_000)
        root = str(tmp_path / "p")
        m1 = ShardedAnnBuilder(root, port_config(), device=CPU).build(stream(vecs, ids))
        m2 = ShardedAnnBuilder(root, port_config(rows_per_shard=1_500), device=CPU).build(
            stream(vecs, ids))
        assert m2["generation"] == m1["generation"] + 1
        assert len(m2["shards"]) == 3  # 1.5k + 1.5k + 1k under the new layout
        assert AnnPlane.open(root, device=CPU).num_vectors == 4_000

    def test_fresh_build_bumps_generation(self, tmp_path):
        vecs, ids, _ = make_corpus(n=2_500)
        root = str(tmp_path / "p")
        m1 = ShardedAnnBuilder(root, port_config(), device=CPU).build(stream(vecs, ids))
        m2 = ShardedAnnBuilder(root, port_config(), device=CPU).build(stream(vecs, ids),
                                                                      resume=False)
        assert m2["generation"] == m1["generation"] + 1

    def test_completed_build_is_idempotent(self, tmp_path):
        vecs, ids, _ = make_corpus(n=2_500)
        builder = ShardedAnnBuilder(str(tmp_path / "p"), port_config(), device=CPU)
        m1 = builder.build(stream(vecs, ids))
        assert builder.build(stream(vecs, ids)) == m1

    def test_tensor_batches_build_the_same_plane(self, tmp_path):
        vecs, ids, _ = make_corpus(n=2_500)
        a = ShardedAnnBuilder(str(tmp_path / "a"), port_config(), device=CPU).build(
            stream(vecs, ids))
        b = ShardedAnnBuilder(str(tmp_path / "b"), port_config(), device=CPU).build(
            (torch.from_numpy(v), i) for v, i in stream(vecs, ids))
        assert a == b

    def test_empty_stream_raises(self, tmp_path):
        with pytest.raises(VectorIndexError, match="no vectors"):
            ShardedAnnBuilder(str(tmp_path / "p"), port_config(), device=CPU).build(iter(()))

    def test_dim_mismatch_raises(self, tmp_path):
        vecs = np.zeros((10, 8), np.float32)
        with pytest.raises(VectorIndexError, match="expected"):
            ShardedAnnBuilder(str(tmp_path / "p"), port_config(d=16), device=CPU).build(
                [(vecs, np.arange(10, dtype=np.uint64))])


class TestManifest:
    def test_missing_reads_none(self, tmp_path):
        assert PlaneManifestStore(str(tmp_path / "nope")).read() is None
        assert not PlaneManifestStore(str(tmp_path / "nope")).exists()

    def test_corrupt_record_raises_not_restarts(self, tmp_path):
        vecs, ids, _ = make_corpus(n=2_500)
        root = tmp_path / "p"
        ShardedAnnBuilder(str(root), port_config(), device=CPU).build(stream(vecs, ids))
        rel = _crc_unwrap((root / "PLANE").read_bytes(), "PLANE").decode()
        blob = bytearray((root / rel).read_bytes())
        blob[10] ^= 0xFF
        (root / rel).write_bytes(bytes(blob))
        with pytest.raises(VectorIndexError, match="CRC"):
            PlaneManifestStore(str(root)).read()

    def test_publish_is_all_or_nothing(self, tmp_path, monkeypatch):
        """A publication that fails before its rename leaves the old file
        whole and no temp file behind."""
        target = tmp_path / "PLANE"
        atomicio.publish_bytes(target, b"old")

        def crash(*a):
            raise OSError("crash before the rename")

        monkeypatch.setattr(atomicio.os, "replace", crash)
        with pytest.raises(OSError):
            atomicio.publish_bytes(target, b"new")
        assert target.read_bytes() == b"old"
        assert [p.name for p in tmp_path.iterdir()] == ["PLANE"]

    def test_index_with_deltas_round_trips(self, tmp_path):
        """An index with unmerged delta segments, written by the port, reads
        back in both packages with the same rows and the same answers."""
        from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore

        vecs, ids, queries = make_corpus(n=3_000, seed=3)
        cfg = port_config()
        index = IvfRabitqIndex.train(vecs[:2_000], ids[:2_000], cfg.index, device=CPU)
        index.insert_batch(vecs[2_000:], ids[2_000:])
        store = ManifestStore(tmp_path / "ix")
        assert store.write_index(index) == 1 and store.write_index(index) == 2
        back = store.read_at(1, device=CPU)
        jax_back = JaxManifestStore(str(tmp_path / "ix")).read_latest()
        assert back.num_vectors == jax_back.num_vectors == 3_000
        assert sum(len(d) for d in jax_back.deltas) == sum(len(d) for d in index.deltas) > 0
        params = SearchParams(top_k=10, nprobe=16, rerank_depth=100)
        for q in queries[:4]:
            want = index.search(q, params)
            got = back.search(q, params)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])

    def test_open_pins_shard_generations(self, tmp_path):
        """A concurrent rebuild swaps per-shard LATEST pointers one by one;
        a reader must load the generations its plane record PINNED."""
        vecs, ids, _ = make_corpus(n=2_500)
        root = str(tmp_path / "p")
        cfg = port_config()
        ShardedAnnBuilder(root, cfg, device=CPU).build(stream(vecs, ids))
        other = IvfRabitqIndex.train(vecs[:100], ids[:100], cfg.index, device=CPU)
        ManifestStore(shard_root(root, 0)).write_index(other)
        assert AnnPlane.open(root, device=CPU).num_vectors == 2_500  # NOT 100 + 500

    def test_open_refuses_mid_build_plane(self, tmp_path):
        vecs, ids, _ = make_corpus(n=5_000)
        root = str(tmp_path / "p")

        def broken():
            yield vecs[:2_500], ids[:2_500]
            raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            ShardedAnnBuilder(root, port_config(), device=CPU).build(broken())
        with pytest.raises(VectorIndexError, match="mid-build"):
            AnnPlane.open(root, device=CPU)
        with pytest.raises(VectorIndexError, match="no ANN plane"):
            AnnPlane.open(str(tmp_path / "none"), device=CPU)


# ------------------------------------------------------- search semantics
class TestSearch:
    def test_single_vs_multi_shard_parity(self, port_built, tmp_path):
        """Same corpus, one shard vs three: full-probe searches return the
        same top-k distances (ids equal up to exact ties)."""
        _, cfg, plane, _, vecs, ids, queries = port_built
        cfg1 = AnnPlaneConfig(index=cfg.index,
                              shard_budget_bytes=cfg.bytes_per_vector() * (len(ids) + 1))
        root1 = str(tmp_path / "one")
        ShardedAnnBuilder(root1, cfg1, device=CPU).build(stream(vecs, ids))
        single = AnnPlane.open(root1, device=CPU)
        assert len(single.shards) == 1 and len(plane.shards) == 3
        params = SearchParams(top_k=10, nprobe=10**6, rerank_depth=400)
        assert_same_results(single.batch_search(queries, params),
                            plane.batch_search(queries, params))

    def test_per_query_nprobe_fuses_exactly(self, port_built):
        """A mixed-nprobe ragged batch returns exactly what per-query calls
        with the same nprobe return — raggedness changes cost, not answers."""
        *_, queries = port_built
        plane = port_built[2]
        m_ids, m_d = plane.batch_search(queries, SearchParams(top_k=5, nprobe=8), nprobes=MIXED)
        for i, npb in enumerate(MIXED):
            one_ids, one_d = plane.search(queries[i], SearchParams(top_k=5, nprobe=int(npb)))
            np.testing.assert_array_equal(m_ids[i], one_ids)
            np.testing.assert_array_equal(m_d[i], one_d)

    def test_recall_against_exact_oracle(self, port_built):
        _, _, plane, _, vecs, ids, queries = port_built
        got, _ = plane.batch_search(queries, SearchParams(top_k=10, nprobe=12, rerank_depth=80))
        assert recall_at_k(exact_topk(vecs, ids, queries, 10), got) >= 0.9

    def test_estimates_reproduce_the_index_estimator(self):
        """The folded (a, b, h) form reproduces the index's estimator: an
        est-only one-shard plane equals IvfRabitqIndex.search(rerank=False)."""
        vecs, ids, _ = make_corpus(n=3_000, seed=5)
        cfg = port_config(rows_per_shard=3_001, nlist=8, keep_raw=False)
        index = IvfRabitqIndex.train(vecs, ids, cfg.index, keep_raw=False, device=CPU)
        plane = AnnPlane.from_indexes(cfg, [index], device=CPU)
        params = SearchParams(top_k=10, nprobe=8, rerank_depth=10)
        for q in vecs[[17, 900, 2500]]:
            p_ids, p_d = plane.search(q, params)
            r_ids, r_d = index.search(q, params, rerank=False)
            # the JAX test's tolerance for this identity (test_annplane.py:407):
            # estimates near 0 are differences of ~1e3 terms, and the plane
            # rounds its probe distances from float64
            np.testing.assert_allclose(np.sort(p_d), np.sort(r_d), rtol=1e-3, atol=1e-2)
            assert set(p_ids.tolist()) == set(r_ids.tolist())

    def test_from_indexes_equals_open(self, port_built):
        root, cfg, plane, manifest, _, _, queries = port_built
        indexes = [ManifestStore(shard_root(root, e["shard"])).read_at(e["generation"], device=CPU)
                   for e in manifest["shards"]]
        other = AnnPlane.from_indexes(cfg, indexes, device=CPU)
        params = SearchParams(top_k=10, nprobe=6)
        a, b = plane.batch_search(queries, params), other.batch_search(queries, params)
        for q in range(len(queries)):
            np.testing.assert_array_equal(a[0][q], b[0][q])

    def test_unflushed_deltas_are_searched(self):
        """Shards resident with delta segments (inserts not merged) serve
        every row, as the reference's resident layout does."""
        vecs, ids, queries = make_corpus(n=3_000, seed=2)
        cfg = port_config(rows_per_shard=4_000)
        index = IvfRabitqIndex.train(vecs[:2_000], ids[:2_000], cfg.index, device=CPU)
        index.insert_batch(vecs[2_000:], ids[2_000:])
        plane = AnnPlane.from_indexes(cfg, [index], device=CPU)
        assert plane.num_vectors == 3_000
        got, _ = plane.batch_search(vecs[2_990:], SearchParams(top_k=1, nprobe=16,
                                                               rerank_depth=200))
        assert [int(g[0]) for g in got] == list(range(2_990, 3_000))

    def test_nprobes_length_must_match(self, port_built):
        plane, queries = port_built[2], port_built[-1]
        with pytest.raises(VectorIndexError, match="nprobes"):
            plane.batch_search(queries, nprobes=[1, 2])

    def test_metrics_count_queries_and_pairs(self, port_built):
        from lakesoul_tpu_torch.obs import registry

        plane, queries = port_built[2], port_built[-1]
        reg = registry()
        q0 = reg.counter("lakesoul_ann_ragged_queries_total").value
        p0 = reg.counter("lakesoul_ann_ragged_pairs_total").value
        plane.batch_search(queries[:4], SearchParams(nprobe=5), nprobes=[1, 2, 3, 4])
        assert reg.counter("lakesoul_ann_ragged_queries_total").value == q0 + 4
        assert reg.counter("lakesoul_ann_ragged_pairs_total").value == p0 + 10


def test_entry_points_raise_without_cuda(tmp_path, port_built):
    """device=None means the card; with no card every entry point raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, cfg = port_built[0], port_built[1]
    with pytest.raises(ConfigError):
        AnnPlane.open(root)
    with pytest.raises(ConfigError):
        ShardedAnnBuilder(str(tmp_path / "p"), cfg)
    with pytest.raises(ConfigError):
        AnnPlane.from_indexes(cfg, [])
    # an ex-code plane is refused without a card too, and builds on the CPU
    # when the caller names it
    ex = AnnPlaneConfig(index=VectorIndexConfig(column="e", dim=16, total_bits=4))
    with pytest.raises(ConfigError):
        ShardedAnnBuilder(str(tmp_path / "ex"), ex)
    m = ShardedAnnBuilder(str(tmp_path / "ex"), ex, device=CPU).build(
        stream(*make_corpus(n=100, d=16)[:2]))
    assert m["complete"] and m["total_rows"] == 100
    with pytest.raises(ConfigError):
        AnnPlane.open(str(tmp_path / "ex"))


# ------------------------------------------------------ (h) the endpoint
class TestServing:
    def test_endpoint_matches_direct(self, port_built):
        plane, queries = port_built[2], port_built[-1]
        params = SearchParams(top_k=5, nprobe=8)
        with ShardedAnnEndpoint(plane, params, max_wait_ms=1.0, name="port-plane-eq") as ep:
            futs = [ep.submit(q) for q in queries]
            direct = plane.batch_search(queries, params)
            for i, f in enumerate(futs):
                ids, dists = f.result(timeout=30)
                np.testing.assert_array_equal(ids, direct[0][i])
                np.testing.assert_array_equal(dists, direct[1][i])
            st = ep.stats()
        assert st["requests"] == len(queries)
        assert st["latency_p99"] >= st["latency_p50"] >= 0.0

    def test_mixed_nprobe_requests_share_one_batch(self, port_built):
        plane, queries = port_built[2], port_built[-1]
        params = SearchParams(top_k=5, nprobe=8)
        probes = [1, 8, 32, None]
        with ShardedAnnEndpoint(plane, params, max_wait_ms=50.0, name="port-plane-mix") as ep:
            futs = [ep.submit(queries[i], nprobe=probes[i % 4]) for i in range(len(queries))]
            outs = [f.result(timeout=30) for f in futs]
            st = ep.stats()
        assert st["mean_batch"] > 1.0  # the window fused them
        for i, (ids, dists) in enumerate(outs):
            npb = probes[i % 4] or params.nprobe
            want = plane.search(queries[i], SearchParams(top_k=5, nprobe=npb))
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])

    def test_bad_nprobe_rejected(self, port_built):
        with ShardedAnnEndpoint(port_built[2], SearchParams(top_k=1)) as ep:
            with pytest.raises(ValueError, match="nprobe"):
                ep.submit(port_built[-1][0], nprobe=0)

    def test_overload_64_clients_typed_sheds(self, port_built):
        """64 concurrent clients against a tiny pending bound: every request
        completes or sheds TYPED, and the endpoint survives."""
        plane, queries = port_built[2], port_built[-1]
        ep = ShardedAnnEndpoint(plane, SearchParams(top_k=1, nprobe=4), max_batch=8,
                                max_wait_ms=5.0, max_pending=16, name="port-plane-shed")
        sheds = [0] * 64
        errors = []
        start = threading.Barrier(64)  # the 64 clients' first requests arrive together

        def client(ci):
            start.wait()
            for j in range(4):
                try:
                    ep.search(queries[(ci + j) % len(queries)], timeout=60)
                except OverloadedError:
                    sheds[ci] += 1
                except Exception as e:  # surfaced below
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = ep.stats()
        ep.close()
        assert not errors
        assert sum(sheds) > 0  # the bound bit
        assert st["rejected"] == sum(sheds)
        assert st["requests"] == 64 * 4 - sum(sheds)

    @pytest.mark.parametrize("raw, ok", [("7", True), ("0", False), ("x", False)])
    def test_env_max_pending(self, port_built, monkeypatch, raw, ok):
        monkeypatch.setenv("LAKESOUL_ANN_MAX_PENDING", raw)
        if not ok:
            with pytest.raises(VectorIndexError, match="LAKESOUL_ANN_MAX_PENDING"):
                ShardedAnnEndpoint(port_built[2], SearchParams(top_k=1))
            return
        ep = ShardedAnnEndpoint(port_built[2], SearchParams(top_k=1))
        try:
            assert ep.max_pending == 7
        finally:
            ep.close()
