"""The port's sharded ANN plane over ex-codes (``total_bits`` 2-16) against
the JAX package's, on the CPU.

A 2-shard ex plane the JAX ``ShardedAnnBuilder`` wrote is opened by the port
(same resident layout: codes · scales in float32, the ex fold of a / b / h)
and searched like the JAX ``AnnPlane`` searches it, on its host path and
with its Pallas ``ragged_score`` in interpret mode, with mixed nprobe; a
plane the port wrote opens in the JAX package; the port's own builder
resumes shard-exact; its ``ShardedAnnEndpoint`` serves an ex plane.

Tolerances: those of ``test_torch_annplane_plane`` (ids equal except ties
within 1e-5; distances allclose at rtol 1e-4, atol 1e-4); the resident
layout's codes are the same float32 products, held bitwise, and a / b / h
the same float32 arithmetic, held at rtol 1e-6; item scores, sums of
products that cancel, at 1e-4 + 1e-5 · (the magnitude of the terms).
"""

import numpy as np
import pytest
import torch

from lakesoul_tpu.annplane import AnnPlane as JaxPlane
from lakesoul_tpu.annplane import ShardedAnnBuilder as JaxBuilder
from lakesoul_tpu.annplane import ragged as J
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu_torch.annplane import (
    AnnPlane,
    AnnPlaneConfig,
    PlaneManifestStore,
    ShardedAnnBuilder,
    ShardedAnnEndpoint,
)
from lakesoul_tpu_torch.annplane import ragged as R
from lakesoul_tpu_torch.annplane.build import shard_root
from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.vector.manifest import ManifestStore
from lakesoul_tpu_torch.vector.oracle import exact_topk, recall_at_k
from test_torch_annplane_plane import (  # noqa: F401  (no_cuda_build: autouse fixture)
    CPU,
    MIXED,
    assert_same_results,
    jax_config,
    make_corpus,
    no_cuda_build,
    stream,
)

BITS = (2, 4, 8, 9)  # 9: int16 codes
PARAMS = dict(top_k=10, nprobe=6, rerank_depth=40)


def ex_config(d=32, *, bits=4, rows_per_shard=2_000, nlist=16, keep_raw=True, **kw):
    index = VectorIndexConfig(column="e", dim=d, nlist=nlist, total_bits=bits, **kw)
    probe = AnnPlaneConfig(index=index, shard_budget_bytes=1 << 30, keep_raw=keep_raw)
    return AnnPlaneConfig(index=index, shard_budget_bytes=rows_per_shard * probe.bytes_per_vector(),
                          keep_raw=keep_raw)


@pytest.fixture(scope="module", params=BITS, ids=lambda b: f"bits{b}")
def jax_built(request, tmp_path_factory):
    """A 2-shard ex plane built by the JAX package."""
    vecs, ids, queries = make_corpus(n=4_000)
    cfg = ex_config(bits=request.param)
    root = str(tmp_path_factory.mktemp("jaxexplane") / "p")
    JaxBuilder(root, jax_config(cfg)).build(stream(vecs, ids))
    return root, cfg, vecs, ids, queries


@pytest.fixture(scope="module", params=BITS, ids=lambda b: f"bits{b}")
def port_built(request, tmp_path_factory):
    """A 2-shard ex plane built by the port on the CPU, opened by it."""
    vecs, ids, queries = make_corpus(n=4_000, seed=1)
    cfg = ex_config(bits=request.param)
    root = str(tmp_path_factory.mktemp("portexplane") / "p")
    manifest = ShardedAnnBuilder(root, cfg, device=CPU).build(stream(vecs, ids))
    return root, cfg, AnnPlane.open(root, device=CPU), manifest, vecs, ids, queries


@pytest.mark.parametrize("bits", [4, 9])
def test_config_counts_ex_codes_as_the_reference(bits):
    cfg = ex_config(d=128, bits=bits, rows_per_shard=10)
    assert cfg.bytes_per_vector() == jax_config(cfg).bytes_per_vector()
    assert cfg.digest() == jax_config(cfg).digest()
    if bits == 4:  # the scale leg's plane: 1,176 B a row, 684,784 rows a 768 MiB shard
        big = AnnPlaneConfig(index=cfg.index, shard_budget_bytes=768 << 20)
        assert (big.bytes_per_vector(), big.rows_per_shard()) == (1_176, 684_784)


def test_fold_cluster_ex_matches_reference():
    rng = np.random.default_rng(0)
    norms = rng.random(500).astype(np.float32) * 3
    factors = (rng.random(500) * 0.5 + 0.5).astype(np.float32)
    cdc = rng.normal(size=500).astype(np.float32)
    want = J.fold_cluster(norms, factors, cdc, d=128, ex=True)
    got = R.fold_cluster(*(torch.from_numpy(v) for v in (norms, factors, cdc)), d=128, ex=True)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    assert not got[2].any()  # h = 0: the ex estimator takes no csum


# --------------------------------------- a JAX-built ex plane opened by the port
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_port_opens_jax_ex_plane_and_searches_alike(jax_built, mixed):
    root, cfg, _, _, queries = jax_built
    plane = AnnPlane.open(root, device=CPU)
    assert len(plane.shards) == 2
    nprobes = MIXED if mixed else None
    got = plane.batch_search(queries, SearchParams(**PARAMS), nprobes=nprobes)
    for kw in (dict(use_pallas=False), dict(use_pallas=True, pallas_interpret=True)):
        ref = JaxPlane.open(root, **kw).batch_search(queries, JaxParams(**PARAMS),
                                                     nprobes=nprobes)
        assert_same_results(ref, got)


def test_port_ex_layout_is_the_reference(jax_built):
    root, _, vecs, _, _ = jax_built
    plane = AnnPlane.open(root, device=CPU)
    ref = JaxPlane.open(root, use_pallas=False)
    assert plane.num_vectors == ref.num_vectors == len(vecs)
    for s, r in zip(plane.shards, ref.shards):
        np.testing.assert_array_equal(s.tile_start, r.tile_start)
        np.testing.assert_array_equal(s.ids, r.ids)
        np.testing.assert_array_equal(s.codes.numpy(), r.codes)  # codes · scales, f32
        for f in ("a", "b", "h"):
            np.testing.assert_allclose(getattr(s, f).numpy(), getattr(r, f), rtol=1e-6)
        np.testing.assert_array_equal(s.raw.numpy(), r.raw)


def test_probe_pairs_give_zero_csum(jax_built):
    root, _, _, _, queries = jax_built
    plane = AnnPlane.open(root, device=CPU)
    nprobes = np.minimum(MIXED, len(plane.centroids))  # as batch_search clips them
    pq, pgc, csq, csum, _ = plane.probe_pairs(torch.from_numpy(queries), nprobes)
    assert len(pq) == nprobes.sum() and csum.dtype == np.float32 and not csum.any()


def test_ragged_score_on_ex_items_matches_pallas(jax_built):
    """The item scores of one shard's real ex tables: the port's plain
    version against the reference's Pallas kernel in interpret mode."""
    root, _, _, _, queries = jax_built
    plane = AnnPlane.open(root, device=CPU)
    pq, pgc, csq, csum, q_glob = plane.probe_pairs(torch.from_numpy(queries),
                                                   np.full(len(queries), 6))
    sh = plane.shards[0]
    m = plane.shard_of[pgc] == 0
    items = R.plan_items(pq[m], plane.local_cluster[pgc[m]], csq[m], csum[m], sh.tile_start,
                         sh.tile_count)
    got = R.ragged_score(*items, q_glob, sh.codes, sh.a, sh.b, sh.h).numpy()
    want = J.ragged_score_pallas(*items, q_glob.numpy(), sh.codes.numpy(), sh.a.numpy(),
                                 sh.b.numpy(), sh.h.numpy(), interpret=True)
    rows = np.asarray(items[1], np.int64)[:, None] * R.TILE + np.arange(R.TILE)
    terms = np.abs(sh.b.numpy()[rows]) + np.abs(items[2])[:, None] + np.abs(
        sh.a.numpy()[rows] * np.einsum("mtd,md->mt", sh.codes.numpy()[rows],
                                       q_glob.numpy()[items[0]]))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-4 + 1e-5 * terms).all()


# --------------------------------------- a port-built ex plane opened by JAX
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_jax_opens_port_ex_plane_and_searches_alike(port_built, mixed):
    root, _, plane, _, _, _, queries = port_built
    nprobes = MIXED if mixed else None
    got = plane.batch_search(queries, SearchParams(**PARAMS), nprobes=nprobes)
    ref = JaxPlane.open(root, use_pallas=False).batch_search(queries, JaxParams(**PARAMS),
                                                             nprobes=nprobes)
    assert_same_results(ref, got)


def test_port_ex_shards_carry_scales(port_built):
    root, cfg, _, manifest, _, _, _ = port_built
    bits = cfg.index.total_bits
    for e in manifest["shards"]:
        index = ManifestStore(shard_root(root, e["shard"])).read_at(e["generation"], device=CPU)
        assert index.config.total_bits == bits
        dtype = torch.int8 if bits <= 8 else torch.int16
        assert all(c.codes.dtype == dtype and len(c.scales) == len(c.ids)
                   for c in index.clusters)


def test_port_ex_plane_recall_and_batch_invariance(port_built):
    _, _, plane, _, vecs, ids, queries = port_built
    got, _ = plane.batch_search(queries, SearchParams(top_k=10, nprobe=12, rerank_depth=80))
    assert recall_at_k(exact_topk(vecs, ids, queries, 10), got) >= 0.95
    m_ids, m_d = plane.batch_search(queries, SearchParams(top_k=5, nprobe=8), nprobes=MIXED)
    for i, npb in enumerate(MIXED):
        one_ids, one_d = plane.search(queries[i], SearchParams(top_k=5, nprobe=int(npb)))
        np.testing.assert_array_equal(m_ids[i], one_ids)
        np.testing.assert_array_equal(m_d[i], one_d)


def test_sampled_ex_shard_matches_the_jax_builder(tmp_path):
    """A shard larger than ``train_sample_rows`` trains on the reference's
    sample, starts from empty ex clusters and inserts every row: the JAX
    builder's clusters and answers."""
    vecs, ids, queries = make_corpus(n=3_000)
    base = ex_config(rows_per_shard=3_000)
    cfg = AnnPlaneConfig(index=base.index, shard_budget_bytes=base.budget_bytes,
                         train_sample_rows=1_000)
    jcfg = jax_config(cfg)
    jcfg = type(jcfg)(index=jcfg.index, shard_budget_bytes=jcfg.shard_budget_bytes,
                      train_sample_rows=1_000)
    ShardedAnnBuilder(str(tmp_path / "p"), cfg, device=CPU).build(stream(vecs, ids))
    JaxBuilder(str(tmp_path / "j"), jcfg).build(stream(vecs, ids))
    from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore

    p = ManifestStore(shard_root(str(tmp_path / "p"), 0)).read_latest(device=CPU)
    j = JaxManifestStore(shard_root(str(tmp_path / "j"), 0)).read_latest()
    for pc, jc in zip(p.clusters, j.clusters):
        np.testing.assert_array_equal(pc.ids, jc.ids)
        assert pc.codes.dtype == torch.int8 and pc.codes.shape == jc.codes.shape
    assert_same_results(
        JaxPlane.open(str(tmp_path / "j"), use_pallas=False).batch_search(
            queries, JaxParams(**PARAMS)),
        AnnPlane.open(str(tmp_path / "p"), device=CPU).batch_search(queries,
                                                                    SearchParams(**PARAMS)),
    )


def test_interrupted_ex_build_resumes_shard_exact(tmp_path):
    vecs, ids, queries = make_corpus(n=5_000, seed=2)
    cfg = ex_config(bits=9)
    root = str(tmp_path / "p")
    builder = ShardedAnnBuilder(root, cfg, device=CPU)

    def broken():
        yield vecs[:2_000], ids[:2_000]
        yield vecs[2_000:3_000], ids[2_000:3_000]
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        builder.build(broken())
    partial = PlaneManifestStore(root).read()
    assert not partial["complete"] and len(partial["shards"]) == 1
    m = builder.build(stream(vecs, ids))
    assert m["complete"] and len(m["shards"]) == 3
    assert m["shards"][0] == partial["shards"][0]
    fresh = ShardedAnnBuilder(str(tmp_path / "fresh"), cfg, device=CPU).build(stream(vecs, ids))
    assert [s["num_vectors"] for s in m["shards"]] == [s["num_vectors"] for s in fresh["shards"]]
    # shard-exact: every resumed shard holds the same arrays as a fresh build's
    for a, b in zip(m["shards"], fresh["shards"]):
        sa = ManifestStore(shard_root(root, a["shard"])).read_at(a["generation"], device=CPU)
        sb = ManifestStore(shard_root(str(tmp_path / "fresh"), b["shard"])).read_at(
            b["generation"], device=CPU)
        for ca, cb in zip(sa.state()["clusters"], sb.state()["clusters"]):
            for f in ("codes", "scales", "norms", "factors", "ids", "code_dot_c", "raw"):
                np.testing.assert_array_equal(ca[f], cb[f])
    params = SearchParams(top_k=10, nprobe=8)
    a = AnnPlane.open(root, device=CPU).batch_search(queries, params)
    b = AnnPlane.open(str(tmp_path / "fresh"), device=CPU).batch_search(queries, params)
    for q in range(len(queries)):
        np.testing.assert_array_equal(a[0][q], b[0][q])
        np.testing.assert_array_equal(a[1][q], b[1][q])


def test_endpoint_serves_an_ex_plane(port_built):
    plane, queries = port_built[2], port_built[-1]
    params = SearchParams(top_k=5, nprobe=8)
    probes = [1, 8, 32, None]
    with ShardedAnnEndpoint(plane, params, max_wait_ms=20.0, name="port-ex-plane") as ep:
        futs = [ep.submit(queries[i], nprobe=probes[i % 4]) for i in range(len(queries))]
        outs = [f.result(timeout=30) for f in futs]
    for i, (ids, dists) in enumerate(outs):
        want = plane.search(queries[i], SearchParams(top_k=5, nprobe=probes[i % 4] or 8))
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(dists, want[1])


def test_ex_shard_without_scales_raises():
    vecs, ids, _ = make_corpus(n=1_000)
    cfg = ex_config()
    index = IvfRabitqIndex.train(vecs, ids, cfg.index, device=CPU)
    index.clusters[3].scales = None
    with pytest.raises(VectorIndexError, match="no scales"):
        AnnPlane.from_indexes(cfg, [index], device=CPU)
