"""The port's plane table feed (``iter_table_vectors``,
``build_table_ann_plane``), its host search path (``ragged_topk_host`` and
the native re-rank, which a plane opened on the CPU runs) and its manifest
stores on an object-store URI, against the JAX package, on the CPU.

Tolerances: streamed vectors and ids, manifests, shard digests and resumed
shards are exact.  Search answers: ids equal except where two distances tie
within 1e-5 (relative), distances at rtol 1e-5, atol 1e-4 (float32 sums in
another order; see ``test_torch_annplane_plane.py``).  Estimator scores of
the host path against the item path: rtol 1e-5 with an absolute floor of
1e-4 of the terms' magnitude (``est = b + csq - h·csum - a·g``: the terms
are ~1e2 and cancel)."""

import hashlib

import fsspec
import numpy as np
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu
import lakesoul_tpu.annplane.ragged as ref_ragged
import lakesoul_tpu_torch
import lakesoul_tpu_torch.annplane.build as port_build
from lakesoul_tpu.annplane import AnnPlane as JaxPlane
from lakesoul_tpu.annplane import build_table_ann_plane as ref_build_table_ann_plane
from lakesoul_tpu.annplane import iter_table_vectors as ref_iter_table_vectors
from lakesoul_tpu.vector.index import SearchParams as JaxParams
from lakesoul_tpu.vector.manifest import ManifestStore as JaxManifestStore
from lakesoul_tpu_torch import native
from lakesoul_tpu_torch.annplane import (
    AnnPlane,
    AnnPlaneConfig,
    PlaneManifestStore,
    ShardedAnnBuilder,
    build_table_ann_plane,
    iter_table_vectors,
)
from lakesoul_tpu_torch.annplane import ragged, search
from lakesoul_tpu_torch.annplane.build import shard_root
from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
from lakesoul_tpu_torch.vector.manifest import ManifestStore

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
D, N, NLIST = 16, 6_000, 8
CPU = "cpu"


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


def _corpus(seed=3, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, D)).astype(np.float32) * 3.0
    vals = centers[rng.integers(0, 32, n)] + rng.normal(size=(n, D)).astype(np.float32)
    queries = centers[rng.integers(0, 32, 12)] + rng.normal(size=(12, D)).astype(np.float32)
    return vals.astype(np.float32), queries.astype(np.float32)


SCHEMA = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), D))])


def _table(wh, *, pk: bool):
    """The scale leg's table shape (micro.py:1382-1395) at a small size:
    ``id`` int64, ``emb`` FixedSizeList<float32>, LSF, in three commits;
    with ``pk`` a primary-key table (``hash_bucket_num=2``) with an upsert
    wave, so the scan merges on read.  Written by the reference package."""
    vals, _ = _corpus()
    kw = {"primary_keys": ["id"], "hash_bucket_num": 2} if pk else {}
    t = lakesoul_tpu.LakeSoulCatalog(str(wh)).create_table(
        "corpus", SCHEMA, properties={"lakesoul.file_format": "lsf"}, **kw)
    for part in np.array_split(np.arange(N), 3):
        t.write_arrow(pa.table({"id": part, "emb": pa.FixedSizeListArray.from_arrays(
            pa.array(vals[part].reshape(-1)), D)}, schema=SCHEMA))
    if pk:
        up = np.arange(0, N, 7)
        t.upsert(pa.table({"id": up, "emb": pa.FixedSizeListArray.from_arrays(
            pa.array((vals[up] + 0.5).reshape(-1)), D)}, schema=SCHEMA))
    return (lakesoul_tpu.LakeSoulCatalog(str(wh)).table("corpus"),
            lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("corpus"))


def _plane_config(rows_per_shard=2_500, bits=4):
    index = VectorIndexConfig(column="emb", dim=D, nlist=NLIST, total_bits=bits)
    probe = AnnPlaneConfig(index=index, shard_budget_bytes=1 << 30)
    return AnnPlaneConfig(index=index,
                          shard_budget_bytes=rows_per_shard * probe.bytes_per_vector())


@pytest.mark.parametrize("pk", [False, True], ids=["plain", "pk_upserted"])
def test_iter_table_vectors_streams_what_the_reference_streams(tmp_path, pk):
    ref_t, port_t = _table(tmp_path, pk=pk)
    want = list(ref_iter_table_vectors(ref_t, "emb", "id", batch_size=1_000))
    got = list(iter_table_vectors(port_t, "emb", "id", batch_size=1_000))
    assert len(got) == len(want) > 3
    for (gv, gi), (wv, wi) in zip(got, want):
        assert gv.dtype == wv.dtype == np.float32 and gi.dtype == wi.dtype == np.uint64
        assert gv.tobytes() == wv.tobytes() and gi.tobytes() == wi.tobytes()
    assert sum(len(i) for _, i in got) == N


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_table_plane_built_by_either_package_answers_alike(tmp_path, builder):
    ref_t, port_t = _table(tmp_path, pk=True)
    cfg = _plane_config()
    if builder == "jax":
        from lakesoul_tpu.annplane import AnnPlaneConfig as JaxPlaneConfig
        from lakesoul_tpu.vector.config import VectorIndexConfig as JaxConfig

        manifest = ref_build_table_ann_plane(ref_t, "emb", config=JaxPlaneConfig(
            index=JaxConfig.parse(cfg.index.encode()), shard_budget_bytes=cfg.budget_bytes))
    else:
        manifest = build_table_ann_plane(port_t, "emb", config=cfg, device=CPU)
    assert manifest["complete"] and manifest["total_rows"] == N
    assert len(manifest["shards"]) == 3
    root = f"{port_t.info.table_path}/_ann_plane/emb"
    assert PlaneManifestStore(root).read() == manifest
    _, queries = _corpus()
    for kw in ({"nprobes": None}, {"nprobes": np.array([2, 4, 8, 24] * 3)}):
        want = JaxPlane.open(root, use_pallas=False).batch_search(
            queries, JaxParams(top_k=10, nprobe=6, rerank_depth=40), **kw)
        got = AnnPlane.open(root, device=CPU).batch_search(
            queries, SearchParams(top_k=10, nprobe=6, rerank_depth=40), **kw)
        assert_same_results(want, got)


def test_build_from_table_keyword_config_as_the_reference(tmp_path):
    """The reference's own call (``tests/test_annplane.py:190``): a non-PK
    table, ``id_column=``, the index config by keyword."""
    _, port_t = _table(tmp_path, pk=False)
    manifest = build_table_ann_plane(
        port_t, "emb", id_column="id", nlist=NLIST, total_bits=4,
        shard_budget_bytes=_plane_config().budget_bytes, device=CPU)
    assert manifest["complete"] and manifest["total_rows"] == N
    assert len(manifest["shards"]) >= 2
    vals, _ = _corpus()
    plane = AnnPlane.open(f"{port_t.info.table_path}/_ann_plane/emb", device=CPU)
    ids, _ = plane.search(vals[42], SearchParams(top_k=1, nprobe=NLIST))
    assert int(ids[0]) == 42


def _digests(root):
    out = []
    for e in PlaneManifestStore(root).read()["shards"]:
        store = ManifestStore(shard_root(root, e["shard"]))
        st = store.state(store.read_manifest_at(e["generation"]))
        h = hashlib.sha256(np.ascontiguousarray(st["centroids"]).tobytes())
        for seg in st["clusters"] + sum(st["deltas"], []):
            for f in sorted(seg):
                h.update(f.encode() + np.ascontiguousarray(seg[f]).tobytes())
        out.append((e["row_start"], e["row_end"], h.hexdigest()))
    return out


def test_build_table_ann_plane_resumes_shard_exact(tmp_path, monkeypatch):
    _, port_t = _table(tmp_path, pk=True)
    cfg = _plane_config(rows_per_shard=2_000)
    fresh = str(tmp_path / "fresh")
    build_table_ann_plane(port_t, "emb", config=cfg, root=fresh, device=CPU)
    real = port_build.iter_table_vectors

    def dies_midway(*a, **kw):  # a crash in the third shard, in 500-row pieces
        seen = 0
        for v, i in real(*a, **kw):
            for lo in range(0, len(i), 500):
                if seen >= 4_500:
                    raise RuntimeError("killed")
                seen += len(i[lo:lo + 500])
                yield v[lo:lo + 500], i[lo:lo + 500]

    root = str(tmp_path / "resumed")
    monkeypatch.setattr(port_build, "iter_table_vectors", dies_midway)
    with pytest.raises(RuntimeError, match="killed"):
        build_table_ann_plane(port_t, "emb", config=cfg, root=root, device=CPU)
    partial = PlaneManifestStore(root).read()
    assert not partial["complete"] and len(partial["shards"]) == 2
    monkeypatch.setattr(port_build, "iter_table_vectors", real)
    manifest = build_table_ann_plane(port_t, "emb", config=cfg, root=root, device=CPU)
    assert manifest["complete"] and manifest["total_rows"] == N
    assert manifest["shards"][:2] == partial["shards"]  # the durable shards stand
    assert _digests(root) == _digests(fresh)


@pytest.fixture(scope="module")
def cpu_plane(tmp_path_factory):
    vals, queries = _corpus()
    root = str(tmp_path_factory.mktemp("plane") / "p")
    for bits in (1, 4):
        ShardedAnnBuilder(f"{root}{bits}", _plane_config(bits=bits), device=CPU).build(
            [(vals, np.arange(N, dtype=np.uint64))])
    return {bits: AnnPlane.open(f"{root}{bits}", device=CPU) for bits in (1, 4)}, queries


def _shard_pairs(plane, queries, nprobe=5):
    q = torch.from_numpy(queries)
    pq, pgc, csq, csum, q_glob = plane.probe_pairs(q, np.full(len(q), nprobe, np.int64))
    sel = plane.shard_of[pgc]
    for si, sh in enumerate(plane.shards):
        m = sel == si
        yield sh, pq[m], plane.local_cluster[pgc[m]], csq[m], csum[m], q_glob


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("path", ["native", "torch"])
def test_ragged_topk_host_equals_the_plain_item_path(cpu_plane, monkeypatch, bits, path):
    """A CPU plane's shortlist: ``ragged_topk_host`` where the native library
    is built, else the item path on ``ragged_score``'s plain version — each
    equal to the item path and to the reference's host path."""
    if path == "torch":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    planes, queries = cpu_plane
    plane = planes[bits]
    nq, s = len(queries), 40
    for sh, pq, plc, csq, csum, q_glob in _shard_pairs(plane, queries):
        rows, est = (t.numpy() for t in plane._score_shard(sh, q_glob, pq, plc, csq, csum, nq, s))
        items = ragged.plan_items(pq, plc, csq, csum, sh.tile_start, sh.tile_count)
        scores = ragged.ragged_score(*items, q_glob, sh.codes, sh.a, sh.b, sh.h)
        want_rows, want_est = ragged.items_topk(scores, items[0], items[1], nq, s)
        want_rows, want_est = want_rows.numpy(), want_est.numpy()
        # the reference's host path on the same arrays
        ref_rows, ref_est = ref_ragged.ragged_topk_host(
            sh.codes.numpy(), sh.a.numpy(), sh.b.numpy(), sh.h.numpy(), sh.row_start,
            sh.row_count, pq, plc, csq, csum, q_glob.numpy(), nq, s)
        scale = 1e-4 * max(1.0, float(np.abs(sh.b.numpy()[sh.b.numpy() < 1e29]).max()))
        # every (query, row) score of the item path
        full = np.full((nq, len(sh.codes)), np.inf, np.float32)
        cols = np.asarray(items[1], np.int64)[:, None] * sh.tile + np.arange(sh.tile)
        full[np.asarray(items[0], np.int64)[:, None], cols] = scores.numpy()
        for r_all, e_all in ((rows, est), (ref_rows, ref_est)):
            assert r_all.shape == e_all.shape == want_est.shape == (nq, s)
            for q in range(nq):
                # the same shortlist of estimates, in any order...
                np.testing.assert_allclose(np.sort(e_all[q]), np.sort(want_est[q]),
                                           rtol=RTOL, atol=scale)
                # ...and each row's estimate is the item path's for that row
                valid = r_all[q] >= 0
                assert np.array_equal(valid, np.isfinite(e_all[q]))
                np.testing.assert_allclose(e_all[q][valid], full[q, r_all[q][valid]],
                                           rtol=RTOL, atol=scale)


def test_cpu_rerank_native_equals_torch_and_float64(cpu_plane, monkeypatch):
    """The CPU re-rank: the native library's, else the float64
    ``exact_distances`` the card runs — both the float64 distances."""
    planes, queries = cpu_plane
    sh = planes[1].shards[0]
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(-1, len(sh.ids), (len(queries), 30)))
    q = torch.from_numpy(queries)
    native_d = AnnPlane._rerank_shard(sh, q, rows, None).numpy()
    monkeypatch.setattr(native, "available", lambda: False)
    torch_d = AnnPlane._rerank_shard(sh, q, rows, None).numpy()
    raw = sh.raw.numpy().astype(np.float64)[np.clip(rows.numpy(), 0, None)]
    exact = ((raw - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)
    exact[rows.numpy() < 0] = np.inf
    for got in (native_d, torch_d):
        assert np.array_equal(np.isinf(got), rows.numpy() < 0)
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)


def test_a_cpu_plane_takes_the_host_path(cpu_plane, monkeypatch):
    """The branch is the plane's device: on the CPU the shortlist is
    ``ragged_topk_host``'s and ``ragged_score`` is never called."""
    planes, queries = cpu_plane
    calls = []
    real = search.ragged_topk_host

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def forbidden(*a, **kw):
        raise AssertionError("ragged_score on a CPU plane")

    monkeypatch.setattr(search, "ragged_topk_host", spy)
    monkeypatch.setattr(search, "ragged_score", forbidden)
    ids, d = planes[4].batch_search(queries, SearchParams(top_k=10, nprobe=6))
    assert calls and all(len(i) == 10 for i in ids)


def test_manifests_on_an_object_store_uri(tmp_path):
    """Both stores through ``io/object_store.py``: a plane and an index
    written to a ``memory://`` URI by the port open there in both
    packages, with equal answers."""
    vals, queries = _corpus()
    root = "memory://lakesoul-test/plane"
    fsspec.filesystem("memory").rm("/lakesoul-test", recursive=True) \
        if fsspec.filesystem("memory").exists("/lakesoul-test") else None
    manifest = ShardedAnnBuilder(root, _plane_config(), device=CPU).build(
        [(vals, np.arange(N, dtype=np.uint64))])
    assert manifest["complete"] and PlaneManifestStore(root).read() == manifest
    assert not (tmp_path / "lakesoul-test").exists()
    want = JaxPlane.open(root, use_pallas=False).batch_search(
        queries, JaxParams(top_k=10, nprobe=6, rerank_depth=40))
    got = AnnPlane.open(root, device=CPU).batch_search(
        queries, SearchParams(top_k=10, nprobe=6, rerank_depth=40))
    assert_same_results(want, got)
    ix_root = "memory://lakesoul-test/index"
    index = IvfRabitqIndex.train(vals, np.arange(N, dtype=np.uint64),
                                 VectorIndexConfig(column="emb", dim=D, nlist=NLIST), device=CPU)
    store = ManifestStore(ix_root)
    assert store.write_index(index, indexed_files=["b.lsf", "a.lsf"]) == 1
    assert store.exists() and store.read_manifest()["indexed_files"] == ["a.lsf", "b.lsf"]
    assert JaxManifestStore(ix_root).read_latest().num_vectors == N
    assert store.read_latest(device=CPU).num_vectors == N
    fsspec.filesystem("memory").rm("/lakesoul-test", recursive=True)
