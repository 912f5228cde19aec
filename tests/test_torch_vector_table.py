"""The port's table vector index (``lakesoul_tpu_torch/vector/builder.py``:
``build_vector_index``, ``vector_search``, ``scan().vector_search``) against
the JAX package's, on the CPU.

Each table is written by the reference package; the two packages build
their own index over it (each in a warehouse of its own, made from the same
seed) or one package builds and both search.  A shard written by either
package opens in the other.  Tolerances: ids equal except where two
distances tie within 1e-5 (relative); distances at rtol 1e-5 with an
absolute floor of 1e-4 — both sides compute in float32 in another order
(see ``test_torch_vector_index.py``).  Row counts, indexed files and the
rows a vector-filtered scan returns are exact."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu
import lakesoul_tpu.vector.builder as ref_builder
import lakesoul_tpu_torch
import lakesoul_tpu_torch.vector.builder as port_builder
from lakesoul_tpu.errors import VectorIndexError as RefVectorIndexError
from lakesoul_tpu.vector.config import VectorIndexConfig as RefConfig
from lakesoul_tpu.vector.manifest import ManifestStore as RefStore
from lakesoul_tpu_torch.errors import ConfigError, VectorIndexError
from lakesoul_tpu_torch.vector import IvfRabitqIndex, VectorIndexConfig
from lakesoul_tpu_torch.vector.manifest import ManifestStore

RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5
DIM, N_ROWS, NLIST, BUCKETS = 16, 1_200, 8, 2
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


SCHEMA = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), DIM)),
                    ("tag", pa.string())])


def _rows(ids, rng):
    vecs = (rng.normal(size=(8, DIM)) * 3.0)[rng.integers(0, 8, len(ids))] \
        + rng.normal(size=(len(ids), DIM))
    return pa.table({"id": np.asarray(ids, np.int64),
                     "emb": pa.FixedSizeListArray.from_arrays(
                         vecs.astype(np.float32).reshape(-1), DIM),
                     "tag": [f"t{i}" for i in ids]}, schema=SCHEMA)


def _write(wh, *, commits=2, seed=0):
    """A primary-key table (``hash_bucket_num=2``) in ``commits`` writes, by
    the reference package; the port and the reference open it."""
    rng = np.random.default_rng(seed)
    t = lakesoul_tpu.LakeSoulCatalog(str(wh)).create_table(
        "vecs", SCHEMA, primary_keys=["id"], hash_bucket_num=BUCKETS)
    for part in np.array_split(np.arange(N_ROWS), commits):
        t.write_arrow(_rows(part, rng))
    return _tables(wh)


def _tables(wh):
    return (lakesoul_tpu.LakeSoulCatalog(str(wh)).table("vecs"),
            lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("vecs"))


def _queries(n=12, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, DIM)) * 3.0).astype(np.float32)


def _search_both(ref_t, port_t, q, **kw):
    return (ref_t.vector_search("emb", q, **kw),
            port_t.vector_search("emb", q, device=CPU, **kw))


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_index_built_by_either_package_searches_alike_in_both(tmp_path, builder):
    ref_t, port_t = _write(tmp_path)
    if builder == "jax":
        total = ref_t.build_vector_index("emb", nlist=NLIST, seed=3)
    else:
        total = port_t.build_vector_index("emb", nlist=NLIST, seed=3, device=CPU)
    assert total == N_ROWS
    ref_t, port_t = _tables(tmp_path)  # both see the recorded config
    assert ref_t.info.properties["vector_index_columns"] == \
        port_t.info.properties["vector_index_columns"] == RefConfig(
            column="emb", dim=DIM, nlist=NLIST, seed=3).encode()
    for q in _queries():
        for kw in ({"top_k": 5, "nprobe": 3}, {"top_k": 10, "nprobe": NLIST}):
            (ri, rd), (pi, pd) = _search_both(ref_t, port_t, q, **kw)
            assert_same_topk(ri, rd, pi, pd)
    # scan().vector_search: the rows behind the ids, through merge-on-read
    for q in _queries(4):
        ids, _ = port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, device=CPU)
        got = port_t.scan().vector_search("emb", q, top_k=5, nprobe=NLIST, device=CPU).to_arrow()
        want = ref_t.scan().vector_search("emb", q, top_k=5, nprobe=NLIST).to_arrow()
        assert sorted(got.column("id").to_pylist()) == sorted(int(i) for i in ids)
        assert got.sort_by("id").equals(want.sort_by("id"))


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_a_shard_written_by_either_package_opens_in_the_other(tmp_path, builder):
    ref_t, port_t = _write(tmp_path)
    if builder == "jax":
        ref_t.build_vector_index("emb", nlist=NLIST)
    else:
        port_t.build_vector_index("emb", nlist=NLIST, device=CPU)
    units = port_t.scan().scan_plan()
    assert len(units) == BUCKETS
    for unit in units:
        root = port_builder._shard_root(port_t.info.table_path, "emb", unit.partition_desc,
                                        unit.bucket_id)
        assert root == ref_builder._shard_root(ref_t.info.table_path, "emb",
                                               unit.partition_desc, unit.bucket_id)
        p_store, r_store = ManifestStore(root), RefStore(root)
        assert p_store.read_manifest() == r_store.read_manifest()
        assert p_store.read_manifest()["indexed_files"] == sorted(unit.data_files)
        port_ix, ref_ix = p_store.read_latest(device=CPU), r_store.read_latest()
        assert port_ix.num_vectors == ref_ix.num_vectors > 0
        for c_ref, c_port in zip(ref_ix.clusters, port_ix.clusters):
            np.testing.assert_array_equal(c_ref.ids, c_port.ids)
            np.testing.assert_array_equal(c_ref.codes, c_port.codes.numpy())


def test_incremental_build_after_an_upsert_ingests_only_the_new_files(tmp_path):
    counts = {}
    for name in ("jax", "port"):
        wh = tmp_path / name
        ref_t, port_t = _write(wh)
        t = ref_t if name == "jax" else port_t
        kw = {} if name == "jax" else {"device": CPU}
        assert t.build_vector_index("emb", nlist=NLIST, **kw) == N_ROWS
        assert t.build_vector_index("emb", nlist=NLIST, incremental=True, **kw) == 0
        before = {u.bucket_id: set(u.data_files) for u in t.scan().scan_plan()}
        # an upsert wave: 60 rows rewritten, 40 new ids
        lakesoul_tpu.LakeSoulCatalog(str(wh)).table("vecs").upsert(
            _rows(np.r_[np.arange(0, 1200, 20), np.arange(5000, 5040)],
                  np.random.default_rng(1)))
        t = _tables(wh)[0 if name == "jax" else 1]
        counts[name] = t.build_vector_index("emb", nlist=NLIST, incremental=True, **kw)
        for u in t.scan().scan_plan():
            root = port_builder._shard_root(t.info.table_path, "emb", u.partition_desc,
                                            u.bucket_id)
            manifest = ManifestStore(root).read_manifest()
            new = set(u.data_files) - before[u.bucket_id]
            assert new and set(manifest["indexed_files"]) == before[u.bucket_id] | new
            assert len(manifest["delta_segments"]) > 0  # inserted, not rebuilt
    assert counts["jax"] == counts["port"] == 100
    # the new ids are found, the upserted rows by their new vectors
    port_t = _tables(tmp_path / "port")[1]
    new = port_t.scan().to_arrow().to_pydict()
    emb = {i: np.asarray(e, np.float32) for i, e in zip(new["id"], new["emb"])}
    for i in (5007, 20, 1180):
        ids, _ = port_t.vector_search("emb", emb[i], top_k=1, nprobe=NLIST, device=CPU)
        assert int(ids[0]) == i


def test_two_pass_build_above_the_train_sample_rows(tmp_path, monkeypatch):
    """Above ``DEFAULT_TRAIN_SAMPLE_ROWS`` (lowered here) a shard trains on
    the reservoir sample, then a second pass inserts every row: the
    reference takes the same path through ``VectorShardIndexBuilder(...,
    train_sample_rows=...)`` and both answer alike over the port's shards."""
    ref_t, port_t = _write(tmp_path, commits=3)
    monkeypatch.setattr(port_builder, "DEFAULT_TRAIN_SAMPLE_ROWS", 300)
    trained = []
    real_train = IvfRabitqIndex.train.__func__

    def spy(cls, vectors, ids, config, **kw):
        trained.append(len(ids))
        return real_train(cls, vectors, ids, config, **kw)

    monkeypatch.setattr(IvfRabitqIndex, "train", classmethod(spy))
    assert port_t.build_vector_index("emb", nlist=NLIST, device=CPU) == N_ROWS
    assert trained == [300] * BUCKETS  # the sample, not the ~600-row shards
    ref_t, port_t = _tables(tmp_path)
    for unit in port_t.scan().scan_plan():
        root = port_builder._shard_root(port_t.info.table_path, "emb", unit.partition_desc,
                                        unit.bucket_id)
        ix = RefStore(root).read_latest()
        assert ix.num_vectors == sum(len(c.ids) for c in ix.clusters) > 300
        assert not any(ix.deltas)  # pass 2's deltas merged
    for q in _queries():
        (ri, rd), (pi, pd) = _search_both(ref_t, port_t, q, top_k=5, nprobe=NLIST)
        assert_same_topk(ri, rd, pi, pd)
    # the reference's own two-pass build, unit by unit, indexes the same rows
    cfg = RefConfig(column="emb", dim=DIM, nlist=NLIST)
    ref_b = ref_builder.VectorShardIndexBuilder(str(tmp_path / "refix"), cfg, "id",
                                                train_sample_rows=300)
    port_b = port_builder.VectorShardIndexBuilder(str(tmp_path / "portix"),
                                                  VectorIndexConfig.parse(cfg.encode()), "id",
                                                  train_sample_rows=300, device=CPU)
    for unit in port_t.scan().scan_plan():
        assert port_b.build(unit, port_t.info.arrow_schema) == ref_b.build(
            unit, ref_t.info.arrow_schema)


def _bad_table(kind):
    if kind == "null":
        arr = pa.array([[1.0] * DIM, None], pa.list_(pa.float32(), DIM))
    elif kind == "width":
        arr = pa.FixedSizeListArray.from_arrays(pa.array(np.zeros(2 * 8, np.float32)), 8)
    else:
        arr = pa.array([1.0, 2.0], pa.float32())
    return pa.table({"emb": arr, "id": np.arange(2, dtype=np.int64)})


@pytest.mark.parametrize("kind", ["null", "width", "type"])
def test_extract_vectors_errors_typed_alike(kind):
    with pytest.raises(RefVectorIndexError) as r:
        ref_builder.extract_vectors(_bad_table(kind), "emb", "id", DIM)
    with pytest.raises(VectorIndexError) as p:
        port_builder.extract_vectors(_bad_table(kind), "emb", "id", DIM)
    assert str(p.value) == str(r.value)


def test_extract_vectors_equals_the_reference():
    t = _rows(np.arange(50), np.random.default_rng(2))
    rv, ri = ref_builder.extract_vectors(t, "emb", "id", DIM)
    pv, pi = port_builder.extract_vectors(t, "emb", "id", DIM)
    assert pv.tobytes() == rv.tobytes() and pi.tobytes() == ri.tobytes()
    assert pi.dtype == np.uint64


@pytest.mark.parametrize("case", ["no_pk", "composite_pk", "not_built"])
def test_table_errors_typed_alike(tmp_path, case):
    if case == "not_built":
        ref_t, port_t = _write(tmp_path)
        with pytest.raises(RefVectorIndexError) as r:
            ref_t.vector_search("emb", _queries(1)[0])
        with pytest.raises(VectorIndexError) as p:
            port_t.vector_search("emb", _queries(1)[0], device=CPU)
    else:
        pks = [] if case == "no_pk" else ["id", "tag"]
        lakesoul_tpu.LakeSoulCatalog(str(tmp_path)).create_table(
            "vecs", SCHEMA, primary_keys=pks)
        ref_t, port_t = _tables(tmp_path)
        with pytest.raises(RefVectorIndexError) as r:
            ref_t.build_vector_index("emb", nlist=NLIST)
        with pytest.raises(VectorIndexError) as p:
            port_t.build_vector_index("emb", nlist=NLIST, device=CPU)
    assert str(p.value) == str(r.value)


def test_the_entry_points_need_a_card_unless_told_the_cpu(tmp_path):
    assert not torch.cuda.is_available()
    _, port_t = _write(tmp_path)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        port_t.build_vector_index("emb", nlist=NLIST)
    port_t.build_vector_index("emb", nlist=NLIST, device=CPU)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        port_t.vector_search("emb", _queries(1)[0])
    with pytest.raises(ConfigError, match="CUDA is not available"):
        port_t.scan().vector_search("emb", _queries(1)[0]).to_arrow()


def test_an_opened_shard_is_kept_until_its_latest_moves(tmp_path, monkeypatch):
    """A search without a handle reads its shards every time, as the
    reference's; ``index=TableVectorIndex(...)`` opens each once, answers
    alike (the search and the vector-filtered scan), re-opens a shard after
    a build moves its ``LATEST``, and drops them all on ``release``."""
    _, port_t = _write(tmp_path)
    port_t.build_vector_index("emb", nlist=NLIST, device=CPU)
    reads = []
    real = ManifestStore.read_latest

    def counting(self, **kw):
        reads.append(self.root)
        return real(self, **kw)

    monkeypatch.setattr(ManifestStore, "read_latest", counting)
    q = _queries(1)[0]
    want = port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, device=CPU)
    port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, device=CPU)
    assert len(reads) == 2 * BUCKETS  # no handle: read on every search
    reads.clear()
    with port_builder.TableVectorIndex(CPU) as handle:
        first = port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, index=handle)
        second = port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, index=handle)
        scan = port_t.scan().vector_search("emb", q, top_k=5, nprobe=NLIST, index=handle)
        assert sorted(scan.to_arrow().column("id").to_pylist()) == sorted(first[0].tolist())
        assert len(reads) == BUCKETS  # opened once each
        assert_same_topk(*want, *first)
        np.testing.assert_array_equal(first[0], second[0])
        port_t.build_vector_index("emb", nlist=NLIST, device=CPU)  # a new generation
        port_t.vector_search("emb", q, top_k=5, nprobe=NLIST, index=handle)
        assert len(reads) == 2 * BUCKETS
        assert {g for g, _ in handle._shards.values()} == {2}
        with pytest.raises(VectorIndexError, match="not both"):
            port_t.vector_search("emb", q, index=handle, device=CPU)
    assert not handle._shards