"""A table written by either package opens and scans the same in the other.

For each physical format (parquet, LSF) and each table kind — a plain
append table; a hash-bucketed primary-key table with two upsert waves
(merge-on-read); a CDC table with a ``delete_where`` and CDC delete rows;
and a table with range partitions and hash buckets — one package writes the
table on one warehouse and one SQLite store, and the other package opens it
there.  Every scan's ``to_arrow()`` must be equal (``Table.equals``, and a
sha256 over each column's buffers) to the writing package's own scan: the
whole table, ``select`` + ``filter``, the union of ``shard(r, 4)``,
``count_rows``, a ``snapshot_at`` read taken before the second wave, and an
``incremental`` read between the two waves.
"""

import hashlib
import time

import numpy as np
import pyarrow as pa
import pytest

import lakesoul_tpu
import lakesoul_tpu.io.filters as jax_filters
import lakesoul_tpu_torch
import lakesoul_tpu_torch.io.filters as torch_filters

PACKAGES = {
    "jax": (lakesoul_tpu, jax_filters),
    "torch": (lakesoul_tpu_torch, torch_filters),
}
FORMATS = ("parquet", "lsf")
KINDS = ("plain", "pk_mor", "cdc", "range_hash")
DIRECTIONS = (("jax", "torch"), ("torch", "jax"))
SCHEMA = pa.schema(
    [("id", pa.int64()), ("v", pa.float64()), ("f", pa.float32()),
     ("name", pa.string()), ("date", pa.string())]
)


def _rows(rng, ids, tag: int) -> dict:
    n = len(ids)
    return {
        "id": np.asarray(ids, dtype=np.int64),
        "v": rng.normal(size=n),
        "f": rng.normal(size=n).astype(np.float32),
        "name": [f"r{tag}_{i}" for i in ids],
        "date": [f"d{i % 3}" for i in ids],
    }


def _max_ts(table) -> int:
    client = table.catalog.client
    return max(h.timestamp for h in client.store.get_all_latest_partition_info(table.info.table_id))


def _write(pkg_name: str, wh, fmt: str, kind: str):
    """Write the case's table with one package; returns (table, the
    timestamp after wave 1, the timestamp after wave 2)."""
    pkg, _ = PACKAGES[pkg_name]
    cat = pkg.LakeSoulCatalog(str(wh))
    rng = np.random.default_rng(7)
    props = {"lakesoul.file_format": fmt}
    if kind == "plain":
        t = cat.create_table("t", SCHEMA, properties=props)
        write = t.write_arrow
    elif kind == "pk_mor":
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=4, properties=props)
        write = t.upsert
    elif kind == "cdc":
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2, cdc=True,
                             properties=props)
        write = t.upsert
    else:
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], range_partitions=["date"],
                             hash_bucket_num=2, properties=props)
        write = t.upsert

    def batch(ids, tag, ops=None):
        cols = _rows(rng, ids, tag)
        if kind == "cdc":
            cols[t.info.cdc_column] = ops or ["insert"] * len(ids)
        return pa.table(cols, schema=t.schema)

    t.write_arrow(batch(range(300), 0))
    time.sleep(0.003)
    write(batch(list(range(0, 100)) + list(range(300, 340)), 1))
    if kind == "cdc":
        # a rewrite of the matching partitions (it leaves no delete rows)
        t.delete_where(PACKAGES[pkg_name][1].col("id") >= 330)
    ts1 = _max_ts(t)
    time.sleep(0.003)
    wave2 = list(range(50, 150)) + list(range(340, 400))
    # the CDC table's second wave carries delete rows, which a plain scan
    # drops and ``with_cdc_deletes`` keeps
    ops2 = ["delete" if i % 10 == 0 else "update" for i in wave2] if kind == "cdc" else None
    write(batch(wave2, 2, ops2))
    ts2 = _max_ts(t)
    return t, ts1, ts2


def _scans(pkg_name: str, wh, ts1: int, ts2: int, kind: str) -> dict:
    """Every scan the interop contract holds, through one package."""
    pkg, filters = PACKAGES[pkg_name]
    t = pkg.LakeSoulCatalog(str(wh)).table("t")
    s = t.scan()
    out = {
        "all": s.to_arrow(),
        "select_filter": s.select(["id", "f", "name"]).filter(filters.col("v") > 0.0).to_arrow(),
        "shards": pa.concat_tables([s.shard(r, 4).to_arrow() for r in range(4)]),
        "snapshot": s.snapshot_at(ts1).to_arrow(),
        "incremental": s.incremental(ts1, ts2).to_arrow(),
    }
    if kind == "cdc":
        out["cdc_deletes"] = s.with_cdc_deletes().to_arrow()
    out["count_rows"] = s.count_rows()
    return out


def _column_shas(table: pa.Table) -> list:
    shas = []
    for col in table.columns:
        h = hashlib.sha256()
        for chunk in col.chunks:
            for buf in chunk.buffers():
                if buf is not None:
                    h.update(buf.to_pybytes())
        shas.append(h.hexdigest())
    return shas


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_table_scans_the_same_in_the_other_package(tmp_path, fmt, kind, writer, reader):
    wh = tmp_path / "wh"
    wh.mkdir()
    _, ts1, ts2 = _write(writer, wh, fmt, kind)
    want = _scans(writer, wh, ts1, ts2, kind)
    got = _scans(reader, wh, ts1, ts2, kind)
    assert got.keys() == want.keys()
    assert got.pop("count_rows") == want.pop("count_rows") == want["all"].num_rows
    for name, table in want.items():
        assert got[name].equals(table), name
        assert _column_shas(got[name]) == _column_shas(table), name
    # the scans are not vacuous: the merge, the waves and the filter all bite
    assert want["all"].num_rows > 0 and want["incremental"].num_rows > 0
    assert 0 < want["select_filter"].num_rows < want["all"].num_rows
    if kind != "plain":
        assert want["snapshot"].num_rows < want["all"].num_rows
    if kind == "cdc":
        assert want["cdc_deletes"].num_rows > want["all"].num_rows
