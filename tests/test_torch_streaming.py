"""The port's streaming ingest (``lakesoul_tpu_torch/streaming/``) against the
reference's: the same seeded calls on twin warehouses, and both packages on
one warehouse where the point is that a checkpoint id committed by one is a
replay for the other.

- ``CdcIngestor``: one seeded stream of inserts, updates and deletes, in
  buffered epochs with a replayed checkpoint, gives the reference's table;
  its commit ids are the reference's.
- ``CheckpointedWriter``: ``checkpoint_replace`` swaps the table's content
  replay-safely, ``adopt_staged`` carries staged files across writers, as
  in the reference.
- ``DatabaseSyncer`` (a sqlite source) and ``DebeziumJsonConsumer``
  (auto-create, schema evolution, an epoch replayed twice) give identical
  tables in both packages.
"""

from __future__ import annotations

import hashlib
import sqlite3

import numpy as np
import pyarrow as pa
import pytest

import lakesoul_tpu.streaming as ref_streaming
from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.errors import ConfigError as RefConfigError
from lakesoul_tpu.streaming.cdc import checkpoint_commit_id as ref_commit_id
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch import streaming
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.streaming.cdc import checkpoint_commit_id
from lakesoul_tpu_torch.analysis.arm import armed

PKGS = ("port", "ref")
CATALOGS = {"port": LakeSoulCatalog, "ref": RefCatalog}
MODS = {"port": streaming, "ref": ref_streaming}
ERRORS = {"port": ConfigError, "ref": RefConfigError}
SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64()), ("tag", pa.string())])


@pytest.fixture
def twins(tmp_path):
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        out[pkg] = CATALOGS[pkg](str(tmp_path / pkg / "wh"), db_path=str(tmp_path / pkg / "meta.db"))
    return out


@pytest.fixture
def shared(tmp_path):
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    return {pkg: CATALOGS[pkg](wh, db_path=db) for pkg in PKGS}


def _sha(table, key="id") -> str:
    got = table.scan().to_arrow().sort_by(key)
    return hashlib.sha256(repr((got.schema.names, got.to_pydict())).encode()).hexdigest()


def _events(seed=0, n=600, keys=150):
    """A seeded CDC stream: inserts of new keys, updates and deletes of live
    ones (deletes carry only the key)."""
    rng = np.random.default_rng(seed)
    live: set[int] = set()
    out = []
    for i in range(n):
        r = rng.random()
        k = int(rng.integers(0, keys))
        if k not in live or r < 0.2:
            op = "insert" if k not in live else "update"
            live.add(k)
            out.append((op, {"id": k, "v": float(rng.normal()), "tag": f"t{i % 7}"}))
        elif r < 0.35:
            live.discard(k)
            out.append(("delete", {"id": k}))
        else:
            out.append(("update", {"id": k, "v": float(i), "tag": None}))
    return out


def _ingest(pkg, cat, events, *, buffer_rows, epochs=4):
    t = cat.create_table("cdc", SCHEMA, primary_keys=["id"], hash_bucket_num=2, cdc=True)
    ing = MODS[pkg].CdcIngestor(t, buffer_rows=buffer_rows)
    per = len(events) // epochs
    committed = []
    for e in range(epochs):
        ing.apply_many(events[e * per:(e + 1) * per])
        committed.append(ing.checkpoint(e))
    return t, committed


# ---------------------------------------------------------------- CDC ingest
@pytest.mark.parametrize("buffer_rows", [7, 10_000])
def test_cdc_ingest_gives_the_references_table(twins, buffer_rows):
    events = _events()
    out = {}
    for pkg, cat in twins.items():
        t, committed = _ingest(pkg, cat, events, buffer_rows=buffer_rows)
        # a replayed epoch (a restarted source re-sends epoch 2) is a no-op
        again = MODS[pkg].CdcIngestor(cat.table("cdc"), buffer_rows=buffer_rows)
        again.apply_many(events[150:300])
        replay = again.checkpoint(1)
        store = cat.client.store
        versions = [v.commit_op.value for v in store.get_partition_versions(t.info.table_id, "-5")]
        out[pkg] = (committed, replay, versions, _sha(cat.table("cdc")))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [1, 1, 1, 1] and out["port"][1] == 0


def test_cdc_commit_ids_are_the_references(shared):
    """On one warehouse: the port commits epochs 0-3; the reference,
    replaying epoch 2 with the same events, finds its ids already durable
    and commits nothing, and so does the port replaying the reference's."""
    events = _events(seed=3)
    t, _ = _ingest("port", shared["port"], events, buffer_rows=64)
    store = shared["port"].client.store
    ids = {c for v in store.get_partition_versions(t.info.table_id, "-5") for c in v.snapshot}
    assert {checkpoint_commit_id(t.info.table_id, "-5", e) for e in range(4)} == ids
    assert all(checkpoint_commit_id(t.info.table_id, "-5", e) ==
               ref_commit_id(t.info.table_id, "-5", e) for e in (0, "x", 17))
    before = _sha(t)
    ref = ref_streaming.CdcIngestor(shared["ref"].table("cdc"))
    ref.apply_many(events[300:450])
    assert ref.checkpoint(2) == 0
    ref.apply_many(events[:10])
    assert ref.checkpoint(4) == 1  # a new epoch lands
    port = streaming.CdcIngestor(shared["port"].table("cdc"))
    port.apply_many(events[:10])
    assert port.checkpoint(4) == 0  # the reference's epoch 4, replayed
    assert _sha(shared["port"].table("cdc")) == _sha(shared["ref"].table("cdc"))
    assert _sha(shared["port"].table("cdc")) != before


@pytest.mark.parametrize("case", ["not_cdc", "no_pk", "bad_op"])
def test_cdc_ingestor_refusals_are_the_references(twins, case):
    msgs = {}
    for pkg, cat in twins.items():
        kw = {"primary_keys": ["id"], "cdc": True}
        if case == "not_cdc":
            kw = {"primary_keys": ["id"]}
        elif case == "no_pk":
            kw = {"cdc": True}
        t = cat.create_table("t", SCHEMA, **kw)
        with pytest.raises(ERRORS[pkg]) as e:
            MODS[pkg].CdcIngestor(t).apply("upsert", {"id": 1})
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["ref"]


# --------------------------------------------------------- replace and adopt
def _parts_table(cat):
    schema = pa.schema([("p", pa.utf8()), ("id", pa.int64())])
    t = cat.create_table("parts", schema, range_partitions=["p"])
    t.write_arrow(pa.table({"p": ["a", "a", "b"], "id": [1, 2, 3]}))
    return t


def test_checkpoint_replace_is_replay_safe_as_the_reference(twins):
    out = {}
    for pkg, cat in twins.items():
        t = _parts_table(cat)
        w = MODS[pkg].CheckpointedWriter(t)
        w.write(pa.table({"p": ["a", "c"], "id": [9, 10]}))
        first = w.checkpoint_replace("epoch-1")
        # the replay re-stages the same rows: its ids are durable, nothing lands
        w.write(pa.table({"p": ["a", "c"], "id": [9, 10]}))
        replay = w.checkpoint_replace("epoch-1")
        got = cat.table("parts").scan().to_arrow().sort_by("id")
        out[pkg] = (first, replay, got.to_pydict())
    assert out["port"] == out["ref"]
    assert out["port"] == (3, 0, {"p": ["a", "c"], "id": [9, 10]})


def test_checkpoint_replace_replays_across_packages(shared):
    t = _parts_table(shared["port"])
    w = streaming.CheckpointedWriter(t)
    w.write(pa.table({"p": ["b"], "id": [7]}))
    assert w.checkpoint_replace(5) == 2  # b swapped, a truncated
    ref = ref_streaming.CheckpointedWriter(shared["ref"].table("parts"))
    ref.write(pa.table({"p": ["b"], "id": [7]}))
    assert ref.checkpoint_replace(5) == 0
    assert shared["ref"].table("parts").scan().to_arrow().to_pydict() == {"p": ["b"], "id": [7]}


def test_adopt_staged_gives_the_references_result(twins):
    out = {}
    for pkg, cat in twins.items():
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        old = MODS[pkg].CheckpointedWriter(t)
        old.write(pa.table({"id": [1, 2, 3], "v": [1.0, 2.0, 3.0], "tag": ["a", "b", "c"]},
                           schema=SCHEMA))
        fresh = MODS[pkg].CheckpointedWriter(cat.table("t"))
        fresh.adopt_staged(old)
        fresh.adopt_staged(None)  # nothing to take
        fresh.write(pa.table({"id": [3, 4], "v": [30.0, 4.0], "tag": [None, "d"]},
                             schema=SCHEMA))
        committed = fresh.checkpoint(1)
        donor_gone = old._writer is None
        old.close()
        out[pkg] = (committed, donor_gone, _sha(cat.table("t")))
    assert out["port"] == out["ref"] and out["port"][:2] == (1, True)


# ------------------------------------------------------------- database sync
def _source():
    conn = sqlite3.connect(":memory:")
    conn.executescript("""
        CREATE TABLE users (uid INTEGER PRIMARY KEY, name TEXT, score REAL, ok BOOLEAN);
        CREATE TABLE events (ts BIGINT, kind VARCHAR(8), payload BLOB, n NUMERIC);
        CREATE TABLE pairs (a INT, b INT, note CLOB, PRIMARY KEY (b, a));
    """)
    rng = np.random.default_rng(5)
    conn.executemany("INSERT INTO users VALUES (?, ?, ?, ?)",
                     [(i, f"u{i}", float(rng.normal()), i % 2) for i in range(1, 60)])
    conn.executemany("INSERT INTO events VALUES (?, ?, ?, ?)",
                     [(100 * i, "xy"[i % 2], bytes([i % 256]), i / 4) for i in range(40)])
    conn.executemany("INSERT INTO pairs VALUES (?, ?, ?)",
                     [(i % 5, i, f"n{i}") for i in range(25)])
    return conn


def test_database_syncer_gives_identical_tables(twins):
    out = {}
    for pkg, cat in twins.items():
        src = _source()
        s = MODS[pkg].DatabaseSyncer(cat, hash_bucket_num=3)
        first = s.sync(src, tables=None)
        src.execute("UPDATE users SET score = 9.9 WHERE uid = 2")
        src.execute("INSERT INTO users VALUES (100, 'new', 4.0, 1)")
        again = s.sync(src, tables=["users", "pairs"])
        tables = {}
        for name in ("users", "events", "pairs"):
            t = cat.table(name)
            tables[name] = (t.primary_keys, str(t.schema),
                            _sha(t, key=t.schema.names[0]))
        out[pkg] = (first, again, tables)
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"users": 59, "events": 40, "pairs": 25}
    assert out["port"][2]["pairs"][0] == ["b", "a"]
    assert twins["port"].table("users").scan().count_rows() == 60


# -------------------------------------------------------- Debezium consumer
def _ev(table, op, row, before=None):
    return {"payload": {"op": op, "after": row if op != "d" else None,
                        "before": before if before is not None else (row if op == "d" else None),
                        "source": {"table": table}}}


DEBEZIUM = {
    "multi_table_auto_create": [
        _ev("users", "c", {"uid": 1, "name": "a"}),
        _ev("orders", "c", {"oid": 10, "total": 5.0}),
        _ev("users", "u", {"uid": 1, "name": "A"}),
        _ev("users", "r", {"uid": 2, "name": "b"}),
        _ev("orders", "d", {"oid": 10, "total": 5.0}),
        {"op": "c", "after": {"uid": 3, "name": "flat"}, "source": {"table": "users"}},
    ],
    "schema_evolution": [
        _ev("users", "c", {"uid": 1, "name": "a"}),
        _ev("users", "c", {"uid": 2, "name": "b", "extra": "new", "flag": True}),
        _ev("users", "u", {"uid": 1, "name": "a2", "extra": None, "flag": False}),
        _ev("users", "c", {"uid": 3, "name": "c", "blob": b"\x01", "n": 7}),
    ],
}


@pytest.mark.parametrize("case", sorted(DEBEZIUM))
def test_debezium_consumer_gives_identical_tables(twins, case):
    out = {}
    for pkg, cat in twins.items():
        c = MODS[pkg].DebeziumJsonConsumer(
            cat, primary_keys={"users": ["uid"], "orders": ["oid"]}, hash_bucket_num=2)
        events = DEBEZIUM[case]
        half = len(events) // 2
        c.consume_many(events[:half])
        first = c.checkpoint(1)
        c.consume_many(events[half:])
        second = c.checkpoint(2)
        # an epoch replayed twice, on a fresh consumer: idempotent
        replayed = []
        for _ in range(2):
            r = MODS[pkg].DebeziumJsonConsumer(cat, primary_keys={"users": ["uid"]})
            r.consume_many(events[half:])
            replayed.append(r.checkpoint(2))
        tables = {n: (str(cat.table(n).schema), _sha(cat.table(n), key=cat.table(n).schema.names[0]))
                  for n in sorted(cat.list_tables())}
        out[pkg] = (first, second, replayed, tables)
    assert out["port"] == out["ref"]
    assert out["port"][2] == [0, 0]


def test_debezium_refusals_are_the_references(twins):
    msgs = {}
    for pkg, cat in twins.items():
        c = MODS[pkg].DebeziumJsonConsumer(cat)
        got = []
        for ev in (_ev("mystery", "c", {"id": 1}), {"payload": {"op": "x"}},
                   {"op": "c", "after": None, "source": {"table": "t"}},
                   {"op": "c", "after": {"id": 1}, "source": {}}):
            with pytest.raises(ERRORS[pkg]) as e:
                c.consume(ev)
            got.append(str(e.value))
        msgs[pkg] = got
    assert msgs["port"] == msgs["ref"]


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
