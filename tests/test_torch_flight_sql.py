"""The port's Flight SQL server (``lakesoul_tpu_torch/service/flight_sql.py``)
against the reference's (``lakesoul_tpu/service/flight_sql.py``).

- The reference's own protocol tests, each with a counterpart here, run
  against the port's server on the CPU (``device="cpu"``): statements,
  updates, bulk ingest with its exactly-once replay, prepared statements,
  the metadata commands, auth, parameter binding and server transactions.
- Across the packages, on one warehouse and one SQLite store: the
  reference's ``FlightSqlClient`` against the port's server and the port's
  against the reference's give the reference's answers; an ingest (one
  transaction id, minted or not) committed through one package's server
  and replayed through the other's adds no row; every message the codec
  sends is byte-equal to the reference's ``_flight_sql_pb2``.
- The JSON fall-through: ``vector_search`` on the Flight SQL server equals
  the table's direct search; ``device=None`` is the card and raises
  without one.
- The deployable: ``python -m lakesoul_tpu_torch.service.flight_sql``
  serves with Prometheus ``/metrics``, prints the bound port for
  ``--port 0``, stops cleanly on SIGINT, and refuses ``--device cuda``
  without a card.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest

from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.service import _flight_sql_pb2 as ref_pb
from lakesoul_tpu.service import flight_sql as ref_fsql
from lakesoul_tpu_torch import LakeSoulCatalog, _build
from lakesoul_tpu_torch.service import _flight_sql_pb2 as pb
from lakesoul_tpu_torch.service import flight_sql as port_fsql
from lakesoul_tpu_torch.service.flight_sql import (
    FlightSqlClient,
    LakeSoulFlightSqlServer,
    _pack,
    _unpack,
    bind_parameters,
)
from lakesoul_tpu_torch.service.jwt import Claims

SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64())])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_cuda_build(monkeypatch):
    """On the CPU every search runs the kernels' plain versions."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach a CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.fixture()
def server(tmp_warehouse):
    catalog = LakeSoulCatalog(str(tmp_warehouse))
    t = catalog.create_table("orders", SCHEMA, primary_keys=["id"])
    t.write_arrow(pa.table({"id": np.arange(10), "v": np.arange(10) * 1.0}))
    srv = LakeSoulFlightSqlServer(catalog, "grpc://127.0.0.1:0", device="cpu")
    yield srv, catalog
    srv.shutdown()


@pytest.fixture()
def client(server):
    srv, _ = server
    c = FlightSqlClient(f"grpc://127.0.0.1:{srv.port}")
    yield c
    c.close()


def _count(c, table="orders") -> int:
    return c.execute(f"SELECT count(*) AS c FROM {table}").column("c").to_pylist()[0]


# ---------------------------------------------- the reference's protocol tests
class TestStatementQuery:
    def test_select_round_trip(self, client):
        out = client.execute("SELECT id, v FROM orders WHERE id < 3")
        assert out.num_rows == 3
        assert sorted(out.column("id").to_pylist()) == [0, 1, 2]

    def test_aggregate(self, client):
        out = client.execute("SELECT sum(v) AS s FROM orders")
        assert out.column("s").to_pylist() == [45.0]

    def test_ticket_is_one_shot(self, server):
        srv, _ = server
        raw = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        desc = flight.FlightDescriptor.for_command(
            _pack(pb.CommandStatementQuery(query="SELECT count(*) AS c FROM orders")))
        ticket = raw.get_flight_info(desc).endpoints[0].ticket
        assert raw.do_get(ticket).read_all().column("c").to_pylist() == [10]
        with pytest.raises(flight.FlightError, match="expired"):
            raw.do_get(ticket).read_all()
        raw.close()

    def test_command_as_ticket_direct(self, server):
        srv, _ = server
        raw = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        t = raw.do_get(flight.Ticket(
            _pack(pb.CommandStatementQuery(query="SELECT count(*) AS c FROM orders")))).read_all()
        assert t.column("c").to_pylist() == [10]
        raw.close()

    def test_flight_info_reports_schema_and_rows(self, server):
        srv, _ = server
        raw = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        info = raw.get_flight_info(flight.FlightDescriptor.for_command(
            _pack(pb.CommandStatementQuery(query="SELECT id FROM orders"))))
        assert info.schema.names == ["id"] and info.total_records == 10
        got = raw.get_schema(flight.FlightDescriptor.for_command(
            _pack(pb.CommandStatementQuery(query="SELECT v FROM orders"))))
        assert got.schema.names == ["v"]
        raw.close()

    def test_json_dialect_still_served(self, server):
        from lakesoul_tpu_torch.service.flight import LakeSoulFlightClient

        srv, _ = server
        assert LakeSoulFlightClient(f"grpc://127.0.0.1:{srv.port}").scan("orders").num_rows == 10

    def test_connection_probe_statement(self, tmp_warehouse):
        """test_federation's ``test_over_flight_sql``: the ADBC probe."""
        srv = LakeSoulFlightSqlServer(LakeSoulCatalog(str(tmp_warehouse)),
                                      "grpc://127.0.0.1:0", device="cpu")
        try:
            c = FlightSqlClient(f"grpc://127.0.0.1:{srv.port}")
            assert c.execute("SELECT 1").to_pydict() == {"1": [1]}
            c.close()
        finally:
            srv.shutdown()


class TestStatementUpdate:
    def test_insert_reports_count(self, client):
        assert client.execute_update("INSERT INTO orders VALUES (100, 1.5), (101, 2.5)") == 2
        assert _count(client) == 12

    def test_update_and_delete_counts(self, client):
        assert client.execute_update("UPDATE orders SET v = 0 WHERE id < 4") == 4
        assert client.execute_update("DELETE FROM orders WHERE id >= 8") == 2
        assert client.execute("SELECT sum(v) AS s FROM orders").column("s").to_pylist() == [
            4.0 + 5 + 6 + 7]


class TestIngest:
    def test_ingest_append_existing(self, client):
        assert client.ingest("orders", pa.table({"id": np.arange(20, 25), "v": np.ones(5)})) == 5
        assert _count(client) == 15

    def test_ingest_creates_missing_table(self, client):
        assert client.ingest("fresh", pa.table({"a": [1, 2, 3]}), primary_keys=["a"]) == 3
        assert _count(client, "fresh") == 3

    def test_ingest_transaction_id_exactly_once(self, client):
        data = pa.table({"id": np.arange(30, 33), "v": np.zeros(3)})
        assert client.ingest("orders", data, transaction_id=b"job-7:epoch-3") == 3
        client.ingest("orders", data, transaction_id=b"job-7:epoch-3")
        assert _count(client) == 13

    def test_ingest_replace(self, client):
        data = pa.table({"id": np.arange(3), "v": np.zeros(3)})
        client.ingest("scratch", data)
        assert client.ingest("scratch", data, mode="replace") == 3
        assert _count(client, "scratch") == 3

    def test_ingest_replace_preserves_structure(self, client, server):
        _, catalog = server
        client.ingest("orders", pa.table({"id": np.arange(3), "v": np.zeros(3)}), mode="replace")
        assert catalog.table("orders").info.primary_keys == ["id"]
        client.ingest("orders", pa.table({"id": np.arange(3), "v": np.ones(3)}))
        out = client.execute("SELECT count(*) AS c, sum(v) AS s FROM orders")
        assert out.column("c").to_pylist() == [3] and out.column("s").to_pylist() == [3.0]

    def test_ingest_fail_mode(self, client):
        with pytest.raises(flight.FlightError, match="already exists"):
            client.ingest("orders", pa.table({"id": np.arange(3), "v": np.zeros(3)}), mode="fail")


class TestPreparedStatements:
    def test_prepare_execute_close(self, client):
        handle = client.prepare("SELECT id, v FROM orders WHERE id < 5")
        assert client.execute_prepared(handle).num_rows == 5
        client.execute_update("DELETE FROM orders WHERE id = 0")
        assert client.execute_prepared(handle).num_rows == 4
        client.close_prepared(handle)
        with pytest.raises(flight.FlightError, match="unknown prepared"):
            client.execute_prepared(handle)

    def test_parameter_binding(self, client):
        handle = client.prepare("SELECT v FROM orders WHERE id = ?")
        assert client.execute_prepared(handle, params=[7]).column("v").to_pylist() == [7.0]
        assert client.execute_prepared(handle, params=[3]).column("v").to_pylist() == [3.0]
        client.close_prepared(handle)

    def test_create_returns_dataset_schema(self, server):
        srv, _ = server
        raw = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        action = flight.Action("CreatePreparedStatement", _pack(
            pb.ActionCreatePreparedStatementRequest(query="SELECT id FROM orders")))
        name, msg = _unpack(list(raw.do_action(action))[0].body.to_pybytes())
        assert name == "ActionCreatePreparedStatementResult"
        assert pa.ipc.read_schema(pa.py_buffer(msg.dataset_schema)).names == ["id"]
        raw.close()


class TestMetadataCommands:
    def test_catalogs_schemas_table_types(self, client):
        assert client.get_catalogs().column("catalog_name").to_pylist() == ["lakesoul"]
        assert "default" in client.get_db_schemas().column("db_schema_name").to_pylist()
        assert client.get_table_types().column("table_type").to_pylist() == ["TABLE"]

    def test_get_tables_with_pattern_and_schema(self, client):
        assert client.get_tables(table_pattern="ord%").column("table_name").to_pylist() == [
            "orders"]
        t = client.get_tables(include_schema=True)
        row = t.column("table_name").to_pylist().index("orders")
        schema = pa.ipc.read_schema(pa.py_buffer(t.column("table_schema").to_pylist()[row]))
        assert schema.names == ["id", "v"]

    def test_primary_keys(self, client):
        pk = client.get_primary_keys("orders")
        assert pk.column("column_name").to_pylist() == ["id"]
        assert pk.column("key_sequence").to_pylist() == [1]

    def test_sql_info(self, client):
        info = client.get_sql_info()
        names = info.column("info_name").to_pylist()
        values = info.column("value")
        assert values[names.index(0)].as_py() == "lakesoul_tpu"
        assert values[names.index(3)].as_py() is False


class TestAuth:
    def test_jwt_enforced_on_flight_sql_paths(self, tmp_warehouse):
        catalog = LakeSoulCatalog(str(tmp_warehouse))
        catalog.create_table("sec", SCHEMA).write_arrow(pa.table({"id": [1], "v": [1.0]}))
        srv = LakeSoulFlightSqlServer(catalog, "grpc://127.0.0.1:0", jwt_secret="s3cr3t",
                                      device="cpu")
        try:
            anon = FlightSqlClient(f"grpc://127.0.0.1:{srv.port}")
            with pytest.raises(flight.FlightError, match="[Uu]nauthenticated|authorization"):
                anon.execute("SELECT * FROM sec")
            anon.close()
            token = srv.jwt_server.create_token(Claims(sub="alice", group="public"))
            ok = FlightSqlClient(f"grpc://127.0.0.1:{srv.port}", token=token)
            assert _count(ok, "sec") == 1
            ok.close()
        finally:
            srv.shutdown()


class TestBindParameters:
    def test_placeholders_outside_strings_only(self):
        q = "SELECT * FROM t WHERE a = ? AND b = 'x?y' AND c = ?"
        assert bind_parameters(q, None, [1, "it's"]) == (
            "SELECT * FROM t WHERE a = 1 AND b = 'x?y' AND c = 'it''s'")

    def test_too_few_params(self):
        with pytest.raises(flight.FlightError, match="1 parameter"):
            bind_parameters("SELECT ?", None, [])

    @pytest.mark.parametrize("values", [
        [1e-07, 1e16, -0.5, True, None, "a'b?", 12345678901234],
        [float("3.141592653589793"), False, ""],
    ])
    def test_rendering_equals_the_reference(self, values):
        q = ", ".join("?" for _ in values)
        assert bind_parameters(f"SELECT {q}", None, values) == ref_fsql.bind_parameters(
            f"SELECT {q}", None, values)


class TestTransactions:
    def test_begin_ingest_commit(self, client):
        txn = client.begin_transaction()
        assert isinstance(txn, bytes) and len(txn) == 16
        assert client.ingest("orders", pa.table({"id": np.arange(50, 55), "v": np.ones(5)}),
                             transaction_id=txn) == 5
        assert _count(client) == 10  # staged, not visible before commit
        client.commit(txn)
        assert _count(client) == 15

    def test_rollback_leaves_no_rows(self, client, server):
        _, catalog = server
        root = catalog.table("orders").info.table_path
        before = {f for _, _, files in os.walk(root) for f in files}
        txn = client.begin_transaction()
        client.ingest("orders", pa.table({"id": np.arange(60, 70), "v": np.zeros(10)}),
                      transaction_id=txn)
        client.rollback(txn)
        assert _count(client) == 10
        assert {f for _, _, files in os.walk(root) for f in files} == before

    def test_multi_table_transaction(self, client):
        txn = client.begin_transaction()
        client.ingest("orders", pa.table({"id": [90], "v": [1.0]}), transaction_id=txn)
        client.ingest("fresh_tx", pa.table({"a": [1, 2]}), transaction_id=txn)
        client.commit(txn)
        assert _count(client) == 11 and _count(client, "fresh_tx") == 2

    def test_commit_unknown_transaction(self, client):
        with pytest.raises(flight.FlightError, match="unknown or expired"):
            client.commit(b"nope-nope-nope!!")

    def test_transaction_gone_after_end(self, client):
        txn = client.begin_transaction()
        client.commit(txn)
        with pytest.raises(flight.FlightError, match="unknown or expired"):
            client.rollback(txn)

    def test_non_minted_transaction_id_keeps_idempotent_path(self, client):
        data = pa.table({"id": np.arange(70, 73), "v": np.zeros(3)})
        assert client.ingest("orders", data, transaction_id=b"ext:epoch9") == 3
        assert _count(client) == 13

    def test_replace_within_transaction(self, client, server):
        _, catalog = server
        before = catalog.table("orders").info.table_id
        txn = client.begin_transaction()
        client.ingest("orders", pa.table({"id": [1], "v": [9.0]}), mode="replace",
                      transaction_id=txn)
        assert _count(client) == 10
        client.commit(txn)
        out = client.execute("SELECT id, v FROM orders")
        assert out.column("id").to_pylist() == [1] and out.column("v").to_pylist() == [9.0]
        assert catalog.table("orders").info.table_id == before

    def test_listed_actions(self, server):
        srv, _ = server
        raw = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        assert {"BeginTransaction", "EndTransaction"} <= {a.type for a in raw.list_actions()}
        raw.close()

    def test_ingest_on_ended_transaction_rejected(self, client):
        txn = client.begin_transaction()
        client.commit(txn)
        with pytest.raises(flight.FlightError, match="already ended"):
            client.ingest("orders", pa.table({"id": [1], "v": [0.0]}), transaction_id=txn)
        assert _count(client) == 10

    def test_open_transaction_cap_rejects_new_begins(self, client, monkeypatch):
        monkeypatch.setattr(port_fsql, "_TXN_CAP", 3)
        txns = [client.begin_transaction() for _ in range(3)]
        with pytest.raises(flight.FlightError, match="too many open"):
            client.begin_transaction()
        client.rollback(txns[0])
        client.begin_transaction()

    def test_closed_transaction_ingest_creates_no_table(self, client, server):
        _, catalog = server
        txn = client.begin_transaction()
        client.commit(txn)
        with pytest.raises(flight.FlightError, match="already ended"):
            client.ingest("ghost_tbl", pa.table({"a": [1]}), transaction_id=txn)
        assert "ghost_tbl" not in catalog.list_tables("default")


# ------------------------------------------------------------ the two packages
def _message_cases():
    """Every message the codec puts on the wire, filled."""
    tdo = "CommandStatementIngest.TableDefinitionOptions"
    return [
        ("CommandStatementQuery", dict(query="SELECT 1", transaction_id=b"\x01" * 16)),
        ("TicketStatementQuery", dict(statement_handle=b"\x02" * 16)),
        ("CommandStatementUpdate", dict(query="DELETE FROM t")),
        ("CommandPreparedStatementQuery", dict(prepared_statement_handle=b"h")),
        ("CommandPreparedStatementUpdate", dict(prepared_statement_handle=b"h")),
        ("DoPutUpdateResult", dict(record_count=1 << 40)),
        ("ActionBeginTransactionRequest", {}),
        ("ActionBeginTransactionResult", dict(transaction_id=b"\x03" * 16)),
        ("ActionEndTransactionRequest", dict(transaction_id=b"t", action=2)),
        ("ActionCreatePreparedStatementRequest", dict(query="SELECT ?")),
        ("ActionCreatePreparedStatementResult", dict(prepared_statement_handle=b"h",
                                                     dataset_schema=b"s")),
        ("ActionClosePreparedStatementRequest", dict(prepared_statement_handle=b"h")),
        ("CommandGetCatalogs", {}),
        ("CommandGetDbSchemas", dict(db_schema_filter_pattern="d%")),
        ("CommandGetTables", dict(table_name_filter_pattern="o%", include_schema=True)),
        ("CommandGetTableTypes", {}),
        ("CommandGetPrimaryKeys", dict(table="orders", db_schema="default")),
        ("CommandGetSqlInfo", dict(info=[0, 1, 3, 8])),
        (tdo, dict(if_not_exist=1, if_exists=2)),
    ]


def _build_msg(mod, name, fields):
    cls = mod
    for part in name.split("."):
        cls = getattr(cls, part)
    return cls(**fields)


@pytest.mark.parametrize("name, fields", _message_cases(), ids=lambda c: str(c)[:40])
def test_messages_are_the_references_byte_for_byte(name, fields):
    port, ref = _build_msg(pb, name, fields), _build_msg(ref_pb, name, fields)
    assert port.SerializeToString(deterministic=True) == ref.SerializeToString(
        deterministic=True)
    if "." not in name:
        packed = _pack(port)
        assert packed == ref_fsql._pack(ref)
        assert _unpack(packed)[0] == name == ref_fsql._unpack(packed)[0]


def test_ingest_command_and_descriptor_file_equal_the_reference():
    def ingest(mod):
        tdo = mod.CommandStatementIngest.TableDefinitionOptions(if_not_exist=1, if_exists=2)
        cmd = mod.CommandStatementIngest(table_definition_options=tdo, table="t",
                                         schema="ns", transaction_id=b"x")
        cmd.options["primary_keys"] = "id,k"
        return cmd

    assert _pack(ingest(pb)) == ref_fsql._pack(ingest(ref_pb))
    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert port_fsql._ANY_PREFIX == ref_fsql._ANY_PREFIX == (
        "type.googleapis.com/arrow.flight.protocol.sql.")


@pytest.fixture()
def pair(tmp_path):
    """Both packages' Flight SQL servers over one warehouse + SQLite store."""
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    cats = {"port": LakeSoulCatalog(wh, db_path=db), "ref": RefCatalog(wh, db_path=db)}
    schema = SCHEMA.append(pa.field("k", pa.int64()))
    t = cats["port"].create_table("orders", schema, primary_keys=["id"], hash_bucket_num=2)
    rng = np.random.default_rng(7)
    for lo, hi in ((0, 200), (150, 260)):
        ids = np.arange(lo, hi)
        t.upsert(pa.table({"id": ids, "v": rng.normal(size=hi - lo), "k": ids % 7},
                          schema=schema))
    servers = {"port": LakeSoulFlightSqlServer(cats["port"], "grpc://127.0.0.1:0",
                                               device="cpu"),
               "ref": ref_fsql.LakeSoulFlightSqlServer(cats["ref"], "grpc://127.0.0.1:0")}
    locs = {k: f"grpc://127.0.0.1:{s.port}" for k, s in servers.items()}
    clients = {"port": FlightSqlClient, "ref": ref_fsql.FlightSqlClient}
    yield {"cats": cats, "locs": locs, "clients": clients}
    for s in servers.values():
        s.shutdown()


def _client(pair, client_pkg, server_pkg):
    return pair["clients"][client_pkg](pair["locs"][server_pkg])


CROSS = [("ref", "port"), ("port", "ref")]
QUERIES = [
    "SELECT count(*) AS c, sum(v) AS s, min(id) AS lo, max(id) AS hi FROM orders",
    "SELECT id, v FROM orders WHERE id >= 140 AND id < 170 ORDER BY id",
    "SELECT k, count(*) AS n, avg(v) AS m FROM orders GROUP BY k ORDER BY k",
]


@pytest.mark.parametrize("client_pkg, server_pkg", CROSS)
def test_statements_across_packages_equal_the_reference(pair, client_pkg, server_pkg):
    want = _client(pair, "ref", "ref")
    got = _client(pair, client_pkg, server_pkg)
    for q in QUERIES:
        assert got.execute(q).equals(want.execute(q)), q
    h = got.prepare("SELECT v FROM orders WHERE id = ?")
    assert got.execute_prepared(h, params=[155]).equals(
        want.execute("SELECT v FROM orders WHERE id = 155"))
    got.close_prepared(h)
    assert got.get_tables(include_schema=True).equals(want.get_tables(include_schema=True))
    assert got.get_primary_keys("orders").equals(want.get_primary_keys("orders"))
    assert got.get_db_schemas().equals(want.get_db_schemas())
    assert got.get_sql_info([0, 1, 3, 8]).to_pylist() == want.get_sql_info(
        [0, 1, 3, 8]).to_pylist()
    assert got.execute_update("UPDATE orders SET v = 0 WHERE id < 5") == 5
    assert want.execute("SELECT sum(v) AS s FROM orders WHERE id < 5").column(
        "s").to_pylist() == [0.0]


@pytest.mark.parametrize("first, second", [("port", "ref"), ("ref", "port")])
def test_an_ingest_replayed_to_the_other_package_is_a_no_op(pair, first, second):
    data = pa.table({"id": np.arange(1000, 1040), "v": np.ones(40), "k": np.zeros(40, np.int64)})
    a, b = _client(pair, first, first), _client(pair, second, second)
    before = _count(a)
    assert a.ingest("orders", data, transaction_id=b"job-3:epoch-9") == 40
    b.ingest("orders", data, transaction_id=b"job-3:epoch-9")
    assert _count(a) == _count(b) == before + 40


@pytest.mark.parametrize("first, second", [("port", "ref"), ("ref", "port")])
def test_a_minted_transaction_replayed_to_the_other_package_adds_no_row(pair, first, second):
    """COMMIT publishes under ``transaction_id.hex()`` in both packages, so
    the other server, which never minted the id, sees a replay."""
    data = pa.table({"id": np.arange(2000, 2025), "v": np.zeros(25), "k": np.ones(25, np.int64)})
    a, b = _client(pair, first, first), _client(pair, second, second)
    before = _count(b)
    txn = a.begin_transaction()
    a.ingest("orders", data, transaction_id=txn)
    a.ingest("side", pa.table({"k": np.arange(5)}), transaction_id=txn)
    assert _count(b) == before
    a.commit(txn)
    assert _count(b) == before + 25 and _count(b, "side") == 5
    b.ingest("orders", data, transaction_id=txn)
    b.ingest("side", pa.table({"k": np.arange(5)}), transaction_id=txn)
    assert _count(a) == before + 25 and _count(a, "side") == 5


@pytest.mark.parametrize("client_pkg, server_pkg", CROSS)
def test_transactions_across_packages(pair, client_pkg, server_pkg):
    c = _client(pair, client_pkg, server_pkg)
    want = _client(pair, "ref", "ref")
    before = _count(want)
    txn = c.begin_transaction()
    c.ingest("orders", pa.table({"id": [5000], "v": [1.0], "k": [0]}), transaction_id=txn)
    c.rollback(txn)
    assert _count(want) == before
    txn = c.begin_transaction()
    c.ingest("orders", pa.table({"id": [5001], "v": [1.0], "k": [0]}), transaction_id=txn)
    c.commit(txn)
    assert _count(want) == before + 1
    with pytest.raises(flight.FlightError, match="unknown or expired"):
        c.commit(txn)


# ------------------------------------------------------ the JSON fall-through
def _vector_table(cat, n=400, d=16, seed=0):
    vecs = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), d))])
    t = cat.create_table("docs", schema, primary_keys=["id"], hash_bucket_num=2)
    t.write_arrow(pa.table({"id": np.arange(n, dtype=np.int64),
                            "emb": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), d)},
                           schema=schema))
    return t, vecs


def test_vector_search_through_the_flight_sql_server_equals_the_direct_search(tmp_path):
    from lakesoul_tpu_torch.service import LakeSoulFlightClient

    cat = LakeSoulCatalog(str(tmp_path / "wh"))
    t, vecs = _vector_table(cat)
    srv = LakeSoulFlightSqlServer(cat, "grpc://127.0.0.1:0", device="cpu")
    try:
        loc = f"grpc://127.0.0.1:{srv.port}"
        built = FlightSqlClient(loc).execute(
            "CALL build_vector_index('docs', 'emb')")  # builds on the server's device
        assert built.column("indexed_vectors").to_pylist() == [400]
        t = cat.table("docs")  # the build changed the table's properties
        assert FlightSqlClient(loc).execute("SELECT count(*) AS c FROM docs").column(
            "c").to_pylist() == [t.scan().count_rows()]
        for qi in (0, 9, 399):
            got = json.loads(LakeSoulFlightClient(loc).action("vector_search", {
                "table": "docs", "column": "emb", "query": vecs[qi].tolist(),
                "top_k": 5, "nprobe": 3})[0])
            ids, d = t.vector_search("emb", vecs[qi], top_k=5, nprobe=3, device="cpu")
            assert got["ids"] == [int(i) for i in ids] and got["ids"][0] == qi
            assert np.array_equal(np.asarray(got["distances"], np.float32),
                                  np.asarray(d, np.float32))
    finally:
        srv.shutdown()


def test_the_flight_sql_server_searches_on_the_card_unless_asked(tmp_path, monkeypatch):
    import torch

    from lakesoul_tpu_torch.service import LakeSoulFlightClient

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = LakeSoulCatalog(str(tmp_path / "wh"))
    t, vecs = _vector_table(cat, n=64, d=8)
    t.build_vector_index("emb", nlist=2, device="cpu")
    srv = LakeSoulFlightSqlServer(cat, "grpc://127.0.0.1:0")
    try:
        loc = f"grpc://127.0.0.1:{srv.port}"
        with pytest.raises(flight.FlightError, match="CUDA"):
            LakeSoulFlightClient(loc).action("vector_search", {
                "table": "docs", "column": "emb", "query": vecs[0].tolist()})
        with pytest.raises(flight.FlightError, match="CUDA"):
            FlightSqlClient(loc).execute("CALL build_vector_index('docs', 'emb')")
    finally:
        srv.shutdown()


# ------------------------------------------------------------- the deployable
def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LAKESOUL_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_flight_sql_server_cli(tmp_path):
    mport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.service.flight_sql", "--warehouse",
         str(tmp_path / "wh"), "--host", "127.0.0.1", "--port", "0", "--metrics-port",
         str(mport), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
    try:
        lines = [proc.stdout.readline() for _ in range(2)]
        assert lines[0].startswith(f"metrics on http://127.0.0.1:{mport}/metrics"), lines
        head = "Flight SQL server on grpc://127.0.0.1:"
        assert lines[1].startswith(head) and "(auth=open)" in lines[1], lines
        port = int(lines[1][len(head):].split()[0])
        assert port > 0
        c = FlightSqlClient(f"grpc://127.0.0.1:{port}")
        assert c.ingest("t", pa.table({"a": np.arange(5)})) == 5
        assert c.execute("SELECT sum(a) AS s FROM t").column("s").to_pylist() == [10]
        c.close()
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics").read().decode()
        assert "lakesoul_flight_rows_in 5" in metrics
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_flight_sql_server_cli_without_a_card_refuses_cuda(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", "import sys, torch; torch.cuda.is_available = lambda: False; "
         "from lakesoul_tpu_torch.service.flight_sql import main; "
         "sys.exit(main(sys.argv[1:]))", "--warehouse", str(tmp_path / "wh"),
         "--host", "127.0.0.1", "--port", "0"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode != 0
    assert "ConfigError" in out.stderr and "CUDA is not available" in out.stderr
    assert "Flight SQL server on" not in out.stdout
