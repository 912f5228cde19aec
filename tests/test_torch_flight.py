"""The port's Flight gateway (``lakesoul_tpu_torch/service/``) against the
reference's (``lakesoul_tpu/service/``) on one warehouse and one SQLite
metadata store.

- Tokens and RBAC: with the clock pinned, either package's ``JwtServer``
  mints the same token under one secret and verifies the other's; a user
  registered through either registry logs in through the other; the two
  ``RbacVerifier`` give the same decisions.
- The gateway: DoGet streams (projection, a JSON and a Substrait filter,
  partitions, limit, batch size), DoPut with a repeated checkpoint id,
  ``list_flights``, the actions and the auth failures are the reference's,
  each served by both gateways to the same client; a checkpoint committed
  through one gateway is a replay for the other; DoExchange sheds typed
  under 64 concurrent clients.
- ANN actions: ``ann_search`` over a two-shard CPU plane equals the plane's
  own ``batch_search`` exactly, and the reference gateway's answer on the
  reference's plane of the same seeded data (ties aside); ``vector_search``
  equals the table's direct search exactly, and the reference gateway's.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest

import lakesoul_tpu.service.jwt as ref_jwt
import lakesoul_tpu_torch.service.jwt as port_jwt
from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.service.flight import LakeSoulFlightServer as RefServer
from lakesoul_tpu.service.rbac import RbacVerifier as RefRbac
from lakesoul_tpu_torch import LakeSoulCatalog, _build
from lakesoul_tpu_torch.errors import ConfigError, RBACError
from lakesoul_tpu_torch.io.filters import Filter, col
from lakesoul_tpu_torch.service import LakeSoulFlightClient, LakeSoulFlightServer
from lakesoul_tpu_torch.service.rbac import RbacVerifier

SECRET = "s3cr3t"
SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64()), ("p", pa.string())])
RTOL, ATOL, TIE = 1e-4, 1e-4, 1e-5  # tests/test_torch_annplane_plane.py's


@pytest.fixture(autouse=True)
def no_cuda_build(monkeypatch):
    """On the CPU every search runs the kernels' plain versions."""

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach a CUDA kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _rows(lo: int, hi: int) -> pa.Table:
    ids = np.arange(lo, hi, dtype=np.int64)
    return pa.table({"id": ids, "v": ids * 0.5, "p": [f"p{i % 3}" for i in ids]}, schema=SCHEMA)


@pytest.fixture(scope="module")
def wh(tmp_path_factory):
    """One warehouse: a primary-key table over 2 buckets with an upsert, a
    range-partitioned table, and a table in a foreign domain."""
    root = tmp_path_factory.mktemp("flight")
    cat = LakeSoulCatalog(str(root / "wh"), db_path=str(root / "meta.db"))
    t = cat.create_table("events", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    t.write_arrow(_rows(0, 300))
    t.upsert(_rows(250, 320))
    parts = cat.create_table("parts", SCHEMA, range_partitions=["p"])
    parts.write_arrow(_rows(0, 90))
    cat.client.create_table("priv", str(root / "wh" / "default" / "priv"), SCHEMA,
                            domain="team1")
    return root


def _catalogs(root):
    args = (str(root / "wh"),)
    kw = {"db_path": str(root / "meta.db")}
    return {"port": LakeSoulCatalog(*args, **kw), "ref": RefCatalog(*args, **kw)}


def _serve(server):
    threading.Thread(target=server.serve, daemon=True).start()
    return f"grpc://127.0.0.1:{server.port}"


@pytest.fixture(scope="module")
def gateways(wh):
    """Both packages' gateways over the same warehouse, one secret."""
    cats = _catalogs(wh)
    servers = {"port": LakeSoulFlightServer(cats["port"], jwt_secret=SECRET, device="cpu"),
               "ref": RefServer(cats["ref"], jwt_secret=SECRET)}
    locs = {k: _serve(s) for k, s in servers.items()}
    token = port_jwt.JwtServer(SECRET).create_token(port_jwt.Claims(sub="alice"))
    yield {"servers": servers, "locs": locs, "token": token, "cats": cats}
    for s in servers.values():
        s.shutdown()


def _clients(gateways):
    return {k: LakeSoulFlightClient(loc, token=gateways["token"])
            for k, loc in gateways["locs"].items()}


# ------------------------------------------------------------ tokens and RBAC
def test_tokens_are_the_same_string_and_verify_across(monkeypatch):
    monkeypatch.setattr(ref_jwt.time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(port_jwt.time, "time", lambda: 1_700_000_000.25)
    claims = dict(sub="alice", group="team1")
    port = port_jwt.JwtServer(SECRET).create_token(port_jwt.Claims(**claims), ttl_seconds=60)
    ref = ref_jwt.JwtServer(SECRET).create_token(ref_jwt.Claims(**claims), ttl_seconds=60)
    assert port == ref
    got = port_jwt.JwtServer(SECRET).decode_token(ref)
    want = ref_jwt.JwtServer(SECRET).decode_token(port)
    assert (got.sub, got.group, got.exp) == (want.sub, want.group, want.exp) == (
        "alice", "team1", 1_700_000_060)
    head, payload, sig = port.split(".")
    for bad in (f"{head}.{payload}x.{sig}", "garbage"):
        with pytest.raises(RBACError) as p:
            port_jwt.JwtServer(SECRET).decode_token(bad)
        with pytest.raises(ref_jwt.RBACError) as r:
            ref_jwt.JwtServer(SECRET).decode_token(bad)
        assert str(p.value) == str(r.value)


def test_a_user_registered_by_either_logs_in_through_the_other(wh):
    cats = _catalogs(wh)
    port_jwt.UserRegistry(cats["port"].client).register("pu", "pw1", group="team1")
    ref_jwt.UserRegistry(cats["ref"].client).register("ru", "pw2")
    assert ref_jwt.UserRegistry(cats["ref"].client).verify("pu", "pw1").group == "team1"
    assert port_jwt.UserRegistry(cats["port"].client).verify("ru", "pw2").group == "public"
    with pytest.raises(RBACError, match="invalid credentials"):
        port_jwt.UserRegistry(cats["port"].client).verify("ru", "nope")


@pytest.mark.parametrize("group, table", [
    ("public", "events"), ("team1", "priv"), ("team2", "priv"), ("public", "missing")])
def test_rbac_decisions_equal_the_reference(wh, group, table):
    cats = _catalogs(wh)
    port, ref = RbacVerifier(cats["port"].client), RefRbac(cats["ref"].client)
    got = port.verify_permission_by_table_name("u", group, "default", table)
    assert got == ref.verify_permission_by_table_name("u", group, "default", table)
    assert got == (table == "events" or group == "team1")
    path = str(wh / "wh" / "default" / table)
    if table != "missing":
        path = cats["port"].client.get_table_info_by_name(table).table_path
    assert port.verify_permission_by_table_path("u", group, path) == \
        ref.verify_permission_by_table_path("u", group, path) == got


# ------------------------------------------------------------------ the gateway
def _substrait():
    return Filter.from_substrait((col("v") >= 100.0).to_substrait(SCHEMA))


GET_CASES = {
    "plain": ("events", {}),
    "projection": ("events", {"columns": ["id", "p"]}),
    "filter": ("events", {"filter": {"op": "ge", "col": "id", "value": 280}}),
    "substrait": ("events", {"filter": "substrait"}),
    "partitions": ("parts", {"partitions": {"p": "p1"}}),
    "limit_batch": ("events", {"limit": 33, "batch_size": 16}),
}


@pytest.mark.parametrize("case", sorted(GET_CASES))
def test_do_get_streams_equal_the_reference(gateways, case):
    table, req = GET_CASES[case]
    if req.get("filter") == "substrait":
        req = {**req, "filter": _substrait()}
    got = {k: c.scan(table, **dict(req)) for k, c in _clients(gateways).items()}
    assert got["port"].schema == got["ref"].schema
    assert got["port"].equals(got["ref"]), case
    assert got["port"].num_rows > 0


def test_do_put_checkpoint_commits_once_in_both_and_across(gateways):
    cats = gateways["cats"]
    for pkg, c in _clients(gateways).items():
        name = f"put_{pkg}"
        cats["port"].create_table(name, SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        c.write(name, _rows(0, 40), checkpoint_id=7)
        c.write(name, _rows(0, 40), checkpoint_id=7)  # replay: a no-op
        c.write(name, _rows(40, 50))  # no checkpoint id: a plain commit
        assert c.scan(name).num_rows == 50
    heads = {pkg: sorted(h.version for h in cats["port"].client.store
                         .get_all_latest_partition_info(cats["port"].table(f"put_{pkg}")
                                                        .info.table_id))
             for pkg in ("port", "ref")}
    assert heads["port"] == heads["ref"] == [1]
    # the commit ids are the reference's: an epoch committed through one
    # gateway is a replay through the other
    clients = _clients(gateways)
    clients["ref"].write("put_port", _rows(0, 40), checkpoint_id=7)
    clients["port"].write("put_ref", _rows(0, 40), checkpoint_id=7)
    for name in ("put_port", "put_ref"):
        info = cats["port"].table(name).info
        assert [h.version for h in cats["port"].client.store
                .get_all_latest_partition_info(info.table_id)] == [1]


def test_list_flights_equal_the_reference(gateways):
    got = {}
    for pkg, loc in gateways["locs"].items():
        fc = flight.FlightClient(loc)
        opts = flight.FlightCallOptions(headers=[(b"authorization",
                                                  f"Bearer {gateways['token']}".encode())])
        got[pkg] = sorted((f.descriptor.path[0], f.schema.to_string())
                          for f in fc.list_flights(options=opts))
        info = fc.get_flight_info(flight.FlightDescriptor.for_path("default.events"),
                                  options=opts)
        got[pkg + "_info"] = (info.schema, info.endpoints[0].ticket.ticket)
    assert got["port"] == got["ref"] and len(got["port"]) >= 3
    assert got["port_info"] == got["ref_info"]


def test_actions_equal_the_reference(gateways):
    clients = _clients(gateways)
    hexschema = SCHEMA.serialize().to_pybytes().hex()
    out = {}
    for pkg, c in clients.items():
        name = f"act_{pkg}"
        r = {"create": c.action("create_table", {"table": name, "schema_ipc_hex": hexschema,
                                                 "primary_keys": ["id"]})}
        c.write(name, _rows(0, 5))
        c.write(name, _rows(3, 9))
        r["compact"] = json.loads(c.action("compact", {"table": name})[0])
        r["sql"] = pa.ipc.open_stream(c.action("sql", {
            "statement": f"SELECT p, count(*) AS n, sum(v) AS s FROM {name} GROUP BY p "
                         "ORDER BY p"})[0]).read_all()
        r["scan"] = c.scan(name)
        r["listed"] = f"default.{name}" in c.list_tables()
        c.action("drop_table", {"table": name})
        r["dropped"] = f"default.{name}" not in c.list_tables()
        r["metrics"] = sorted(json.loads(c.action("metrics")[0]))
        r["prometheus"] = sorted(ln.split(" ")[0] for ln in
                                 c.action("metrics_prometheus")[0].decode().splitlines()
                                 if ln and not ln.startswith("#"))
        out[pkg] = r
    for key in ("create", "compact", "listed", "dropped", "metrics", "prometheus"):
        assert out["port"][key] == out["ref"][key], key
    assert out["port"]["compact"] == {"compacted": 1} and out["port"]["dropped"]
    assert out["port"]["sql"].equals(out["ref"]["sql"])
    assert out["port"]["scan"].sort_by("id").equals(out["ref"]["scan"].sort_by("id"))
    assets = {k: pa.ipc.open_stream(c.action("data_assets")[0]).read_all()
              for k, c in clients.items()}
    assert assets["port"].equals(assets["ref"]) and assets["port"].num_rows >= 3


def test_call_clean_keeps_the_ports_error(gateways):
    """``CALL clean`` is warehouse-wide: a scoped user is refused at the
    RBAC gate; an unscoped one gets the cleaner's counts, the reference
    cleaner's columns."""
    c = _clients(gateways)["port"]
    with pytest.raises(flight.FlightError, match="warehouse-wide"):  # priv: team1
        c.action("sql", {"statement": "CALL clean()"})
    cats = gateways["cats"]
    open_cat = LakeSoulCatalog(str(cats["port"].warehouse) + "_open")
    open_cat.create_table("x", SCHEMA)
    server = LakeSoulFlightServer(open_cat, jwt_secret=SECRET, device="cpu")
    try:
        c2 = LakeSoulFlightClient(_serve(server), token=gateways["token"])
        out = pa.ipc.open_stream(c2.action("sql", {"statement": "CALL clean()"})[0]).read_all()
        assert out.column_names == ["versions_dropped", "files_deleted",
                                    "discarded_deleted", "partitions_expired"]
        assert out.num_rows == 1
    finally:
        server.shutdown()


def _tampered(token: str) -> str:
    return token[:-4] + ("AAAA" if token[-4:] != "AAAA" else "BBBB")


@pytest.mark.parametrize("how", ["no_token", "garbage", "tampered", "foreign_domain",
                                 "unknown_action", "missing_table"])
def test_failures_raise_the_same_flight_errors(gateways, how):
    token = gateways["token"]
    errs = {}
    for pkg, loc in gateways["locs"].items():
        c = LakeSoulFlightClient(loc, token={"no_token": None, "garbage": "garbage.t.s",
                                             "tampered": _tampered(token)}.get(how, token))
        try:
            if how == "unknown_action":
                c.action("nope")
            else:
                c.scan({"foreign_domain": "priv", "missing_table": "absent"}.get(how, "events"))
        except Exception as e:  # a malformed token fails in the middleware: not a FlightError
            errs[pkg] = (type(e), str(e).split(". Detail:")[0])
        else:
            errs[pkg] = None
    assert errs["port"] is not None and errs["port"] == errs["ref"], errs


def test_login_mints_a_bearer_both_ways(gateways):
    cats = gateways["cats"]
    port_jwt.UserRegistry(cats["port"].client).register("carol", "pw", group="public")
    tokens = {}
    for pkg, loc in gateways["locs"].items():
        c = LakeSoulFlightClient(loc, basic_auth=("carol", "pw"))
        tokens[pkg] = c.login(ttl_seconds=120)
        assert c.scan("events", limit=3).num_rows == 3
    for pkg, loc in gateways["locs"].items():  # each gateway takes the other's token
        other = tokens["ref" if pkg == "port" else "port"]
        assert LakeSoulFlightClient(loc, token=other).scan("events", limit=2).num_rows == 2
    with pytest.raises(flight.FlightUnauthenticatedError):
        LakeSoulFlightClient(gateways["locs"]["port"], basic_auth=("carol", "no")).login()


def test_exchange_overload_sheds_typed(tmp_path):
    """``TestExchangeOverload`` on the port: beyond max_inflight + max_queue
    exchanges shed with Flight UNAVAILABLE, and the gate drains to zero."""
    from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient

    cat = LakeSoulCatalog(str(tmp_path / "wh"))
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    t.write_arrow(_rows(0, 32_000))
    server = LakeSoulFlightServer(cat, max_inflight=2, max_queue=2, device="cpu")
    loc = f"grpc://127.0.0.1:{server.port}"
    want = t.scan().count_rows()
    results = {"ok": 0, "shed": 0}
    guard, gate = threading.Lock(), threading.Event()

    def run():
        gate.wait()
        c = ScanPlaneClient(loc, max_attempts=1)
        try:
            assert sum(b.num_rows for b in c.iter_batches({"table": "t", "batch_size": 2048})) \
                == want
            key = "ok"
        except flight.FlightUnavailableError:
            key = "shed"
        with guard:
            results[key] += 1

    threads = [threading.Thread(target=run) for _ in range(64)]
    try:
        for th in threads:
            th.start()
        gate.set()
        for th in threads:
            th.join(120.0)
        assert results["ok"] + results["shed"] == 64
        assert results["ok"] > 0 and results["shed"] > 0, results
        snap = server.admission.snapshot()
        assert snap["inflight"] == 0 and snap["waiting"] == 0
    finally:
        server.shutdown()


def test_sql_server_is_not_ported_and_says_so():
    import lakesoul_tpu_torch.service as svc

    with pytest.raises(ConfigError, match="not ported yet"):
        svc.LakeSoulFlightSqlServer


# ------------------------------------------------------------------ ANN actions
def _corpus(n=20_000, d=32, modes=64, nq=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(modes, d)).astype(np.float32) * 3.0
    vecs = centers[rng.integers(0, modes, n)] + rng.normal(size=(n, d)).astype(np.float32)
    qs = centers[rng.integers(0, modes, nq)] + rng.normal(size=(nq, d)).astype(np.float32)
    return vecs.astype(np.float32), qs.astype(np.float32)


def _stream(vecs, batch=5_000):
    for lo in range(0, len(vecs), batch):
        yield vecs[lo:lo + batch], np.arange(lo, min(lo + batch, len(vecs)), dtype=np.uint64)


def _assert_same_topk(ids_ref, d_ref, ids_got, d_got):
    ids_ref, ids_got = np.asarray(ids_ref), np.asarray(ids_got)
    d_ref, d_got = np.asarray(d_ref, np.float64), np.asarray(d_got, np.float64)
    assert ids_ref.shape == ids_got.shape, (ids_ref, ids_got)
    np.testing.assert_allclose(d_got, d_ref, rtol=RTOL, atol=ATOL)
    for i in np.flatnonzero(ids_ref != ids_got):
        tie = np.abs(d_ref - d_ref[i]) <= TIE * max(1.0, abs(d_ref[i]))
        tie[i] = False
        assert tie.any(), f"id {ids_got[i]} != {ids_ref[i]} at rank {i} without a tie"


NPROBES = (1, 3, 8, 16)


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """The same seeded corpus as a two-shard plane built by each package,
    each served by its package's gateway behind a table to RBAC-check
    against."""
    from lakesoul_tpu.annplane import AnnPlane as RefPlane
    from lakesoul_tpu.annplane import AnnPlaneBinding as RefBinding
    from lakesoul_tpu.annplane import AnnPlaneConfig as RefPlaneConfig
    from lakesoul_tpu.annplane import ShardedAnnBuilder as RefBuilder
    from lakesoul_tpu.annplane import ShardedAnnEndpoint as RefEndpoint
    from lakesoul_tpu.vector.config import VectorIndexConfig as RefConfig
    from lakesoul_tpu.vector.index import SearchParams as RefParams
    from lakesoul_tpu_torch.annplane import (AnnPlane, AnnPlaneBinding, AnnPlaneConfig,
                                             ShardedAnnBuilder, ShardedAnnEndpoint)
    from lakesoul_tpu_torch.vector import SearchParams, VectorIndexConfig

    root = tmp_path_factory.mktemp("ann")
    vecs, qs = _corpus()
    cats = _catalogs(root)
    cats["port"].create_table("vecs", pa.schema([("id", pa.int64())]))
    kw = dict(column="e", dim=32, nlist=16, total_bits=1)
    per = AnnPlaneConfig(index=VectorIndexConfig(**kw), shard_budget_bytes=1 << 30)
    budget = 10_000 * per.bytes_per_vector()
    ShardedAnnBuilder(str(root / "port"), AnnPlaneConfig(
        index=VectorIndexConfig(**kw), shard_budget_bytes=budget), device="cpu").build(
        _stream(vecs))
    RefBuilder(str(root / "ref"), RefPlaneConfig(index=RefConfig(**kw),
                                                 shard_budget_bytes=budget)).build(_stream(vecs))
    plane = AnnPlane.open(str(root / "port"), device="cpu")
    ref_plane = RefPlane.open(str(root / "ref"), use_pallas=False)
    assert len(plane.shards) == len(ref_plane.shards) == 2
    params = SearchParams(top_k=10, nprobe=8, rerank_depth=64)
    ep = ShardedAnnEndpoint(plane, params, max_batch=64, max_wait_ms=2.0)
    ref_ep = RefEndpoint(ref_plane, RefParams(top_k=10, nprobe=8, rerank_depth=64),
                         max_batch=64, max_wait_ms=2.0)
    servers = {
        "port": LakeSoulFlightServer(cats["port"], jwt_secret=SECRET, device="cpu",
                                     ann_planes={"p": AnnPlaneBinding(ep, "default", "vecs")}),
        "ref": RefServer(cats["ref"], jwt_secret=SECRET,
                         ann_planes={"p": RefBinding(ref_ep, "default", "vecs")}),
    }
    locs = {k: _serve(s) for k, s in servers.items()}
    token = port_jwt.JwtServer(SECRET).create_token(port_jwt.Claims(sub="alice"))
    yield {"plane": plane, "params": params, "qs": qs, "locs": locs, "token": token}
    for s in servers.values():
        s.shutdown()
    ep.close()
    ref_ep.close()


def _ann(loc, token, body):
    return json.loads(LakeSoulFlightClient(loc, token=token).action("ann_search", body)[0])


@pytest.mark.parametrize("nprobe", NPROBES)
def test_ann_search_equals_the_planes_batch_search_exactly(planes, nprobe):
    qs = planes["qs"]
    got = _ann(planes["locs"]["port"], planes["token"],
               {"plane": "p", "queries": qs.tolist(), "nprobe": nprobe})
    ids, dists = planes["plane"].batch_search(qs, planes["params"],
                                              nprobes=np.full(len(qs), nprobe, np.int64))
    assert len(got) == len(qs)
    for g, i, d in zip(got, ids, dists):
        assert g["ids"] == [int(x) for x in i]
        assert np.array_equal(np.asarray(g["distances"], np.float32), np.asarray(d, np.float32))


def test_ann_search_single_queries_under_concurrency_equal_alone(planes):
    """Concurrent callers share the endpoint's micro-batches: every answer
    is still the query's own batch_search, exactly."""
    qs, loc, token = planes["qs"], planes["locs"]["port"], planes["token"]
    out, errors = {}, []

    def run(i):
        try:
            out[i] = _ann(loc, token, {"plane": "p", "query": qs[i].tolist(),
                                       "nprobe": NPROBES[i % 4], "top_k": 5})
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(qs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors and len(out) == len(qs)
    for i in range(len(qs)):
        ids, d = planes["plane"].batch_search(qs[i:i + 1], planes["params"],
                                              nprobes=np.array([NPROBES[i % 4]]))
        assert out[i]["ids"] == [int(x) for x in ids[0][:5]]
        assert np.array_equal(np.asarray(out[i]["distances"], np.float32), d[0][:5])


def test_ann_search_equals_the_reference_gateway(planes):
    body = {"plane": "p", "queries": planes["qs"].tolist(), "nprobe": 8}
    got = _ann(planes["locs"]["port"], planes["token"], body)
    ref = _ann(planes["locs"]["ref"], planes["token"], body)
    for g, r in zip(got, ref):
        _assert_same_topk(r["ids"], r["distances"], g["ids"], g["distances"])


@pytest.mark.parametrize("body, err", [
    ({"plane": "nope", "query": [0.0] * 32}, "unknown ann plane"),
    ({"plane": "p", "query": [0.0] * 5}, "bad ann_search query"),
])
def test_ann_search_errors_equal_the_reference(planes, body, err):
    msgs = {}
    for pkg, loc in planes["locs"].items():
        with pytest.raises(flight.FlightServerError, match=err) as e:
            _ann(loc, planes["token"], body)
        msgs[pkg] = str(e.value).split(". Detail:")[0]
    assert msgs["port"] == msgs["ref"]


def test_vector_search_equals_the_direct_search_and_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    cats = _catalogs(tmp_path)
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), 16))])
    t = cats["port"].create_table("docs", schema, primary_keys=["id"], hash_bucket_num=2)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    t.write_arrow(pa.table({"id": np.arange(600, dtype=np.int64),
                            "emb": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), 16)},
                           schema=schema))
    assert t.build_vector_index("emb", nlist=4, device="cpu") == 600
    servers = {"port": LakeSoulFlightServer(cats["port"], jwt_secret=SECRET, device="cpu"),
               "ref": RefServer(cats["ref"], jwt_secret=SECRET)}
    try:
        locs = {k: _serve(s) for k, s in servers.items()}
        token = port_jwt.JwtServer(SECRET).create_token(port_jwt.Claims(sub="alice"))
        for qi in (0, 7, 123, 599):
            body = {"table": "docs", "column": "emb", "query": vecs[qi].tolist(),
                    "top_k": 5, "nprobe": 3}
            got = {k: json.loads(LakeSoulFlightClient(loc, token=token)
                                 .action("vector_search", body)[0]) for k, loc in locs.items()}
            ids, d = t.vector_search("emb", vecs[qi], top_k=5, nprobe=3, device="cpu")
            assert got["port"]["ids"] == [int(i) for i in ids] and got["port"]["ids"][0] == qi
            assert np.array_equal(np.asarray(got["port"]["distances"], np.float32),
                                  np.asarray(d, np.float32))
            _assert_same_topk(got["ref"]["ids"], got["ref"]["distances"],
                              got["port"]["ids"], got["port"]["distances"])
        # the gateway holds the opened shards, and sees a rebuild at once
        t.upsert(pa.table({"id": np.arange(600, 640, dtype=np.int64),
                           "emb": pa.FixedSizeListArray.from_arrays(
                               pa.array(vecs[:40].ravel() + 100.0), 16)}, schema=schema))
        assert t.build_vector_index("emb", nlist=4, device="cpu") == 640
        q = vecs[3] + 100.0
        got = json.loads(LakeSoulFlightClient(locs["port"], token=token).action(
            "vector_search", {"table": "docs", "column": "emb", "query": q.tolist(),
                              "top_k": 5, "nprobe": 4})[0])
        ids, _ = t.vector_search("emb", q, top_k=5, nprobe=4, device="cpu")
        assert got["ids"] == [int(i) for i in ids] and got["ids"][0] == 603
    finally:
        for s in servers.values():
            s.shutdown()


def test_the_gateway_searches_on_the_card_unless_asked(tmp_path, monkeypatch):
    """``device=None`` is the card: without one, vector_search raises
    through the gateway instead of searching on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = LakeSoulCatalog(str(tmp_path / "wh"))
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), 8))])
    t = cat.create_table("d", schema, primary_keys=["id"])
    vecs = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    t.write_arrow(pa.table({"id": np.arange(64, dtype=np.int64),
                            "emb": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), 8)},
                           schema=schema))
    t.build_vector_index("emb", nlist=2, device="cpu")
    server = LakeSoulFlightServer(cat)
    try:
        c = LakeSoulFlightClient(_serve(server))
        with pytest.raises(flight.FlightError, match="CUDA"):
            c.action("vector_search", {"table": "d", "column": "emb",
                                       "query": vecs[0].tolist()})
    finally:
        server.shutdown()
