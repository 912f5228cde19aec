"""The port's SQL layer (``lakesoul_tpu_torch/sql``: parser, executor,
TPC-H-lite), ``scan.filter(str)`` and ``to_huggingface`` against the
reference, on one warehouse.

The statement corpus is ``tests/test_sql.py`` itself: every test there that
runs literal statements is one case here, its fixture's statements first,
then its own, in source order.  Each case runs in two namespaces of one
warehouse and metadata store, one a package, through each package's
``SqlSession``; after every statement the two outcomes must be equal: the
same Arrow schema and rows (as a multiset where the statement has no ORDER
BY), or the same error class and message.  What
``test_sql.py`` does in Python between statements is not replayed, so a
statement may see another state than there, but both packages see the same.
"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu as REF
import lakesoul_tpu_torch as PORT
from lakesoul_tpu.sql import SqlSession as RefSession
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.sql import SqlSession
from lakesoul_tpu_torch.sql.parser import parse_predicate

CORPUS_FILE = pathlib.Path(__file__).resolve().parent / "test_sql.py"


def _literal_statements(fn) -> list[str]:
    found = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "execute" and node.args):
            try:
                value = ast.literal_eval(node.args[0])
            except ValueError:
                continue
            if isinstance(value, str):
                found.append((node.lineno, node.col_offset, value))
    return [v for *_, v in sorted(found)]


def _corpus() -> dict[str, list[str]]:
    """``Class::test`` → its fixtures' statements, then its own."""
    tree = ast.parse(CORPUS_FILE.read_text())
    fixtures, tests = {}, {}

    def visit(body, cls):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit(node.body, node.name)
            elif isinstance(node, ast.FunctionDef):
                args = [a.arg for a in node.args.args]
                if any("fixture" in ast.unparse(d) for d in node.decorator_list):
                    fixtures[(cls, node.name)] = _literal_statements(node)
                elif node.name.startswith("test_"):
                    tests[(cls, node.name)] = (args, _literal_statements(node))

    visit(tree.body, None)
    out = {}
    for (cls, name), (args, own) in tests.items():
        setup = []
        for a in args:
            stmts = fixtures.get((cls, a), fixtures.get((None, a)))
            if stmts is not None:
                if not stmts:  # a fixture that builds its tables in Python
                    break
                setup += stmts
        else:
            if own:
                out[f"{cls}::{name}" if cls else name] = setup + own
    return out


CORPUS = _corpus()


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """One warehouse and metadata store; each package's catalog on it."""
    wh = str(tmp_path_factory.mktemp("sql_wh"))
    return {"ref": REF.LakeSoulCatalog(wh), "port": PORT.LakeSoulCatalog(wh)}


def _outcome(session, sql: str, ns: str):
    try:
        out = session.execute(sql)
    except Exception as e:  # the outcome compared is the error itself
        return ("raised", type(e).__name__, str(e).replace(ns, "<ns>"))
    if not isinstance(out, pa.Table):
        return ("value", repr(out).replace(ns, "<ns>"))
    rows = [{k: (v.replace(ns, "<ns>") if isinstance(v, str) else v) for k, v in r.items()}
            for r in out.to_pylist()]
    if "ORDER BY" not in sql.upper():  # SQL leaves the order of such a result open
        rows.sort(key=repr)
    return ("table", [(f.name, str(f.type)) for f in out.schema], rows)


def test_corpus_covers_test_sql():
    """Every statement kind of test_sql.py is in the corpus."""
    assert len(CORPUS) >= 150
    kinds = {s.split()[0].upper() for stmts in CORPUS.values() for s in stmts}
    assert {"SELECT", "WITH", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALTER",
            "CALL", "EXPLAIN", "SHOW", "DESCRIBE"} <= kinds


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_statement_corpus_matches_the_reference(case, warehouse):
    i = sorted(CORPUS).index(case)
    sessions = {}
    for who, cls in (("ref", RefSession), ("port", SqlSession)):
        ns = f"{who}{i:03d}"
        warehouse[who].create_namespace(ns)
        sessions[who] = (cls(warehouse[who], ns) if who == "ref"
                         else cls(warehouse[who], ns, device="cpu"), ns)
    for sql in CORPUS[case]:
        want = _outcome(sessions["ref"][0], sql, sessions["ref"][1])
        got = _outcome(sessions["port"][0], sql, sessions["port"][1])
        assert got == want, sql


# ------------------------------------------------------------------ TPC-H
@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    """The reference generates the eight tables; both packages query them."""
    from lakesoul_tpu.sql.tpch import TpchLite as RefTpch
    from lakesoul_tpu_torch.sql.tpch import TpchLite

    wh = str(tmp_path_factory.mktemp("tpch_wh"))
    ref = RefTpch(REF.LakeSoulCatalog(wh), scale_rows=3_000, seed=7)
    ref.generate()
    return ref, TpchLite(PORT.LakeSoulCatalog(wh), scale_rows=3_000, seed=7)


def test_tpch_has_the_22_queries():
    from lakesoul_tpu.sql.tpch import QUERIES as REF_QUERIES
    from lakesoul_tpu_torch.sql.tpch import QUERIES

    assert QUERIES == REF_QUERIES and len(QUERIES) == 22


@pytest.mark.parametrize("name", [f"q{i:02d}" for i in range(1, 23)])
def test_tpch_query_matches_the_reference(name, tpch):
    ref, port = tpch
    _, want = ref.run(name)
    _, got = port.run(name)
    assert got.schema == want.schema and got.to_pylist() == want.to_pylist()
    assert port.verify(name)


def test_tpch_generates_the_reference_tables(tmp_path):
    """The port's generator writes the reference's rows (seeded numpy)."""
    from lakesoul_tpu.sql.tpch import TpchLite as RefTpch
    from lakesoul_tpu_torch.sql.tpch import TpchLite

    RefTpch(REF.LakeSoulCatalog(str(tmp_path / "r")), scale_rows=500, seed=3).generate()
    TpchLite(PORT.LakeSoulCatalog(str(tmp_path / "p")), scale_rows=500, seed=3).generate()
    r, p = REF.LakeSoulCatalog(str(tmp_path / "r")), PORT.LakeSoulCatalog(str(tmp_path / "p"))
    assert sorted(r.list_tables()) == sorted(p.list_tables()) and len(r.list_tables()) == 8
    for t in r.list_tables():
        want = r.table(t).to_arrow()
        got = p.table(t).to_arrow()
        key = [(c, "ascending") for c in want.column_names]
        assert got.sort_by(key).equals(want.sort_by(key)), t


# ---------------------------------------------------------- scan.filter(str)
@pytest.fixture(scope="module")
def table(tmp_path_factory):
    wh = str(tmp_path_factory.mktemp("filter_wh"))
    rng = np.random.default_rng(0)
    n = 4000
    data = pa.table({"id": np.arange(n, dtype=np.int64),
                     "f0": rng.normal(size=n).astype(np.float32),
                     "label": rng.integers(0, 3, n).astype(np.int32),
                     "city": pa.array(rng.choice(["sf", "nyc", "la", None], n).tolist())})
    t = PORT.LakeSoulCatalog(wh).create_table("t", data.schema, primary_keys=["id"],
                                              hash_bucket_num=4)
    t.write_arrow(data)
    up = data.slice(0, 300)
    t.upsert(up.set_column(1, "f0", pa.array(-up.column("f0").to_numpy())))
    return wh


# each predicate beside its numpy mask over the unfiltered columns
PREDICATES = {
    "f0 > 0.5 AND label = 1": lambda c: (c["f0"] > 0.5) & (c["label"] == 1),
    "label IN (0, 2) OR f0 <= -1.25": lambda c: np.isin(c["label"], [0, 2]) | (c["f0"] <= -1.25),
    "city = 'sf' AND NOT label = 0": lambda c: (c["city"] == "sf") & (c["label"] != 0),
    "city IS NULL": lambda c: c["city"] == None,  # noqa: E711 (elementwise on an object array)
    "id BETWEEN 100 AND 400 AND city <> 'nyc'":
        lambda c: (c["id"] >= 100) & (c["id"] <= 400) & (c["city"] != "nyc")
        & (c["city"] != None),  # noqa: E711 (a NULL city compares to nothing)
    "f0 > 0.5 AND label = 1 AND id < 200":
        lambda c: (c["f0"] > 0.5) & (c["label"] == 1) & (c["id"] < 200),
}


@pytest.mark.parametrize("pred", list(PREDICATES))
def test_string_filter_gives_the_reference_rows(pred, table):
    got = PORT.LakeSoulCatalog(table).scan("t").filter(pred).to_arrow()
    want = REF.LakeSoulCatalog(table).scan("t").filter(pred).to_arrow()
    assert got.num_rows > 0
    assert got.sort_by("id").equals(want.sort_by("id"))
    whole = PORT.LakeSoulCatalog(table).scan("t").to_arrow()
    cols = {k: whole.column(k).to_numpy(zero_copy_only=False) for k in whole.column_names}
    assert got.num_rows == int(PREDICATES[pred](cols).sum())


def test_string_filter_is_the_parsed_filter(table):
    scan = PORT.LakeSoulCatalog(table).scan("t")
    pred = "f0 > 0.5 AND label = 1"
    assert scan.filter(pred)._filter == parse_predicate(pred)
    both = scan.filter("label = 1").filter("f0 > 0.5").to_arrow().sort_by("id")
    assert both.equals(scan.filter(pred).to_arrow().sort_by("id"))


def test_string_filter_feeds_to_torch_iter(table):
    scan = PORT.LakeSoulCatalog(table).scan("t").select(["id", "f0", "label"])
    pred = "f0 > 0.5 AND label = 1"
    rows = sum(len(b["id"]) for b in scan.filter(pred).batch_size(256)
               .to_torch_iter(device="cpu", drop_remainder=False))
    assert rows == scan.filter(pred).count_rows() > 0


def test_a_bad_predicate_raises_the_reference_error(table):
    from lakesoul_tpu.sql.parser import SqlError as RefSqlError
    from lakesoul_tpu_torch.sql.parser import SqlError

    with pytest.raises(RefSqlError) as want:
        REF.LakeSoulCatalog(table).scan("t").filter("f0 > AND")
    with pytest.raises(SqlError) as got:
        PORT.LakeSoulCatalog(table).scan("t").filter("f0 > AND")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------- to_huggingface
@pytest.mark.parametrize("streaming", [True, False])
def test_to_huggingface_gives_the_reference_rows(streaming, table):
    pytest.importorskip("datasets")
    got = list(PORT.LakeSoulCatalog(table).scan("t").to_huggingface(streaming=streaming))
    want = list(REF.LakeSoulCatalog(table).scan("t").to_huggingface(streaming=streaming))
    assert len(got) == 4000
    assert sorted(got, key=lambda r: r["id"]) == sorted(want, key=lambda r: r["id"])


# ------------------------------------------------------------- procedures
def test_call_clean_is_not_ported_yet(tmp_path):
    """``CALL clean`` runs the port's cleaner (it was refused until the
    compaction package was ported) and returns the reference's table."""
    got = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        cat = pkg.LakeSoulCatalog(str(tmp_path / name))
        cat.create_table("t", pa.schema([("id", pa.int64())]))
        s = SqlSession(cat, device="cpu") if name == "port" else RefSession(cat)
        got[name] = s.execute("CALL clean()")
    assert got["port"].equals(got["ref"])
    assert got["port"].to_pylist() == [{"versions_dropped": 0, "files_deleted": 0,
                                        "discarded_deleted": 0, "partitions_expired": 0}]


def test_call_build_vector_index_and_rollback_use_the_port(tmp_path):
    cat = PORT.LakeSoulCatalog(str(tmp_path))
    s = SqlSession(cat, device="cpu")
    s.execute("CREATE TABLE v (id bigint PRIMARY KEY, x bigint)")
    s.execute("INSERT INTO v VALUES (1, 10), (2, 20)")
    s.execute("INSERT INTO v VALUES (3, 30)")
    assert s.execute("CALL rollback('v', 0)").column(0).to_pylist() == [1]
    assert sorted(s.execute("SELECT id FROM v").column("id").to_pylist()) == [1, 2]
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    t = cat.create_table("emb", pa.schema([("id", pa.int64()),
                                           ("v", pa.list_(pa.float32(), 16))]),
                         primary_keys=["id"])
    t.write_arrow(pa.table({"id": np.arange(600, dtype=np.int64),
                            "v": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), 16)}))
    out = s.execute("CALL build_vector_index('emb', 'v')")
    assert out.column("indexed_vectors").to_pylist() == [600]
    if not torch.cuda.is_available():  # device=None is the card, never the CPU
        with pytest.raises(ConfigError, match="CUDA"):
            SqlSession(cat).execute("CALL build_vector_index('emb', 'v')")


def test_aggregates_sum_in_one_order(tmp_path):
    """``GROUP BY`` aggregates and ``DISTINCT`` run pyarrow's hash aggregate
    on one thread: the threaded one merges per-thread partial sums in the
    order the threads finish, so the same statement over the same 20M-row
    table gave ``avg`` values a few ulp apart from run to run on the card's
    8-core host (the reference's executor, ``lakesoul_tpu/sql/executor.py``
    ``group_by(...).aggregate``, still does).  Here the answer is the
    sequential aggregate's, bit for bit, on every run and with 8 threads."""
    cat = PORT.LakeSoulCatalog(str(tmp_path))
    rng = np.random.default_rng(5)
    n = 64 * 4096
    # magnitudes spread over 16 decades: the sum depends on its order
    v = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
    t = cat.create_table("agg", pa.schema([("k", pa.int64()), ("v", pa.float64())]))
    for lo in range(0, n, 4096):  # one file, one batch each: many chunks
        t.write_arrow(pa.table({"k": np.arange(lo, lo + 4096) % 3, "v": v[lo:lo + 4096]}))
    q = "SELECT k, avg(v) AS m, sum(v) AS s, count(*) AS n FROM agg GROUP BY k ORDER BY k"
    held = pa.cpu_count()
    pa.set_cpu_count(8)
    try:
        s = SqlSession(cat, device="cpu")
        outs = [s.execute(q) for _ in range(4)]
        rows = t.scan().to_arrow()
    finally:
        pa.set_cpu_count(held)
    want = rows.group_by("k", use_threads=False).aggregate(
        [("v", "mean"), ("v", "sum"), ("k", "count")]).sort_by("k")
    for out in outs:
        assert out.column("m").to_pylist() == want.column("v_mean").to_pylist()
        assert out.column("s").to_pylist() == want.column("v_sum").to_pylist()
        assert out.column("n").to_pylist() == want.column("k_count").to_pylist()
    distinct = s.execute("SELECT DISTINCT k FROM agg").column("k").to_pylist()
    assert distinct == [0, 1, 2]  # first-seen order, as the rows came
