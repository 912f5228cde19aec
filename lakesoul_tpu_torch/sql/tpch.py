"""TPC-H-lite harness: all 22 query shapes over the 8-table schema (a copy
of ``lakesoul_tpu/sql/tpch.py``).

The reference ships a TPC-H module as a harness (schemas + queries, no
committed numbers — rust/lakesoul-datafusion/src/tpch/, tests/benchmarks/
tpch/).  This is the same idea sized to this framework's SQL dialect: a
scaled generator for all eight TPC-H tables and adaptations of Q1–Q22 that
keep each query's *shape* (joins, grouping, expression aggregates, CASE,
HAVING, sub-queries) while mapping constructs the dialect does not have:

- dates are ISO strings (lexicographic order == date order; EXTRACT(year)
  becomes ``substring(col, 1, 4)``)
- correlated sub-queries run NATIVELY (Q2/Q4/Q17/Q20/Q21/Q22 keep their
  real correlated shapes; the executor decorrelates them mechanically to
  hash semi-joins / grouped left joins, with alias qualifiers resolving
  self-correlation like Q21's ``l2.l_suppkey <> l1.l_suppkey``)
- partsupp's composite key joins through a synthetic ``ps_key``
  (partkey * 1e6 + suppkey) mirrored on lineitem
- multi-role dimension joins (Q7/Q8's two nations) use column-renaming
  derived tables

Every query is result-checked against an independent pandas implementation
(``verify(name)``; tests/test_torch_sql.py holds the port's results
against the reference's), matching the reference's
"correctness harness, not committed numbers" stance.

    t = TpchLite(catalog, scale_rows=20_000)
    t.generate()
    seconds, table = t.run("q01")
    assert t.verify("q01")
"""

from __future__ import annotations

import time

import numpy as np
import pyarrow as pa

from lakesoul_tpu_torch.sql import SqlSession

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
NATIONS = ["FRANCE", "GERMANY", "KENYA", "PERU", "JAPAN", "CANADA", "BRAZIL", "INDIA"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE"]
NATION_REGION = [3, 3, 0, 1, 2, 1, 1, 2]
TYPES = ["PROMO STEEL", "PROMO BRASS", "ECONOMY STEEL", "STANDARD BRASS", "SMALL COPPER"]
BRANDS = ["Brand#11", "Brand#22", "Brand#33", "Brand#44"]
CONTAINERS = ["SM CASE", "MED BOX", "LG JAR", "WRAP BAG"]
MODES = ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

QUERIES = {
    # Q1 pricing summary report: expression aggregates over a date filter
    "q01": (
        "SELECT returnflag, linestatus, sum(quantity) AS sum_qty,"
        " sum(extendedprice) AS sum_base,"
        " sum(extendedprice * (1 - discount)) AS sum_disc,"
        " sum(extendedprice * (1 - discount) * (1 + tax)) AS sum_charge,"
        " avg(quantity) AS avg_qty, avg(extendedprice) AS avg_price,"
        " avg(discount) AS avg_disc, count(*) AS count_order"
        " FROM lineitem WHERE shipdate <= '1998-09-02'"
        " GROUP BY returnflag, linestatus ORDER BY returnflag, linestatus"
    ),
    "q02": (
        # native correlated scalar subquery (min cost per part), the real
        # Q2 shape — decorrelated automatically by the executor
        "SELECT s_acctbal, s_name, n_name, ps_partkey, ps_supplycost"
        " FROM partsupp ps0"
        " JOIN supplier ON ps_suppkey = suppkey"
        " JOIN nation ON s_nationkey = nationkey"
        " JOIN region ON n_regionkey = regionkey"
        " WHERE r_name = 'EUROPE' AND ps_supplycost ="
        " (SELECT min(ps_supplycost) FROM partsupp p2"
        "  WHERE p2.ps_partkey = ps0.ps_partkey)"
        " ORDER BY s_acctbal DESC, n_name, s_name, ps_partkey LIMIT 100"
    ),
    # Q3 shipping priority: 3-way join, grouped revenue
    "q03": (
        "SELECT orderkey, sum(extendedprice * (1 - discount)) AS revenue,"
        " orderdate, o_shippriority"
        " FROM lineitem"
        " JOIN orders ON lineitem.orderkey = orders.orderkey"
        " JOIN customer ON orders.custkey = customer.custkey"
        " WHERE mktsegment = 'BUILDING' AND orderdate < '1995-03-15'"
        " AND shipdate > '1995-03-15'"
        " GROUP BY orderkey, orderdate, o_shippriority"
        " ORDER BY revenue DESC, orderdate LIMIT 10"
    ),
    # Q4 order priority checking — native correlated EXISTS (the real Q4
    # shape; the executor decorrelates it to a hash semi-join)
    "q04": (
        "SELECT o_priority, count(*) AS order_count FROM orders"
        " WHERE orderdate >= '1993-07-01' AND orderdate < '1993-10-01'"
        " AND EXISTS (SELECT * FROM lineitem"
        "             WHERE lineitem.orderkey = orders.orderkey"
        "             AND commitdate < receiptdate)"
        " GROUP BY o_priority ORDER BY o_priority"
    ),
    # Q5 local supplier volume: 6-way join + col-col residual predicate
    "q05": (
        "SELECT n_name, sum(extendedprice * (1 - discount)) AS revenue"
        " FROM lineitem"
        " JOIN orders ON lineitem.orderkey = orders.orderkey"
        " JOIN customer ON orders.custkey = customer.custkey"
        " JOIN supplier ON lineitem.l_suppkey = supplier.suppkey"
        " JOIN nation ON s_nationkey = nationkey"
        " JOIN region ON n_regionkey = regionkey"
        " WHERE r_name = 'ASIA' AND orderdate >= '1994-01-01'"
        " AND orderdate < '1995-01-01' AND c_nationkey = s_nationkey"
        " GROUP BY n_name ORDER BY revenue DESC"
    ),
    # Q6 forecast revenue change: pure filtered aggregate with BETWEEN
    "q06": (
        "SELECT sum(extendedprice * discount) AS revenue FROM lineitem"
        " WHERE shipdate >= '1994-01-01' AND shipdate < '1995-01-01'"
        " AND discount BETWEEN 0.05 AND 0.07 AND quantity < 24"
    ),
    # Q7 volume shipping: two nation roles via renaming derived tables,
    # year via substring
    "q07": (
        "SELECT supp_nation, cust_nation, l_year,"
        " sum(extendedprice * (1 - discount)) AS revenue"
        " FROM (SELECT orderkey AS lo_key, l_suppkey, extendedprice, discount,"
        "              substring(shipdate, 1, 4) AS l_year, shipdate FROM lineitem) l"
        " JOIN orders ON lo_key = orderkey"
        " JOIN customer ON orders.custkey = customer.custkey"
        " JOIN supplier ON l_suppkey = suppkey"
        " JOIN (SELECT nationkey AS s_nkey, n_name AS supp_nation FROM nation) sn"
        " ON s_nationkey = s_nkey"
        " JOIN (SELECT nationkey AS c_nkey, n_name AS cust_nation FROM nation) cn"
        " ON c_nationkey = c_nkey"
        " WHERE shipdate >= '1995-01-01' AND shipdate <= '1996-12-31'"
        " AND supp_nation = 'FRANCE' AND cust_nation = 'GERMANY'"
        " GROUP BY supp_nation, cust_nation, l_year"
        " ORDER BY supp_nation, cust_nation, l_year"
    ),
    # Q8 national market share: CASE-sum ratio, year substring
    "q08": (
        "SELECT o_year, sum(CASE WHEN supp_nation = 'BRAZIL' THEN volume"
        " ELSE 0 END) / sum(volume) AS mkt_share"
        " FROM (SELECT orderkey AS lo_key, l_suppkey, l_partkey,"
        "              extendedprice * (1 - discount) AS volume FROM lineitem) l"
        " JOIN (SELECT orderkey AS ok2, orderdate,"
        "              substring(orderdate, 1, 4) AS o_year FROM orders) o2"
        " ON lo_key = ok2"
        " JOIN part ON l_partkey = partkey"
        " JOIN supplier ON l_suppkey = suppkey"
        " JOIN (SELECT nationkey AS s_nkey, n_name AS supp_nation FROM nation) sn"
        " ON s_nationkey = s_nkey"
        " WHERE p_type = 'ECONOMY STEEL'"
        " AND orderdate >= '1995-01-01' AND orderdate <= '1996-12-31'"
        " GROUP BY o_year ORDER BY o_year"
    ),
    # Q9 product type profit: partsupp composite key via ps_key, LIKE filter
    "q09": (
        "SELECT n_name, o_year, sum(gross - ps_supplycost * quantity) AS sum_profit"
        " FROM (SELECT l_ps_key, l_suppkey, orderkey AS lo_key, l_partkey,"
        "       extendedprice * (1 - discount) AS gross, quantity FROM lineitem) l"
        " JOIN partsupp ON l_ps_key = ps_key"
        " JOIN part ON l_partkey = partkey"
        " JOIN supplier ON l_suppkey = suppkey"
        " JOIN nation ON s_nationkey = nationkey"
        " JOIN (SELECT orderkey AS ok2, substring(orderdate, 1, 4) AS o_year"
        "       FROM orders) o2 ON lo_key = ok2"
        " WHERE p_name LIKE 'PROMO%'"
        " GROUP BY n_name, o_year ORDER BY n_name, o_year DESC"
    ),
    # Q10 returned item reporting
    "q10": (
        "SELECT customer.custkey, c_name,"
        " sum(extendedprice * (1 - discount)) AS revenue, c_acctbal, n_name"
        " FROM lineitem"
        " JOIN orders ON lineitem.orderkey = orders.orderkey"
        " JOIN customer ON orders.custkey = customer.custkey"
        " JOIN nation ON c_nationkey = nationkey"
        " WHERE returnflag = 'R' AND orderdate >= '1993-10-01'"
        " AND orderdate < '1994-01-01'"
        " GROUP BY custkey, c_name, c_acctbal, n_name"
        " ORDER BY revenue DESC LIMIT 20"
    ),
    # Q11 important stock: HAVING against a scalar subquery
    "q11": (
        "SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value"
        " FROM partsupp"
        " JOIN supplier ON ps_suppkey = suppkey"
        " JOIN nation ON s_nationkey = nationkey"
        " WHERE n_name = 'GERMANY'"
        " GROUP BY ps_partkey"
        " HAVING sum(ps_supplycost * ps_availqty) >"
        " (SELECT sum(ps_supplycost * ps_availqty) * 0.01 FROM partsupp"
        "  JOIN supplier ON ps_suppkey = suppkey"
        "  JOIN nation ON s_nationkey = nationkey WHERE n_name = 'GERMANY')"
        " ORDER BY value DESC"
    ),
    # Q12 shipping modes: CASE-sums over a two-mode filter
    "q12": (
        "SELECT shipmode,"
        " sum(CASE WHEN o_priority = '1-URGENT' OR o_priority = '2-HIGH'"
        "     THEN 1 ELSE 0 END) AS high_line_count,"
        " sum(CASE WHEN o_priority <> '1-URGENT' AND o_priority <> '2-HIGH'"
        "     THEN 1 ELSE 0 END) AS low_line_count"
        " FROM lineitem JOIN orders ON lineitem.orderkey = orders.orderkey"
        " WHERE shipmode IN ('MAIL', 'SHIP') AND commitdate < receiptdate"
        " AND shipdate < commitdate AND receiptdate >= '1994-01-01'"
        " AND receiptdate < '1995-01-01'"
        " GROUP BY shipmode ORDER BY shipmode"
    ),
    # Q13 customer order-count distribution: LEFT JOIN + nested grouping
    "q13": (
        "SELECT c_count, count(*) AS custdist FROM"
        " (SELECT customer.custkey, count(orderkey) AS c_count"
        "  FROM customer LEFT JOIN orders ON customer.custkey = orders.custkey"
        "  GROUP BY custkey) c_orders"
        " GROUP BY c_count ORDER BY custdist DESC, c_count DESC"
    ),
    # Q14 promotion effect: CASE-LIKE ratio
    "q14": (
        "SELECT 100.0 * sum(CASE WHEN p_type LIKE 'PROMO%'"
        " THEN extendedprice * (1 - discount) ELSE 0 END)"
        " / sum(extendedprice * (1 - discount)) AS promo_revenue"
        " FROM lineitem JOIN part ON l_partkey = partkey"
        " WHERE shipdate >= '1995-09-01' AND shipdate < '1995-10-01'"
    ),
    # Q15 top supplier: derived revenue view + scalar-subquery equality
    "q15": (
        "SELECT suppkey, s_name, total_revenue FROM supplier"
        " JOIN (SELECT l_suppkey AS rk,"
        "       sum(extendedprice * (1 - discount)) AS total_revenue"
        "       FROM lineitem WHERE shipdate >= '1996-01-01'"
        "       AND shipdate < '1996-04-01' GROUP BY l_suppkey) revenue"
        " ON suppkey = rk"
        " WHERE total_revenue ="
        " (SELECT max(total_revenue) FROM"
        "  (SELECT l_suppkey, sum(extendedprice * (1 - discount)) AS total_revenue"
        "   FROM lineitem WHERE shipdate >= '1996-01-01'"
        "   AND shipdate < '1996-04-01' GROUP BY l_suppkey) r2)"
        " ORDER BY suppkey"
    ),
    # Q16 parts/supplier relationship: count(distinct) + NOT IN subquery
    "q16": (
        "SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt"
        " FROM partsupp JOIN part ON ps_partkey = partkey"
        " WHERE p_brand <> 'Brand#11' AND p_type NOT LIKE 'PROMO%'"
        " AND p_size IN (1, 2, 3, 4, 5)"
        " AND ps_suppkey NOT IN (SELECT suppkey FROM supplier WHERE s_acctbal < 0)"
        " GROUP BY p_brand, p_type, p_size"
        " ORDER BY supplier_cnt DESC, p_brand, p_type, p_size"
    ),
    # Q17 small-quantity-order revenue — native correlated scalar avg (the
    # real Q17 shape; decorrelated to GROUP BY + left join automatically)
    "q17": (
        "SELECT sum(extendedprice) / 7.0 AS avg_yearly FROM lineitem"
        " JOIN part ON l_partkey = partkey"
        " WHERE p_brand = 'Brand#22' AND p_container = 'MED BOX'"
        " AND quantity < (SELECT 0.5 * avg(quantity) FROM lineitem l2"
        "                 WHERE l2.l_partkey = part.partkey)"
    ),
    # Q18 large-volume customers: IN over a HAVING subquery
    "q18": (
        "SELECT c_name, customer.custkey, orders.orderkey, orderdate, totalprice,"
        " sum(quantity) AS total_qty"
        " FROM lineitem"
        " JOIN orders ON lineitem.orderkey = orders.orderkey"
        " JOIN customer ON orders.custkey = customer.custkey"
        " WHERE orders.orderkey IN"
        " (SELECT orderkey FROM lineitem GROUP BY orderkey"
        "  HAVING sum(quantity) > 120)"
        " GROUP BY c_name, custkey, orderkey, orderdate, totalprice"
        " ORDER BY totalprice DESC, orderdate LIMIT 100"
    ),
    # Q19 discounted revenue: OR of AND-groups (fully pushable predicate)
    "q19": (
        "SELECT sum(extendedprice * (1 - discount)) AS revenue"
        " FROM lineitem JOIN part ON l_partkey = partkey"
        " WHERE (p_brand = 'Brand#11' AND p_container = 'SM CASE'"
        "        AND quantity BETWEEN 1 AND 11 AND p_size BETWEEN 1 AND 5)"
        " OR (p_brand = 'Brand#22' AND p_container = 'MED BOX'"
        "     AND quantity BETWEEN 10 AND 20 AND p_size BETWEEN 1 AND 10)"
        " OR (p_brand = 'Brand#33' AND p_container = 'LG JAR'"
        "     AND quantity BETWEEN 20 AND 30 AND p_size BETWEEN 1 AND 15)"
    ),
    # Q20 potential part promotion — the real nested shape: IN over a
    # subquery whose availqty threshold is a CORRELATED scalar sum over
    # lineitem (correlates to the middle partsupp scope)
    "q20": (
        "SELECT s_name FROM supplier"
        " JOIN nation ON s_nationkey = nationkey"
        " WHERE n_name = 'CANADA' AND suppkey IN"
        " (SELECT ps_suppkey FROM partsupp"
        "  WHERE ps_partkey IN (SELECT partkey FROM part WHERE p_name LIKE 'PROMO%')"
        "  AND ps_availqty > (SELECT 0.5 * sum(quantity) FROM lineitem"
        "                     WHERE l_partkey = ps_partkey"
        "                     AND l_suppkey = ps_suppkey))"
        " ORDER BY s_name"
    ),
    # Q21 suppliers who kept orders waiting — the REAL self-correlated
    # shape: alias qualifiers (l1/l2/l3) resolve the same-named columns
    # across scopes; the executor decorrelates both EXISTS legs to
    # semi-joins with the <> predicate evaluated on the joined pairs
    "q21": (
        "SELECT s_name, count(*) AS numwait FROM lineitem l1"
        " JOIN supplier ON l1.l_suppkey = suppkey"
        " JOIN orders ON l1.orderkey = orders.orderkey"
        " JOIN nation ON s_nationkey = nationkey"
        " WHERE o_status = 'F' AND receiptdate > commitdate"
        " AND n_name = 'KENYA'"
        " AND EXISTS (SELECT * FROM lineitem l2 WHERE l2.orderkey = l1.orderkey"
        "             AND l2.l_suppkey <> l1.l_suppkey)"
        " AND NOT EXISTS (SELECT * FROM lineitem l3"
        "                 WHERE l3.orderkey = l1.orderkey"
        "                 AND l3.l_suppkey <> l1.l_suppkey"
        "                 AND l3.receiptdate > l3.commitdate)"
        " GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT 100"
    ),
    # Q22 global sales opportunity: substring country codes, scalar-subquery
    # threshold, and the real correlated NOT EXISTS anti-join
    "q22": (
        "SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal FROM"
        " (SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal, custkey"
        "  FROM customer) c"
        " WHERE cntrycode IN ('13', '31', '23', '29', '30')"
        " AND c_acctbal > (SELECT avg(c_acctbal) FROM customer"
        "                  WHERE c_acctbal > 0.0)"
        " AND NOT EXISTS (SELECT * FROM orders WHERE orders.custkey = c.custkey)"
        " GROUP BY cntrycode ORDER BY cntrycode"
    ),
}


class TpchLite:
    def __init__(self, catalog, *, scale_rows: int = 20_000, seed: int = 0):
        self.catalog = catalog
        self.sql = SqlSession(catalog)
        self.scale_rows = scale_rows
        self.seed = seed
        self._frames: dict[str, "object"] = {}

    # --------------------------------------------------------------- schema
    def generate(self) -> None:
        rng = np.random.default_rng(self.seed)
        n_li = self.scale_rows
        n_ord = max(4, n_li // 4)
        n_cust = max(4, n_ord // 10)
        n_part = max(4, n_li // 20)
        n_supp = max(4, n_li // 100)
        n_nation = len(NATIONS)

        ddl = [
            "CREATE TABLE IF NOT EXISTS region (regionkey bigint PRIMARY KEY,"
            " r_name string)",
            "CREATE TABLE IF NOT EXISTS nation (nationkey bigint PRIMARY KEY,"
            " n_name string, n_regionkey bigint)",
            "CREATE TABLE IF NOT EXISTS supplier (suppkey bigint PRIMARY KEY,"
            " s_name string, s_nationkey bigint, s_acctbal double)",
            "CREATE TABLE IF NOT EXISTS customer (custkey bigint PRIMARY KEY,"
            " c_name string, c_nationkey bigint, c_acctbal double,"
            " mktsegment string, c_phone string)",
            "CREATE TABLE IF NOT EXISTS part (partkey bigint PRIMARY KEY,"
            " p_name string, p_brand string, p_type string, p_size int,"
            " p_container string, p_retailprice double)",
            "CREATE TABLE IF NOT EXISTS partsupp (ps_key bigint PRIMARY KEY,"
            " ps_partkey bigint, ps_suppkey bigint, ps_availqty int,"
            " ps_supplycost double) WITH (hashBucketNum = '2')",
            "CREATE TABLE IF NOT EXISTS orders (orderkey bigint PRIMARY KEY,"
            " custkey bigint, o_status string, totalprice double,"
            " orderdate string, o_priority string, o_shippriority int)"
            " WITH (hashBucketNum = '4')",
            "CREATE TABLE IF NOT EXISTS lineitem (linekey bigint PRIMARY KEY,"
            " orderkey bigint, l_partkey bigint, l_suppkey bigint,"
            " l_ps_key bigint, quantity double, extendedprice double,"
            " discount double, tax double, returnflag string,"
            " linestatus string, shipdate string, commitdate string,"
            " receiptdate string, shipmode string)"
            " WITH (hashBucketNum = '4')",
        ]
        for stmt in ddl:
            self.sql.execute(stmt)

        def dates(base: str, spread: int, n: int):
            return (np.datetime64(base) + rng.integers(0, spread, n)).astype(str)

        region = pa.table(
            {"regionkey": np.arange(4, dtype=np.int64), "r_name": REGIONS}
        )
        nation = pa.table(
            {
                "nationkey": np.arange(n_nation, dtype=np.int64),
                "n_name": NATIONS,
                "n_regionkey": np.array(NATION_REGION, dtype=np.int64),
            }
        )
        supplier = pa.table(
            {
                "suppkey": np.arange(n_supp, dtype=np.int64),
                "s_name": [f"Supplier#{i:05d}" for i in range(n_supp)],
                "s_nationkey": rng.integers(0, n_nation, n_supp).astype(np.int64),
                "s_acctbal": (rng.random(n_supp) * 12_000 - 1_000).round(2),
            }
        )
        customer = pa.table(
            {
                "custkey": np.arange(n_cust, dtype=np.int64),
                "c_name": [f"Customer#{i:06d}" for i in range(n_cust)],
                "c_nationkey": rng.integers(0, n_nation, n_cust).astype(np.int64),
                "c_acctbal": (rng.random(n_cust) * 10_000 - 1_000).round(2),
                "mktsegment": rng.choice(SEGMENTS, n_cust),
                "c_phone": [
                    f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                    for _ in range(n_cust)
                ],
            }
        )
        part = pa.table(
            {
                "partkey": np.arange(n_part, dtype=np.int64),
                "p_name": rng.choice(
                    ["PROMO tin", "PROMO lace", "LARGE plated", "SMALL brushed"], n_part
                ),
                "p_brand": rng.choice(BRANDS, n_part),
                "p_type": rng.choice(TYPES, n_part),
                "p_size": rng.integers(1, 21, n_part).astype(np.int32),
                "p_container": rng.choice(CONTAINERS, n_part),
                "p_retailprice": (rng.random(n_part) * 2_000).round(2),
            }
        )
        ps_part = rng.integers(0, n_part, n_li // 5 + 4).astype(np.int64)
        ps_supp = rng.integers(0, n_supp, n_li // 5 + 4).astype(np.int64)
        ps_key = ps_part * 1_000_000 + ps_supp
        _, uniq_idx = np.unique(ps_key, return_index=True)
        partsupp = pa.table(
            {
                "ps_key": ps_key[uniq_idx],
                "ps_partkey": ps_part[uniq_idx],
                "ps_suppkey": ps_supp[uniq_idx],
                "ps_availqty": rng.integers(1, 10_000, len(uniq_idx)).astype(np.int32),
                "ps_supplycost": (rng.random(len(uniq_idx)) * 1_000).round(2),
            }
        )
        orders = pa.table(
            {
                "orderkey": np.arange(n_ord, dtype=np.int64),
                "custkey": rng.integers(0, n_cust, n_ord).astype(np.int64),
                "o_status": rng.choice(["O", "F", "P"], n_ord),
                "totalprice": (rng.random(n_ord) * 100_000).round(2),
                "orderdate": dates("1992-01-01", 2500, n_ord),
                "o_priority": rng.choice(PRIORITIES, n_ord),
                "o_shippriority": np.zeros(n_ord, dtype=np.int32),
            }
        )
        # lineitem draws its partsupp pair from existing partsupp rows so the
        # synthetic ps_key join always matches
        pick = rng.integers(0, len(partsupp), n_li)
        l_part = partsupp.column("ps_partkey").to_numpy()[pick]
        l_supp = partsupp.column("ps_suppkey").to_numpy()[pick]
        ship = np.datetime64("1992-01-02") + rng.integers(0, 2500, n_li)
        commit = ship + rng.integers(-30, 60, n_li)
        receipt = commit + rng.integers(-10, 45, n_li)
        lineitem = pa.table(
            {
                "linekey": np.arange(n_li, dtype=np.int64),
                "orderkey": rng.integers(0, n_ord, n_li).astype(np.int64),
                "l_partkey": l_part,
                "l_suppkey": l_supp,
                "l_ps_key": l_part * 1_000_000 + l_supp,
                "quantity": rng.integers(1, 51, n_li).astype(np.float64),
                "extendedprice": (rng.random(n_li) * 10_000).round(2),
                "discount": rng.integers(0, 11, n_li).astype(np.float64) / 100.0,
                "tax": rng.integers(0, 9, n_li).astype(np.float64) / 100.0,
                "returnflag": rng.choice(["A", "N", "R"], n_li),
                "linestatus": rng.choice(["O", "F"], n_li),
                "shipdate": ship.astype(str),
                "commitdate": commit.astype(str),
                "receiptdate": receipt.astype(str),
                "shipmode": rng.choice(MODES, n_li),
            }
        )
        tables = {
            "region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem,
        }
        for name, tbl in tables.items():
            self.catalog.table(name).write_arrow(tbl)
        self._frames = {k: v.to_pandas() for k, v in tables.items()}

    # ---------------------------------------------------------------- runs
    def run(self, name: str) -> tuple[float, pa.Table]:
        sql = QUERIES[name]
        start = time.perf_counter()
        out = self.sql.execute(sql)
        return time.perf_counter() - start, out

    def run_all(self) -> dict[str, tuple[float, pa.Table]]:
        return {name: self.run(name) for name in QUERIES}

    # ---------------------------------------------------------------- verify
    def verify(self, name: str, *, atol: float = 1e-6) -> bool:
        """Execute + compare against the independent pandas reference."""
        _, got = self.run(name)
        expected = pandas_reference(name, self.frames())
        return _tables_match(got, expected, atol=atol)

    def frames(self) -> dict:
        if not self._frames:
            self._frames = {
                n: self.catalog.table(n).to_arrow().to_pandas()
                for n in ("region", "nation", "supplier", "customer", "part",
                          "partsupp", "orders", "lineitem")
            }
        return self._frames


def _tables_match(got: pa.Table, expected, *, atol: float) -> bool:
    import pandas as pd

    gdf = got.to_pandas().reset_index(drop=True)
    edf = expected.reset_index(drop=True)
    if list(gdf.columns) != list(edf.columns):
        raise AssertionError(f"column mismatch: {list(gdf.columns)} vs {list(edf.columns)}")
    if len(gdf) != len(edf):
        raise AssertionError(f"row count mismatch: {len(gdf)} vs {len(edf)}")
    for col in gdf.columns:
        g, e = gdf[col], edf[col]
        if pd.api.types.is_numeric_dtype(e):
            if not np.allclose(
                g.astype(float).fillna(np.nan),
                e.astype(float).fillna(np.nan),
                atol=atol, rtol=1e-9, equal_nan=True,
            ):
                raise AssertionError(f"numeric mismatch in {col}")
        else:
            if not (g.fillna("<null>").astype(str) == e.fillna("<null>").astype(str)).all():
                raise AssertionError(f"value mismatch in {col}")
    return True


def pandas_reference(name: str, f: dict):
    """Independent pandas implementation of each adapted query."""
    import pandas as pd

    li, od, cu = f["lineitem"], f["orders"], f["customer"]
    su, na, re_, pt, ps = f["supplier"], f["nation"], f["region"], f["part"], f["partsupp"]

    def rev(df):
        return df["extendedprice"] * (1 - df["discount"])

    if name == "q01":
        d = li[li.shipdate <= "1998-09-02"].copy()
        d["sum_disc"] = rev(d)
        d["sum_charge"] = rev(d) * (1 + d["tax"])
        g = d.groupby(["returnflag", "linestatus"], as_index=False).agg(
            sum_qty=("quantity", "sum"), sum_base=("extendedprice", "sum"),
            sum_disc=("sum_disc", "sum"), sum_charge=("sum_charge", "sum"),
            avg_qty=("quantity", "mean"), avg_price=("extendedprice", "mean"),
            avg_disc=("discount", "mean"), count_order=("quantity", "size"),
        )
        return g.sort_values(["returnflag", "linestatus"])

    if name == "q02":
        m = ps.groupby("ps_partkey", as_index=False)["ps_supplycost"].min()
        m.columns = ["ps_partkey", "mincost"]
        d = (
            ps.merge(su, left_on="ps_suppkey", right_on="suppkey")
            .merge(na, left_on="s_nationkey", right_on="nationkey")
            .merge(re_, left_on="n_regionkey", right_on="regionkey")
            .merge(m, on="ps_partkey")
        )
        d = d[(d.r_name == "EUROPE") & (d.ps_supplycost == d.mincost)]
        d = d.sort_values(
            ["s_acctbal", "n_name", "s_name", "ps_partkey"],
            ascending=[False, True, True, True],
        ).head(100)
        return d[["s_acctbal", "s_name", "n_name", "ps_partkey", "ps_supplycost"]]

    if name == "q03":
        d = li.merge(od, on="orderkey").merge(cu, on="custkey")
        d = d[(d.mktsegment == "BUILDING") & (d.orderdate < "1995-03-15") & (d.shipdate > "1995-03-15")]
        d = d.assign(revenue=rev(d))
        g = d.groupby(["orderkey", "orderdate", "o_shippriority"], as_index=False)["revenue"].sum()
        g = g.sort_values(["revenue", "orderdate"], ascending=[False, True]).head(10)
        return g[["orderkey", "revenue", "orderdate", "o_shippriority"]]

    if name == "q04":
        late = set(li[li.commitdate < li.receiptdate]["orderkey"])
        d = od[
            (od.orderdate >= "1993-07-01") & (od.orderdate < "1993-10-01")
            & od.orderkey.isin(late)
        ]
        g = d.groupby("o_priority", as_index=False).agg(order_count=("orderkey", "size"))
        return g.sort_values("o_priority")

    if name == "q05":
        d = (
            li.merge(od, on="orderkey").merge(cu, on="custkey")
            .merge(su, left_on="l_suppkey", right_on="suppkey")
            .merge(na, left_on="s_nationkey", right_on="nationkey")
            .merge(re_, left_on="n_regionkey", right_on="regionkey")
        )
        d = d[
            (d.r_name == "ASIA") & (d.orderdate >= "1994-01-01")
            & (d.orderdate < "1995-01-01") & (d.c_nationkey == d.s_nationkey)
        ]
        d = d.assign(revenue=rev(d))
        g = d.groupby("n_name", as_index=False)["revenue"].sum()
        return g.sort_values("revenue", ascending=False)

    if name == "q06":
        d = li[
            (li.shipdate >= "1994-01-01") & (li.shipdate < "1995-01-01")
            & (li.discount >= 0.05) & (li.discount <= 0.07) & (li.quantity < 24)
        ]
        return pd.DataFrame({"revenue": [(d["extendedprice"] * d["discount"]).sum()]})

    if name == "q07":
        d = (
            li.merge(od, on="orderkey").merge(cu, on="custkey")
            .merge(su, left_on="l_suppkey", right_on="suppkey")
            .merge(na.rename(columns={"n_name": "supp_nation"}),
                   left_on="s_nationkey", right_on="nationkey")
            .merge(na.rename(columns={"n_name": "cust_nation"}),
                   left_on="c_nationkey", right_on="nationkey")
        )
        d = d[
            (d.shipdate >= "1995-01-01") & (d.shipdate <= "1996-12-31")
            & (d.supp_nation == "FRANCE") & (d.cust_nation == "GERMANY")
        ]
        d = d.assign(l_year=d.shipdate.str[:4], revenue=rev(d))
        g = d.groupby(["supp_nation", "cust_nation", "l_year"], as_index=False)["revenue"].sum()
        return g.sort_values(["supp_nation", "cust_nation", "l_year"])

    if name == "q08":
        d = (
            li.merge(od, on="orderkey").merge(pt, left_on="l_partkey", right_on="partkey")
            .merge(su, left_on="l_suppkey", right_on="suppkey")
            .merge(na.rename(columns={"n_name": "supp_nation"}),
                   left_on="s_nationkey", right_on="nationkey")
        )
        d = d[
            (d.p_type == "ECONOMY STEEL")
            & (d.orderdate >= "1995-01-01") & (d.orderdate <= "1996-12-31")
        ]
        d = d.assign(o_year=d.orderdate.str[:4], volume=rev(d))
        d["brazil"] = np.where(d.supp_nation == "BRAZIL", d.volume, 0.0)
        g = d.groupby("o_year", as_index=False).agg(
            b=("brazil", "sum"), v=("volume", "sum")
        )
        g["mkt_share"] = g.b / g.v
        return g.sort_values("o_year")[["o_year", "mkt_share"]]

    if name == "q09":
        d = (
            li.merge(ps, left_on="l_ps_key", right_on="ps_key")
            .merge(pt, left_on="l_partkey", right_on="partkey")
            .merge(su, left_on="l_suppkey", right_on="suppkey")
            .merge(na, left_on="s_nationkey", right_on="nationkey")
            .merge(od, on="orderkey")
        )
        d = d[d.p_name.str.startswith("PROMO")]
        d = d.assign(
            o_year=d.orderdate.str[:4],
            amount=rev(d) - d.ps_supplycost * d.quantity,
        )
        g = d.groupby(["n_name", "o_year"], as_index=False)["amount"].sum()
        g.columns = ["n_name", "o_year", "sum_profit"]
        return g.sort_values(["n_name", "o_year"], ascending=[True, False])

    if name == "q10":
        d = (
            li.merge(od, on="orderkey").merge(cu, on="custkey")
            .merge(na, left_on="c_nationkey", right_on="nationkey")
        )
        d = d[
            (d.returnflag == "R") & (d.orderdate >= "1993-10-01")
            & (d.orderdate < "1994-01-01")
        ]
        d = d.assign(revenue=rev(d))
        g = d.groupby(["custkey", "c_name", "c_acctbal", "n_name"], as_index=False)["revenue"].sum()
        g = g.sort_values("revenue", ascending=False).head(20)
        return g[["custkey", "c_name", "revenue", "c_acctbal", "n_name"]]

    if name == "q11":
        d = (
            ps.merge(su, left_on="ps_suppkey", right_on="suppkey")
            .merge(na, left_on="s_nationkey", right_on="nationkey")
        )
        d = d[d.n_name == "GERMANY"]
        d = d.assign(value=d.ps_supplycost * d.ps_availqty)
        threshold = d["value"].sum() * 0.01
        g = d.groupby("ps_partkey", as_index=False)["value"].sum()
        g = g[g["value"] > threshold]
        return g.sort_values("value", ascending=False)

    if name == "q12":
        d = li.merge(od, on="orderkey")
        d = d[
            d.shipmode.isin(["MAIL", "SHIP"]) & (d.commitdate < d.receiptdate)
            & (d.shipdate < d.commitdate) & (d.receiptdate >= "1994-01-01")
            & (d.receiptdate < "1995-01-01")
        ]
        high = d.o_priority.isin(["1-URGENT", "2-HIGH"])
        d = d.assign(high_line_count=high.astype(int), low_line_count=(~high).astype(int))
        g = d.groupby("shipmode", as_index=False)[["high_line_count", "low_line_count"]].sum()
        return g.sort_values("shipmode")

    if name == "q13":
        merged = cu.merge(od, on="custkey", how="left")
        counts = merged.groupby("custkey", as_index=False).agg(
            c_count=("orderkey", "count")
        )
        g = counts.groupby("c_count", as_index=False).agg(custdist=("c_count", "size"))
        return g.sort_values(["custdist", "c_count"], ascending=[False, False])

    if name == "q14":
        d = li.merge(pt, left_on="l_partkey", right_on="partkey")
        d = d[(d.shipdate >= "1995-09-01") & (d.shipdate < "1995-10-01")]
        promo = np.where(d.p_type.str.startswith("PROMO"), rev(d), 0.0)
        return pd.DataFrame({"promo_revenue": [100.0 * promo.sum() / rev(d).sum()]})

    if name == "q15":
        d = li[(li.shipdate >= "1996-01-01") & (li.shipdate < "1996-04-01")]
        r = d.assign(revenue=rev(d)).groupby("l_suppkey", as_index=False)["revenue"].sum()
        r.columns = ["l_suppkey", "total_revenue"]
        top = r[r.total_revenue == r.total_revenue.max()]
        out = su.merge(top, left_on="suppkey", right_on="l_suppkey")
        return out.sort_values("suppkey")[["suppkey", "s_name", "total_revenue"]]

    if name == "q16":
        bad = set(su[su.s_acctbal < 0]["suppkey"])
        d = ps.merge(pt, left_on="ps_partkey", right_on="partkey")
        d = d[
            (d.p_brand != "Brand#11") & ~d.p_type.str.startswith("PROMO")
            & d.p_size.isin([1, 2, 3, 4, 5]) & ~d.ps_suppkey.isin(bad)
        ]
        g = d.groupby(["p_brand", "p_type", "p_size"], as_index=False).agg(
            supplier_cnt=("ps_suppkey", "nunique")
        )
        return g.sort_values(
            ["supplier_cnt", "p_brand", "p_type", "p_size"],
            ascending=[False, True, True, True],
        )

    if name == "q17":
        avg_qty = li.groupby("l_partkey", as_index=False)["quantity"].mean()
        avg_qty.columns = ["l_partkey", "avg_qty"]
        d = li.merge(pt, left_on="l_partkey", right_on="partkey").merge(avg_qty, on="l_partkey")
        d = d[
            (d.p_brand == "Brand#22") & (d.p_container == "MED BOX")
            & (d.quantity < 0.5 * d.avg_qty)
        ]
        return pd.DataFrame({"avg_yearly": [d["extendedprice"].sum() / 7.0]})

    if name == "q18":
        big = li.groupby("orderkey", as_index=False)["quantity"].sum()
        big = set(big[big.quantity > 120]["orderkey"])
        d = li.merge(od, on="orderkey").merge(cu, on="custkey")
        d = d[d.orderkey.isin(big)]
        g = d.groupby(
            ["c_name", "custkey", "orderkey", "orderdate", "totalprice"], as_index=False
        )["quantity"].sum()
        g.columns = ["c_name", "custkey", "orderkey", "orderdate", "totalprice", "total_qty"]
        g = g.sort_values(["totalprice", "orderdate"], ascending=[False, True]).head(100)
        return g

    if name == "q19":
        d = li.merge(pt, left_on="l_partkey", right_on="partkey")
        m1 = (
            (d.p_brand == "Brand#11") & (d.p_container == "SM CASE")
            & d.quantity.between(1, 11) & d.p_size.between(1, 5)
        )
        m2 = (
            (d.p_brand == "Brand#22") & (d.p_container == "MED BOX")
            & d.quantity.between(10, 20) & d.p_size.between(1, 10)
        )
        m3 = (
            (d.p_brand == "Brand#33") & (d.p_container == "LG JAR")
            & d.quantity.between(20, 30) & d.p_size.between(1, 15)
        )
        d = d[m1 | m2 | m3]
        return pd.DataFrame({"revenue": [rev(d).sum()]})

    if name == "q20":
        promo_parts = set(pt[pt.p_name.str.startswith("PROMO")]["partkey"])
        qty = li.groupby(["l_partkey", "l_suppkey"])["quantity"].sum()
        cand = ps[ps.ps_partkey.isin(promo_parts)].copy()
        thresh = cand.apply(
            lambda r: 0.5 * qty.get((r.ps_partkey, r.ps_suppkey), float("nan")),
            axis=1,
        )
        # NaN threshold (no lineitem rows) never passes — SQL NULL semantics
        supp = set(cand[cand.ps_availqty > thresh]["ps_suppkey"])
        d = su.merge(na, left_on="s_nationkey", right_on="nationkey")
        d = d[(d.n_name == "CANADA") & d.suppkey.isin(supp)]
        return d.sort_values("s_name")[["s_name"]]

    if name == "q21":
        # real Q21 semantics: l1 late; ANOTHER supplier has a lineitem in
        # the same order; and NO other supplier's lineitem in it is late
        supp_by_order = li.groupby("orderkey")["l_suppkey"].agg(lambda s: set(s))
        late = li[li.receiptdate > li.commitdate]
        late_by_order = late.groupby("orderkey")["l_suppkey"].agg(lambda s: set(s))
        d = (
            li.merge(su, left_on="l_suppkey", right_on="suppkey")
            .merge(od, on="orderkey")
            .merge(na, left_on="s_nationkey", right_on="nationkey")
        )
        d = d[
            (d.o_status == "F") & (d.receiptdate > d.commitdate)
            & (d.n_name == "KENYA")
        ]
        keep = d.apply(
            lambda r: bool(supp_by_order.get(r.orderkey, set()) - {r.l_suppkey})
            and not (late_by_order.get(r.orderkey, set()) - {r.l_suppkey}),
            axis=1,
        )
        d = d[keep] if len(d) else d
        g = d.groupby("s_name", as_index=False).agg(numwait=("orderkey", "size"))
        return g.sort_values(["numwait", "s_name"], ascending=[False, True]).head(100)

    if name == "q22":
        avg_bal = cu[cu.c_acctbal > 0.0]["c_acctbal"].mean()
        has_orders = set(od["custkey"])
        d = cu.assign(cntrycode=cu.c_phone.str[:2])
        d = d[
            d.cntrycode.isin(["13", "31", "23", "29", "30"])
            & (d.c_acctbal > avg_bal) & ~d.custkey.isin(has_orders)
        ]
        g = d.groupby("cntrycode", as_index=False).agg(
            numcust=("custkey", "size"), totacctbal=("c_acctbal", "sum")
        )
        return g.sort_values("cntrycode")

    raise KeyError(name)
