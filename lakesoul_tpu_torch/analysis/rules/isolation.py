"""Isolation-portability rules — the metadata path must survive PG.

The seed store grew up on SQLite, whose write transactions are fully
serialized: any read-then-write inside ``transaction()`` is atomic for
free, and sqlite-only SQL just works.  The reference deployment is
PostgreSQL at READ COMMITTED, where none of that holds — a peer's commit
can land between your read and your dependent write, and a blind
``UPDATE ... WHERE pk=?`` silently overwrites a takeover.  The lease
table made the lease protocol CAS-shaped by hand; these rules make the
discipline mechanical for the whole ``meta/`` path.  Four rules over the
shared SQL statement model (:mod:`lakesoul_tpu_torch.analysis.sqlinfo`):

- ``cas-guard``: UPDATE/DELETE on the coordination tables (``lease``,
  ``partition_info``, ``data_commit_info``) must carry the full CAS
  predicate in the WHERE — not just the primary key — and lease CAS
  results must be consumed through ``.rowcount`` (an unexamined CAS is a
  blind write with extra steps).  ``DELETE FROM lease`` is always wrong:
  lease rows are tombstoned so fencing tokens stay monotonic per key.
- ``read-modify-write``: a value read from the store (``get_*``,
  ``commit_state``, …) flowing into a dependent blind store write
  (``set_global_config``/``update_table_properties``/
  ``update_table_schema``) — interprocedural, over the taint framework.
  Flows whose sink sits lexically inside a ``with store.transaction()``
  block are sanctioned: the seam (plus ``ROW_LOCK`` reads) makes them
  unsplittable.
- ``txn-boundary``: write statements must execute inside a transaction
  context (``with ...transaction()``, ``with conn:``, or routed through
  ``self._exec(conn, …)`` by a helper that received the txn's conn), and
  callers outside ``meta/store.py`` must not reach around the named seam
  via ``store._exec``/``store._txn``/``store._conn``.
- ``sqlite-ism``: sqlite-only SQL headed for the backend seam — ``INSERT
  OR REPLACE``, ``datetime('now')``/``julianday``/``strftime``,
  ``rowid``, ``AUTOINCREMENT``, ``PRAGMA`` outside the sqlite backend
  class, and qmark/OR-IGNORE statements bound past ``translate_sql`` via
  a raw ``execute`` — everything ``fake_psycopg2`` or real PG would
  reject or silently mis-run.

Known limits, on purpose: SQL strings assembled in variables before the
execute call are invisible (the store inlines every statement); the
seam-reach-around check keys on a ``store``-named receiver so unrelated
``_exec`` methods stay out of scope; and transaction context is lexical
(a callee that writes on a caller's conn is accepted only through the
``_exec(conn, …)`` convention) — deeper interleaving questions are the
runtime replayer's job (:mod:`lakesoul_tpu_torch.analysis.txncheck`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Project,
    Rule,
    dotted_name,
)
from lakesoul_tpu_torch.analysis.sqlinfo import Statement, parse_statement

# default repo scope: the PG-ready metadata path
SCOPE = ("meta/",)

# seam modules that may touch transaction internals (_exec/_txn/_conn)
SEAM = ("meta/store.py",)

# coordination tables and the CAS discipline each one carries
_LEASE_CAS_COLS = frozenset({"fencing_token", "holder_id", "expires_at_ms"})
_TABLE_KEYS = {
    "partition_info": frozenset({"table_id", "partition_desc", "version"}),
    "data_commit_info": frozenset({"table_id", "partition_desc", "commit_id"}),
}

_WRITE_VERBS = ("insert", "update", "delete")
_STMT_HEADS = (
    "SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "PRAGMA",
    "BEGIN", "COMMIT", "ROLLBACK", "ATTACH", "VACUUM", "ANALYZE",
)


@dataclass
class _SqlSite:
    """One SQL string in a module, with its execution context."""

    stmt: Statement
    line: int
    node: ast.AST  # the string expression
    call: "ast.Call | None"  # nearest enclosing call, if any
    exec_kind: str  # "seam" (_exec) | "direct" (execute*) | "none"
    in_txn: bool  # lexically inside an accepted transaction context
    conn_routed: bool  # _exec(conn, …) inside a conn-taking helper
    func: "ast.AST | None"  # enclosing function def
    class_name: "str | None"  # enclosing class name


def _string_text(node: ast.AST) -> "str | None":
    """The statement-ish text of a string expression.  JoinedStr formatted
    values become \\x00 placeholders (never identifier-shaped, so a dynamic
    table name reads as unresolvable rather than as a table)."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, ast.JoinedStr):
        parts = []
        for value in node.values:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                parts.append(value.value)
            else:
                parts.append("\x00")
        return "".join(parts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _string_text(node.left)
        right = _string_text(node.right)
        if left is not None and right is not None:
            return left + right
    return None


def _terminal(func: ast.expr) -> str:
    return (dotted_name(func) or "").rsplit(".", 1)[-1]


def _is_txn_with(node: ast.With) -> bool:
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call):
            if _terminal(ce.func) in ("transaction", "_txn"):
                return True
        elif isinstance(ce, ast.Name) and ce.id.startswith("conn"):
            return True  # `with conn:` — the DB-API transaction CM
    return False


_SCOPE_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Lambda)


def _context(node: ast.AST, parents: dict) -> tuple:
    """(nearest call, in_txn, enclosing function, enclosing class name) for
    a string node.  Transaction context is lexical and does not cross
    function boundaries — a With wrapping a nested def says nothing about
    when the def's body runs."""
    call = None
    in_txn = False
    func = None
    class_name = None
    crossed_func = False
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.Call) and call is None and not crossed_func:
            call = cur
        elif isinstance(cur, ast.With) and not crossed_func:
            in_txn = in_txn or _is_txn_with(cur)
        elif isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if func is None:
                func = cur
            crossed_func = True
        elif isinstance(cur, ast.ClassDef):
            if class_name is None:
                class_name = cur.name
            crossed_func = True
        cur = parents.get(cur)
    return call, in_txn, func, class_name


def _module_sites(module: Module) -> "list[_SqlSite]":
    """Every statement-shaped SQL string in the module with its context.
    Cheap relative to the shared walk — the three per-module rules each
    call this on the handful of ``meta/`` files."""
    parents = module.parents()
    sites: list[_SqlSite] = []
    seen: set = set()
    for node in module.walk():
        if not isinstance(node, (ast.Constant, ast.JoinedStr)):
            continue
        if id(node) in seen:
            continue
        # implicit concatenation folds into one node; explicit `+` chains
        # are walked from their root so halves don't double-report
        parent = parents.get(node)
        if isinstance(parent, ast.JoinedStr) or (
            isinstance(parent, ast.BinOp) and isinstance(parent.op, ast.Add)
        ):
            continue
        text = _string_text(node)
        if text is None:
            continue
        head = text.lstrip().split(" ", 1)[0].upper() if text.strip() else ""
        if head.rstrip("(") not in _STMT_HEADS:
            continue
        stmt = parse_statement(text)
        if stmt is None:
            continue
        seen.add(id(node))
        call, in_txn, func, class_name = _context(node, parents)
        exec_kind = "none"
        conn_routed = False
        if call is not None:
            term = _terminal(call.func)
            if term == "_exec":
                exec_kind = "seam"
                has_conn_param = func is not None and any(
                    a.arg == "conn" for a in func.args.args
                )
                conn_routed = has_conn_param and bool(call.args) and (
                    isinstance(call.args[0], ast.Name)
                    and call.args[0].id == "conn"
                )
            elif term in ("execute", "executemany", "executescript"):
                exec_kind = "direct"
        line = call.lineno if call is not None else node.lineno
        sites.append(_SqlSite(
            stmt, line, node, call, exec_kind, in_txn, conn_routed,
            func, class_name,
        ))
    return sites


def _txn_ranges(project: Project) -> "dict[str, list[tuple[int, int]]]":
    """Per-module line ranges of transaction() / _txn Withs, built once and
    cached on the project — the read-modify-write sanction filter."""
    cached = project._isolation_index
    if cached is not None:
        return cached
    out: dict[str, list[tuple[int, int]]] = {}
    for module in project.modules:
        ranges = []
        for node in module.walk():
            if isinstance(node, ast.With) and _is_txn_with(node):
                end = getattr(node, "end_lineno", None) or node.lineno
                ranges.append((node.lineno, end))
        if ranges:
            out[module.relpath] = ranges
    project._isolation_index = out
    return out


def _in_scope(relpath: str, scope: tuple) -> bool:
    return any(s in relpath for s in scope)


def _consumes_rowcount(site: _SqlSite, module: Module) -> bool:
    """True when the execute call's result reaches a ``.rowcount`` read —
    directly (``...).rowcount``) or via the assigned name anywhere in the
    enclosing function."""
    call = site.call
    if call is None:
        return False
    parents = module.parents()
    parent = parents.get(call)
    if isinstance(parent, ast.Attribute) and parent.attr == "rowcount":
        return True
    target = None
    if (isinstance(parent, ast.Assign) and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        target = parent.targets[0].id
    elif isinstance(parent, ast.AnnAssign) and isinstance(parent.target, ast.Name):
        target = parent.target.id
    if target is None:
        return False
    root = site.func if site.func is not None else module.tree
    for node in ast.walk(root):
        if (isinstance(node, ast.Attribute) and node.attr == "rowcount"
                and isinstance(node.value, ast.Name)
                and node.value.id == target):
            return True
    return False


class CasGuardRule(Rule):
    id = "cas-guard"
    title = "coordination-table write without a compare-and-set guard"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not _in_scope(module.relpath, self.scope):
            return
        for site in _module_sites(module):
            stmt = site.stmt
            if stmt.op not in ("update", "delete"):
                continue
            if stmt.table == "lease":
                if stmt.op == "delete":
                    yield Finding(
                        self.id, module.relpath, site.line,
                        "DELETE FROM lease — lease rows are tombstoned "
                        "(holder cleared), never deleted: deleting restarts "
                        "fencing tokens at 1 and a zombie ex-holder could "
                        "pass the commit guard with its stale token",
                    )
                    continue
                if ("lease_key" not in stmt.where_cols
                        or not (stmt.where_cols & _LEASE_CAS_COLS)):
                    yield Finding(
                        self.id, module.relpath, site.line,
                        "UPDATE lease without a CAS predicate — the WHERE "
                        "must re-check holder/token/expiry (not just "
                        "lease_key) so a racing takeover's commit makes "
                        "this update match zero rows under READ COMMITTED",
                    )
                    continue
                if not _consumes_rowcount(site, module):
                    yield Finding(
                        self.id, module.relpath, site.line,
                        "lease CAS result is never checked — read "
                        ".rowcount and treat 0 matched rows as 'lost the "
                        "race'; an unexamined CAS is a blind write with "
                        "extra steps",
                    )
                continue
            keys = _TABLE_KEYS.get(stmt.table or "")
            if keys is None:
                continue
            missing = keys - stmt.where_cols
            if missing:
                yield Finding(
                    self.id, module.relpath, site.line,
                    f"{stmt.op.upper()} {stmt.table} constrains "
                    f"{sorted(stmt.where_cols) or 'nothing'} but not "
                    f"{sorted(missing)} — version-chain rows are immutable "
                    "at coarser granularity; a write that spans versions "
                    "clobbers concurrent committers",
                )


# store reads whose results, flowing into a blind write, form an RMW race
_READ_METHODS = frozenset({
    "get_global_config", "get_desc_epoch", "get_lease",
    "get_latest_partition_info", "get_all_latest_partition_info",
    "get_partition_versions", "get_partition_info_at_version",
    "get_partition_descs", "get_partition_at_timestamp",
    "get_data_commit_info", "commit_state", "get_table_info_by_id",
    "get_table_info_by_name", "get_table_info_by_path",
    "list_uncommitted_commits",
})

# blind store writes: last-writer-wins on the whole value
_BLIND_WRITES = {
    "set_global_config": 1,
    "update_table_properties": 1,
    "update_table_schema": 1,
}

# every module is a potential entry: RMW flows start wherever store reads do
RMW_SCOPE = (".py",)


class ReadModifyWriteRule(Rule):
    id = "read-modify-write"
    title = "store read flows into a dependent blind store write"

    def __init__(self, scope: tuple = RMW_SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        from lakesoul_tpu_torch.analysis.dataflow import TaintAnalysis, TaintConfig

        def is_store_read(call: ast.Call, name: str) -> bool:
            return (isinstance(call.func, ast.Attribute)
                    and call.func.attr in _READ_METHODS)

        config = TaintConfig(
            source_self_attrs=frozenset(),
            sanitizer_prefixes=(),
            sink_methods=dict(_BLIND_WRITES),
            source_call_predicate=is_store_read,
            propagate_all_calls=True,
        )
        analysis = TaintAnalysis(project.callgraph(), config)
        ranges = _txn_ranges(project)
        seen: set = set()
        for hit in analysis.run(self.scope):
            if any(lo <= hit.line <= hi
                   for lo, hi in ranges.get(hit.relpath, ())):
                continue  # inside the transaction seam: unsplittable
            key = (hit.relpath, hit.line)
            if key in seen:
                continue
            seen.add(key)
            via = " -> ".join(hit.chain)
            yield Finding(
                self.id, hit.relpath, hit.line,
                f"value read from the store ({hit.source_desc}) flows into "
                f"blind write {hit.sink}(...) (via {via}) — under READ "
                "COMMITTED a peer's commit between read and write is "
                "silently overwritten; use a CAS helper "
                "(merge_table_properties / update_global_config / "
                "set_descs_verified) or do both inside one "
                "store.transaction() with a ROW_LOCK read",
            )


class TxnBoundaryRule(Rule):
    id = "txn-boundary"
    title = "store mutation outside the write-transaction seam"

    # the analysis package quotes SQL as data (rule messages, fixtures,
    # the replayer's statement model) — never executes it
    EXCLUDE = ("analysis/",)

    def __init__(self, scope: tuple = ("lakesoul_tpu_torch/",), seam: tuple = SEAM):
        self.scope = scope
        self.seam = seam

    def check(self, module: Module) -> Iterable[Finding]:
        if not _in_scope(module.relpath, self.scope):
            return
        if _in_scope(module.relpath, self.EXCLUDE):
            return
        in_seam = any(module.relpath.endswith(s) for s in self.seam)
        if not in_seam:
            # reach-around: transaction internals on a store receiver
            for node in module.walk():
                if not isinstance(node, ast.Call):
                    continue
                if not isinstance(node.func, ast.Attribute):
                    continue
                if node.func.attr not in ("_exec", "_txn", "_conn"):
                    continue
                receiver = (dotted_name(node.func.value) or "")
                if "store" not in receiver.rsplit(".", 1)[-1].lower():
                    continue
                yield Finding(
                    self.id, module.relpath, node.lineno,
                    f"store transaction internals reached around the named "
                    f"seam ({receiver}.{node.func.attr}) — callers use "
                    "store.transaction() or a CAS helper so subclass "
                    "overrides and txncheck instrumentation still apply",
                )
        for site in _module_sites(module):
            stmt = site.stmt
            if not stmt.is_write or stmt.table is None:
                continue
            if site.in_txn or site.conn_routed:
                continue
            yield Finding(
                self.id, module.relpath, site.line,
                f"{stmt.op.upper()} {stmt.table} executes outside any "
                "transaction context (autocommit) — multi-statement "
                "invariants straddle commit points under READ COMMITTED; "
                "wrap the statements in `with store.transaction() as "
                "conn:` or route through `self._exec(conn, ...)` from a "
                "helper that received the transaction's conn",
            )


_TIME_FUNCS = ("datetime(", "julianday(", "strftime(")


class SqliteIsmRule(Rule):
    id = "sqlite-ism"
    title = "sqlite-only SQL headed for the backend seam"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not _in_scope(module.relpath, self.scope):
            return
        for site in _module_sites(module):
            if site.class_name and site.class_name.startswith("Sqlite"):
                continue  # the sqlite backend speaks sqlite by definition
            reason = self._reason(site)
            if reason is not None:
                yield Finding(self.id, module.relpath, site.line, reason)

    @staticmethod
    def _reason(site: _SqlSite) -> "str | None":
        stmt = site.stmt
        low = stmt.text.lower()
        if stmt.or_replace:
            return ("INSERT OR REPLACE is sqlite-only and translate_sql "
                    "does not rewrite it — spell the upsert as ON CONFLICT "
                    "(...) DO UPDATE")
        for fn in _TIME_FUNCS:
            if fn in low:
                return (f"sqlite time function {fn}...) has no PG "
                        "equivalent — compute timestamps in Python "
                        "(now_millis()) and bind them as parameters")
        if "rowid" in low:
            return ("rowid is sqlite's implicit key and does not exist in "
                    "PG — name an explicit primary-key column")
        if "autoincrement" in low:
            return ("AUTOINCREMENT is sqlite-only — PG spells it "
                    "GENERATED ALWAYS AS IDENTITY; the shared schema must "
                    "avoid both (ids are assigned in Python)")
        if stmt.op == "pragma":
            return ("PRAGMA outside the sqlite backend class — backend "
                    "tuning belongs to SqliteMetadataStore; PG would "
                    "reject the statement")
        if site.exec_kind == "direct":
            if stmt.or_ignore:
                return ("INSERT OR IGNORE bound past translate_sql via a "
                        "raw execute — only self._exec() rewrites it to ON "
                        "CONFLICT DO NOTHING for the PG paramstyle")
            if stmt.qmark:
                return ("qmark placeholders executed directly — PG's "
                        "paramstyle is %s; route the statement through "
                        "self._exec() so translate_sql rebinds it")
        return None
