"""SQL execution over catalog scans (the port's copy of
``lakesoul_tpu/sql/executor.py``: ``CALL clean`` runs the compaction
cleaner, and ``CALL build_vector_index`` builds on the session's ``device``,
the card unless ``"cpu"`` is named).

Role parity with rust/lakesoul-datafusion's embedded engine: the WHERE tree
becomes the framework's portable Filter (predicate pushdown + bucket pruning
for free), projections push into the scan, aggregates/sorts run on Arrow
compute kernels.  INSERT/CREATE/DROP route through the ACID catalog paths."""

from __future__ import annotations

import time

import pyarrow as pa
import pyarrow.compute as pc

from lakesoul_tpu_torch.io.filters import Filter
from lakesoul_tpu_torch.obs import registry, span
from lakesoul_tpu_torch.sql import parser as ast
from lakesoul_tpu_torch.sql.parser import SqlError, parse


def _stage_observe(stage: str, started: float) -> None:
    """Per-stage executor latency: lakesoul_sql_stage_seconds{stage=...}."""
    registry().histogram("lakesoul_sql_stage_seconds", stage=stage).observe(
        time.perf_counter() - started
    )

# date-part function → Arrow kernel (parser.EXTRACT_PARTS mirrors the keys)
_DATE_PARTS = {
    "year": pc.year, "month": pc.month, "day": pc.day,
    "hour": pc.hour, "minute": pc.minute, "second": pc.second,
}

_TYPE_MAP = {
    "bigint": pa.int64(),
    "long": pa.int64(),
    "int": pa.int32(),
    "integer": pa.int32(),
    "smallint": pa.int16(),
    "tinyint": pa.int8(),
    "double": pa.float64(),
    "float": pa.float32(),
    "real": pa.float32(),
    "string": pa.string(),
    "varchar": pa.string(),
    "text": pa.string(),
    "bool": pa.bool_(),
    "boolean": pa.bool_(),
    "timestamp": pa.timestamp("us"),
    "date": pa.date32(),
    "binary": pa.binary(),
}


def _walk_case(case, on_value, on_bool) -> None:
    """THE place that knows which CASE parts are VALUE expressions and
    which are boolean trees: simple-form whens (``CASE x WHEN v``) hold
    value expressions and the operand is a value; searched-form whens are
    boolean conditions.  Every COLLECTING walker traverses CASE through
    this helper so the distinction cannot drift per-walker (three walkers
    got it independently wrong before it existed); the REBUILDING
    rewriters (_subst_aggs, _map_node_cols) encode the same form
    dispatch inline because they return new nodes."""
    if case.operand is not None:
        on_value(case.operand)
    for cond, val in case.whens:
        (on_value if case.operand is not None else on_bool)(cond)
        on_value(val)
    if case.default is not None:
        on_value(case.default)


def _expr_columns(expr) -> set[str]:
    """Columns a value expression references (does NOT descend into
    subqueries — those resolve against their own tables)."""
    if isinstance(expr, ast.Column):
        return {expr.name}
    if isinstance(expr, ast.Arith):
        return _expr_columns(expr.left) | _expr_columns(expr.right)
    if isinstance(expr, ast.Agg):
        return _expr_columns(expr.arg) if expr.arg is not None else set()
    if isinstance(expr, ast.Case):
        cols: set[str] = set()
        _walk_case(
            expr,
            lambda e: cols.update(_expr_columns(e)),
            lambda n: cols.update(_node_columns(n)),
        )
        return cols
    if isinstance(expr, ast.Func):
        cols = set()
        for a in expr.args:
            if a is not None:
                cols |= _expr_columns(a)
        return cols
    if isinstance(expr, ast.WindowFn):
        cols = set(expr.partition_by) | {c for c, _ in expr.order_by}
        cols |= _expr_columns(expr.fn)
        return cols
    return set()


def _node_columns(node) -> set[str]:
    """Columns a boolean tree references on the CURRENT table."""
    if isinstance(node, ast.Compare):
        if node.simple:
            return {node.col}
        return _expr_columns(node.left) | _expr_columns(node.right)
    if isinstance(node, (ast.InList, ast.IsNull, ast.Like, ast.Between)):
        return {node.col}
    if isinstance(node, ast.InSubquery):
        return {node.col}
    if isinstance(node, ast.Exists):
        return set()
    if isinstance(node, ast.BoolOp):
        cols = set()
        for a in node.args:
            cols |= _node_columns(a)
        return cols
    if isinstance(node, ast.NotOp):
        return _node_columns(node.arg)
    return set()


def _flatten_and(node) -> list:
    """AND tree → conjunct list (single node when not an AND)."""
    if isinstance(node, ast.BoolOp) and node.op == "and":
        out: list = []
        for a in node.args:
            out.extend(_flatten_and(a))
        return out
    return [node]


def _subquery_outer_candidates(node) -> set[str]:
    """Every column name referenced anywhere inside subqueries of a boolean
    tree OR value expression (any depth).  Correlated subqueries resolve
    some of these against the OUTER table, so scan projection must keep any
    that match the base schema — over-collection only retains a column the
    planner could have dropped, never changes results."""
    subs: list = []

    def walk(n):
        if isinstance(n, (ast.Exists, ast.InSubquery)):
            subs.append(n.select)
        elif isinstance(n, ast.Compare) and not n.simple:
            walk_expr(n.left)
            walk_expr(n.right)
        elif isinstance(n, ast.BoolOp):
            for a in n.args:
                walk(a)
        elif isinstance(n, ast.NotOp):
            walk(n.arg)

    def walk_expr(e):
        if isinstance(e, ast.ScalarSubquery):
            subs.append(e.select)
        elif isinstance(e, ast.Arith):
            walk_expr(e.left)
            walk_expr(e.right)
        elif isinstance(e, ast.Agg):
            if e.arg is not None:
                walk_expr(e.arg)
        elif isinstance(e, ast.Func):
            for a in e.args:
                if a is not None:
                    walk_expr(a)
        elif isinstance(e, ast.Case):
            _walk_case(e, walk_expr, walk)

    # accept either a boolean node or a bare value expression
    if isinstance(e := node, (ast.ScalarSubquery, ast.Arith, ast.Agg, ast.Func,
                              ast.Case, ast.Column)):
        walk_expr(e)
    else:
        walk(node)
    cols: set[str] = set()
    while subs:
        sel = subs.pop()
        if isinstance(sel, ast.SetOp):
            subs.extend([sel.left, sel.right])
            continue
        if sel.where is not None:
            cols |= _node_columns(sel.where)
            walk(sel.where)
    return cols


def _node_column_refs(node) -> list:
    """(qualifier, name) pairs a boolean tree references on the CURRENT
    table — like _node_columns but keeping qualifiers for scope resolution;
    does not descend into nested subqueries."""
    refs: list = []

    def expr_refs(e):
        if isinstance(e, ast.Column):
            refs.append((e.qual, e.name))
        elif isinstance(e, ast.Arith):
            expr_refs(e.left)
            expr_refs(e.right)
        elif isinstance(e, ast.Agg):
            if e.arg is not None:
                expr_refs(e.arg)
        elif isinstance(e, ast.Func):
            for a in e.args:
                if a is not None:
                    expr_refs(a)
        elif isinstance(e, ast.Case):
            _walk_case(e, expr_refs, walk)

    def walk(n):
        if isinstance(n, ast.Compare):
            if n.simple:
                refs.append((n.col_qual, n.col))
            else:
                expr_refs(n.left)
                expr_refs(n.right)
        elif isinstance(n, (ast.InList, ast.IsNull, ast.Like, ast.Between,
                            ast.InSubquery)):
            refs.append((n.col_qual, n.col))
        elif isinstance(n, ast.BoolOp):
            for a in n.args:
                walk(a)
        elif isinstance(n, ast.NotOp):
            walk(n.arg)

    walk(node)
    return refs


def _rewrite_outer_refs(node, resolve, prefix: str = "__o_", inner_renames=None):
    """Rename column references in a boolean tree for evaluation on the
    semi-joined frame: outer-resolved refs get the ``__o_`` prefix (the join
    renamed outer columns to avoid inner-name collisions), and inner refs in
    ``inner_renames`` map to their coalesced key column (pyarrow joins drop
    right-key columns; on matched rows the values are equal by the join)."""
    inner_renames = inner_renames or {}

    def map_col(qual, name):
        if resolve(qual, name) == "outer":
            return None, prefix + name
        return None, inner_renames.get(name, name)

    return _map_node_cols(node, map_col)


def _contains_agg(expr) -> bool:
    return any(True for _ in _walk_aggs(expr))


def _walk_aggs(expr):
    if isinstance(expr, ast.Agg):
        yield expr
        return
    if isinstance(expr, ast.Arith):
        yield from _walk_aggs(expr.left)
        yield from _walk_aggs(expr.right)
    elif isinstance(expr, ast.Case):
        found: list = []
        _walk_case(
            expr,
            lambda e: found.extend(_walk_aggs(e)),
            lambda n: found.extend(
                a for sub in _bool_exprs(n) for a in _walk_aggs(sub)
            ),
        )
        yield from found
    elif isinstance(expr, ast.Func):
        for a in expr.args:
            if a is not None:
                yield from _walk_aggs(a)


def _bool_exprs(node):
    """Value expressions embedded in a boolean tree (for agg collection)."""
    if isinstance(node, ast.Compare) and not node.simple:
        yield node.left
        yield node.right
    elif isinstance(node, ast.BoolOp):
        for a in node.args:
            yield from _bool_exprs(a)
    elif isinstance(node, ast.NotOp):
        yield from _bool_exprs(node.arg)


def _agg_key(a: ast.Agg) -> tuple:
    # repr of the arg AST: labels are too lossy (every CASE stringifies to
    # "case", which would merge distinct CASE aggregates)
    return (a.fn, a.distinct, repr(a.arg) if a.arg is not None else "*")


def _subst_aggs(expr, agg_col: dict):
    """Replace Agg nodes with Column references into the aggregated table."""
    if isinstance(expr, ast.Agg):
        return ast.Column(agg_col[_agg_key(expr)])
    if isinstance(expr, ast.Arith):
        return ast.Arith(
            expr.op, _subst_aggs(expr.left, agg_col), _subst_aggs(expr.right, agg_col)
        )
    if isinstance(expr, ast.Case):
        # conds carry aggregates too: searched CASE WHEN count(*) > 2 ...,
        # simple CASE sum(x) WHEN ... — substitute per the form
        subst_cond = (
            (lambda c: _subst_aggs(c, agg_col)) if expr.operand is not None
            else (lambda c: _subst_aggs_bool(c, agg_col))
        )
        return ast.Case(
            [(subst_cond(c), _subst_aggs(v, agg_col)) for c, v in expr.whens],
            _subst_aggs(expr.default, agg_col) if expr.default is not None else None,
            _subst_aggs(expr.operand, agg_col) if expr.operand is not None else None,
        )
    if isinstance(expr, ast.Func):
        return ast.Func(
            expr.name,
            [_subst_aggs(a, agg_col) if a is not None else None for a in expr.args],
        )
    return expr


def _subst_aggs_bool(node, agg_col: dict):
    if isinstance(node, ast.Compare) and not node.simple:
        return ast.Compare(
            node.op, "", None,
            left=_subst_aggs(node.left, agg_col),
            right=_subst_aggs(node.right, agg_col),
        )
    if isinstance(node, ast.BoolOp):
        return ast.BoolOp(node.op, [_subst_aggs_bool(a, agg_col) for a in node.args])
    if isinstance(node, ast.NotOp):
        return ast.NotOp(_subst_aggs_bool(node.arg, agg_col))
    return node


def _resolve_aliases_bool(node, alias_map: dict):
    """HAVING may reference select aliases (``HAVING n > 5``); rewrite those
    columns to the aliased expressions before aggregate collection."""

    def resolve_expr(expr):
        if isinstance(expr, ast.Column) and expr.name in alias_map:
            return alias_map[expr.name]
        if isinstance(expr, ast.Arith):
            return ast.Arith(expr.op, resolve_expr(expr.left), resolve_expr(expr.right))
        return expr

    if isinstance(node, ast.Compare):
        if node.simple and node.col in alias_map:
            return ast.Compare(
                node.op, "", None,
                left=alias_map[node.col], right=ast.Literal(node.value),
            )
        if not node.simple:
            return ast.Compare(
                node.op, "", None,
                left=resolve_expr(node.left), right=resolve_expr(node.right),
            )
        return node
    if isinstance(node, ast.BoolOp):
        return ast.BoolOp(node.op, [_resolve_aliases_bool(a, alias_map) for a in node.args])
    if isinstance(node, ast.NotOp):
        return ast.NotOp(_resolve_aliases_bool(node.arg, alias_map))
    return node


def _map_node_cols(node, map_col, map_sel=None):
    """Generic boolean-tree rewriter — the ONE walker behind join-key
    renames, semi-join outer-prefix rewrites, and subquery-descending
    correlation renames.  ``map_col(qual, name) -> (qual, name)`` rewrites
    every column reference (including inside Func/Case/Agg expressions);
    ``map_sel(select)`` transforms nested subquery Selects (identity when
    None — nested scopes resolve their own names)."""
    import copy as _copy

    sel = map_sel if map_sel is not None else (lambda s: s)

    def ren_expr(e):
        if isinstance(e, ast.Column):
            q, n = map_col(e.qual, e.name)
            return ast.Column(n, qual=q)
        if isinstance(e, ast.Arith):
            return ast.Arith(e.op, ren_expr(e.left), ren_expr(e.right))
        if isinstance(e, ast.Agg):
            if e.arg is None:
                return e
            return ast.Agg(e.fn, ren_expr(e.arg), e.alias, e.distinct)
        if isinstance(e, ast.Func):
            return ast.Func(
                e.name, [None if a is None else ren_expr(a) for a in e.args]
            )
        if isinstance(e, ast.Case):
            return ast.Case(
                # simple-CASE whens hold VALUE expressions, not bool trees
                [
                    ((walk(c) if e.operand is None else ren_expr(c)), ren_expr(v))
                    for c, v in e.whens
                ],
                None if e.default is None else ren_expr(e.default),
                None if e.operand is None else ren_expr(e.operand),
            )
        if isinstance(e, ast.ScalarSubquery):
            return ast.ScalarSubquery(sel(e.select))
        return e

    def walk(n):
        if isinstance(n, ast.Compare):
            if n.simple:
                q, name = map_col(n.col_qual, n.col)
                return ast.Compare(n.op, name, n.value, col_qual=q)
            return ast.Compare(
                n.op, "", None, left=ren_expr(n.left), right=ren_expr(n.right)
            )
        if isinstance(n, (ast.InList, ast.IsNull, ast.Like, ast.Between,
                          ast.InSubquery)):
            out = _copy.copy(n)
            out.col_qual, out.col = map_col(n.col_qual, n.col)
            if isinstance(out, ast.InSubquery):
                out.select = sel(out.select)
            return out
        if isinstance(n, ast.Exists):
            out = _copy.copy(n)
            out.select = sel(out.select)
            return out
        if isinstance(n, ast.BoolOp):
            return ast.BoolOp(n.op, [walk(a) for a in n.args])
        if isinstance(n, ast.NotOp):
            return ast.NotOp(walk(n.arg))
        return n

    return walk(node)


def _rename_node_cols(node, mapping: dict):
    """Rewrite column names in a boolean tree (join key renames)."""
    return _map_node_cols(
        node, lambda q, n: (q, mapping.get(n, n))
    )


def _select_rebinds(sel, qual: str) -> bool:
    """Does this (sub)query's own FROM/JOIN bind ``qual`` as a table name
    or alias?  If so, the qualifier is re-scoped inside it."""
    if sel.table == qual or sel.from_alias == qual:
        return True
    return any(j.table == qual or j.alias == qual for j in sel.joins)


def _unqualified(node):
    """Copy of an expression tree with every qualifier dropped — GROUP BY
    key matching is structural (``upper(t.s)`` groups by ``upper(s)``)."""
    import copy as _copy
    import dataclasses

    if not dataclasses.is_dataclass(node) or isinstance(node, ast.Token):
        return node
    out = _copy.copy(node)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.name in ("qual", "col_qual"):
            setattr(out, f.name, None)
        elif isinstance(v, list):
            setattr(out, f.name, [
                tuple(_unqualified(y) for y in x) if isinstance(x, tuple)
                else _unqualified(x)
                for x in v
            ])
        elif dataclasses.is_dataclass(v) and not isinstance(v, ast.Token):
            setattr(out, f.name, _unqualified(v))
    return out


def _norm_repr(node) -> str:
    return repr(_unqualified(node))


def _subst_group_keys(node, by_norm: dict):
    """Rebuild an expression/boolean tree replacing every subtree that is
    STRUCTURALLY one of the GROUP BY key expressions (qualifier-insensitive)
    with its synthesized key column — items AND HAVING both resolve
    ``upper(s)`` onto ``__grp_0`` after aggregation drops ``s``.  Nested
    sub-Selects keep their own scope untouched."""
    import copy as _copy
    import dataclasses

    if not dataclasses.is_dataclass(node) or isinstance(
        node, (ast.Token, ast.Select, ast.SetOp, ast.Literal, ast.Agg)
    ):
        return node
    key = _norm_repr(node)
    if key in by_norm:
        return ast.Column(by_norm[key])
    out = _copy.copy(node)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, list):
            setattr(out, f.name, [
                tuple(_subst_group_keys(y, by_norm) for y in x)
                if isinstance(x, tuple) else _subst_group_keys(x, by_norm)
                for x in v
            ])
        elif dataclasses.is_dataclass(v) and not isinstance(v, ast.Token):
            setattr(out, f.name, _subst_group_keys(v, by_norm))
    return out


def _rename_qualified_refs(node, qual: str, name: str, new: str,
                           _seen: set | None = None) -> None:
    """IN-PLACE: every reference written ``<qual>.<name>`` becomes the bare
    column ``new`` — items, WHERE/HAVING trees, later-join ON keys, and
    subqueries alike.  Used when a RIGHT/FULL join keeps BOTH same-named
    key columns and the right one survives under a suffix (the statement
    AST is parsed per-execution, so mutation is safe)."""
    import dataclasses

    seen = _seen if _seen is not None else set()
    if node is None or not dataclasses.is_dataclass(node) \
            or isinstance(node, ast.Token) or id(node) in seen:
        return
    if isinstance(node, ast.Select) and seen and _select_rebinds(node, qual):
        # a nested subquery whose OWN FROM/JOIN binds the same qualifier
        # re-scopes it: its inner references must stay untouched
        return
    seen.add(id(node))
    if isinstance(node, ast.Column):
        if node.qual == qual and node.name == name:
            node.name, node.qual = new, None
        return
    if getattr(node, "col_qual", None) == qual and getattr(node, "col", None) == name:
        node.col, node.col_qual = new, None
    if isinstance(node, ast.Join):
        # EITHER operand of a later ON may reference the renamed key (the
        # executor swap-binds by qualifier, so both sides are candidates)
        if node.left_qual == qual and node.left_on == name:
            node.left_on, node.left_qual = new, None
        if node.right_qual == qual and node.right_on == name:
            node.right_on, node.right_qual = new, None
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        for item in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(item, tuple):
                for sub in item:
                    _rename_qualified_refs(sub, qual, name, new, seen)
            else:
                _rename_qualified_refs(item, qual, name, new, seen)


def _slice_limit_offset(out: pa.Table, stmt) -> pa.Table:
    """Apply the statement's OFFSET/LIMIT tail (shared by every result
    path so the sites cannot drift)."""
    if stmt.offset or stmt.limit is not None:
        out = out.slice(stmt.offset or 0, stmt.limit)
    return out


def _broadcast(val, n: int):
    """Expression results may be scalars (column-free expressions); broadcast
    them to the table's row count.  The scalar's TYPE is preserved — on a
    zero-row table an untyped pa.array([]) would come out null-typed and
    break downstream kernels (coalesce, comparisons)."""
    if isinstance(val, pa.Scalar):
        return pa.chunked_array([pa.array([val.as_py()] * n, type=val.type)])
    if isinstance(val, pa.Array):
        return pa.chunked_array([val])
    return val


def _expr_label(expr) -> str:
    if isinstance(expr, ast.Column):
        return expr.name
    if isinstance(expr, ast.Literal):
        return str(expr.value)
    if isinstance(expr, ast.Arith):
        return f"{_expr_label(expr.left)}{expr.op}{_expr_label(expr.right)}"
    if isinstance(expr, ast.Agg):
        arg = _expr_label(expr.arg) if expr.arg is not None else "*"
        d = "distinct " if expr.distinct else ""
        return f"{expr.fn}({d}{arg})"
    if isinstance(expr, ast.Case):
        return "case"
    if isinstance(expr, ast.Func):
        return expr.name
    if isinstance(expr, ast.WindowFn):
        return _expr_label(expr.fn)
    return "expr"


def _pushable(node) -> bool:
    """Can this predicate push into the scan as a portable Filter?"""
    if isinstance(node, ast.Compare):
        return node.simple
    if isinstance(node, (ast.InList, ast.IsNull, ast.Between)):
        return True
    if isinstance(node, ast.BoolOp):
        return all(_pushable(a) for a in node.args)
    if isinstance(node, ast.NotOp):
        return _pushable(node.arg)
    return False  # LIKE, subqueries, general comparisons stay residual


def _split_where(node) -> tuple[list, list]:
    """Split a WHERE tree into pushdown-eligible conjuncts and residual
    conjuncts (evaluated post-scan with the general evaluator)."""
    conjuncts = (
        list(node.args) if isinstance(node, ast.BoolOp) and node.op == "and" else [node]
    )
    push = [c for c in conjuncts if _pushable(c)]
    resid = [c for c in conjuncts if not _pushable(c)]
    return push, resid


def _where_to_filter(node) -> Filter:
    if isinstance(node, ast.Compare):
        if not node.simple:
            raise SqlError("general comparison cannot push down")
        return Filter(op=node.op, col=node.col, value=node.value)
    if isinstance(node, ast.InList):
        return Filter(op="in", col=node.col, value=list(node.values))
    if isinstance(node, ast.Between):
        return Filter(
            op="and",
            args=(
                Filter(op="ge", col=node.col, value=node.low),
                Filter(op="le", col=node.col, value=node.high),
            ),
        )
    if isinstance(node, ast.IsNull):
        return Filter(op="not_null" if node.negated else "is_null", col=node.col)
    if isinstance(node, ast.BoolOp):
        args = tuple(_where_to_filter(a) for a in node.args)
        return Filter(op=node.op, args=args)
    if isinstance(node, ast.NotOp):
        return Filter(op="not", args=(_where_to_filter(node.arg),))
    raise SqlError(f"unsupported WHERE node {node!r}")


class SqlSession:
    """Execute SQL statements against a catalog; results are Arrow tables."""

    def __init__(self, catalog, namespace: str = "default", *, device=None):
        self.catalog = catalog
        self.namespace = namespace
        # where CALL build_vector_index trains and quantizes: None = the
        # CUDA card, as every entry point of the port ("cpu" asks for the CPU)
        self.device = device
        self._externals: dict[str, object] = {}

    # ----------------------------------------------------------- federation
    def register_external(self, name: str, source) -> None:
        """Register a READ-ONLY external table for federation — the role of
        the reference's ADBC federation in lakesoul-datafusion (SURVEY §2.5:
        querying a mysql catalog from the same SQL session).  ``source`` is
        an Arrow table, a data-file path (any format the registry reads —
        parquet/LSF/IPC — on any fsspec store), or a zero-arg callable
        returning an Arrow table (e.g. an ADBC/DB-API fetch).  External
        names shadow catalog tables inside THIS session and join/subquery
        freely against lakehouse tables; DML against them is rejected."""
        self._externals[name] = source

    def _prefetch_join_scans(self, stmt: "ast.Select") -> dict:
        """Start scanning plain-table join right sides on the runtime pool
        (overlapping the base-table scan).  Derived/external right sides
        stay lazy — they may recurse into this executor.  Returns
        {join_index: Future}; errors surface where the serial code would
        have raised (the join's ``.result()``)."""
        from lakesoul_tpu_torch.runtime import get_pool

        pool = get_pool()
        futs: dict = {}
        if pool.in_worker():  # nested query on a pool thread: stay serial
            return futs
        for ji, j in enumerate(stmt.joins):
            if j.subquery is not None or self._external_table(j.table) is not None:
                continue

            def scan_one(name=j.table):
                return self.catalog.table(name, self.namespace).to_arrow()

            futs[ji] = pool.submit(scan_one)
        return futs

    def _external_table(self, name: str) -> "pa.Table | None":
        source = self._externals.get(name)
        if source is None:
            return None
        memo = getattr(self, "_ext_memo", None)
        if memo is None:
            memo = {}  # outside a statement: discarded temporary
        if name in memo:
            return memo[name]
        if isinstance(source, pa.Table):
            out = source
        elif callable(source):
            out = source()
            if not isinstance(out, pa.Table):
                raise SqlError(
                    f"external source {name!r} returned {type(out).__name__},"
                    " expected pyarrow.Table"
                )
        else:
            from lakesoul_tpu_torch.io.formats import format_for

            out = format_for(str(source)).read_table(str(source))
        # one fetch per STATEMENT: a query referencing the external several
        # times (join + subquery) sees one consistent snapshot; outside a
        # statement the memo is a discarded temporary (nothing stays pinned)
        memo[name] = out
        return out

    def execute(self, sql: str) -> pa.Table:
        started = time.perf_counter()
        stmt = parse(sql)
        _stage_observe("parse", started)
        target = getattr(stmt, "table", None)
        if target in self._externals and isinstance(
            stmt,
            (ast.Insert, ast.Update, ast.Delete, ast.DropTable,
             ast.AlterAddColumn, ast.AlterSetProperties),
        ):
            raise SqlError(f"external table {target!r} is read-only")
        self._ext_memo: dict[str, pa.Table] = {}
        started = time.perf_counter()
        try:
            # the statement span carries any client-propagated trace id down
            # into io/meta spans opened underneath
            with span("sql.execute", statement=type(stmt).__name__):
                return self._execute_stmt(stmt)
        finally:
            _stage_observe("execute", started)
            # a fetched external snapshot must not stay pinned past the
            # statement on a long-lived session
            self._ext_memo = None

    def _execute_stmt(self, stmt) -> pa.Table:
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt.stmt)
        if isinstance(stmt, ast.Select):
            return self._select(stmt)
        if isinstance(stmt, ast.SetOp):
            return self._set_op(stmt)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._create(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._drop(stmt)
        if isinstance(stmt, ast.ShowTables):
            return pa.table({"table_name": sorted(self.catalog.list_tables(self.namespace))})
        if isinstance(stmt, ast.AlterAddColumn):
            if stmt.type_name not in _TYPE_MAP:
                raise SqlError(f"unknown type {stmt.type_name!r}")
            self.catalog.table(stmt.table, self.namespace).add_columns(
                pa.field(stmt.column, _TYPE_MAP[stmt.type_name])
            )
            return pa.table({"status": ["ok"]})
        if isinstance(stmt, ast.AlterSetProperties):
            self.catalog.table(stmt.table, self.namespace).set_properties(
                stmt.properties
            )
            return pa.table({"status": ["ok"]})
        if isinstance(stmt, ast.Call):
            return self._call(stmt)
        if isinstance(stmt, ast.Update):
            flt, mask_fn = self._dml_predicate(stmt.where)
            literals: dict = {}
            exprs: dict = {}
            for col, val in stmt.assignments.items():
                if isinstance(val, ast.Literal):
                    literals[col] = val.value
                else:
                    # evaluated over the MATCHED rows at rewrite time
                    exprs[col] = (
                        lambda tbl, e=val: _broadcast(
                            self._eval_expr(e, tbl), len(tbl)
                        )
                    )
            try:
                # arm the per-statement subquery memo UP FRONT: SET-expression
                # subqueries must see the pre-statement snapshot even when the
                # WHERE is pushdown-expressible (mask_fn is None then and
                # would never arm it)
                self._stmt_query_memo = {}
                n = self.catalog.table(stmt.table, self.namespace).update_where(
                    flt, literals, mask_fn=mask_fn, expr_assignments=exprs
                )
            finally:
                self._stmt_query_memo = None
            return pa.table({"updated": pa.array([n], pa.int64())})
        if isinstance(stmt, ast.Delete):
            flt, mask_fn = self._dml_predicate(stmt.where)
            try:
                self._stmt_query_memo = {}
                n = self.catalog.table(stmt.table, self.namespace).delete_where(
                    flt, mask_fn=mask_fn
                )
            finally:
                self._stmt_query_memo = None
            return pa.table({"deleted": pa.array([n], pa.int64())})
        if isinstance(stmt, ast.Describe):
            t = self.catalog.table(stmt.table, self.namespace)
            return pa.table(
                {
                    "column": [f.name for f in t.schema],
                    "type": [str(f.type) for f in t.schema],
                    "primary_key": [f.name in t.primary_keys for f in t.schema],
                }
            )
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    @staticmethod
    def _apply_fn(name: str, fn, *args):
        """Apply an Arrow kernel for a SQL function, surfacing type
        mismatches as SqlError (never a raw Arrow traceback)."""
        try:
            return fn(*args)
        except (pa.lib.ArrowNotImplementedError, pa.lib.ArrowInvalid) as e:
            raise SqlError(f"{name}(): {e}")

    def _dml_predicate(self, where):
        """UPDATE/DELETE WHERE → (pushdown Filter, mask_fn).

        Fully pushdown-expressible predicates keep the Filter fast path
        (partition pruning + vectorized match, no general evaluator).
        Otherwise the GENERAL predicate — functions, CASE, subqueries —
        evaluates through the full boolean evaluator per partition, while
        any pushable AND-conjuncts still ride along as a Filter so
        partition pruning survives mixed predicates.  Uncorrelated
        subqueries are memoized for the STATEMENT, so every partition sees
        the same pre-statement snapshot of any table the subquery reads
        (partition 1's committed rewrite must not change partition 2's
        predicate)."""
        import numpy as np

        try:
            return _where_to_filter(where), None
        except SqlError:
            pass
        push_nodes, _residual = _split_where(where)
        flt = None
        if push_nodes:
            flt = _where_to_filter(push_nodes[0])
            for n in push_nodes[1:]:
                flt = flt & _where_to_filter(n)

        def mask_fn(table: pa.Table):
            # arm the statement-scoped subquery memo (cleared by the
            # Update/Delete branch once the whole statement commits)
            if getattr(self, "_stmt_query_memo", None) is None:
                self._stmt_query_memo = {}
            mask = pc.fill_null(
                _broadcast(self._eval_bool(where, table), len(table)), False
            )
            if isinstance(mask, pa.ChunkedArray):
                mask = mask.combine_chunks()
            return np.asarray(mask.to_numpy(zero_copy_only=False), dtype=bool)

        return flt, mask_fn

    _CALL_ARITY = {"compact": 1, "rollback": 2, "build_vector_index": 2, "clean": 0}

    def _call(self, stmt) -> pa.Table:
        """Maintenance procedures (reference: Spark CALL commands)."""
        args = list(stmt.args)
        want = self._CALL_ARITY.get(stmt.procedure)
        if want is not None and len(args) != want:
            raise SqlError(
                f"CALL {stmt.procedure} expects {want} argument(s), got {len(args)}"
            )
        if stmt.procedure == "compact":
            n = self.catalog.table(str(args[0]), self.namespace).compact()
            return pa.table({"compacted_partitions": pa.array([n], pa.int64())})
        if stmt.procedure == "rollback":
            t = self.catalog.table(str(args[0]), self.namespace)
            n = t.rollback(to_version=int(args[1]))
            return pa.table({"rolled_back_partitions": pa.array([n], pa.int64())})
        if stmt.procedure == "build_vector_index":
            t = self.catalog.table(str(args[0]), self.namespace)
            n = t.build_vector_index(str(args[1]), device=self.device)
            return pa.table({"indexed_vectors": pa.array([n], pa.int64())})
        if stmt.procedure == "clean":
            from lakesoul_tpu_torch.compaction import Cleaner

            result = Cleaner(self.catalog).clean_all()
            return pa.table({k: pa.array([v], pa.int64()) for k, v in result.items()})
        raise SqlError(f"unknown procedure {stmt.procedure!r}")

    # ------------------------------------------------------------------- DQL
    def _query(self, stmt) -> pa.Table:
        """Select or set-op subtree (derived tables / CTE bodies).

        During a general-predicate DML statement, results are memoized per
        AST node (the statement is parsed once, so each subquery node is
        stable): every partition's mask evaluation then reads the SAME
        pre-statement snapshot instead of re-scanning tables this very
        statement may already have rewritten."""
        memo = getattr(self, "_stmt_query_memo", None)
        if memo is not None and id(stmt) in memo:
            return memo[id(stmt)]
        if isinstance(stmt, ast.SetOp):
            out = self._set_op(stmt)
        else:
            out = self._select(stmt)
        if memo is not None:
            memo[id(stmt)] = out
        return out

    def _set_op(self, stmt: ast.SetOp) -> pa.Table:
        """UNION [ALL] / INTERSECT / EXCEPT with SQL set semantics (distinct
        rows unless ALL; NULLs compare equal for dedup, like DISTINCT)."""
        left = self._query(stmt.left)
        right = self._query(stmt.right)
        if left.num_columns != right.num_columns:
            raise SqlError(
                f"set operation arity mismatch: {left.num_columns} vs "
                f"{right.num_columns} columns"
            )
        right = right.rename_columns(left.column_names)
        if stmt.op == "union":
            # permissive: unify types across branches (int + double → double)
            out = pa.concat_tables([left, right], promote_options="permissive")
            if not stmt.all:
                # same dedup the SELECT DISTINCT path uses (NULLs group equal)
                out = out.group_by(out.column_names).aggregate([])
        else:
            import pandas as pd

            lf = left.to_pandas()
            rf = right.to_pandas()
            if stmt.op == "intersect":
                merged = lf.drop_duplicates().merge(rf.drop_duplicates(), how="inner")
            else:  # except
                probe = lf.drop_duplicates().merge(
                    rf.drop_duplicates(), how="left", indicator=True
                )
                merged = probe[probe["_merge"] == "left_only"].drop(columns="_merge")
            out = pa.Table.from_pandas(merged, preserve_index=False)
            # pandas may widen types (e.g. int64 → float64 when NaNs appear)
            try:
                out = out.cast(left.schema)
            except (pa.lib.ArrowInvalid, pa.lib.ArrowNotImplementedError):
                pass
        if stmt.order_by:
            out = out.sort_by(
                [(c, "descending" if d else "ascending") for c, d in stmt.order_by]
            )
        return _slice_limit_offset(out, stmt)

    def _base_scan(self, stmt: ast.Select):
        """Scan of the FROM table, positioned at AS OF when time-traveling."""
        scan = self.catalog.table(stmt.table, self.namespace).scan()
        if stmt.as_of_ms is not None:
            scan = scan.snapshot_at(stmt.as_of_ms)
        return scan

    def _plan_base(self, stmt: ast.Select, has_aggs: bool):
        """Base-table scan with every pushdown decision applied — filter
        split, projection, early-stop LIMIT.  Shared by execution and
        EXPLAIN so the plan shown IS the plan run.  → (scan, residual)."""
        base_schema = set(
            self.catalog.table(stmt.table, self.namespace).schema.names
        )
        scan = self._base_scan(stmt)
        residual_nodes: list = []
        push_nodes: list = []
        if stmt.where is not None:
            push_nodes, residual_nodes = _split_where(stmt.where)
            if any(j.kind in ("right", "full") for j in stmt.joins):
                # RIGHT/FULL OUTER preserve unmatched rows from the other
                # side, whose base columns surface as NULL: a base-table
                # predicate does NOT commute below the join (it would drop
                # the NULL-extended rows' match partners) — everything
                # evaluates post-join
                residual_nodes = residual_nodes + push_nodes
                push_nodes = []
            elif stmt.joins:
                # only base-table conjuncts may push below the join
                spill = [
                    n for n in push_nodes if not _node_columns(n) <= base_schema
                ]
                push_nodes = [n for n in push_nodes if _node_columns(n) <= base_schema]
                residual_nodes = residual_nodes + spill
        if push_nodes:
            flt = _where_to_filter(push_nodes[0])
            for n in push_nodes[1:]:
                flt = flt & _where_to_filter(n)
            scan = scan.filter(flt)
        if not stmt.joins and not stmt.star:
            needed = self._needed_columns(stmt, residual_nodes)
            refs = sorted(needed & base_schema)
            if refs:
                scan = scan.select(refs)
            # no refs → full scan keeps the row count for literal selects
        if (
            stmt.limit is not None
            and not stmt.joins
            and not residual_nodes
            and not stmt.order_by
            and not has_aggs
            and not stmt.distinct
        ):
            # LIMIT without ORDER BY returns arbitrary rows, so the scan
            # can stop early (unread units are skipped entirely); with an
            # OFFSET the prefix rows must still be delivered for the slice
            scan = scan.limit(stmt.limit + (stmt.offset or 0))
        return scan, residual_nodes

    def _explain(self, stmt) -> pa.Table:
        """EXPLAIN: the plan as text lines, nothing executed.  For base-table
        selects the scan line comes from the SAME _plan_base/scan.explain
        decisions execution uses; other statements get a structural sketch."""
        import json as _json

        lines: list[str] = []

        def describe(s, indent=""):
            if isinstance(s, ast.SetOp):
                lines.append(f"{indent}SetOp: {s.op}{' all' if s.all else ''}")
                describe(s.left, indent + "  ")
                describe(s.right, indent + "  ")
                if s.order_by or s.limit is not None or s.offset:
                    tail_bits = []
                    if s.order_by:
                        tail_bits.append(f"order_by={s.order_by}")
                    if s.limit is not None:
                        tail_bits.append(f"limit={s.limit}")
                    if s.offset:
                        tail_bits.append(f"offset={s.offset}")
                    lines.append(f"{indent}  " + " ".join(tail_bits))
                return
            if not isinstance(s, ast.Select):
                lines.append(f"{indent}{type(s).__name__}")
                return
            if s.from_subquery is not None:
                lines.append(f"{indent}DerivedTable{f' {s.from_alias}' if s.from_alias else ''}:")
                describe(s.from_subquery, indent + "  ")
                if s.where is not None:
                    # derived tables take no pushdown: the whole WHERE is a
                    # post-materialization filter (same as _select)
                    lines.append(f"{indent}Filter (post-materialization): WHERE clause")
                has_aggs = bool(s.group_by) or s.having is not None or any(
                    _contains_agg(it.expr) for it in s.items
                )
            elif s.table in self._externals:
                lines.append(
                    f"{indent}ExternalScan: {s.table} (federated source; no"
                    " pushdown — whole WHERE filters post-materialization)"
                )
                has_aggs = bool(s.group_by) or s.having is not None or any(
                    _contains_agg(it.expr) for it in s.items
                )
            elif not s.table:
                lines.append(f"{indent}OneRow: FROM-less SELECT")
                return
            elif self._count_shortcut_applies(s):
                lines.append(
                    f"{indent}MetadataCount: table={s.table} — row count from"
                    " file metadata, no data files read"
                )
                return
            else:
                has_aggs = bool(s.group_by) or s.having is not None or any(
                    _contains_agg(it.expr) for it in s.items
                )
                scan, residual = self._plan_base(s, has_aggs)
                d = scan.explain()
                lines.append(
                    f"{indent}Scan: table={d['table']}"
                    + (f" columns={d['columns']}" if d["columns"] is not None else " columns=*")
                    + (f" snapshot_ts={d['snapshot_ts']}" if d["snapshot_ts"] else "")
                )
                if d["filter"] is not None:
                    lines.append(f"{indent}  pushdown: {_json.dumps(d['filter'])}")
                if d.get("zone_predicates"):
                    lines.append(
                        f"{indent}  zone-map conjuncts: {len(d['zone_predicates'])}"
                    )
                if d["partitions"]:
                    lines.append(f"{indent}  partition filter: {d['partitions']}")
                lines.append(
                    f"{indent}  units={d['units']} (merge-on-read {d['merge_units']},"
                    f" unit-pruned {d['units_pruned']} of"
                    f" {d['units_before_bucket_prune']}) files={d['files']}"
                    + (f" bytes={d['bytes_known']}" if d["bytes_known"] else "")
                    + (f" formats={d['file_formats']}" if d["file_formats"] else "")
                )
                if d["limit"] is not None:
                    lines.append(f"{indent}  early-stop limit: {d['limit']}")
                if residual:
                    lines.append(f"{indent}Residual filter: {len(residual)} predicate(s) post-scan")
            for j in s.joins:
                target = j.alias or j.table or "(subquery)"
                lines.append(f"{indent}Join: {j.kind} {target} ON {j.left_on} = {j.right_on}")
                if j.subquery is not None:
                    describe(j.subquery, indent + "  ")
            if has_aggs:
                n_sets = len(s.grouping_sets) if s.grouping_sets is not None else 1
                lines.append(
                    f"{indent}Aggregate: group_by={s.group_by} sets={n_sets}"
                    + (" having" if s.having is not None else "")
                )
            if s.distinct:
                lines.append(f"{indent}Distinct")
            if s.order_by:
                lines.append(f"{indent}Sort: {s.order_by}")
            if s.limit is not None or s.offset:
                bits = []
                if s.limit is not None:
                    bits.append(f"Limit: {s.limit}")
                if s.offset:
                    bits.append(f"offset={s.offset}" if bits else f"Offset: {s.offset}")
                lines.append(f"{indent}" + " ".join(bits))

        describe(stmt)
        return pa.table({"plan": lines})

    def _count_shortcut_applies(self, stmt: ast.Select) -> bool:
        """Bare ``SELECT count(*) FROM t``: metadata-only count, no decode
        (reference: EmptyScanCountExec shortcut).  Shared with EXPLAIN so the
        plan shown is the plan run."""
        return (
            stmt.table not in self._externals
            and len(stmt.items) == 1
            and isinstance(stmt.items[0].expr, ast.Agg)
            and stmt.items[0].expr.fn == "count"
            and stmt.items[0].expr.arg is None
            and stmt.where is None
            and not stmt.joins
            and not stmt.group_by
            and stmt.having is None
            and stmt.from_subquery is None
            and not stmt.distinct
            and not stmt.star
            and (stmt.limit is None or stmt.limit >= 1)  # LIMIT 0 drops the row
            and not stmt.offset  # OFFSET 1+ drops the single result row
        )

    def _select(self, stmt: ast.Select) -> pa.Table:
        if not stmt.table and stmt.from_subquery is None and not stmt.joins:
            # FROM-less SELECT: evaluate items over one anonymous row
            one = pa.table({"__r__": pa.array([0])})
            if stmt.where is not None:
                mask = self._eval_bool(stmt.where, one)
                one = one.filter(pc.fill_null(_broadcast(mask, 1), False))
            out, hidden = self._project(stmt, one)
            if hidden:
                out = out.drop_columns(hidden)
            return _slice_limit_offset(out, stmt)
        if self._count_shortcut_applies(stmt):
            n = self._base_scan(stmt).count_rows()
            label = stmt.items[0].alias or "count(*)"
            return pa.table({label: pa.array([n], type=pa.int64())})

        has_aggs = bool(stmt.group_by) or stmt.having is not None or any(
            _contains_agg(it.expr) for it in stmt.items
        )

        # ---- source: scan with pushdown, or a derived table
        residual_nodes: list = []
        key_renames: dict[str, str] = {}
        join_tables: dict = {}
        if stmt.from_subquery is not None:
            if stmt.as_of_ms is not None:
                raise SqlError("AS OF time travel requires a base table")
            table = self._query(stmt.from_subquery)
            if stmt.where is not None:
                residual_nodes = [stmt.where]
        elif (ext := self._external_table(stmt.table)) is not None:
            if stmt.as_of_ms is not None:
                raise SqlError("AS OF time travel requires a lakehouse table")
            table = ext
            if stmt.where is not None:
                residual_nodes = [stmt.where]
        else:
            started = time.perf_counter()
            scan, residual_nodes = self._plan_base(stmt, has_aggs)
            _stage_observe("plan", started)
            started = time.perf_counter()
            # parallel scan stage on the shared runtime: join right-side
            # base tables start scanning on the pool WHILE the base table
            # scans here (each scan's own units also fan out on the pool).
            # Every future resolves HERE — a failure anywhere cancels the
            # rest, so no background scan outlives a failed statement
            join_futs = self._prefetch_join_scans(stmt)
            try:
                table = scan.to_arrow()  # MOR timings land in lakesoul_io_*
                join_tables = {ji: f.result() for ji, f in sorted(join_futs.items())}
            except BaseException:
                import concurrent.futures

                for f in join_futs.values():
                    f.cancel()
                # cancel() can't stop an already-RUNNING scan: wait it out
                # (bounded by that scan's own duration) so no background
                # scan outlives the failed statement and races a retry or
                # a DROP TABLE issued right after
                concurrent.futures.wait(list(join_futs.values()))
                raise
            _stage_observe("scan", started)

        emit_started = time.perf_counter()
        # ---- joins (hash joins on Arrow compute; right side may be derived)
        for ji, j in enumerate(stmt.joins):
            if j.subquery is not None:
                right = self._query(j.subquery)
            elif (jext := self._external_table(j.table)) is not None:
                right = jext
            elif (pre := join_tables.get(ji)) is not None:
                right = pre
            else:
                right = self.catalog.table(j.table, self.namespace).to_arrow()
            rname = j.alias or j.table
            join_type = {
                "inner": "inner",
                "left": "left outer",
                "right": "right outer",
                "full": "full outer",
            }[j.kind]
            left_key, right_key = j.left_on, j.right_on
            # bind keys by their written qualifier (ON b.x = a.y works in
            # either order); bare names fall back to column membership
            if (j.left_qual is not None and j.left_qual in (j.table, j.alias)) or (
                j.left_qual is None
                and left_key not in table.column_names
                and left_key in right.column_names
            ):
                left_key, right_key = right_key, left_key
            if j.kind in ("right", "full"):
                # ON semantics under outer extension: keep BOTH key columns
                # (pyarrow's default key coalescing would make the
                # NULL-extended side's key read the other side's value,
                # silently breaking `a.k IS NULL` anti-joins)
                clashes = set(table.column_names) & set(right.column_names)
                suffix = f"_{rname}" if clashes else None
                table = table.join(
                    right, keys=left_key, right_keys=right_key,
                    join_type=join_type, right_suffix=suffix,
                    coalesce_keys=False,
                )
                if left_key == right_key and suffix:
                    # the right key survives suffixed: qualified references
                    # to it resolve there (bare ones stay on the left key)
                    new = right_key + suffix
                    _rename_qualified_refs(stmt, rname, right_key, new)
                    for n2 in residual_nodes:
                        _rename_qualified_refs(n2, rname, right_key, new)
                    # ORDER BY / GROUP BY store bare names; their recorded
                    # qualifiers rebind `b.k` onto the suffixed right key
                    # (silently sorting the NULL-extended left key instead
                    # would return wrong orderings)
                    oq = stmt.order_by_quals
                    stmt.order_by = [
                        (new, d)
                        if i < len(oq) and oq[i] == rname and c == right_key
                        else (c, d)
                        for i, (c, d) in enumerate(stmt.order_by)
                    ]
                    gq = stmt.group_by_quals
                    stmt.group_by = [
                        new
                        if i < len(gq) and gq[i] == rname and c == right_key
                        else c
                        for i, c in enumerate(stmt.group_by)
                    ]
                continue
            # non-key name collisions: suffix the right side (documented,
            # deterministic; a bare reference resolves to the left table)
            clashes = (set(table.column_names) & set(right.column_names)) - {right_key}
            suffix = f"_{rname}" if clashes else None
            table = table.join(
                right, keys=left_key, right_keys=right_key, join_type=join_type,
                right_suffix=suffix,
            )
            if right_key != left_key:
                # the right key column is dropped by the join; predicates
                # on it rewrite to the surviving left key
                key_renames[right_key] = left_key

        # ---- residual WHERE (general predicates, subqueries, post-join)
        if residual_nodes:
            node = (
                residual_nodes[0]
                if len(residual_nodes) == 1
                else ast.BoolOp("and", list(residual_nodes))
            )
            if key_renames:
                node = _rename_node_cols(node, key_renames)
                node = self._rename_correlated_outer_refs(node, key_renames)
            mask = self._eval_bool(node, table)
            table = table.filter(pc.fill_null(_broadcast(mask, len(table)), False))

        # ---- aggregate / project
        if has_aggs:
            out, hidden = self._aggregate(stmt, table)
        elif stmt.star:
            out, hidden = table, []
        else:
            out, hidden = self._project(stmt, table)

        # ---- DISTINCT (on the visible projection)
        if stmt.distinct:
            if hidden:
                out = out.drop_columns(hidden)
                hidden = []
            out = out.group_by(out.column_names).aggregate([])

        # ---- ORDER BY (one multi-key sort; hidden columns carry unprojected
        # sort keys) / LIMIT
        if stmt.order_by:
            keys = []
            for c, desc in stmt.order_by:
                name = c if c in out.column_names else f"__ord_{c}"
                if name not in out.column_names:
                    raise SqlError(f"ORDER BY column {c!r} not available")
                keys.append((name, "descending" if desc else "ascending"))
            out = out.sort_by(keys)
        if hidden:
            out = out.drop_columns(hidden)
        out = _slice_limit_offset(out, stmt)
        _stage_observe("emit", emit_started)
        return out

    def _needed_columns(self, stmt: ast.Select, residual_nodes: list) -> set[str]:
        cols: set[str] = set(stmt.group_by)
        for name, e in stmt.group_exprs:
            cols.discard(name)  # synthesized, not a base column
            cols |= _expr_columns(e)
        for it in stmt.items:
            cols |= _expr_columns(it.expr)
            cols |= _subquery_outer_candidates(it.expr)
        for c, _ in stmt.order_by:
            cols.add(c)
        if stmt.having is not None:
            cols |= _node_columns(stmt.having)
            cols |= _subquery_outer_candidates(stmt.having)
        for n in residual_nodes:
            cols |= _node_columns(n)
            cols |= _subquery_outer_candidates(n)  # correlation columns
        return cols

    def _project(self, stmt: ast.Select, table: pa.Table) -> tuple[pa.Table, list[str]]:
        """Evaluate non-aggregate select items; append hidden ``__ord_*``
        columns for ORDER BY keys that are not projected."""
        cols, labels = [], []
        for it in stmt.items:
            cols.append(_broadcast(self._eval_expr(it.expr, table), len(table)))
            labels.append(it.alias or _expr_label(it.expr))
        hidden: list[str] = []
        for c, _ in stmt.order_by:
            if c not in labels and c in table.column_names:
                h = f"__ord_{c}"
                cols.append(table.column(c))
                labels.append(h)
                hidden.append(h)
        return pa.table(cols, names=labels), hidden  # list form keeps dup labels

    _AGG_FN = {"count": "count", "sum": "sum", "min": "min", "max": "max", "avg": "mean"}

    def _aggregate(self, stmt: ast.Select, table: pa.Table) -> tuple[pa.Table, list[str]]:
        """GROUP BY / global aggregation with HAVING and expressions over
        aggregates (e.g. ``100 * sum(a) / sum(b)``)."""
        # GROUP BY <expr>: materialize each synthesized key column over the
        # pre-aggregation table, then rewrite every STRUCTURAL occurrence of
        # a key expression (qualifier-insensitive, as a subexpression) in
        # the select items and HAVING onto the key column — after
        # aggregation the base columns are gone
        if stmt.group_exprs:
            by_norm = {}
            for name, e in stmt.group_exprs:
                table = table.append_column(
                    name, _broadcast(self._eval_expr(e, table), len(table))
                )
                by_norm[_norm_repr(e)] = name
            new_items = []
            for it in stmt.items:
                sub = _subst_group_keys(it.expr, by_norm)
                alias = it.alias
                if sub is not it.expr and alias is None:
                    alias = _expr_label(it.expr)
                new_items.append(ast.SelectItem(sub, alias))
            stmt.items = new_items
            if stmt.having is not None:
                stmt.having = _subst_group_keys(stmt.having, by_norm)
        # alias resolution for HAVING/expressions: alias → item expression
        alias_map = {it.alias: it.expr for it in stmt.items if it.alias}

        # collect every distinct aggregate across select items + HAVING
        agg_nodes: dict[tuple, ast.Agg] = {}

        def collect(expr):
            for a in _walk_aggs(expr):
                agg_nodes.setdefault(_agg_key(a), a)

        for it in stmt.items:
            collect(it.expr)
        having = stmt.having
        if having is not None:
            having = _resolve_aliases_bool(having, alias_map)
            for sub in _bool_exprs(having):
                collect(sub)

        # materialize expression arguments, build one spec per distinct agg
        work = table
        specs: list = []
        agg_col: dict[tuple, str] = {}
        for i, (key, agg) in enumerate(agg_nodes.items()):
            if agg.arg is None:
                specs.append(([], "count_all"))
                agg_col[key] = "count_all"
                continue
            if isinstance(agg.arg, ast.Column):
                target = agg.arg.name
            else:
                target = f"__agg_in_{i}"
                arr = _broadcast(self._eval_expr(agg.arg, work), len(work))
                work = work.append_column(target, arr)
            if agg.distinct and agg.fn != "count":
                raise SqlError(
                    f"DISTINCT is only supported for count, not {agg.fn}"
                )
            fn = "count_distinct" if agg.distinct else self._AGG_FN[agg.fn]
            specs.append((target, fn))
            agg_col[key] = f"{target}_{fn}"
        # dedup identical specs (repeated aggregates share one output column)
        call_specs, seen = [], set()
        for target, fn in specs:
            k = (tuple(target) if isinstance(target, list) else target, fn)
            if k not in seen:
                seen.add(k)
                call_specs.append((target, fn))

        # ROLLUP/CUBE/GROUPING SETS: aggregate once per set; grouping columns
        # absent from a set surface as NULL in its (subtotal) rows
        sets = (
            stmt.grouping_sets if stmt.grouping_sets is not None else [list(stmt.group_by)]
        )
        agg_names = [
            "count_all" if not target else f"{target}_{fn}" for target, fn in call_specs
        ]
        parts = []
        for s in sets:
            g = work.group_by(list(s)).aggregate(call_specs)
            for c in stmt.group_by:
                if c not in s:
                    g = g.append_column(c, pa.nulls(len(g), type=work.schema.field(c).type))
            parts.append(g.select(agg_names + list(stmt.group_by)))
        grouped = parts[0] if len(parts) == 1 else pa.concat_tables(parts)

        if having is not None:
            try:
                mask = self._eval_bool(_subst_aggs_bool(having, agg_col), grouped)
            except KeyError as e:
                raise SqlError(
                    f"HAVING references {e} which is neither grouped nor"
                    " inside an aggregate"
                )
            grouped = grouped.filter(pc.fill_null(_broadcast(mask, len(grouped)), False))

        # project select items over the aggregated table
        cols, labels = [], []
        for it in stmt.items:
            if isinstance(it.expr, ast.Column):
                if it.expr.name not in stmt.group_by:
                    raise SqlError(f"column {it.expr.name} must appear in GROUP BY")
                cols.append(grouped.column(it.expr.name))
                labels.append(it.alias or it.expr.name)
            else:
                expr = _subst_aggs(it.expr, agg_col)
                try:
                    cols.append(
                        _broadcast(self._eval_expr(expr, grouped), len(grouped))
                    )
                except KeyError as e:
                    # a non-grouped base column survived substitution: the
                    # aggregated frame no longer carries it
                    raise SqlError(
                        f"select expression references {e} which is neither"
                        " grouped (column or GROUP BY expression) nor inside"
                        " an aggregate"
                    )
                labels.append(it.alias or _expr_label(it.expr))
        out = pa.table(cols, names=labels)
        # unprojected ORDER BY keys that are group keys ride along hidden
        hidden: list[str] = []
        for c, _ in stmt.order_by:
            if c not in labels and c in grouped.column_names:
                h = f"__ord_{c}"
                out = out.append_column(h, grouped.column(c))
                hidden.append(h)
        return out, hidden

    # ------------------------------------------------------- expression eval
    # ---------------------------------------------- correlated subqueries
    #
    # Correlated EXISTS / IN / scalar-aggregate subqueries are decorrelated
    # mechanically — the classic transforms DataFusion
    # applies in the reference:
    #   EXISTS (… WHERE inner.k = outer.k AND p)   → hash semi-join on k
    #   col IN (SELECT c FROM … WHERE corr)        → EXISTS with c = col
    #   (SELECT agg(x) FROM … WHERE inner.k = outer.k AND p)
    #                                              → GROUP BY k + left join
    # Column references resolve QUALIFIER-FIRST (Column.qual survives
    # parsing): a qualifier naming the subquery's own table/alias is inner,
    # any other qualifier is outer; bare names resolve by scope membership,
    # innermost-first.  That covers aliased self-correlation too — Q21's
    # ``l2.l_suppkey <> l1.l_suppkey`` runs natively, the inner/outer sides
    # disambiguated by the l1/l2 aliases even though the names collide.

    def _projection_names(self, sel) -> set[str]:
        if isinstance(sel, ast.SetOp):
            return self._projection_names(sel.left)
        if sel.star:
            return self._scope_columns(sel)
        names: set[str] = set()
        for it in sel.items:
            if it.alias:
                names.add(it.alias)
            elif isinstance(it.expr, ast.Column):
                names.add(it.expr.name)
        return names

    def _table_schema_names(self, name: str) -> set[str]:
        ext = self._external_table(name)
        if ext is not None:
            return set(ext.schema.names)
        return set(self.catalog.table(name, self.namespace).schema.names)

    def _scope_columns(self, sel) -> set[str]:
        """Names visible inside a Select's FROM scope, without executing it."""
        cols: set[str] = set()
        if sel.from_subquery is not None:
            cols |= self._projection_names(sel.from_subquery)
        elif sel.table:
            cols |= self._table_schema_names(sel.table)
        for j in sel.joins:
            if j.subquery is not None:
                cols |= self._projection_names(j.subquery)
            elif j.table:
                cols |= self._table_schema_names(j.table)
        return cols

    @staticmethod
    def _inner_quals(sel) -> set[str]:
        quals = {sel.table, sel.from_alias}
        for j in sel.joins:
            quals.add(j.table)
            quals.add(j.alias)
        quals.discard(None)
        quals.discard("")
        return quals

    def _make_scope_resolver(self, sel, outer_cols: set[str]):
        """→ resolve(qual, name) ∈ {"inner", "outer"}.  Qualifiers win
        (``orders.orderkey`` is outer even when lineitem also has
        ``orderkey``); bare names resolve innermost-scope-first."""
        inner_cols = self._scope_columns(sel)
        inner_quals = self._inner_quals(sel)

        def resolve(qual, name):
            if qual == "__outer__":
                # marker left by _rename_correlated_outer_refs: this ref was
                # a join-key column the outer join coalesced away, already
                # rewritten to the surviving left-key name
                if name not in outer_cols:
                    raise SqlError(f"unknown outer column {name!r} in subquery")
                return "outer"
            if qual:
                if qual in inner_quals:
                    if name not in inner_cols:
                        raise SqlError(f"unknown column {qual}.{name} in subquery")
                    return "inner"
                if name not in outer_cols:
                    raise SqlError(
                        f"unknown column {qual}.{name} (outer scope has no {name!r})"
                    )
                return "outer"
            if name in inner_cols:
                return "inner"
            if name in outer_cols:
                return "outer"
            raise SqlError(f"unknown column {name!r} in subquery")

        return resolve

    def _split_correlated(self, sel, outer_cols: set[str]):
        """Classify a subquery's WHERE conjuncts against (inner, outer)
        scopes → (inner_only_node, eq_pairs [(outer_col, inner_col)],
        mixed_conjuncts, outer_only_conjuncts, resolve)."""
        if sel.where is None:
            return None, [], [], [], None
        resolve = self._make_scope_resolver(sel, outer_cols)
        inner, eq_pairs, mixed, outer_only = [], [], [], []
        for c in _flatten_and(sel.where):
            refs = _node_column_refs(c)
            if not refs:
                inner.append(c)
                continue
            scopes = {resolve(q, n) for q, n in refs}
            if scopes == {"inner"}:
                inner.append(c)
            elif scopes == {"outer"}:
                outer_only.append(c)
            else:
                pair = self._as_eq_pair(c, resolve)
                if pair is not None:
                    eq_pairs.append(pair)
                else:
                    mixed.append(c)
        node = (
            inner[0] if len(inner) == 1
            else (ast.BoolOp("and", inner) if inner else None)
        )
        return node, eq_pairs, mixed, outer_only, resolve

    @staticmethod
    def _as_eq_pair(c, resolve):
        if (
            isinstance(c, ast.Compare) and c.op == "eq" and not c.simple
            and isinstance(c.left, ast.Column) and isinstance(c.right, ast.Column)
        ):
            ls = resolve(c.left.qual, c.left.name)
            rs = resolve(c.right.qual, c.right.name)
            if ls == "inner" and rs == "outer":
                return (c.right.name, c.left.name)
            if rs == "inner" and ls == "outer":
                return (c.left.name, c.right.name)
        return None

    def _rename_correlated_outer_refs(self, node, mapping: dict):
        """Join-key renames must reach OUTER references inside subqueries:
        ``JOIN part ON l_partkey = partkey`` drops ``partkey`` from the
        outer frame, so a correlated ``l2.l_partkey = part.partkey`` must
        rewrite to the surviving ``l_partkey`` — marked with the reserved
        ``__outer__`` qualifier so scope resolution still reads it as outer
        even when the inner scope has a column of the same name."""
        from dataclasses import replace as _dc_replace

        def fix_sel(sel):
            if not isinstance(sel, ast.Select) or sel.where is None:
                return sel
            inner_cols = self._scope_columns(sel)
            inner_quals = self._inner_quals(sel)

            def map_col(qual, name):
                if qual and qual in inner_quals:
                    return qual, name
                if not qual and name in inner_cols:
                    return qual, name
                if name in mapping:
                    return "__outer__", mapping[name]
                return qual, name

            return _dc_replace(
                sel, where=_map_node_cols(sel.where, map_col, map_sel=fix_sel)
            )

        # top level: only descend into subqueries — top-level refs were
        # already renamed by _rename_node_cols
        return _map_node_cols(node, lambda q, n: (q, n), map_sel=fix_sel)

    def _decorrelated_inner(self, sel, inner_node, needed: set | None = None) -> pa.Table:
        from dataclasses import replace as _dc_replace

        if sel.group_by or sel.having is not None:
            raise SqlError(
                "correlated EXISTS/IN with GROUP BY is not supported"
            )
        if sel.limit is not None or sel.offset:
            # decorrelation evaluates the inner ONCE over all groups; a
            # per-outer-row LIMIT/OFFSET cannot be expressed there — reject
            # loudly rather than silently dropping it (wrong answers)
            raise SqlError(
                "correlated subqueries do not support LIMIT/OFFSET"
            )
        if needed:
            # project to the correlation keys + mixed-predicate columns:
            # EXISTS over a wide fact table must not materialize every column
            items = [ast.SelectItem(ast.Column(c)) for c in sorted(needed)]
            inner_sel = _dc_replace(
                sel, items=items, star=False, where=inner_node,
                order_by=[], limit=None, offset=None, distinct=True,
            )
        else:
            inner_sel = _dc_replace(
                sel, items=[], star=True, where=inner_node, order_by=[],
                limit=None, offset=None,
            )
        return self._query(inner_sel)

    def _semi_join_mask(self, outer, inner, eq_pairs, mixed, resolve):
        """Per-outer-row EXISTS mask: hash semi-join on the equality
        correlation keys, remaining mixed-reference conjuncts evaluated on
        the joined pairs.  Null keys never match (SQL semantics).  Outer
        columns are renamed ``__o_<name>`` on the joined frame so inner
        columns with the SAME name (self-correlation) stay unambiguous."""
        import numpy as np

        n = len(outer)
        idx = pa.array(np.arange(n, dtype=np.int64))
        keys_o = list(dict.fromkeys(p[0] for p in eq_pairs))
        keys_i = [p[1] for p in eq_pairs]
        if mixed:
            need = set(keys_o)
            for c in mixed:
                need |= {nm for q, nm in _node_column_refs(c)
                         if resolve(q, nm) == "outer"}
            osel = outer.select(sorted(need)).rename_columns(
                ["__o_" + c for c in sorted(need)]
            ).append_column("__cidx__", idx)
            if eq_pairs:
                joined = osel.join(
                    inner,
                    keys=["__o_" + p[0] for p in eq_pairs],
                    right_keys=keys_i,
                    join_type="inner",
                )
            else:
                one = pa.array(np.ones(len(osel), np.int8))
                joined = osel.append_column("__one__", one).join(
                    inner.append_column(
                        "__one__", pa.array(np.ones(len(inner), np.int8))
                    ),
                    keys="__one__",
                    join_type="inner",
                )
            # inner join-key columns are dropped (coalesced) by the join;
            # mixed refs to them read the surviving outer-side key instead
            inner_renames = {i: "__o_" + o for o, i in eq_pairs}
            rewritten = [
                _rewrite_outer_refs(c, resolve, inner_renames=inner_renames)
                for c in mixed
            ]
            node = (
                rewritten[0] if len(rewritten) == 1
                else ast.BoolOp("and", rewritten)
            )
            m = self._eval_bool(node, joined)
            joined = joined.filter(pc.fill_null(_broadcast(m, len(joined)), False))
            matched = joined.column("__cidx__")
        else:
            distinct = inner.select(keys_i).group_by(keys_i).aggregate([])
            joined = (
                outer.select(keys_o)
                .rename_columns(["__o_" + c for c in keys_o])
                .append_column("__cidx__", idx)
                .join(
                    distinct,
                    keys=["__o_" + p[0] for p in eq_pairs],
                    right_keys=keys_i,
                    join_type="inner",
                )
            )
            matched = joined.column("__cidx__")
        mask = np.zeros(n, dtype=bool)
        mi = matched.combine_chunks().to_numpy(zero_copy_only=False)
        mask[mi] = True
        return pa.array(mask)

    def _eval_exists(self, node, table):
        sel = node.select
        if isinstance(sel, ast.SetOp):
            exists = len(self._query(sel)) > 0
            return pa.scalar(exists != node.negated)
        inner_node, eq_pairs, mixed, outer_only, resolve = self._split_correlated(
            sel, set(table.column_names)
        )
        if not eq_pairs and not mixed and not outer_only:
            exists = len(self._query(sel)) > 0
            return pa.scalar(exists != node.negated)
        needed = {i for _, i in eq_pairs}
        for c in mixed:
            needed |= {nm for q, nm in _node_column_refs(c)
                       if resolve(q, nm) == "inner"}
        inner = self._decorrelated_inner(sel, inner_node, needed or None)
        if eq_pairs or mixed:
            mask = self._semi_join_mask(table, inner, eq_pairs, mixed, resolve)
        else:
            mask = pa.array([len(inner) > 0] * len(table))
        for c in outer_only:
            mask = pc.and_kleene(
                pc.fill_null(mask, False),
                pc.fill_null(_broadcast(self._eval_bool(c, table), len(table)), False),
            )
        return pc.invert(mask) if node.negated else mask

    def _eval_in_subquery(self, node, table):
        sel = node.select
        if isinstance(sel, ast.Select) and sel.where is not None:
            inner_node, eq_pairs, mixed, outer_only, resolve = self._split_correlated(
                sel, set(table.column_names)
            )
        else:
            inner_node, eq_pairs, mixed, outer_only, resolve = (
                None, [], [], [], None,
            )
        if not eq_pairs and not mixed and not outer_only:
            sub = self._query(sel)
            if sub.num_columns != 1:
                raise SqlError("IN (SELECT ...) must produce one column")
            values = sub.column(0).combine_chunks()
            col = table.column(node.col)
            mask = pc.fill_null(
                pc.is_in(col, value_set=values, skip_nulls=True), False
            )
            # SQL three-valued logic: an UNMATCHED probe is UNKNOWN (null),
            # not FALSE, when the probe is NULL or the set contains NULLs —
            # so `x NOT IN (... NULL ...)` filters the row instead of
            # keeping it (Kleene invert maps null → null)
            if len(values) and (col.null_count or values.null_count):
                unknown = pc.and_(
                    pc.invert(mask),
                    pc.or_(
                        pc.is_null(col), pa.scalar(bool(values.null_count))
                    ),
                )
                mask = pc.if_else(unknown, pa.scalar(None, pa.bool_()), mask)
            return pc.invert(mask) if node.negated else mask
        # correlated IN: col IN (SELECT c …) ≡ EXISTS(… AND c = col)
        if isinstance(sel, ast.SetOp) or sel.star or len(sel.items) != 1 \
                or not isinstance(sel.items[0].expr, ast.Column):
            raise SqlError(
                "correlated IN subquery must select a single plain column"
            )
        inner_item = sel.items[0].expr.name
        needed = {i for _, i in eq_pairs} | {inner_item}
        for c in mixed:
            needed |= {nm for q, nm in _node_column_refs(c)
                       if resolve(q, nm) == "inner"}
        inner = self._decorrelated_inner(sel, inner_node, needed)
        mask = self._semi_join_mask(
            table, inner, eq_pairs + [(node.col, inner_item)], mixed, resolve
        )
        # three-valued logic: unmatched is UNKNOWN (not FALSE) when the outer
        # value is NULL and the correlated group is non-empty, or the group
        # itself contains a NULL — `NOT IN` must filter such rows.  Joins
        # never match NULL keys, so `mask` alone would claim definite FALSE.
        outer_col = table.column(node.col)
        inner_vals = inner.column(inner_item)
        if outer_col.null_count or inner_vals.null_count:
            def _group_mask(group: pa.Table):
                if eq_pairs or mixed:
                    return self._semi_join_mask(
                        table, group, eq_pairs, mixed, resolve
                    )
                return pa.array([len(group) > 0] * len(table))

            unknown = None
            if inner_vals.null_count:
                unknown = _group_mask(inner.filter(pc.is_null(inner_vals)))
            if outer_col.null_count:
                probe_null = pc.and_(
                    pc.is_null(outer_col), _group_mask(inner)
                )
                unknown = probe_null if unknown is None \
                    else pc.or_(unknown, probe_null)
            unknown = pc.and_(
                pc.fill_null(_broadcast(unknown, len(table)), False),
                pc.invert(pc.fill_null(_broadcast(mask, len(table)), False)),
            )
            mask = pc.if_else(
                unknown, pa.scalar(None, pa.bool_()),
                _broadcast(mask, len(table)),
            )
        for c in outer_only:
            # the outer-only predicate gates the whole subquery: where it is
            # FALSE or UNKNOWN the group is empty → IN is definite FALSE
            mask = pc.and_kleene(
                _broadcast(mask, len(table)),
                pc.fill_null(_broadcast(self._eval_bool(c, table), len(table)), False),
            )
        return pc.invert(mask) if node.negated else mask

    def _eval_scalar_correlated(self, sel, inner_node, eq_pairs, table):
        """(SELECT agg(x) FROM … WHERE k = outer.k AND p) → GROUP BY k,
        left-joined back per outer row; groupless rows yield NULL (0 for a
        bare count, matching SQL)."""
        import numpy as np
        from dataclasses import replace as _dc_replace

        if len(sel.items) != 1 or not _contains_agg(sel.items[0].expr) \
                or sel.group_by:
            raise SqlError(
                "correlated scalar subquery must be a single aggregate"
            )
        if sel.limit is not None or sel.offset:
            raise SqlError(
                "correlated subqueries do not support LIMIT/OFFSET"
            )
        keys_o = [p[0] for p in eq_pairs]
        keys_i = [p[1] for p in eq_pairs]
        dec = _dc_replace(
            sel,
            items=[ast.SelectItem(ast.Column(k)) for k in keys_i]
            + [ast.SelectItem(sel.items[0].expr, "__scalar__")],
            star=False,
            where=inner_node,
            group_by=list(keys_i),
            order_by=[],
            limit=None,
            offset=None,
        )
        grouped = self._select(dec)
        n = len(table)
        idx = pa.array(np.arange(n, dtype=np.int64))
        joined = (
            table.select(keys_o)
            .append_column("__cidx__", idx)
            .join(grouped, keys=keys_o, right_keys=keys_i, join_type="left outer")
            .sort_by("__cidx__")
        )
        vals = joined.column("__scalar__")
        fill = self._agg_expr_empty_value(sel.items[0].expr)
        if fill is not None:
            # SQL evaluates the aggregate expression over the EMPTY set for
            # outer rows with no matching group: count(*) → 0, so
            # count(*)+1 → 1; sum/avg/min/max → NULL keeps the join NULL
            vals = pc.fill_null(vals, fill)
        return vals

    def _agg_expr_empty_value(self, expr):
        """Value of an aggregate expression over zero rows, or None when it
        is NULL (any NULL-yielding aggregate poisons the expression)."""

        def sub(e):
            if isinstance(e, ast.Agg):
                return ast.Literal(0) if e.fn == "count" else ast.Literal(None)
            if isinstance(e, ast.Arith):
                return ast.Arith(e.op, sub(e.left), sub(e.right))
            if isinstance(e, ast.Func):
                return ast.Func(e.name, [None if a is None else sub(a) for a in e.args])
            return e

        one_row = pa.table({"__d__": pa.array([0])})
        try:
            v = self._eval_expr(sub(expr), one_row)
        except (SqlError, pa.ArrowInvalid, TypeError, KeyError):
            # KeyError: the expression also references a (correlation) column
            # — no constant empty-set value exists, keep the NULL
            return None
        if isinstance(v, pa.ChunkedArray):
            v = v.combine_chunks()
        if isinstance(v, (pa.Array, pa.ChunkedArray)):
            v = v[0]
        py = v.as_py() if isinstance(v, pa.Scalar) else v
        return py if py is not None else None

    def _eval_expr(self, expr, table: pa.Table):
        """Evaluate a value expression against a table → Arrow array/scalar."""
        if isinstance(expr, ast.Column):
            return table.column(expr.name)
        if isinstance(expr, ast.Literal):
            return pa.scalar(expr.value)
        if isinstance(expr, ast.Arith):
            left = self._eval_expr(expr.left, table)
            right = self._eval_expr(expr.right, table)
            fn = {"+": pc.add, "-": pc.subtract, "*": pc.multiply, "/": pc.divide}[expr.op]
            return fn(left, right)
        if isinstance(expr, ast.WindowFn):
            return self._eval_window(expr, table)
        if isinstance(expr, ast.Case):
            return self._eval_case(expr, table)
        if isinstance(expr, ast.Func):
            if expr.name == "substring":
                arr, start, length = expr.args
                s = self._eval_expr(start, table)
                s0 = (s.as_py() if isinstance(s, pa.Scalar) else s) - 1  # SQL is 1-based
                stop = None
                if length is not None:
                    ln = self._eval_expr(length, table)
                    stop = s0 + (ln.as_py() if isinstance(ln, pa.Scalar) else ln)
                return pc.utf8_slice_codeunits(
                    self._eval_expr(arr, table), start=s0, stop=stop
                )
            if expr.name == "cast":
                val, spec = expr.args
                tname, params = spec.value
                if tname == "decimal":
                    if params:
                        precision = params[0]
                        scale = params[1] if len(params) > 1 else 0
                    else:
                        precision, scale = 38, 10
                    try:
                        target = pa.decimal128(precision, scale)
                    except ValueError as e:  # precision out of [1, 38]
                        raise SqlError(f"CAST failed: {e}")
                elif tname in ("varchar", "char"):
                    target = pa.string()  # length is advisory in SQL
                else:
                    target = _TYPE_MAP.get(tname)
                if target is None:
                    raise SqlError(f"unknown type {tname!r} in CAST")
                try:
                    # float→int TRUNCATES (standard SQL / Spark / DuckDB);
                    # malformed strings and overflows still error
                    opts = pc.CastOptions(
                        target_type=target, allow_float_truncate=True
                    )
                    return pc.cast(self._eval_expr(val, table), options=opts)
                except (pa.lib.ArrowInvalid, pa.lib.ArrowNotImplementedError) as e:
                    raise SqlError(f"CAST failed: {e}")
            if expr.name == "coalesce":
                vals = [
                    _broadcast(self._eval_expr(a, table), len(table))
                    for a in expr.args
                ]
                return pc.coalesce(*vals)
            if expr.name == "nullif":
                if len(expr.args) != 2:
                    raise SqlError("nullif takes exactly two arguments")
                a = _broadcast(self._eval_expr(expr.args[0], table), len(table))
                b = _broadcast(self._eval_expr(expr.args[1], table), len(table))
                eq = pc.fill_null(pc.equal(a, b), False)
                return pc.if_else(eq, pa.scalar(None, a.type), a)
            if expr.name in _DATE_PARTS:
                if len(expr.args) != 1:
                    raise SqlError(f"{expr.name} takes exactly one argument")
                fn = _DATE_PARTS[expr.name]
                # evaluate the argument OUTSIDE the guard: a failure inside
                # a nested expression is that expression's error, not a
                # date-typing complaint from this function
                arg = self._eval_expr(expr.args[0], table)
                arg_type = arg.type if hasattr(arg, "type") else None
                if arg_type is not None and pa.types.is_null(arg_type):
                    # bare NULL literal: date_part(NULL) is NULL, not an error
                    return pa.scalar(None, pa.int64())
                if (
                    arg_type is not None and pa.types.is_date(arg_type)
                    and expr.name in ("hour", "minute", "second")
                ):
                    # DataFusion semantics: time parts of a DATE are 0
                    arg = pc.cast(arg, pa.timestamp("us"))
                try:
                    out = fn(arg)
                except (pa.lib.ArrowNotImplementedError, pa.lib.ArrowInvalid) as e:
                    raise SqlError(f"{expr.name}() needs a date/timestamp: {e}")
                return pc.cast(out, pa.int64())  # BI tools expect plain ints
            if expr.name in ("trim", "ltrim", "rtrim"):
                if len(expr.args) != 1:
                    raise SqlError(f"{expr.name} takes exactly one argument")
                fn = {
                    "trim": pc.utf8_trim_whitespace,
                    "ltrim": pc.utf8_ltrim_whitespace,
                    "rtrim": pc.utf8_rtrim_whitespace,
                }[expr.name]
                return self._apply_fn(expr.name, fn, self._eval_expr(expr.args[0], table))
            if expr.name == "replace":
                if len(expr.args) != 3:
                    raise SqlError("replace takes exactly three arguments")
                pat, rep = expr.args[1], expr.args[2]
                if not isinstance(pat, ast.Literal) or not isinstance(rep, ast.Literal):
                    raise SqlError("replace pattern and replacement must be literals")
                if pat.value is None or rep.value is None:
                    # SQL: any NULL argument nulls the result — never the
                    # text "None"
                    return pa.nulls(len(table), pa.string())
                return pc.replace_substring(
                    self._eval_expr(expr.args[0], table),
                    pattern=str(pat.value), replacement=str(rep.value),
                )
            if expr.name == "concat":
                if not expr.args:
                    raise SqlError("concat takes at least one argument")
                parts = [
                    pc.cast(
                        _broadcast(self._eval_expr(a, table), len(table)),
                        pa.string(),
                    )
                    for a in expr.args
                ]
                # NULL arguments are SKIPPED (Postgres/DataFusion concat
                # semantics — the engine this dialect claims parity with;
                # Spark/MySQL instead null the whole result).  That holds
                # for ONE argument too: concat(NULL) is '' — skipping the
                # sole NULL leaves the empty string, never NULL
                if len(parts) == 1:
                    return pc.fill_null(parts[0], "")
                return pc.binary_join_element_wise(
                    *parts, "", null_handling="skip"
                )
            if expr.name in ("abs", "upper", "lower", "length", "round"):
                if expr.name == "round":
                    if not 1 <= len(expr.args) <= 2:
                        raise SqlError("round takes one or two arguments")
                    nd = 0
                    if len(expr.args) == 2:
                        ndv = self._eval_expr(expr.args[1], table)
                        if not isinstance(ndv, pa.Scalar):
                            raise SqlError("round digits must be a literal")
                        nd = int(ndv.as_py())
                    # SQL rounds half away from zero, not banker's rounding
                    return pc.round(
                        self._eval_expr(expr.args[0], table),
                        ndigits=nd, round_mode="half_towards_infinity",
                    )
                if len(expr.args) != 1:
                    raise SqlError(f"{expr.name} takes exactly one argument")
                arg = self._eval_expr(expr.args[0], table)
                fn = {
                    "abs": pc.abs,
                    "upper": pc.utf8_upper,
                    "lower": pc.utf8_lower,
                    "length": pc.utf8_length,
                }[expr.name]
                return self._apply_fn(expr.name, fn, arg)
            raise SqlError(f"unknown function {expr.name!r}")
        if isinstance(expr, ast.ScalarSubquery):
            sel = expr.select
            if isinstance(sel, ast.Select) and sel.where is not None:
                inner_node, eq_pairs, mixed, outer_only, _rs = self._split_correlated(
                    sel, set(table.column_names)
                )
                if eq_pairs or mixed or outer_only:
                    if mixed or outer_only:
                        raise SqlError(
                            "correlated scalar subquery supports equality"
                            " correlation predicates only"
                        )
                    return self._eval_scalar_correlated(
                        sel, inner_node, eq_pairs, table
                    )
            sub = self._query(sel)
            if sub.num_columns != 1 or len(sub) > 1:
                raise SqlError("scalar subquery must produce one value")
            return sub.column(0)[0] if len(sub) else pa.scalar(None)
        if isinstance(expr, ast.Agg):
            raise SqlError("aggregate not allowed here (missing GROUP BY context?)")
        raise SqlError(f"unsupported expression {expr!r}")

    def _eval_window(self, wf: ast.WindowFn, table: pa.Table):
        """Window functions: ONE stable multi-key sort (partition + order
        keys + row tiebreaker), vectorized rank/offset/aggregate computation
        in the sorted domain, scatter back to row order.  Aggregates with an
        ORDER BY are running with RANGE semantics (peer rows share the value
        at the last peer); without one they broadcast the partition value —
        standard SQL defaults (the reference gets these from DataFusion's
        window planner)."""
        import numpy as np

        fn = wf.fn
        n = len(table)
        is_rank = isinstance(fn, ast.Func) and fn.name in (
            "row_number", "rank", "dense_rank"
        )
        if n == 0:
            return pa.nulls(0, type=pa.int64() if is_rank else pa.float64())

        aug = table.append_column("__rn", pa.array(np.arange(n, dtype=np.int64)))
        sort_keys = (
            [(c, "ascending") for c in wf.partition_by]
            + [(c, "descending" if d else "ascending") for c, d in wf.order_by]
            + [("__rn", "ascending")]  # determinism among peers
        )
        order = pc.sort_indices(aug, sort_keys=sort_keys).to_numpy()
        idx = np.arange(n, dtype=np.int64)
        inv = np.empty(n, dtype=np.int64)
        inv[order] = idx

        def sorted_codes(cname: str) -> np.ndarray:
            # dictionary codes make run detection null-safe and type-agnostic
            arr = table.column(cname).combine_chunks()
            enc = arr if pa.types.is_dictionary(arr.type) else pc.dictionary_encode(arr)
            codes = pc.fill_null(enc.indices.cast(pa.int64()), -1).to_numpy()
            return codes[order]

        part_new = np.zeros(n, dtype=bool)
        part_new[0] = True
        for c in wf.partition_by:
            cs = sorted_codes(c)
            part_new[1:] |= cs[1:] != cs[:-1]
        peer_new = part_new.copy()
        for c, _ in wf.order_by:
            cs = sorted_codes(c)
            peer_new[1:] |= cs[1:] != cs[:-1]
        part_first = np.maximum.accumulate(np.where(part_new, idx, 0))

        if isinstance(fn, ast.Func) and fn.name in ("row_number", "rank", "dense_rank"):
            if fn.name == "row_number":
                out_sorted = idx - part_first + 1
            elif fn.name == "rank":
                peer_first = np.maximum.accumulate(np.where(peer_new, idx, 0))
                out_sorted = peer_first - part_first + 1
            else:  # dense_rank
                dr = np.cumsum(peer_new)
                dr_start = np.maximum.accumulate(np.where(part_new, dr, 0))
                out_sorted = dr - dr_start + 1
            res = np.empty(n, dtype=np.int64)
            res[order] = out_sorted
            return pa.array(res)

        if isinstance(fn, ast.Func):  # lag / lead
            k = fn.args[1].value if len(fn.args) > 1 else 1
            default = fn.args[2].value if len(fn.args) > 2 else None
            vals = _broadcast(self._eval_expr(fn.args[0], table), n)
            if isinstance(vals, pa.ChunkedArray):
                vals = vals.combine_chunks()
            sorted_vals = vals.take(pa.array(order))
            shift = k if fn.name == "lag" else -k
            src = idx - shift
            part_id = np.cumsum(part_new)
            valid = (src >= 0) & (src < n)
            src_c = np.clip(src, 0, n - 1)
            valid &= part_id[src_c] == part_id
            taken = sorted_vals.take(pa.array(np.where(valid, src_c, 0)))
            fallback = (
                pa.nulls(n, type=sorted_vals.type)
                if default is None
                else pa.array([default] * n).cast(sorted_vals.type)
            )
            out = pc.if_else(pa.array(valid), taken, fallback)
            return out.take(pa.array(inv))

        # aggregate window (Agg)
        import pandas as pd

        part_id = np.cumsum(part_new)
        if fn.arg is None:
            ser = pd.Series(np.ones(n))
            counts_star = True
        else:
            vals = _broadcast(self._eval_expr(fn.arg, table), n)
            if isinstance(vals, pa.ChunkedArray):
                vals = vals.combine_chunks()
            ser = vals.take(pa.array(order)).to_pandas()
            counts_star = False
        g = ser.groupby(part_id)
        if not wf.order_by:  # whole-partition broadcast
            if fn.fn == "count":
                out = g.transform("size") if counts_star else g.transform("count")
            else:
                out = g.transform({"sum": "sum", "min": "min", "max": "max",
                                   "avg": "mean"}[fn.fn])
                if fn.fn == "sum":
                    # SQL: sum over zero non-null inputs is NULL, not 0
                    nn = ser.notna().groupby(part_id).transform("sum")
                    out = out.where(nn > 0)
            out_sorted = out.to_numpy()
        else:  # running (RANGE: peers share the last peer row's value)
            # SQL frame semantics: NULL inputs are SKIPPED — the running
            # value carries forward through them (pandas cum* would leave
            # NaN at NaN positions instead)
            nn = ser.notna().groupby(part_id).cumsum()
            if fn.fn == "count":
                out = g.cumcount() + 1 if counts_star else nn
            elif fn.fn == "sum":
                out = ser.fillna(0).groupby(part_id).cumsum().where(nn > 0)
            elif fn.fn == "min":
                out = g.cummin().groupby(part_id).ffill()
            elif fn.fn == "max":
                out = g.cummax().groupby(part_id).ffill()
            else:  # avg
                out = (ser.fillna(0).groupby(part_id).cumsum() / nn).where(nn > 0)
            starts = np.flatnonzero(peer_new)
            ends = np.append(starts[1:], n) - 1
            peer_last = np.repeat(ends, np.diff(np.append(starts, n)))
            out_sorted = out.to_numpy()[peer_last]
        res = np.empty(n, dtype=np.asarray(out_sorted).dtype)
        res[order] = out_sorted
        return pa.array(res, from_pandas=True)  # NaN → null

    def _eval_case(self, expr: ast.Case, table: pa.Table):
        """CASE with SQL's lazy-branch guarantee: each THEN/ELSE evaluates
        only over the rows its condition selects (``CASE WHEN b != 0 THEN
        a / b ...`` must not divide by zero on guarded rows), then results
        scatter back into row order."""
        import numpy as np

        n = len(table)
        remaining = np.ones(n, dtype=bool)
        parts: list[tuple[np.ndarray, pa.Table]] = []
        # simple CASE: the operand evaluates ONCE, each WHEN compares to it
        op_val = (
            _broadcast(self._eval_expr(expr.operand, table), n)
            if expr.operand is not None else None
        )
        for cond, value in expr.whens:
            if op_val is not None:
                raw = pc.equal(
                    op_val, _broadcast(self._eval_expr(cond, table), n)
                )
            else:
                raw = _broadcast(self._eval_bool(cond, table), n)
            mask = pc.fill_null(raw, False)
            m = np.asarray(mask) & remaining
            rows = np.nonzero(m)[0]
            if rows.size:
                sub = table.take(pa.array(rows))
                vals = _broadcast(self._eval_expr(value, sub), len(sub))
                parts.append((rows, pa.table({"v": vals})))
            remaining &= ~m
        rest = np.nonzero(remaining)[0]
        if rest.size:
            if expr.default is not None:
                sub = table.take(pa.array(rest))
                vals = _broadcast(self._eval_expr(expr.default, sub), len(sub))
            else:
                vals = pa.nulls(rest.size)
            parts.append((rest, pa.table({"v": vals})))
        if not parts:
            return pa.nulls(0)
        merged = pa.concat_tables(
            [p for _, p in parts], promote_options="permissive"
        ).column("v")
        order = np.concatenate([r for r, _ in parts])
        inverse = np.empty(n, dtype=np.int64)
        inverse[order] = np.arange(n, dtype=np.int64)
        return merged.take(pa.array(inverse))

    def _eval_bool(self, node, table: pa.Table):
        """Evaluate a boolean tree to an Arrow mask (Kleene semantics)."""
        if isinstance(node, ast.Compare):
            ops = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
                   "le": pc.less_equal, "gt": pc.greater, "ge": pc.greater_equal}
            if node.simple:
                return ops[node.op](table.column(node.col), pa.scalar(node.value))
            return ops[node.op](
                self._eval_expr(node.left, table), self._eval_expr(node.right, table)
            )
        if isinstance(node, ast.InList):
            return pc.is_in(table.column(node.col), value_set=pa.array(node.values))
        if isinstance(node, ast.InSubquery):
            return self._eval_in_subquery(node, table)
        if isinstance(node, ast.Exists):
            return self._eval_exists(node, table)
        if isinstance(node, ast.Like):
            mask = pc.match_like(table.column(node.col), node.pattern)
            return pc.invert(mask) if node.negated else mask
        if isinstance(node, ast.Between):
            col = table.column(node.col)
            return pc.and_kleene(
                pc.greater_equal(col, pa.scalar(node.low)),
                pc.less_equal(col, pa.scalar(node.high)),
            )
        if isinstance(node, ast.IsNull):
            col = table.column(node.col)
            return col.is_valid() if node.negated else pc.is_null(col)
        if isinstance(node, ast.BoolOp):
            fold = pc.and_kleene if node.op == "and" else pc.or_kleene
            masks = [
                _broadcast(self._eval_bool(a, table), len(table)) for a in node.args
            ]
            out = masks[0]
            for m in masks[1:]:
                out = fold(out, m)
            return out
        if isinstance(node, ast.NotOp):
            return pc.invert(
                _broadcast(self._eval_bool(node.arg, table), len(table))
            )
        raise SqlError(f"unsupported predicate {node!r}")

    # ------------------------------------------------------------------- DML
    def _insert(self, stmt: ast.Insert) -> pa.Table:
        t = self.catalog.table(stmt.table, self.namespace)
        schema = t.schema
        if stmt.select is not None:
            src = self._query(stmt.select)
            names = stmt.columns or list(src.column_names)
            if len(names) != src.num_columns:
                raise SqlError(
                    f"INSERT column list has {len(names)} names but the"
                    f" SELECT produces {src.num_columns} columns"
                )
            cols = {}
            for i, name in enumerate(names):
                if name not in schema.names:
                    raise SqlError(f"unknown column {name!r} in INSERT target")
                cols[name] = src.column(i).cast(schema.field(name).type)
            t.write_arrow(
                pa.table(cols, schema=pa.schema([schema.field(n) for n in names]))
            )
            return pa.table({"inserted": pa.array([len(src)], type=pa.int64())})
        columns = stmt.columns or [f.name for f in schema]
        if any(len(r) != len(columns) for r in stmt.rows):
            raise SqlError("VALUES row arity does not match column list")
        data = {}
        for i, name in enumerate(columns):
            fld = schema.field(name)
            data[name] = pa.array([r[i] for r in stmt.rows], type=fld.type)
        t.write_arrow(pa.table(data, schema=pa.schema([schema.field(c) for c in columns])))
        return pa.table({"inserted": pa.array([len(stmt.rows)], type=pa.int64())})

    # ------------------------------------------------------------------- DDL
    def _create(self, stmt: ast.CreateTable) -> pa.Table:
        if stmt.if_not_exists and self.catalog.table_exists(stmt.table, self.namespace):
            return pa.table({"status": ["exists"]})
        fields = []
        pks = []
        for c in stmt.columns:
            if c.type_name not in _TYPE_MAP:
                raise SqlError(f"unknown type {c.type_name!r}")
            fields.append(pa.field(c.name, _TYPE_MAP[c.type_name]))
            if c.primary_key:
                pks.append(c.name)
        props = {str(k): str(v) for k, v in stmt.properties.items()}
        hash_bucket_num = props.pop("hashBucketNum", None)
        self.catalog.create_table(
            stmt.table,
            pa.schema(fields),
            primary_keys=pks or None,
            range_partitions=stmt.range_partitions or None,
            hash_bucket_num=int(hash_bucket_num) if hash_bucket_num else None,
            properties=props or None,
            namespace=self.namespace,
        )
        return pa.table({"status": ["ok"]})

    def _drop(self, stmt: ast.DropTable) -> pa.Table:
        if stmt.if_exists and not self.catalog.table_exists(stmt.table, self.namespace):
            return pa.table({"status": ["absent"]})
        self.catalog.drop_table(stmt.table, self.namespace)
        return pa.table({"status": ["ok"]})
