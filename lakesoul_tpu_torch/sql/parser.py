"""Minimal SQL parser: tokenizer + recursive descent → dataclass AST (a copy
of ``lakesoul_tpu/sql/parser.py``).

Covers the statement surface the reference exposes through its embedded SQL
engines (rust/lakesoul-datafusion catalog/TableProvider + console):
SELECT (projection, WHERE, GROUP BY, ORDER BY, LIMIT, aggregates), INSERT
INTO … VALUES, CREATE TABLE (with PRIMARY KEY / PARTITIONED BY / WITH
properties), DROP TABLE, SHOW TABLES, DESCRIBE.  WHERE trees compile to the
framework's portable Filter AST so predicate pushdown works unchanged."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

from lakesoul_tpu_torch.errors import LakeSoulError


class SqlError(LakeSoulError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\.|\+|-|/)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "order", "by", "limit", "as", "and",
    "or", "not", "in", "is", "null", "asc", "desc", "insert", "into",
    "values", "create", "table", "drop", "show", "tables", "describe",
    "primary", "key", "partitioned", "with", "if", "exists", "distinct",
    "count", "sum", "min", "max", "avg", "true", "false", "alter", "add",
    "column", "call", "update", "set", "delete", "join", "inner", "left", "on",
    "right", "full", "outer",
    "case", "when", "then", "else", "end", "having", "between", "like",
    "substring", "for", "union", "intersect", "except", "all", "over",
    "partition",
}

# window-only functions (idents, not keywords: usable as column names)
WINDOW_FUNCTIONS = ("row_number", "rank", "dense_rank", "lag", "lead")

# generic scalar functions parsed as ``name(arg, ...)`` (idents, not
# keywords — still usable as column names when not followed by "(")
# EXTRACT(part FROM expr) parts; each is also callable as a function of
# the same name (the executor owns the part → Arrow-kernel mapping)
EXTRACT_PARTS = ("year", "month", "day", "hour", "minute", "second")

SCALAR_FUNCTIONS = (
    "coalesce", "nullif", "abs", "round", "upper", "lower", "length",
    "trim", "ltrim", "rtrim", "replace", "concat",
) + EXTRACT_PARTS


@dataclass
class Token:
    kind: str  # number | string | op | ident | kw
    value: str


def tokenize(sql: str) -> list[Token]:
    tokens = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlError(f"cannot tokenize SQL at: {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        value = m.group()
        if kind == "ident" and value.lower() in KEYWORDS:
            tokens.append(Token("kw", value.lower()))
        else:
            tokens.append(Token(kind, value))
    return tokens


# ----------------------------------------------------------------- AST nodes
@dataclass
class Column:
    name: str
    # table/alias qualifier as written (``o.col``); evaluation resolves by
    # bare name, correlated-subquery classification resolves scope by it
    qual: str | None = None


@dataclass
class Literal:
    value: Any


@dataclass
class Agg:
    fn: str  # count | sum | min | max | avg
    arg: object | None  # Column/Literal/Arith expression; None = count(*)
    alias: str | None = None
    distinct: bool = False  # count(DISTINCT x)


@dataclass
class Arith:
    op: str  # + - * /
    left: object
    right: object


@dataclass
class Case:
    """CASE WHEN cond THEN expr [...] [ELSE expr] END.

    Simple form (``CASE x WHEN v THEN r``): ``operand`` holds ``x`` and
    each when's first element is the comparison VALUE expression — the
    evaluator computes the operand once, not once per branch."""

    whens: list  # [(bool_node | value_expr, value_expr), ...]
    default: object | None = None
    operand: object | None = None


@dataclass
class Func:
    """Scalar function call (substring, ...)."""

    name: str
    args: list


@dataclass
class ScalarSubquery:
    """Uncorrelated (SELECT ...) used as a value."""

    select: "Select"


@dataclass
class WindowFn:
    """``fn OVER (PARTITION BY ... ORDER BY ...)``: fn is an Agg (sum/avg/
    min/max/count) or a Func for row_number/rank/dense_rank/lag/lead.
    Aggregates with an ORDER BY are running (RANGE semantics: peers share
    the value at the last peer row), without one they broadcast the whole-
    partition value — standard SQL defaults."""

    fn: object
    partition_by: list[str] = field(default_factory=list)
    order_by: list[tuple[str, bool]] = field(default_factory=list)  # (col, desc)


@dataclass
class SelectItem:
    expr: Column | Agg
    alias: str | None = None


@dataclass
class Compare:
    op: str
    col: str  # simple column name when the LHS is a bare column, else ""
    value: Any  # literal when the RHS is a literal, else None
    left: Any = None  # general expressions (col-col / arith comparisons)
    right: Any = None
    col_qual: str | None = None  # qualifier of `col` as written (o.total)

    @property
    def simple(self) -> bool:
        """Pushdown-eligible: bare column vs literal."""
        return bool(self.col) and self.left is None


@dataclass
class InList:
    col: str
    values: list
    col_qual: str | None = None


@dataclass
class InSubquery:
    col: str
    select: "Select"
    negated: bool = False
    col_qual: str | None = None


@dataclass
class Exists:
    select: "Select"
    negated: bool = False


@dataclass
class Like:
    col: str
    pattern: str
    negated: bool = False
    col_qual: str | None = None


@dataclass
class Between:
    col: str
    low: Any
    high: Any
    col_qual: str | None = None


@dataclass
class IsNull:
    col: str
    negated: bool
    col_qual: str | None = None


@dataclass
class BoolOp:
    op: str  # and | or
    args: list


@dataclass
class NotOp:
    arg: Any


@dataclass
class Join:
    table: str  # name, or "" when right is a derived table
    kind: str  # inner | left
    left_on: str
    right_on: str
    left_qual: str | None = None  # table qualifier as written (a.col)
    right_qual: str | None = None
    subquery: "Select | None" = None  # JOIN (SELECT ...) alias
    alias: str | None = None


@dataclass
class Select:
    items: list[SelectItem]
    star: bool
    table: str  # name, or "" when from_subquery is set
    from_subquery: "Select | None" = None  # FROM (SELECT ...) alias
    from_alias: str | None = None
    distinct: bool = False
    joins: list = field(default_factory=list)
    where: Any = None
    group_by: list[str] = field(default_factory=list)
    # GROUP BY <expr> entries: [(synthesized column name, expr AST)] — the
    # name also appears in group_by; the executor materializes the column
    # before aggregation and rewrites matching select items onto it
    group_exprs: list = field(default_factory=list)
    # ROLLUP/CUBE/GROUPING SETS: the list of grouping sets (each a subset of
    # group_by); None = plain GROUP BY (one set = group_by itself)
    grouping_sets: list | None = None
    # time travel: epoch ms of `FROM t TIMESTAMP AS OF ...` (Spark style) or
    # `FOR SYSTEM_TIME AS OF ...` (SQL:2011/Flink); None = latest snapshot
    as_of_ms: int | None = None
    having: Any = None
    order_by: list[tuple[str, bool]] = field(default_factory=list)  # (col, desc)
    # qualifiers as written for order_by/group_by entries (aligned by index;
    # may be shorter — ROLLUP/CUBE paths don't record them).  Needed so a
    # RIGHT/FULL join's suffixed right key can rebind `ORDER BY b.k`.
    order_by_quals: list = field(default_factory=list)
    group_by_quals: list = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None


@dataclass
class Explain:
    """EXPLAIN <statement>: plan description, nothing executed."""

    stmt: object


@dataclass
class SetOp:
    """UNION [ALL] / INTERSECT / EXCEPT over two selects (or nested set
    ops).  ORDER BY / LIMIT written after the chain bind to the whole."""

    op: str  # union | intersect | except
    left: "Select | SetOp"
    right: "Select | SetOp"
    all: bool = False
    order_by: list[tuple[str, bool]] = field(default_factory=list)
    limit: int | None = None
    offset: int | None = None


@dataclass
class Insert:
    table: str
    columns: list[str]
    rows: list[list]
    select: "Select | None" = None  # INSERT INTO ... SELECT ...


@dataclass
class ColumnDef:
    name: str
    type_name: str
    primary_key: bool = False


@dataclass
class CreateTable:
    table: str
    columns: list[ColumnDef]
    range_partitions: list[str] = field(default_factory=list)
    properties: dict = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class DropTable:
    table: str
    if_exists: bool = False


@dataclass
class ShowTables:
    pass


@dataclass
class Describe:
    table: str


@dataclass
class AlterAddColumn:
    table: str
    column: str
    type_name: str


@dataclass
class AlterSetProperties:
    table: str
    properties: dict


@dataclass
class Call:
    procedure: str  # compact | rollback | clean | build_vector_index
    args: list


@dataclass
class Update:
    table: str
    assignments: dict
    where: Any


@dataclass
class Delete:
    table: str
    where: Any


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.pos = 0

    # ------------------------------------------------------------- plumbing
    def peek(self) -> Token | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise SqlError("unexpected end of statement")
        self.pos += 1
        return tok

    def accept(self, kind: str, value: str | None = None) -> Token | None:
        tok = self.peek()
        if tok and tok.kind == kind and (value is None or tok.value == value):
            self.pos += 1
            return tok
        return None

    def expect(self, kind: str, value: str | None = None) -> Token:
        tok = self.accept(kind, value)
        if tok is None:
            have = self.peek()
            raise SqlError(f"expected {value or kind}, got {have.value if have else 'EOF'!r}")
        return tok

    def ident(self) -> str:
        tok = self.next()
        if tok.kind not in ("ident", "kw"):
            raise SqlError(f"expected identifier, got {tok.value!r}")
        return tok.value

    # ------------------------------------------------------------ statements
    def parse(self):
        tok = self.peek()
        if tok is None:
            raise SqlError("empty statement")
        if tok.kind == "ident" and tok.value.lower() == "explain":
            self.next()
            return Explain(self.parse())
        dispatch = {
            "select": self.parse_query,
            "with": self.parse_with,
            "insert": self.parse_insert,
            "create": self.parse_create,
            "drop": self.parse_drop,
            "show": self.parse_show,
            "describe": self.parse_describe,
            "alter": self.parse_alter,
            "call": self.parse_call,
            "update": self.parse_update,
            "delete": self.parse_delete,
        }
        if tok.kind != "kw" or tok.value not in dispatch:
            raise SqlError(f"unsupported statement start {tok.value!r}")
        stmt = dispatch[tok.value]()
        if self.peek() is not None and not self.accept("op", ";"):
            extra = self.peek()
            if extra is not None:
                raise SqlError(f"unexpected trailing token {extra.value!r}")
        return stmt

    def parse_with(self):
        """``WITH name AS (query), ... <query>``: non-recursive CTEs, inlined
        as derived tables (each reference becomes a from_subquery — the way
        lightweight planners lower WITH).  Earlier CTEs are visible to later
        ones and to the main query, including inside subqueries and joins."""
        self.expect("kw", "with")
        ctes: dict[str, object] = {}
        while True:
            name = self.ident()
            self.expect("kw", "as")
            self.expect("op", "(")
            body = self.parse_query()
            self.expect("op", ")")
            inline_ctes(body, ctes)
            ctes[name] = body
            if not self.accept("op", ","):
                break
        stmt = self.parse_query()
        inline_ctes(stmt, ctes)
        return stmt

    def parse_query(self):
        """One query: a SELECT, optionally chained with UNION [ALL] /
        INTERSECT / EXCEPT.  Standard precedence: INTERSECT binds tighter
        than UNION/EXCEPT; same-level operators are left-associative."""
        left = self._parse_intersect_chain()
        while True:
            tok = self.peek()
            if tok is None or tok.kind != "kw" or tok.value not in ("union", "except"):
                break
            op = self.next().value
            all_ = bool(self.accept("kw", "all"))
            right = self._parse_intersect_chain()
            left = SetOp(op, left, right, all_)
        return self._hoist_trailing_order(left)

    def _parse_intersect_chain(self):
        left = self.parse_select()
        while self.peek() is not None and self.peek().kind == "kw" \
                and self.peek().value == "intersect":
            self.next()
            all_ = bool(self.accept("kw", "all"))
            left = SetOp("intersect", left, self.parse_select(), all_)
        return left

    @staticmethod
    def _hoist_trailing_order(node):
        """ORDER BY / LIMIT written after a set-op chain were consumed by the
        rightmost SELECT's parse — per SQL they bind to the whole query."""
        if not isinstance(node, SetOp):
            return node
        rightmost = node
        while isinstance(rightmost.right, SetOp):
            rightmost = rightmost.right
        tail = rightmost.right
        if tail.order_by or tail.limit is not None or tail.offset is not None:
            node.order_by, node.limit = tail.order_by, tail.limit
            node.offset = tail.offset
            tail.order_by, tail.limit, tail.offset = [], None, None
            tail.order_by_quals = []
        return node

    def parse_select(self) -> Select:
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        star = False
        items: list[SelectItem] = []
        if self.accept("op", "*"):
            star = True
        else:
            while True:
                items.append(self._select_item())
                if not self.accept("op", ","):
                    break
        sel = Select(items=items, star=star, table="", distinct=distinct)
        has_from = bool(self.accept("kw", "from"))
        if not has_from and star:
            # FROM-less SELECT (`SELECT 1`, `SELECT 1 LIMIT 1`) — the probe
            # statement ADBC/JDBC drivers open connections with; evaluates
            # the items over one anonymous row.  Trailing clauses (WHERE,
            # ORDER BY, LIMIT) parse the same as with a FROM.
            raise SqlError("SELECT * requires a FROM clause")
        if has_from and self.accept("op", "("):
            sel.from_subquery = self.parse_query()
            self.expect("op", ")")
            explicit_as = bool(self.accept("kw", "as"))
            if self.peek() is not None and self.peek().kind == "ident" \
                    and (explicit_as or self.peek().value.lower() != "offset"):
                # same soft-keyword rule as the base-table alias: a bare
                # OFFSET after the derived table starts the OFFSET clause
                sel.from_alias = self.ident()
        elif has_from:
            sel.table = self.ident()
            self._maybe_time_travel(sel)
            # optional table alias (FROM lineitem l) — ignored for resolution,
            # accepted so qualified queries parse.  "offset" stays a soft
            # keyword here: `FROM t OFFSET 1` must not read it as an alias.
            nxt = self.peek()
            if nxt is not None and nxt.kind == "ident" \
                    and nxt.value.lower() != "offset":
                sel.from_alias = self.ident()
        while has_from:
            kind = None
            if self.accept("kw", "inner"):
                kind = "inner"
                self.expect("kw", "join")
            elif self.accept("kw", "left"):
                kind = "left"
                self.accept("kw", "outer")
                self.expect("kw", "join")
            elif self.accept("kw", "right"):
                kind = "right"
                self.accept("kw", "outer")
                self.expect("kw", "join")
            elif self.accept("kw", "full"):
                kind = "full"
                self.accept("kw", "outer")
                self.expect("kw", "join")
            elif self.accept("kw", "join"):
                kind = "inner"
            else:
                break
            sub = None
            jt = ""
            alias = None
            if self.accept("op", "("):
                sub = self.parse_query()
                self.expect("op", ")")
                self.accept("kw", "as")
                alias = self.ident()
            else:
                jt = self.ident()
                nxt = self.peek()
                if nxt is not None and nxt.kind == "ident":
                    alias = self.ident()
            self.expect("kw", "on")
            # ON a.col = b.col  (qualified or bare column names)
            lq, left_on = self._qualified_ident()
            self.expect("op", "=")
            rq, right_on = self._qualified_ident()
            sel.joins.append(Join(jt, kind, left_on, right_on, lq, rq, sub, alias))
        if self.accept("kw", "where"):
            sel.where = self._bool_expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            self._group_by_clause(sel)
        if self.accept("kw", "having"):
            sel.having = self._bool_expr()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                qual, col = self._qualified_ident()
                desc = False
                if self.accept("kw", "desc"):
                    desc = True
                else:
                    self.accept("kw", "asc")
                sel.order_by.append((col, desc))
                sel.order_by_quals.append(qual)
                if not self.accept("op", ","):
                    break
        if self.accept("kw", "limit"):
            sel.limit = int(self.expect("number").value)
        # OFFSET is a soft ident (columns named offset keep working); it
        # composes with or without LIMIT, per standard SQL
        nxt = self.peek()
        if nxt is not None and nxt.kind == "ident" and nxt.value.lower() == "offset":
            self.next()
            sel.offset = int(self.expect("number").value)
        return sel

    def _maybe_time_travel(self, sel: Select) -> None:
        """``FROM t TIMESTAMP AS OF <ts>`` (Spark) or ``FROM t FOR
        SYSTEM_TIME AS OF <ts>`` (SQL:2011/Flink) → snapshot read at that
        instant via the scan's snapshot_at (the reference's Spark time-travel
        read, SnapshotManagement readEndTime).  <ts> is a TIMESTAMP literal,
        an ISO string, or an epoch-milliseconds number."""

        def _nth_is(n, kind, value=None):
            i = self.pos + n
            return i < len(self.tokens) and self.tokens[i].kind == kind and (
                value is None or self.tokens[i].value.lower() == value
            )

        if _nth_is(0, "kw", "for") and _nth_is(1, "ident", "system_time") \
                and _nth_is(2, "kw", "as") and _nth_is(3, "ident", "of"):
            self.next()
            self.next()
        elif _nth_is(0, "ident", "timestamp") and _nth_is(1, "kw", "as") \
                and _nth_is(2, "ident", "of"):
            self.next()
        else:
            return
        self.expect("kw", "as")
        self.next()  # 'of' (checked above)
        val = self._arith_factor()
        if not isinstance(val, Literal):
            raise SqlError("AS OF requires a literal timestamp")
        import datetime as _dt

        v = val.value
        if isinstance(v, str):
            try:
                v = _dt.datetime.fromisoformat(v)
            except ValueError as e:
                raise SqlError(f"invalid AS OF timestamp {val.value!r}: {e}")
        if isinstance(v, _dt.date) and not isinstance(v, _dt.datetime):
            v = _dt.datetime.combine(v, _dt.time())  # DATE '...' = midnight
        if isinstance(v, _dt.datetime):
            if v.tzinfo is None:
                # naive literals are UTC: commit timestamps are UTC epoch ms,
                # and .timestamp() on a naive datetime would bake in the
                # server host's local zone — same query, host-dependent
                # snapshot (ADVICE r2).  Explicit offsets still win.
                v = v.replace(tzinfo=_dt.timezone.utc)
            sel.as_of_ms = int(v.timestamp() * 1000)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            sel.as_of_ms = int(v)
        else:
            raise SqlError(f"invalid AS OF timestamp {val.value!r}")

    def _group_by_clause(self, sel: Select) -> None:
        """Plain column list, or ROLLUP(...) / CUBE(...) / GROUPING SETS
        ((...), ...).  The analytic forms expand to explicit grouping sets
        here, like DataFusion's planner; missing grouping columns surface as
        NULL in the subtotal rows.  The words are soft (idents) so columns
        named rollup/cube/grouping still work in plain GROUP BY."""
        tok = self.peek()
        word = tok.value.lower() if tok is not None and tok.kind == "ident" else None

        def _nth_is(n, kind, value=None):
            i = self.pos + n
            return i < len(self.tokens) and self.tokens[i].kind == kind and (
                value is None or self.tokens[i].value.lower() == value
            )

        if word in ("rollup", "cube") and _nth_is(1, "op", "("):
            self.next()
            self.expect("op", "(")
            cols = [self._qualified_ident()[1]]
            while self.accept("op", ","):
                cols.append(self._qualified_ident()[1])
            self.expect("op", ")")
            sel.group_by = cols
            if word == "rollup":
                sel.grouping_sets = [cols[:i] for i in range(len(cols), -1, -1)]
            else:
                from itertools import combinations

                sel.grouping_sets = [
                    list(c)
                    for r in range(len(cols), -1, -1)
                    for c in combinations(cols, r)
                ]
            return
        if word == "grouping" and _nth_is(1, "ident", "sets") and _nth_is(2, "op", "("):
            self.next()
            self.next()
            self.expect("op", "(")
            sets: list[list[str]] = []
            while True:
                if self.accept("op", "("):
                    s: list[str] = []
                    if not self.accept("op", ")"):
                        s.append(self._qualified_ident()[1])
                        while self.accept("op", ","):
                            s.append(self._qualified_ident()[1])
                        self.expect("op", ")")
                    sets.append(s)
                else:
                    sets.append([self._qualified_ident()[1]])
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            seen: list[str] = []
            for s in sets:
                for c in s:
                    if c not in seen:
                        seen.append(c)
            sel.group_by = seen
            sel.grouping_sets = sets
            return
        self._group_by_entry(sel)
        while self.accept("op", ","):
            self._group_by_entry(sel)

    def _group_by_entry(self, sel: Select) -> None:
        """One plain GROUP BY entry: a bare column keeps its name; an
        integer literal is a select-item ORDINAL (GROUP BY 1, the
        Postgres/Spark convention); any other expression (upper(s),
        CASE ..., k / 10) gets a synthesized key column the executor
        materializes pre-aggregation."""
        expr = self._arith_expr()
        if isinstance(expr, Literal):
            if not isinstance(expr.value, int) or isinstance(expr.value, bool):
                raise SqlError(
                    "cannot GROUP BY a literal; use a column, an expression,"
                    " or a select-item ordinal"
                )
            if not 1 <= expr.value <= len(sel.items):
                raise SqlError(f"GROUP BY ordinal {expr.value} is out of range")
            expr = sel.items[expr.value - 1].expr
        if isinstance(expr, Column):
            sel.group_by.append(expr.name)
            sel.group_by_quals.append(expr.qual)
            return
        name = f"__grp_{len(sel.group_exprs)}"
        sel.group_exprs.append((name, expr))
        sel.group_by.append(name)
        sel.group_by_quals.append(None)

    def _qualified_ident(self) -> tuple[str | None, str]:
        """→ (qualifier or None, column)."""
        name = self.ident()
        if self.accept("op", "."):
            return name, self.ident()
        return None, name

    def _select_item(self) -> SelectItem:
        # aggregates are ordinary factors, so `sum(a) / sum(b)` parses whole
        expr = self._arith_expr()
        alias = self.ident() if self.accept("kw", "as") else None
        return SelectItem(expr, alias)

    def _maybe_agg(self) -> Agg | None:
        tok = self.peek()
        if not (tok and tok.kind == "kw" and tok.value in ("count", "sum", "min", "max", "avg")):
            return None
        fn = self.next().value
        self.expect("op", "(")
        distinct = bool(self.accept("kw", "distinct"))
        if self.accept("op", "*"):
            arg = None
            if fn != "count":
                raise SqlError(f"{fn}(*) not supported")
        else:
            arg = self._arith_expr()
        self.expect("op", ")")
        return Agg(fn, arg, distinct=distinct)

    # arithmetic value expressions: expr := term (±term)*; term := factor (*/factor)*
    @staticmethod
    def _fold(op: str, left, right):
        """Constant-fold literal arithmetic so negative numbers and literal
        math stay pushdown-eligible literals."""
        if isinstance(left, Literal) and isinstance(right, Literal):
            if isinstance(left.value, str) or isinstance(right.value, str):
                raise SqlError("arithmetic requires numeric operands")
            if left.value is None or right.value is None:
                return Literal(None)
            if op == "/":
                if right.value == 0:
                    raise SqlError("division by zero in literal expression")
                if isinstance(left.value, int) and isinstance(right.value, int):
                    # match the runtime's pc.divide: integer division
                    # truncating toward zero, not Python floor/true division
                    return Literal(int(left.value / right.value))
                return Literal(left.value / right.value)
            py = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                  "*": lambda a, b: a * b}[op]
            try:
                return Literal(py(left.value, right.value))
            except TypeError as e:  # e.g. DATE '...' + 1
                raise SqlError(f"invalid literal arithmetic: {e}")
        return Arith(op, left, right)

    def _arith_expr(self):
        left = self._arith_term()
        while True:
            if self.accept("op", "+"):
                left = self._fold("+", left, self._arith_term())
            elif self.accept("op", "-"):
                left = self._fold("-", left, self._arith_term())
            else:
                return left

    def _arith_term(self):
        left = self._arith_factor()
        while True:
            if self.accept("op", "*"):
                left = self._fold("*", left, self._arith_factor())
            elif self.accept("op", "/"):
                left = self._fold("/", left, self._arith_factor())
            else:
                return left

    def _arith_factor(self):
        if self.accept("op", "("):
            # (SELECT ...) scalar subquery or parenthesized expression
            nxt = self.peek()
            if nxt is not None and nxt.kind == "kw" and nxt.value == "select":
                sub = self.parse_query()
                self.expect("op", ")")
                return ScalarSubquery(sub)
            e = self._arith_expr()
            self.expect("op", ")")
            return e
        if self.accept("op", "-"):
            return self._fold("-", Literal(0), self._arith_factor())
        tok = self.peek()
        if tok is None:
            raise SqlError("unexpected end of statement in expression")
        if tok.kind == "kw" and tok.value == "case":
            return self._case_expr()
        if tok.kind == "kw" and tok.value == "substring":
            return self._substring_expr()
        agg = self._maybe_agg()
        if agg is not None:
            # OVER turns the aggregate into a window function
            if self.peek() is not None and self.peek().kind == "kw" \
                    and self.peek().value == "over":
                part, order = self._over_clause()
                return WindowFn(agg, part, order)
            return agg  # aggregates inside expressions (HAVING, agg arith)
        if tok.kind == "number" or tok.kind == "string" or (
            tok.kind == "kw" and tok.value in ("true", "false", "null")
        ):
            return Literal(self._value())
        if tok.kind == "ident" and tok.value.lower() in WINDOW_FUNCTIONS \
                and self.pos + 1 < len(self.tokens) \
                and self.tokens[self.pos + 1].kind == "op" \
                and self.tokens[self.pos + 1].value == "(":
            return self._window_call()
        if tok.kind == "ident" and tok.value.lower() in SCALAR_FUNCTIONS \
                and self.pos + 1 < len(self.tokens) \
                and self.tokens[self.pos + 1].kind == "op" \
                and self.tokens[self.pos + 1].value == "(":
            name = self.next().value.lower()
            self.expect("op", "(")
            args = [self._arith_expr()]
            while self.accept("op", ","):
                args.append(self._arith_expr())
            self.expect("op", ")")
            return Func(name, args)
        if tok.kind == "ident" and tok.value.lower() == "cast" \
                and self.pos + 1 < len(self.tokens) \
                and self.tokens[self.pos + 1].kind == "op" \
                and self.tokens[self.pos + 1].value == "(":
            # CAST(expr AS type) — the standard spelling every ADBC/BI
            # client emits; the type vocabulary is CREATE TABLE's, plus
            # parameterized forms (varchar(n) length is advisory-ignored,
            # decimal(p,s) maps to a real decimal type)
            self.next()
            self.expect("op", "(")
            e = self._arith_expr()
            self.expect("kw", "as")
            tname = self.ident().lower()
            params: list[int] = []
            if self.accept("op", "("):
                params.append(int(self.expect("number").value))
                while self.accept("op", ","):
                    params.append(int(self.expect("number").value))
                self.expect("op", ")")
            self.expect("op", ")")
            return Func("cast", [e, Literal((tname, tuple(params)))])
        if self._at_temporal_literal():
            # typed temporal literals: TIMESTAMP '2026-07-02 00:00:00',
            # DATE '2026-07-02' (standard SQL; DataFusion accepts the same)
            return Literal(self._temporal_literal())
        if tok.kind == "ident" and tok.value.lower() == "extract" \
                and self.pos + 1 < len(self.tokens) \
                and self.tokens[self.pos + 1].kind == "op" \
                and self.tokens[self.pos + 1].value == "(":
            # EXTRACT(part FROM expr) — the standard spelling; sugar for
            # the part-named scalar function
            self.next()
            self.expect("op", "(")
            part = self.ident().lower()
            if part not in EXTRACT_PARTS:
                raise SqlError(f"EXTRACT part {part!r} not supported")
            self.expect("kw", "from")
            e = self._arith_expr()
            self.expect("op", ")")
            return Func(part, [e])
        qual, name = self._qualified_ident()
        # the qualifier is kept for scope resolution (correlated subqueries
        # decide inner-vs-outer by it); plain evaluation ignores it — names
        # are unique within a working table
        return Column(name, qual=qual)

    def _window_call(self) -> WindowFn:
        name = self.next().value.lower()
        self.expect("op", "(")
        args: list = []
        if name in ("lag", "lead"):
            args.append(self._arith_expr())
            if self.accept("op", ","):
                off = self._value()
                args.append(Literal(int(off)))
                if self.accept("op", ","):
                    args.append(Literal(self._value()))
        self.expect("op", ")")
        part, order = self._over_clause()
        if not order and name != "row_number":
            raise SqlError(f"{name}() requires ORDER BY in its OVER clause")
        return WindowFn(Func(name, args), part, order)

    def _over_clause(self) -> tuple[list[str], list[tuple[str, bool]]]:
        self.expect("kw", "over")
        self.expect("op", "(")
        part: list[str] = []
        order: list[tuple[str, bool]] = []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            part.append(self._qualified_ident()[1])
            while self.accept("op", ","):
                part.append(self._qualified_ident()[1])
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                col = self._qualified_ident()[1]
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order.append((col, desc))
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        return part, order

    def _case_expr(self) -> Case:
        self.expect("kw", "case")
        operand = None
        nxt = self.peek()
        if nxt is not None and not (nxt.kind == "kw" and nxt.value == "when"):
            # simple CASE (`CASE x WHEN v THEN r ...`): desugars to the
            # searched form with equality tests — a NULL operand matches
            # no WHEN (standard SQL equality semantics)
            operand = self._arith_expr()
        whens = []
        default = None
        while self.accept("kw", "when"):
            cond = self._arith_expr() if operand is not None else self._bool_expr()
            self.expect("kw", "then")
            whens.append((cond, self._arith_expr()))
        if self.accept("kw", "else"):
            default = self._arith_expr()
        self.expect("kw", "end")
        if not whens:
            raise SqlError("CASE requires at least one WHEN")
        return Case(whens, default, operand)

    def _substring_expr(self) -> Func:
        self.expect("kw", "substring")
        self.expect("op", "(")
        arg = self._arith_expr()
        # substring(x FROM a FOR b) or substring(x, a, b)
        if self.accept("kw", "from"):
            start = self._arith_expr()
            length = self._arith_expr() if self.accept("kw", "for") else None
        else:
            self.expect("op", ",")
            start = self._arith_expr()
            length = self._arith_expr() if self.accept("op", ",") else None
        self.expect("op", ")")
        return Func("substring", [arg, start, length])

    # ------------------------------------------------------------- where expr
    def _bool_expr(self):
        left = self._bool_term()
        while self.accept("kw", "or"):
            right = self._bool_term()
            if isinstance(left, BoolOp) and left.op == "or":
                left.args.append(right)
            else:
                left = BoolOp("or", [left, right])
        return left

    def _bool_term(self):
        left = self._bool_factor()
        while self.accept("kw", "and"):
            right = self._bool_factor()
            if isinstance(left, BoolOp) and left.op == "and":
                left.args.append(right)
            else:
                left = BoolOp("and", [left, right])
        return left

    def _bool_factor(self):
        if self.accept("kw", "not"):
            return NotOp(self._bool_factor())
        if self.accept("kw", "exists"):
            self.expect("op", "(")
            sub = self.parse_query()
            self.expect("op", ")")
            return Exists(sub)
        if self.peek() and self.peek().kind == "op" and self.peek().value == "(":
            # lookahead: "(bool expr)" vs a parenthesized arith LHS like
            # "(a + b) > c" — try bool first, rewind on failure
            mark = self.pos
            self.next()
            try:
                e = self._bool_expr()
                self.expect("op", ")")
                nxt = self.peek()
                # "(x)" followed by a comparison means x was an arith LHS
                if not (nxt and nxt.kind == "op" and nxt.value in ("<", "<=", ">", ">=", "=", "!=", "<>")):
                    return e
            except SqlError:
                pass
            self.pos = mark
        return self._predicate()

    _OP_MAP = {"=": "eq", "!=": "ne", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}

    def _predicate(self):
        left = self._arith_expr()
        simple_col = left.name if isinstance(left, Column) else None
        # the written qualifier rides along: correlated-subquery scope
        # resolution needs `o.total` to resolve OUTER even when the inner
        # scope has a same-named column (evaluation still uses bare names)
        simple_qual = left.qual if isinstance(left, Column) else None
        if simple_col is not None and self.accept("kw", "is"):
            negated = bool(self.accept("kw", "not"))
            self.expect("kw", "null")
            return IsNull(simple_col, negated, col_qual=simple_qual)
        if simple_col is not None and self.accept("kw", "between"):
            low = self._arith_expr()
            self.expect("kw", "and")
            high = self._arith_expr()
            if not (isinstance(low, Literal) and isinstance(high, Literal)):
                raise SqlError("BETWEEN bounds must be literals")
            return Between(simple_col, low.value, high.value, col_qual=simple_qual)
        if self.peek() and self.peek().kind == "kw" and self.peek().value == "not":
            self.next()
            if self.accept("kw", "like"):
                if simple_col is None:
                    raise SqlError("LIKE requires a plain column")
                return Like(simple_col, self._string_value(), negated=True,
                            col_qual=simple_qual)
            self.expect("kw", "in")
            node = self._in_tail(simple_col, simple_qual)
            if isinstance(node, InSubquery):
                node.negated = True
                return node
            return NotOp(node)
        if simple_col is not None and self.accept("kw", "like"):
            return Like(simple_col, self._string_value(), col_qual=simple_qual)
        if self.accept("kw", "in"):
            return self._in_tail(simple_col, simple_qual)
        op_tok = self.next()
        if op_tok.kind != "op" or op_tok.value not in self._OP_MAP:
            raise SqlError(f"expected comparison operator, got {op_tok.value!r}")
        op = self._OP_MAP[op_tok.value]
        right = self._arith_expr()
        if simple_col is not None and isinstance(right, Literal):
            return Compare(op, simple_col, right.value, col_qual=simple_qual)
        return Compare(op, "", None, left=left, right=right)

    def _in_tail(self, simple_col: str | None, simple_qual: str | None = None):
        """After IN: either a literal list or a subquery."""
        self.expect("op", "(")
        nxt = self.peek()
        if nxt is not None and nxt.kind == "kw" and nxt.value == "select":
            sub = self.parse_query()
            self.expect("op", ")")
            if simple_col is None:
                raise SqlError("IN (SELECT ...) requires a plain column")
            return InSubquery(simple_col, sub, col_qual=simple_qual)
        vals = [self._value()]
        while self.accept("op", ","):
            vals.append(self._value())
        self.expect("op", ")")
        if simple_col is None:
            raise SqlError("IN list requires a plain column")
        return InList(simple_col, vals, col_qual=simple_qual)

    def _string_value(self) -> str:
        v = self._value()
        if not isinstance(v, str):
            raise SqlError("LIKE pattern must be a string literal")
        return v

    def _at_temporal_literal(self) -> bool:
        nxt = self.peek()
        return (
            nxt is not None and nxt.kind == "ident"
            and nxt.value.lower() in ("timestamp", "date")
            and self.pos + 1 < len(self.tokens)
            and self.tokens[self.pos + 1].kind == "string"
        )

    def _temporal_literal(self):
        """``TIMESTAMP '...'`` / ``DATE '...'`` → datetime/date value — the
        ONE parser for typed temporal literals, shared by expressions and
        INSERT VALUES so the two paths cannot drift."""
        import datetime as _dt

        kind = self.next().value.lower()
        raw = self._value()
        try:
            if kind == "date":
                return _dt.date.fromisoformat(raw)
            return _dt.datetime.fromisoformat(raw)
        except ValueError as e:
            raise SqlError(f"invalid {kind.upper()} literal {raw!r}: {e}")

    def _value_list(self) -> list:
        self.expect("op", "(")
        vals = [self._value()]
        while self.accept("op", ","):
            vals.append(self._value())
        self.expect("op", ")")
        return vals

    def _value(self):
        if self.accept("op", "-"):
            v = self._value()
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise SqlError("unary minus requires a numeric literal")
            return -v
        if self._at_temporal_literal():
            # typed temporal literals in VALUES, same as in expressions
            return self._temporal_literal()
        tok = self.next()
        if tok.kind == "number":
            return float(tok.value) if "." in tok.value else int(tok.value)
        if tok.kind == "string":
            return tok.value[1:-1].replace("''", "'")
        if tok.kind == "kw" and tok.value in ("true", "false"):
            return tok.value == "true"
        if tok.kind == "kw" and tok.value == "null":
            return None
        raise SqlError(f"expected literal, got {tok.value!r}")

    # ---------------------------------------------------------------- others
    def parse_insert(self) -> Insert:
        self.expect("kw", "insert")
        self.expect("kw", "into")
        table = self.ident()
        columns: list[str] = []
        if self.accept("op", "("):
            columns.append(self.ident())
            while self.accept("op", ","):
                columns.append(self.ident())
            self.expect("op", ")")
        nxt = self.peek()
        if nxt is not None and nxt.kind == "kw" and nxt.value == "select":
            return Insert(table, columns, [], select=self.parse_query())
        self.expect("kw", "values")
        rows = [self._value_list()]
        while self.accept("op", ","):
            rows.append(self._value_list())
        return Insert(table, columns, rows)

    def parse_create(self) -> CreateTable:
        self.expect("kw", "create")
        self.expect("kw", "table")
        if_not_exists = False
        if self.accept("kw", "if"):
            self.expect("kw", "not")
            self.expect("kw", "exists")
            if_not_exists = True
        table = self.ident()
        self.expect("op", "(")
        cols = []
        while True:
            name = self.ident()
            type_name = self.ident()
            pk = False
            if self.accept("kw", "primary"):
                self.expect("kw", "key")
                pk = True
            cols.append(ColumnDef(name, type_name.lower(), pk))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        stmt = CreateTable(table, cols, if_not_exists=if_not_exists)
        if self.accept("kw", "partitioned"):
            self.expect("kw", "by")
            self.expect("op", "(")
            stmt.range_partitions.append(self.ident())
            while self.accept("op", ","):
                stmt.range_partitions.append(self.ident())
            self.expect("op", ")")
        if self.accept("kw", "with"):
            self.expect("op", "(")
            while True:
                key = self._value() if self.peek().kind == "string" else self.ident()
                self.expect("op", "=")
                stmt.properties[str(key)] = self._value()
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return stmt

    def parse_drop(self) -> DropTable:
        self.expect("kw", "drop")
        self.expect("kw", "table")
        if_exists = False
        if self.accept("kw", "if"):
            self.expect("kw", "exists")
            if_exists = True
        return DropTable(self.ident(), if_exists)

    def parse_alter(self):
        self.expect("kw", "alter")
        self.expect("kw", "table")
        table = self.ident()
        if self.accept("kw", "set"):
            # ALTER TABLE t SET ('k' = 'v', ...) — TBLPROPERTIES role
            self.expect("op", "(")
            props = {}
            while True:
                key = self._value() if self.peek().kind == "string" else self.ident()
                self.expect("op", "=")
                props[str(key)] = self._value()
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            return AlterSetProperties(table, props)
        self.expect("kw", "add")
        self.expect("kw", "column")
        name = self.ident()
        type_name = self.ident()
        return AlterAddColumn(table, name, type_name.lower())

    def parse_call(self) -> Call:
        self.expect("kw", "call")
        proc = self.ident()
        args: list = []
        if self.accept("op", "("):
            if not self.accept("op", ")"):
                while True:
                    tok = self.peek()
                    if tok is None:
                        raise SqlError("unexpected end of statement in CALL arguments")
                    if tok.kind in ("number", "string") or (
                        tok.kind == "kw" and tok.value in ("true", "false", "null")
                    ):
                        args.append(self._value())
                    else:
                        args.append(self.ident())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
        return Call(proc.lower(), args)

    def parse_update(self) -> Update:
        self.expect("kw", "update")
        table = self.ident()
        self.expect("kw", "set")
        assignments = {}
        while True:
            col = self.ident()
            self.expect("op", "=")
            # full value expressions (SET v = abs(v) + 1), not just literals
            assignments[col] = self._arith_expr()
            if not self.accept("op", ","):
                break
        self.expect("kw", "where")  # whole-table updates must be explicit
        return Update(table, assignments, self._bool_expr())

    def parse_delete(self) -> Delete:
        self.expect("kw", "delete")
        self.expect("kw", "from")
        table = self.ident()
        self.expect("kw", "where")  # whole-table deletes go through DROP/delete_partitions
        return Delete(table, self._bool_expr())

    def parse_show(self) -> ShowTables:
        self.expect("kw", "show")
        self.expect("kw", "tables")
        return ShowTables()

    def parse_describe(self) -> Describe:
        self.expect("kw", "describe")
        return Describe(self.ident())


def inline_ctes(node, ctes: dict, _seen: set | None = None) -> None:
    """Substitute CTE references throughout a query AST: any Select/Join
    whose source name matches a CTE becomes a derived table over the CTE
    body.  Walks every dataclass field (subqueries in WHERE/HAVING/items
    included); shared CTE bodies are visited once."""
    import dataclasses

    if not ctes or not dataclasses.is_dataclass(node) or isinstance(node, Token):
        return
    seen = _seen if _seen is not None else set()
    if id(node) in seen:
        return
    seen.add(id(node))
    if isinstance(node, Select) and node.from_subquery is None and node.table in ctes:
        node.from_subquery = ctes[node.table]
        node.from_alias = node.from_alias or node.table
        node.table = ""
    if isinstance(node, Join) and node.subquery is None and node.table in ctes:
        node.subquery = ctes[node.table]
        node.alias = node.alias or node.table
        node.table = ""
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        for item in (v if isinstance(v, list) else [v]):
            if dataclasses.is_dataclass(item) and not isinstance(item, Token):
                inline_ctes(item, ctes, seen)


def referenced_tables(stmt) -> set[str]:
    """Every catalog table name a parsed statement reads or writes —
    primary FROM tables, JOINed tables, and tables inside derived tables,
    EXISTS / IN / scalar subqueries, set operations, INSERT ... SELECT,
    EXPLAIN bodies, and maintenance CALLs, recursively.

    This is the per-statement RBAC surface: a gateway must check ALL of
    these, not just the primary FROM table, or ``SELECT ... FROM allowed
    JOIN secret`` reads ``secret`` unchecked.  CREATE TABLE targets are
    excluded (the table does not exist yet); CTE names never appear (they
    are inlined into derived tables at parse time); derived tables carry
    ``table == ""``."""
    import dataclasses

    out: set[str] = set()
    seen: set[int] = set()

    def walk(node) -> None:
        if node is None or isinstance(node, (str, bytes, int, float, bool)):
            return
        if isinstance(node, (list, tuple, set, frozenset)):
            for item in node:
                walk(item)
            return
        if isinstance(node, dict):
            for item in node.values():
                walk(item)
            return
        if not dataclasses.is_dataclass(node) or isinstance(node, Token):
            return
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, CreateTable):
            return
        if isinstance(node, Call):
            # compact/rollback/build_vector_index address a table by name in
            # their first argument; clean is warehouse-wide and so has NO
            # per-table surface — gateways must gate it explicitly
            # (LakeSoulFlightServer._check_statement), an empty set here is
            # NOT a grant
            if node.procedure in ("compact", "rollback", "build_vector_index") \
                    and node.args:
                out.add(str(node.args[0]))
            return
        target = getattr(node, "table", None)
        if isinstance(target, str) and target:
            out.add(target)
        for f in dataclasses.fields(node):
            walk(getattr(node, f.name))

    walk(stmt)
    return out


def parse(sql: str):
    return Parser(sql).parse()


def parse_predicate(text: str):
    """Parse a bare WHERE-style boolean expression (``"f > 100 AND id IN
    (1, 2)"``) into the pushdown Filter AST — the string form of
    ``LakeSoulScan.filter``.  Only pushdown-eligible predicates are accepted
    (simple comparisons, IN, BETWEEN, IS NULL, AND/OR/NOT); anything needing
    the general SQL evaluator must go through ``SqlSession``."""
    from lakesoul_tpu_torch.sql.executor import _where_to_filter

    p = Parser(text)
    node = p._bool_expr()
    tok = p.peek()
    if tok is not None:
        raise SqlError(f"trailing input in predicate: {tok.value!r}")
    return _where_to_filter(node)
