"""Minimal SQL statement model for the metadata-store dialect.

Shared by the isolation rule pack (``rules/isolation.py``), which reads
statements out of the AST, and the runtime interleaving replayer
(``txncheck.py``), which records them at the ``meta/store.py`` execution
boundary.  This is NOT a SQL parser — it is a regex-level classifier for
the one dialect the store emits: single-table INSERT/UPDATE/DELETE/SELECT
with ``?`` placeholders, ``IN (...)`` lists, ``ON CONFLICT`` upserts and
the ``/*row-lock*/`` / ``FOR UPDATE`` row-lock markers.  Known limits, on
purpose: joins, subqueries and OR-trees are not modeled — columns named
anywhere after the first WHERE count as constrained (the loosening
direction: more where-columns means FEWER isolation findings, never
false ones), and values it cannot bind stay unknown rather than guessed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["Statement", "parse_statement", "bind_values"]

_WS_RE = re.compile(r"\s+")
_OP_RE = re.compile(r"^\s*([A-Za-z]+)")
_UPDATE_RE = re.compile(r"^\s*UPDATE\s+([A-Za-z_]\w*)", re.I)
_DELETE_RE = re.compile(r"^\s*DELETE\s+FROM\s+([A-Za-z_]\w*)", re.I)
_INSERT_RE = re.compile(
    r"^\s*INSERT(?:\s+OR\s+(IGNORE|REPLACE))?\s+INTO\s+([A-Za-z_]\w*)\s*(?:\(([^)]*)\))?",
    re.I,
)
_FROM_RE = re.compile(r"\bFROM\s+([A-Za-z_]\w*)", re.I)
_WHERE_SPLIT_RE = re.compile(r"\bWHERE\b", re.I)
_SET_SPLIT_RE = re.compile(r"\bSET\b", re.I)
_CONFLICT_RE = re.compile(r"\bON\s+CONFLICT\s*\(([^)]*)\)", re.I)
_DO_UPDATE_RE = re.compile(r"\bDO\s+UPDATE\b", re.I)
# a column under comparison, or heading an IN list
_WHERE_COL_RE = re.compile(r"([A-Za-z_]\w*)\s*(?:=|<=|>=|<>|!=|<|>|\s+IN\b)", re.I)
# one ordered scan: comparisons and IN lists, so ? slots bind in textual order
_WHERE_TERM_RE = re.compile(
    r"([A-Za-z_]\w*)\s*(=|<=|>=|<>|!=|<|>)\s*(\?|'[^']*'|-?\d+|NULL)"
    r"|([A-Za-z_]\w*)\s+IN\s*\(([^)]*)\)",
    re.I,
)
_ROW_LOCK_RE = re.compile(r"/\*row-lock\*/|\bFOR\s+UPDATE\b", re.I)


@dataclass(frozen=True)
class Statement:
    """One classified SQL statement (pre-``translate_sql`` spelling)."""

    op: str  # "select" | "insert" | "update" | "delete" | "pragma" | "other"
    table: "str | None"
    where_cols: frozenset  # every column constrained after the first WHERE
    set_cols: frozenset  # UPDATE SET targets / INSERT column list
    relative_cols: frozenset  # SET cols whose RHS references themselves (x=x+1)
    or_ignore: bool = False
    or_replace: bool = False
    upsert: bool = False  # ON CONFLICT ... DO UPDATE
    conflict_cols: frozenset = frozenset()
    row_locked: bool = False
    qmark: bool = False
    text: str = ""
    # ordered binding slots: ("where"|"set"|"insert", col, "?"|literal)
    _slots: tuple = field(default=(), repr=False)

    @property
    def is_write(self) -> bool:
        return self.op in ("insert", "update", "delete")


def _split_top_level(text: str) -> "list[str]":
    """Split on commas at paren depth 0 (SET lists, VALUES lists)."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def parse_statement(sql: str) -> "Statement | None":
    """Classify one statement; None when the text is not statement-shaped
    (prefix fragments like ``"INSERT OR IGNORE"`` used by translate_sql)."""
    text = _WS_RE.sub(" ", sql).strip()
    m = _OP_RE.match(text)
    if not m:
        return None
    verb = m.group(1).upper()
    qmark = "?" in text
    row_locked = bool(_ROW_LOCK_RE.search(text))
    slots: list = []

    if verb == "PRAGMA":
        return Statement("pragma", None, frozenset(), frozenset(), frozenset(),
                         qmark=qmark, text=text)

    where_part = ""
    where_split = _WHERE_SPLIT_RE.split(text, maxsplit=1)
    if len(where_split) == 2:
        where_part = where_split[1]
    where_cols = frozenset(c.lower() for c in _WHERE_COL_RE.findall(where_part))
    for m2 in _WHERE_TERM_RE.finditer(where_part):
        if m2.group(1):  # comparison — equality binds, others only consume ?
            kind = "where" if m2.group(2) == "=" else "where-skip"
            slots.append((kind, m2.group(1).lower(), m2.group(3)))
        else:  # IN list — each item binds into the column's value set
            for item in _split_top_level(m2.group(5)):
                slots.append(("where", m2.group(4).lower(), item.strip()))

    if verb == "UPDATE":
        mt = _UPDATE_RE.match(text)
        # "UPDATE SET x: ..." in an error message is prose, not SQL — a
        # table position holding a keyword means this never parsed
        if mt and mt.group(1).lower() in ("set", "where", "from"):
            mt = None
        head = where_split[0]
        set_split = _SET_SPLIT_RE.split(head, maxsplit=1)
        set_cols, relative = set(), set()
        set_slots: list = []
        if len(set_split) == 2:
            for item in _split_top_level(set_split[1]):
                if "=" not in item:
                    continue
                col, rhs = item.split("=", 1)
                col = col.strip().lower()
                rhs = rhs.strip()
                set_cols.add(col)
                if re.search(rf"\b{re.escape(col)}\b", rhs, re.I):
                    relative.add(col)
                set_slots.append(("set", col, rhs))
        return Statement(
            "update", mt.group(1).lower() if mt else None,
            where_cols, frozenset(set_cols), frozenset(relative),
            row_locked=row_locked, qmark=qmark, text=text,
            _slots=tuple(set_slots + slots),
        )

    if verb == "DELETE":
        mt = _DELETE_RE.match(text)
        return Statement(
            "delete", mt.group(1).lower() if mt else None,
            where_cols, frozenset(), frozenset(),
            row_locked=row_locked, qmark=qmark, text=text, _slots=tuple(slots),
        )

    if verb == "INSERT":
        mt = _INSERT_RE.match(text)
        if not mt or not mt.group(2):
            return None  # not statement-shaped (no INTO <table>)
        modifier = (mt.group(1) or "").upper()
        cols = tuple(
            c.strip().lower() for c in (mt.group(3) or "").split(",") if c.strip()
        )
        insert_slots: list = []
        mv = re.search(r"\bVALUES\s*\(", text, re.I)
        if mv and cols:
            depth, i, start = 1, mv.end(), mv.end()
            while i < len(text) and depth:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
            values = _split_top_level(text[start:i - 1])
            if len(values) == len(cols):
                insert_slots = [
                    ("insert", c, v.strip()) for c, v in zip(cols, values)
                ]
        conflict = _CONFLICT_RE.search(text)
        return Statement(
            "insert", mt.group(2).lower(),
            where_cols, frozenset(cols), frozenset(),
            or_ignore=modifier == "IGNORE", or_replace=modifier == "REPLACE",
            upsert=bool(_DO_UPDATE_RE.search(text)),
            conflict_cols=frozenset(
                c.strip().lower() for c in conflict.group(1).split(",")
            ) if conflict else frozenset(),
            row_locked=row_locked, qmark=qmark, text=text,
            _slots=tuple(insert_slots + slots),
        )

    if verb == "SELECT":
        mt = _FROM_RE.search(text)
        return Statement(
            "select", mt.group(1).lower() if mt else None,
            where_cols, frozenset(), frozenset(),
            row_locked=row_locked, qmark=qmark, text=text, _slots=tuple(slots),
        )

    return Statement("other", None, frozenset(), frozenset(), frozenset(),
                     qmark=qmark, text=text)


def bind_values(stmt: Statement, params: tuple) -> "dict[str, dict]":
    """Resolve the statement's per-column values against its parameters.

    Returns ``{"where": {col: {values...}}, "write": {col: {values...}}}``
    where ``write`` covers SET/INSERT columns.  ``?`` slots consume params
    in statement order (SET before WHERE, matching the store's argument
    convention); quoted/numeric literals bind directly; expressions bind
    nothing (the column stays constrained-but-unknown)."""
    out: dict = {"where": {}, "write": {}}
    params = tuple(params or ())
    idx = 0
    for kind, col, val in stmt._slots:
        bound = None
        if val == "?":
            if idx < len(params):
                bound = params[idx]
            idx += 1
        elif re.fullmatch(r"'[^']*'", val):
            bound = val[1:-1]
        elif re.fullmatch(r"-?\d+", val):
            bound = int(val)
        elif val.upper() == "NULL":
            bound = None
        else:
            idx += val.count("?")  # expression: unknown value, keep alignment
            continue
        if kind == "where-skip":
            continue  # non-equality comparison: slot consumed, no key bound
        bucket = "where" if kind == "where" else "write"
        out[bucket].setdefault(col, set()).add(bound)
    return out
