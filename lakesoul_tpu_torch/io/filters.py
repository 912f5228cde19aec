"""Engine-portable filter expressions.

The reference serializes filters once as Substrait plan bytes and re-parses
them in the native core so every engine gets identical semantics
(rust/lakesoul-io/src/filter/parser.rs:15-27).  Two portable encodings are
accepted here:

- the framework's small JSON expression tree (compiled to
  ``pyarrow.compute.Expression`` for pushdown into file scans), and
- **Substrait ExtendedExpression bytes** (``Filter.from_substrait``) — the
  exact wire format external engines emit, deserialized via
  ``pyarrow.substrait``.  Substrait filters are opaque (no column
  introspection), so the reader applies them with conservative pushdown:
  never pre-merge on PK tables, full-width file reads under projection.

Also provides the OR-conjunctive PK-equality analysis used for hash-bucket
pruning (reference: helpers/mod.rs collect_or_conjunctive_filter_expressions,
reader.rs:164-225).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import Any

import pyarrow.compute as pc
import pyarrow.dataset as pads

_COMPARES = {"eq", "ne", "lt", "le", "gt", "ge"}


@dataclass(frozen=True)
class Filter:
    """One node of the filter tree."""

    op: str
    col: str | None = None
    value: Any = None
    args: tuple["Filter", ...] = ()

    # -- construction --------------------------------------------------------
    def __and__(self, other: "Filter") -> "Filter":
        return Filter(op="and", args=(self, other))

    def __or__(self, other: "Filter") -> "Filter":
        return Filter(op="or", args=(self, other))

    def __invert__(self) -> "Filter":
        return Filter(op="not", args=(self,))

    # -- compilation ---------------------------------------------------------
    def to_arrow(self) -> pc.Expression:
        f = pads.field
        if self.op in _COMPARES:
            lhs = f(self.col)
            rhs = pads.scalar(self.value)
            return {
                "eq": lhs == rhs,
                "ne": lhs != rhs,
                "lt": lhs < rhs,
                "le": lhs <= rhs,
                "gt": lhs > rhs,
                "ge": lhs >= rhs,
            }[self.op]
        if self.op == "in":
            return f(self.col).isin(list(self.value))
        if self.op == "is_null":
            return f(self.col).is_null()
        if self.op == "not_null":
            return ~f(self.col).is_null()
        if self.op == "and":
            out = self.args[0].to_arrow()
            for a in self.args[1:]:
                out = out & a.to_arrow()
            return out
        if self.op == "or":
            out = self.args[0].to_arrow()
            for a in self.args[1:]:
                out = out | a.to_arrow()
            return out
        if self.op == "not":
            return ~self.args[0].to_arrow()
        if self.op == "substrait":
            return _substrait_to_expression(self.value)
        raise ValueError(f"unknown filter op {self.op}")

    # -- substrait interop ---------------------------------------------------
    @classmethod
    def from_substrait(cls, data: bytes) -> "Filter":
        """Wrap Substrait ExtendedExpression bytes (the first expression is
        the predicate).  Validated eagerly so bad bytes fail at the API
        boundary, not mid-scan."""
        _substrait_to_expression(data)
        return cls(op="substrait", value=bytes(data))

    def to_substrait(self, schema) -> bytes:
        """Serialize this filter as Substrait ExtendedExpression bytes bound
        to ``schema`` — what this framework hands an external engine (the
        reverse of from_substrait)."""
        import pyarrow.substrait as ps

        if self.op == "substrait":
            return self.value
        return bytes(ps.serialize_expressions([self.to_arrow()], ["filter"], schema))

    # -- serde ---------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self._to_dict())

    def _to_dict(self) -> dict:
        d: dict[str, Any] = {"op": self.op}
        if self.col is not None:
            d["col"] = self.col
        if self.op == "substrait":
            d["substrait_b64"] = base64.b64encode(self.value).decode()
        elif self.value is not None or self.op == "eq":
            d["value"] = _encode_value(self.value)
        if self.args:
            d["args"] = [a._to_dict() for a in self.args]
        return d

    @classmethod
    def from_json(cls, s: str) -> "Filter":
        return cls._from_dict(json.loads(s))

    @classmethod
    def _from_dict(cls, d: dict) -> "Filter":
        if d["op"] == "substrait":
            return cls(op="substrait", value=base64.b64decode(d["substrait_b64"]))
        return cls(
            op=d["op"],
            col=d.get("col"),
            value=_decode_value(d.get("value")),
            args=tuple(cls._from_dict(a) for a in d.get("args", ())),
        )


def _encode_value(v):
    """JSON-portable encoding for non-native scalar types so temporal/decimal
    /binary predicates survive the wire (Flight tickets, checkpointed scans).
    Tagged single-key dicts keep plain values untouched."""
    import datetime
    import decimal

    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    if isinstance(v, datetime.datetime):
        return {"$ts": v.isoformat()}
    if isinstance(v, datetime.date):
        return {"$date": v.isoformat()}
    if isinstance(v, datetime.timedelta):
        # integer math: total_seconds() is a float and drops microseconds
        # once the duration exceeds float64's exact-integer range
        us = (v.days * 86_400 + v.seconds) * 1_000_000 + v.microseconds
        return {"$dur_us": us}
    if isinstance(v, decimal.Decimal):
        return {"$dec": str(v)}
    if isinstance(v, (bytes, bytearray)):
        return {"$b64": base64.b64encode(v).decode()}
    return v


def _decode_value(v):
    import datetime
    import decimal

    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    if isinstance(v, dict) and len(v) == 1:
        ((tag, x),) = v.items()
        if tag == "$ts":
            return datetime.datetime.fromisoformat(x)
        if tag == "$date":
            return datetime.date.fromisoformat(x)
        if tag == "$dur_us":
            return datetime.timedelta(microseconds=x)
        if tag == "$dec":
            return decimal.Decimal(x)
        if tag == "$b64":
            return base64.b64decode(x)
    return v


class col:
    """Filter builder: ``col("id") == 5``, ``col("x").is_in([1,2])``."""

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, v):  # type: ignore[override]
        return Filter(op="eq", col=self.name, value=v)

    def __ne__(self, v):  # type: ignore[override]
        return Filter(op="ne", col=self.name, value=v)

    def __lt__(self, v):
        return Filter(op="lt", col=self.name, value=v)

    def __le__(self, v):
        return Filter(op="le", col=self.name, value=v)

    def __gt__(self, v):
        return Filter(op="gt", col=self.name, value=v)

    def __ge__(self, v):
        return Filter(op="ge", col=self.name, value=v)

    def is_in(self, values):
        return Filter(op="in", col=self.name, value=list(values))

    def is_null(self):
        return Filter(op="is_null", col=self.name)

    def not_null(self):
        return Filter(op="not_null", col=self.name)


def _substrait_to_expression(data: bytes) -> pc.Expression:
    import pyarrow.substrait as ps

    bound = ps.deserialize_expressions(bytes(data))
    if not bound.expressions:
        raise ValueError("substrait payload contains no expressions")
    return next(iter(bound.expressions.values()))


def zone_conjuncts(flt: "Filter | None") -> list[tuple[str, str, Any]]:
    """Simple (col, op, value) conjuncts provably AND-ed at the top of the
    tree — the zone-map contract: each is a NECESSARY condition, so a file
    chunk whose min/max stats refute any one of them cannot contain a
    matching row (LSF chunk skipping; the role of parquet's row-group
    statistics pruning)."""
    out: list[tuple[str, str, Any]] = []
    if flt is None:
        return out
    if flt.op == "and":
        for a in flt.args:
            out.extend(zone_conjuncts(a))
        return out
    if flt.op in _COMPARES and flt.op != "ne" and flt.col is not None:
        out.append((flt.col, flt.op, flt.value))
    elif flt.op == "in" and flt.col is not None:
        out.append((flt.col, "in", list(flt.value)))
    return out


def filter_column_names(flt: "Filter | None") -> set[str] | None:
    """Columns a filter references, or None when unknowable (substrait
    payloads are opaque) — callers must then be conservative: no pre-merge
    pushdown on PK tables, no projection narrowing."""
    if flt is None:
        return set()
    names: set[str] = set()

    def walk(f: Filter) -> bool:
        if f.op == "substrait":
            return False
        if f.col:
            names.add(f.col)
        return all(walk(a) for a in f.args)

    return names if walk(flt) else None


def conjoin(filters: list[Filter]) -> Filter | None:
    if not filters:
        return None
    out = filters[0]
    for f in filters[1:]:
        out = out & f
    return out


def extract_pk_equalities(flt: Filter | None, primary_keys: list[str]) -> list[tuple[str, Any]]:
    """(col, value) pairs a row MUST match one of — the reader prunes hash
    buckets to the values' hashes.  Conforming shapes: a pure OR-tree of PK
    equality / IN nodes (helpers/mod.rs:collect_or_conjunctive_filter_
    expressions), possibly sitting as ONE conjunct of a top-level AND — an
    AND only narrows, so any conforming conjunct alone justifies the prune
    (``id = 7 AND ts > x`` point lookups).  Anything else → [] (no pruning)."""
    if flt is None:
        return []

    def collect(f: Filter) -> list[tuple[str, Any]] | None:
        """The pure OR/eq/in walk; None when the subtree doesn't conform."""
        if f.op == "or":
            out: list[tuple[str, Any]] = []
            for a in f.args:
                sub = collect(a)
                if sub is None:
                    return None
                out.extend(sub)
            return out
        if f.op == "eq" and f.col in primary_keys:
            return [(f.col, f.value)]
        if f.op == "in" and f.col in primary_keys:
            return [(f.col, v) for v in f.value]
        return None

    def conjuncts(f: Filter):
        if f.op == "and":
            for a in f.args:
                yield from conjuncts(a)
        else:
            yield f

    best: list[tuple[str, Any]] = []
    for c in conjuncts(flt):
        got = collect(c)
        if got and (not best or len(got) < len(best)):
            # smallest conforming conjunct = fewest candidate buckets
            # (id IN (1..1000) AND id = 5 must prune on the equality)
            best = got
    return best
