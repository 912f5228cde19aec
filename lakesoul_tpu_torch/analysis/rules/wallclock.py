"""``wall-clock-lease``: ``time.time()`` arithmetic is banned in TTL /
deadline / lease math across the coordination-bearing layers.

The lease table makes clocks load-bearing: a compaction service that
computes "is my lease still valid" or "has this deadline passed" from
``time.time()`` is one NTP step away from either abandoning a healthy
lease or trusting a dead one.  The discipline the topology layer settled
on:

- **Local** validity windows, renewal cadences, and shutdown/drain
  deadlines use ``time.monotonic()`` — immune to wall-clock jumps.
- **Cross-process** lease expiry lives in the store on ITS shared
  timebase (``meta.entity.now_millis``); no in-process wall-clock
  comparison ever decides correctness — the fencing token does.
- Wire formats whose spec *is* epoch seconds (JWT ``exp``, RFC 7519)
  keep the wall clock behind a justified pragma.

Scope: ``service/``, ``compaction/``, ``meta/`` — the layers that hold
leases, serve tokens, or sweep by age.  A ``time.time()`` call is flagged
when the statement it sits in also mentions a TTL/deadline/lease-shaped
identifier (``ttl``, ``deadline``, ``lease``, ``expire``/``expiry``,
``timeout``) — the co-occurrence that marks duration math, while plain
epoch *timestamps* (``now_millis``-style stamping) stay legal.  For
compound statements (``while``/``if``/``for``) only the controlling
expression is considered, not the body.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Module, Rule, dotted_name

SCOPE = ("service/", "compaction/", "meta/", "scanplane/", "freshness/")

_KEYWORDS = ("ttl", "deadline", "lease", "expire", "expiry", "timeout")


def _controlling_expr(stmt: ast.stmt) -> ast.AST:
    """The part of a compound statement whose identifiers count: the test
    of a While/If, the iterable of a For — never the body (nested
    statements get their own check)."""
    if isinstance(stmt, (ast.While, ast.If)):
        return stmt.test
    if isinstance(stmt, ast.For):
        return stmt.iter
    return stmt


def _mentions_keyword(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None:
            low = name.lower()
            if any(k in low for k in _KEYWORDS):
                return True
    return False


class WallClockLeaseRule(Rule):
    id = "wall-clock-lease"
    title = "time.time() in TTL/deadline/lease arithmetic (use time.monotonic())"

    def __init__(self, scope: tuple[str, ...] = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(s in module.relpath for s in self.scope):
            return
        parents = module.parents()
        for node in module.walk():
            if not (
                isinstance(node, ast.Call)
                and dotted_name(node.func) == "time.time"
            ):
                continue
            stmt: ast.AST = node
            while stmt in parents and not isinstance(stmt, ast.stmt):
                stmt = parents[stmt]
            if not isinstance(stmt, ast.stmt):
                continue
            if _mentions_keyword(_controlling_expr(stmt)):
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    "time.time() used in TTL/deadline/lease math — wall-clock"
                    " jumps (NTP) corrupt it; use time.monotonic() for local"
                    " windows (cross-process lease expiry belongs in the"
                    " store via meta.entity.now_millis)",
                )
