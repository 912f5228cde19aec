"""``ad-hoc-retry``: hand-rolled retry loops are banned outside the
resilience layer.

The repo used to carry four independent retry dialects (meta commit's
unseeded ``random.uniform`` sleeps, compaction's bare 3-attempt loop, the
proxy upstreams' ``for _ in range(retries + 1)``, the page cache's
hardcoded backoff constant).  Each invented its own backoff, its own idea
of which errors are worth retrying, and none of them counted attempts or
exhaustion anywhere observable.  ``runtime/resilience.py`` is now the one
place a retry loop may live: every other call site configures a
:class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy` (seeded jitter,
deadlines, ``lakesoul_retry_*`` counters) instead of writing a loop.

Two shapes are flagged, both only inside ``for ... in range(...)`` loops
(the canonical bounded-attempts shape; ``while`` condition polls and
event waits stay legal):

- a ``try`` whose ``except`` handler swallows the error (no top-level
  ``raise``/``return``/``break``) so the loop can go around again — the
  retry loop itself, anchored at the ``for`` line;
- ``time.sleep(...)`` inside such a loop that also contains a ``try`` —
  sleep-based backoff, anchored at the sleep call.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Rule,
    dotted_name,
    walk_stopping_at_functions,
)

# the one module allowed to iterate attempts and sleep between them
_RESILIENCE_MODULE = "runtime/resilience.py"


def _is_range_for(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.For)
        and isinstance(node.iter, ast.Call)
        and dotted_name(node.iter.func) in ("range",)
    )


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """A handler that neither re-raises nor exits the loop at its top level
    lets the ``for`` go around again — the defining move of a retry loop.
    (A conditional ``raise`` buried in an ``if`` still swallows on the
    other branch, which is exactly the not-retryable/retryable split the
    policy's ``classify`` should own.)"""
    return not any(
        isinstance(stmt, (ast.Raise, ast.Return, ast.Break))
        for stmt in handler.body
    )


class AdHocRetryRule(Rule):
    id = "ad-hoc-retry"
    title = "hand-rolled retry loop / sleep backoff outside runtime/resilience.py"

    def __init__(self, scope_exempt: tuple[str, ...] = (_RESILIENCE_MODULE,)):
        self.scope_exempt = scope_exempt

    def check(self, module: Module) -> Iterable[Finding]:
        if any(module.relpath.endswith(m) for m in self.scope_exempt):
            return
        for node in module.walk():
            if not _is_range_for(node):
                continue
            # lexical loop body only; a nested def's body runs elsewhere
            body_nodes = list(walk_stopping_at_functions(node.body))
            tries = [n for n in body_nodes if isinstance(n, ast.Try)]
            swallowing = [
                t for t in tries if any(_handler_swallows(h) for h in t.handlers)
            ]
            if swallowing:
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    "for-range loop swallows exceptions to try again — an "
                    "ad-hoc retry loop; route through "
                    "runtime/resilience.RetryPolicy (seeded backoff, "
                    "deadlines, retry counters)",
                )
            if not swallowing:
                # a re-raising handler (or no handler) means the loop is not
                # retrying; a sleep there is a poll cadence, not backoff
                continue
            for n in body_nodes:
                if (
                    isinstance(n, ast.Call)
                    and dotted_name(n.func) in ("time.sleep", "sleep")
                ):
                    yield Finding(
                        self.id,
                        module.relpath,
                        n.lineno,
                        "sleep-based backoff inside a retry loop — use "
                        "RetryPolicy's backoff schedule instead of "
                        "hand-rolled sleeps",
                    )
