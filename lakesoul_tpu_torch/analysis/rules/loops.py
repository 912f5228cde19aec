"""``unstoppable-loop``: a ``while True`` poll loop in a long-running
service layer must consult a stop event or deadline every iteration.

The freshness follower made the shutdown contract explicit: a
follower, worker or service poll loop that sleeps blind (``while True:
...; time.sleep(poll)``) can only be stopped by killing the process — a
fleet drain then leaks a whole poll interval per role, and a test that
forgets the kill hangs the suite.  The settled discipline (compaction
service, scan-plane worker, freshness follower): the idle wait rides the
stop event itself (``stop.wait(poll_interval)``) or the loop condition
consults it, so shutdown latency is bounded by ONE tick.

Scope: ``streaming/``, ``compaction/``, ``scanplane/``, ``freshness/`` —
the layers whose loops outlive a request.  A loop is flagged when it is
``while True:`` (or ``while 1:``), its body contains a blocking sleep
(``time.sleep`` / bare ``sleep``) — the poll-loop signature — and the
body (nested defs excluded) consults nothing that can end it:

- no ``.wait(...)`` / ``.is_set()`` call (event consult),
- no ``if``/``while`` test mentioning a stop/cancel/shutdown/deadline/
  stop-event-shaped identifier,
- no conditional ``raise`` (an attempt-budget loop that raises on
  exhaustion — the scan-plane client's reconnect loop — terminates under
  persistent failure and stays legal).

Data-drain loops without a sleep (``while True: rows = cur.fetchmany();
if not rows: break``) terminate with their input and are not poll loops.
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

SCOPE = ("streaming/", "compaction/", "scanplane/", "freshness/")

_STOP_WORDS = ("stop", "cancel", "shutdown", "deadline", "closing", "done")
_CONSULT_ATTRS = ("wait", "is_set")


def _is_while_true(node: ast.While) -> bool:
    test = node.test
    return isinstance(test, ast.Constant) and test.value in (True, 1)


def _mentions_stop_word(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None:
            low = name.lower()
            if any(w in low for w in _STOP_WORDS):
                return True
    return False


class UnstoppableLoopRule(Rule):
    id = "unstoppable-loop"
    title = "while-True poll loop never consults a stop event/deadline"

    def __init__(self, scope: tuple[str, ...] = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(s in module.relpath for s in self.scope):
            return
        for node in module.walk():
            if not (isinstance(node, ast.While) and _is_while_true(node)):
                continue
            sleeps = False
            consults = False
            for sub in walk_stopping_at_functions(node.body):
                if isinstance(sub, ast.Call):
                    dn = dotted_name(sub.func)
                    if dn in ("time.sleep", "sleep"):
                        sleeps = True
                    if (
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _CONSULT_ATTRS
                    ):
                        consults = True
                elif isinstance(sub, (ast.If, ast.While)) and _mentions_stop_word(
                    sub.test
                ):
                    consults = True
                elif isinstance(sub, ast.Raise):
                    # a raise = attempt budget or hard failure: the loop
                    # ends under persistent failure (the scan-plane
                    # client's reconnect loop shape)
                    consults = True
            if sleeps and not consults:
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    "while-True poll loop sleeps blind: consult a stop"
                    " event/deadline each iteration (idiom:"
                    " stop_event.wait(poll_interval) as the idle wait, or"
                    " a while-not-stop loop condition) so shutdown is"
                    " bounded by one tick",
                )
