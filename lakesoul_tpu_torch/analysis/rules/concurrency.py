"""Concurrency-discipline rules.

The three invariants that keep the threaded data path deadlock- and
race-free:

- ``raw-thread``: all parallelism flows through ``runtime/pool.py`` so the
  host's thread budget stays one knob and ``in_worker()`` can break nested
  blocking submits.  A stray ``ThreadPoolExecutor`` reintroduces exactly the
  oversubscription + nested-pool deadlock class the pool removed.
- ``lock-held-call``: no blocking call (pool submit/result, join, wait,
  sleep, file open) while holding a lock — a worker parked on a lock that a
  blocked submitter holds is the canonical pool deadlock.
- ``sqlite-scope``: sqlite connections/cursors only inside ``meta/store.py``
  whose RLock serializes the shared ``:memory:`` connection (the
  "Cursor needed to be reset" race stays fixed).
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

# the one module allowed to construct raw thread primitives
_POOL_MODULE = "runtime/pool.py"

_THREAD_CTORS = {
    "threading.Thread",
    "Thread",
    "concurrent.futures.ThreadPoolExecutor",
    "futures.ThreadPoolExecutor",
    "ThreadPoolExecutor",
}


class RawThreadRule(Rule):
    id = "raw-thread"
    title = "raw threading.Thread / ThreadPoolExecutor outside runtime/pool.py"

    def check(self, module: Module) -> Iterable[Finding]:
        if module.relpath.endswith(_POOL_MODULE):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _THREAD_CTORS:
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    f"{name}(...) bypasses the shared worker pool "
                    "(runtime/pool.py); use get_pool()/pipeline stages, or "
                    "justify with an inline pragma / baseline entry",
                )


# method names that block the calling thread; attribute calls only, so
# ubiquitous non-blocking names (dict.get, …) stay out
_BLOCKING_METHODS = {"submit", "result", "join", "wait", "sleep"}
_BLOCKING_FUNCS = {"open"}

# receivers whose .join is string/path assembly, never a blocking wait
_JOIN_SAFE_PREFIXES = ("os.path", "posixpath", "ntpath", "pathlib")


def _is_blocking_join(call: ast.Call, receiver: str | None) -> bool:
    """``.join`` is only a blocking wait on thread-like receivers:
    ``str.join``/``os.path.join`` always take positional arguments while
    ``Thread.join`` takes none (timeouts are keyword in this codebase), so
    a positional-arg join is string/path assembly unless the receiver name
    says otherwise."""
    if receiver and any(
        receiver == p or receiver.startswith(p + ".") for p in _JOIN_SAFE_PREFIXES
    ):
        return False
    if not call.args:
        return True
    terminal = (receiver or "").rsplit(".", 1)[-1].lower()
    return any(hint in terminal for hint in ("thread", "proc", "worker", "pump"))


def _is_lock_expr(node: ast.expr) -> bool:
    name = dotted_name(node)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1]
    return "lock" in terminal.lower()


def blocking_call_name(call: ast.Call) -> str | None:
    """The dotted name of a direct blocking call, or None.  Shared by the
    lexical rule and the transitive (call-graph) rule so both agree on what
    "blocking" means — submit/result/join/wait/sleep attribute calls (with
    the join string/path disambiguation) plus bare ``open``."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _BLOCKING_METHODS:
        if isinstance(func.value, ast.Constant):
            return None  # ", ".join(...) — a str method, not a thread
        receiver = dotted_name(func.value)
        if func.attr == "join" and not _is_blocking_join(call, receiver):
            return None
        return dotted_name(func) or func.attr
    if isinstance(func, ast.Name) and func.id in _BLOCKING_FUNCS:
        return func.id
    return None


def _iter_lock_bodies_from(nodes):
    """``(with_node, held_lock_name)`` for the ``with <lock>:`` blocks in
    ``nodes`` — the ONE definition of "a held lock" shared by the lexical
    and transitive rules (divergence here would make them disagree about
    what counts as a critical section)."""
    for node in nodes:
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_names = [
            dotted_name(item.context_expr)
            for item in node.items
            if _is_lock_expr(item.context_expr)
        ]
        if lock_names:
            yield node, lock_names[0]


def iter_lock_bodies(module: Module):
    """Every ``with <lock>:`` block in the module."""
    yield from _iter_lock_bodies_from(module.walk())


class LockHeldCallRule(Rule):
    id = "lock-held-call"
    title = "blocking call or pool.submit while holding a lock"

    def check(self, module: Module) -> Iterable[Finding]:
        for node, held in iter_lock_bodies(module):
            for inner in walk_stopping_at_functions(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                called = blocking_call_name(inner)
                if called is None:
                    continue
                yield Finding(
                    self.id,
                    module.relpath,
                    inner.lineno,
                    f"{called}(...) can block while holding {held} — the "
                    "nested-pool deadlock class; move the blocking work "
                    "outside the critical section",
                )


class TransitiveLockHeldCallRule(Rule):
    """The lexical rule upgraded with call-graph reach: a helper that
    sleeps is just as much a deadlock under a held lock as an inline
    ``sleep`` — and exactly the thing a refactor extracts.  Flags calls in
    a ``with <lock>:`` body whose resolved callee reaches a direct blocking
    call within ``max_hops`` call-graph edges (hop 1 = the callee itself).
    Lexically-direct blocking calls stay the lexical rule's findings."""

    id = "transitive-lock-held-call"
    title = "blocking call reachable through helpers while holding a lock"

    def __init__(self, max_hops: int = 3):
        self.max_hops = max_hops

    def finalize(self, project) -> Iterable[Finding]:
        graph = project.callgraph()
        blocking_memo: dict[str, "tuple[str, int] | None"] = {}

        def direct_blocking(qname: str):
            hit = blocking_memo.get(qname, _UNSET)
            if hit is not _UNSET:
                return hit
            fn = graph.functions[qname]
            found = None
            for call in walk_stopping_at_functions(fn.node.body):
                if isinstance(call, ast.Call):
                    name = blocking_call_name(call)
                    if name is not None:
                        found = (name, call.lineno)
                        break
            blocking_memo[qname] = found
            return found

        for fn in graph.functions.values():
            edges_by_node = {id(e.node): e for e in graph.callees(fn.qname)}
            for with_node, held in iter_lock_bodies_in(fn):
                for inner in walk_stopping_at_functions(with_node.body):
                    if not isinstance(inner, ast.Call):
                        continue
                    edge = edges_by_node.get(id(inner))
                    if edge is None or edge.callee is None:
                        continue
                    chain = self._find_blocking_chain(
                        graph, edge.callee, direct_blocking
                    )
                    if chain is None:
                        continue
                    path = " -> ".join(
                        [edge.raw] + [c.rsplit("::", 1)[-1] for c in chain[0][1:]]
                        + [chain[1]]
                    )
                    yield Finding(
                        self.id,
                        fn.relpath,
                        inner.lineno,
                        f"{edge.raw}(...) reaches {chain[1]}(...) ({path}) "
                        f"within {len(chain[0])} call(s) while holding "
                        f"{held} — the nested-pool deadlock class, one "
                        "refactor away from lock-held-call",
                    )

    def _find_blocking_chain(self, graph, start: str, direct_blocking):
        """BFS over resolved edges: shortest (qnames, blocking_name) chain
        from ``start`` to a function with a direct blocking call, within
        ``max_hops`` functions; None if none."""
        frontier = [(start, [start])]
        seen = {start}
        for _ in range(self.max_hops):
            nxt = []
            for q, path in frontier:
                hit = direct_blocking(q)
                if hit is not None:
                    return path, hit[0]
                if len(path) >= self.max_hops:
                    continue
                for e in graph.callees(q):
                    if e.callee is not None and e.callee not in seen:
                        seen.add(e.callee)
                        nxt.append((e.callee, path + [e.callee]))
            frontier = nxt
            if not frontier:
                break
        return None


_UNSET = object()


def iter_lock_bodies_in(fn):
    """``(with_node, held)`` for with-lock blocks lexically inside ``fn``
    (not inside its nested defs — those bodies belong to the nested
    function's own analysis)."""
    yield from _iter_lock_bodies_from(walk_stopping_at_functions(fn.node.body))


_STORE_MODULE = "meta/store.py"
_SQLITE_MARKERS = {"sqlite3.connect", "sqlite3.Connection", "sqlite3.Cursor"}


class SqliteScopeRule(Rule):
    id = "sqlite-scope"
    title = "direct sqlite use outside the serialized meta/store.py path"

    def check(self, module: Module) -> Iterable[Finding]:
        if module.relpath.endswith(_STORE_MODULE):
            return
        for node in module.walk():
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "sqlite3":
                        yield Finding(
                            self.id,
                            module.relpath,
                            node.lineno,
                            "import sqlite3 outside meta/store.py — all "
                            "sqlite access must go through the store's "
                            "RLock-serialized connection",
                        )
            elif isinstance(node, ast.ImportFrom) and node.module == "sqlite3":
                yield Finding(
                    self.id,
                    module.relpath,
                    node.lineno,
                    "from sqlite3 import … outside meta/store.py — all "
                    "sqlite access must go through the store's "
                    "RLock-serialized connection",
                )
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name in _SQLITE_MARKERS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "cursor"
                    and (dotted_name(node.func) or "").split(".")[-2:-1]
                    in (["conn"], ["connection"], ["db"], ["_conn"], ["_db"])
                ):
                    yield Finding(
                        self.id,
                        module.relpath,
                        node.lineno,
                        f"{name or 'cursor'}(...) outside meta/store.py — "
                        "the shared :memory: connection races without the "
                        "store's RLock (the 'Cursor needed to be reset' bug)",
                    )
