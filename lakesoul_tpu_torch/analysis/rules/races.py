"""Shared-state race rules — the Eraser lockset discipline, statically.

The runtime, the fleet and the services made the stack aggressively
concurrent: heartbeat and pump threads, pool tasks, admission-gated
handler threads.  Nothing before
this module machine-checked the one invariant that keeps all of that
coherent: **a field touched from two thread roots holds one consistent
lock**.  Two rules enforce it, both over the shared thread-root index
(:mod:`~lakesoul_tpu_torch.analysis.threadroots`) and one per-class access
index built once per run:

- ``shared-state-race`` (Eraser's lockset algorithm, lexically): for each
  class, every method's ``self.<field>`` writes (rebinds, ``+=``,
  subscript stores, and container-mutator calls like ``.append``) are
  collected with the set of locks lexically held at the access.  A field
  written from ≥ 2 distinct thread roots whose write locksets intersect
  to ∅ is a race: two threads can interleave mid-update and the field's
  value silently corrupts — the reproducibility killer class (arxiv
  2604.21275) the runtime racecheck hunts dynamically.
- ``racy-check-then-act``: an ``if``/``while`` whose test reads a shared
  mutable container field and whose body mutates it, with no lock held —
  the TOCTOU shape (``if len(self.q) < cap: self.q.append(...)``) that is
  racy even when every individual operation is GIL-atomic.

What counts as "a lock held": ``with self.<attr>:`` where ``<attr>`` was
assigned a ``Lock``/``RLock``/``Condition``/``Semaphore`` anywhere in the
class (a ``Condition(self._mu)`` aliases to ``_mu`` — the wrapped lock IS
the condition's lock, so ``with self._cv:`` and ``with self._mu:`` agree),
``with <module-level lock>:``, or any ``with`` expression whose terminal
name looks lock-shaped (``*lock*``/``*guard*``/``*mutex*``) — the same
heuristic family as ``lock-held-call``.

Known limits, on purpose (low false positives over completeness):
``__init__`` writes are the init phase (Eraser's Virgin→Exclusive states —
construction happens-before publication); nested-function bodies belong to
their own node, so a closure's writes are the runtime detector's job; and
only *resolved* call edges propagate roots, so dynamically dispatched
paths under-report rather than spray.  Fields whose single-writer
invariant is load-bearing carry an inline pragma naming it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import Finding, Project, Rule, dotted_name
from lakesoul_tpu_torch.analysis.threadroots import ThreadRootIndex, thread_roots

# the package scope the repo gate runs with; fixtures override
SCOPE = ("lakesoul_tpu_torch/",)

# terminal callable names whose result is a lock-ish synchronizer
_LOCK_CTOR_TERMINALS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
}

# method calls that mutate their receiver container in place
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft", "remove",
    "clear", "add", "discard", "update", "setdefault", "sort", "reverse",
}

_LOCKISH_NAME_HINTS = ("lock", "guard", "mutex")


@dataclass(frozen=True)
class _Access:
    method: str  # method qname
    terminal: str  # method name as written ("submit")
    attr: str
    kind: str  # "write" | "mutate" | "read"
    line: int
    locks: frozenset
    roots: frozenset


@dataclass(frozen=True)
class _Check:
    """One if/while whose test reads ``attr`` and whose body mutates it."""

    method: str
    terminal: str
    attr: str
    line: int
    locks: frozenset


@dataclass
class _ClassAccesses:
    qname: str
    relpath: str
    name: str
    lock_attrs: set
    container_attrs: set  # attrs the class binds to builtin containers
    accesses: list  # [_Access]
    checks: list  # [_Check]


def _lockish_terminal(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in _LOCKISH_NAME_HINTS)


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _lock_ctor_call(value: ast.expr) -> "tuple[bool, str | None]":
    """``(is lock ctor, aliased self attr)`` for an assignment's RHS.
    ``threading.Condition(self._mu)`` aliases to ``_mu`` — the condition
    *wraps* that lock, it does not introduce a second one."""
    if not isinstance(value, ast.Call):
        return False, None
    name = dotted_name(value.func)
    if name is None:
        return False, None
    terminal = name.rsplit(".", 1)[-1]
    if terminal not in _LOCK_CTOR_TERMINALS and not (
        terminal.lower().endswith("lock") and terminal[:1].isupper()
    ):
        return False, None
    alias = None
    if terminal == "Condition" and value.args:
        alias = _self_attr(value.args[0])
    return True, alias


_CONTAINER_CTOR_TERMINALS = {
    "list", "dict", "set", "deque", "OrderedDict", "defaultdict", "Counter",
}


def _is_container_ctor(value: ast.expr) -> bool:
    """RHS shapes that make an attribute a builtin mutable container — the
    precondition for reading ``.add``/``.update``/… as a *container*
    mutation rather than a domain method on a thread-safe object
    (``self.metrics.add(...)`` must not count)."""
    if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        name = dotted_name(value.func)
        return (name or "").rsplit(".", 1)[-1] in _CONTAINER_CTOR_TERMINALS
    return False


def _module_locks(module) -> set:
    """Module-level names bound to lock constructors (``_POOL_LOCK = …``)."""
    out = set()
    for stmt in module.tree.body:
        if isinstance(stmt, ast.Assign):
            is_lock, _ = _lock_ctor_call(stmt.value)
            if is_lock:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


class _MethodWalker:
    """Collect field accesses (+ check-then-act shapes) in one method body
    with the lexically-held lock tokens at each point.  Nested function
    bodies are skipped — their code runs outside this lock context."""

    def __init__(self, cls: _ClassAccesses, aliases: dict, mod_locks: set,
                 fn, roots: frozenset):
        self.cls = cls
        self.aliases = aliases
        self.mod_locks = mod_locks
        self.fn = fn
        self.roots = roots
        self.terminal = fn.name.rsplit(".", 1)[-1]

    # ----------------------------------------------------------- lock tokens
    def _canonical(self, attr: str) -> str:
        seen = set()
        while attr in self.aliases and attr not in seen:
            seen.add(attr)
            attr = self.aliases[attr]
        return attr

    def _lock_token(self, expr: ast.expr) -> str | None:
        attr = _self_attr(expr)
        if attr is not None:
            if attr in self.cls.lock_attrs:
                return f"self.{self._canonical(attr)}"
            if _lockish_terminal(attr):
                return f"self.{attr}"
            return None
        name = dotted_name(expr)
        if name is None:
            return None
        terminal = name.rsplit(".", 1)[-1]
        if terminal in self.mod_locks or _lockish_terminal(terminal):
            return name
        return None

    # --------------------------------------------------------------- walking
    def walk(self) -> None:
        for stmt in self.fn.node.body:
            self._visit(stmt, frozenset())

    def _record(self, attr: str, kind: str, line: int, held: frozenset) -> None:
        if attr.startswith("__") or attr in self.cls.lock_attrs:
            return
        self.cls.accesses.append(_Access(
            self.fn.qname, self.terminal, attr, kind, line, held, self.roots,
        ))

    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            tokens = set(held)
            for item in node.items:
                self._visit(item.context_expr, held)
                tok = self._lock_token(item.context_expr)
                if tok is not None:
                    tokens.add(tok)
            new = frozenset(tokens)
            for stmt in node.body:
                self._visit(stmt, new)
            return
        if isinstance(node, (ast.If, ast.While)):
            self._visit(node.test, held)
            read = self._attrs_read(node.test)
            mutated = self._attrs_mutated_in(node.body)
            for attr in read & mutated:
                if not held and not attr.startswith("__"):
                    self.cls.checks.append(_Check(
                        self.fn.qname, self.terminal, attr, node.lineno, held,
                    ))
            for stmt in node.body:
                self._visit(stmt, held)
            for stmt in getattr(node, "orelse", []):
                self._visit(stmt, held)
            return
        if isinstance(node, ast.Attribute):
            attr = _self_attr(node)
            if attr is not None:
                kind = (
                    "write" if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                self._record(attr, kind, node.lineno, held)
            self._visit(node.value, held)
            return
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = _self_attr(node.value)
            if attr is not None:
                self._record(attr, "mutate", node.lineno, held)
            for child in ast.iter_child_nodes(node):
                self._visit(child, held)
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr is not None and attr in self.cls.container_attrs:
                    self._record(attr, "mutate", node.lineno, held)
            for child in ast.iter_child_nodes(node):
                self._visit(child, held)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    # ----------------------------------------------- check-then-act helpers
    def _attrs_read(self, test: ast.expr) -> set:
        out = set()
        for sub in ast.walk(test):
            attr = _self_attr(sub)
            if attr is not None:
                out.add(attr)
        return out

    def _attrs_mutated_in(self, body: list) -> set:
        out = set()
        stack: list[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # nested defs run elsewhere
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                self._lock_token(item.context_expr) is not None
                for item in node.items
            ):
                continue  # the act happens under a lock — not the TOCTOU
                # shape; non-lock context managers (open(), suppress())
                # don't shield their bodies
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in _MUTATORS:
                    attr = _self_attr(node.func.value)
                    if attr is not None and attr in self.cls.container_attrs:
                        out.add(attr)
            if isinstance(node, ast.Subscript) and isinstance(node.ctx, (ast.Store, ast.Del)):
                attr = _self_attr(node.value)
                if attr is not None:
                    out.add(attr)
            if isinstance(node, ast.Attribute) and isinstance(node.ctx, (ast.Store, ast.Del)):
                attr = _self_attr(node)
                if attr is not None:
                    out.add(attr)
            stack.extend(ast.iter_child_nodes(node))
        return out


def _class_index(project: Project, scope: tuple) -> "dict[str, _ClassAccesses]":
    """Per-class access index, built once per (project, scope) and shared by
    both rules (the walk over every method is the expensive half)."""
    cache = project._race_index
    if cache is None:
        cache = project._race_index = {}
    hit = cache.get(scope)
    if hit is not None:
        return hit

    graph = project.callgraph()
    idx: ThreadRootIndex = thread_roots(project)
    mod_locks_by_rel = {
        m.relpath: _module_locks(m) for m in project.modules
    }
    out: dict[str, _ClassAccesses] = {}
    for cq, cls in graph.classes.items():
        if not any(s in cls.relpath for s in scope):
            continue
        # lock attributes + condition aliases, over every method (usually
        # __init__, but lazily-created locks count too)
        lock_attrs: set = set()
        aliases: dict = {}
        container_attrs: set = set()
        for mq in cls.methods.values():
            fn = graph.functions[mq]
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                is_lock, alias = _lock_ctor_call(node.value)
                is_container = _is_container_ctor(node.value)
                if not is_lock and not is_container:
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if is_lock:
                        lock_attrs.add(attr)
                        if alias is not None:
                            aliases[attr] = alias
                    else:
                        container_attrs.add(attr)
        acc = _ClassAccesses(
            cq, cls.relpath, cls.name, lock_attrs, container_attrs, [], []
        )
        for mname, mq in cls.methods.items():
            if mname == "__init__":
                continue  # init phase: construction happens-before publication
            fn = graph.functions[mq]
            _MethodWalker(
                acc, aliases, mod_locks_by_rel.get(cls.relpath, set()),
                fn, idx.roots_of(mq),
            ).walk()
        out[cq] = acc
    cache[scope] = out
    return out


def _render_roots(roots: Iterable[str]) -> str:
    return ", ".join(sorted(ThreadRootIndex.render(r) for r in roots))


class SharedStateRaceRule(Rule):
    id = "shared-state-race"
    title = "field written from ≥2 thread roots with no common lock"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        for cls in _class_index(project, self.scope).values():
            by_field: dict[str, list[_Access]] = {}
            for a in cls.accesses:
                by_field.setdefault(a.attr, []).append(a)
            for attr, accs in sorted(by_field.items()):
                writes = [a for a in accs if a.kind in ("write", "mutate")]
                if not writes:
                    continue
                write_roots = frozenset().union(*(a.roots for a in writes))
                if len(write_roots) < 2:
                    continue
                lockset = writes[0].locks
                for a in writes[1:]:
                    lockset &= a.locks
                if lockset:
                    continue
                anchor = min(
                    (a for a in writes if not a.locks),
                    key=lambda a: a.line,
                    default=min(writes, key=lambda a: a.line),
                )
                methods = ", ".join(sorted({a.terminal for a in writes}))
                yield Finding(
                    self.id,
                    cls.relpath,
                    anchor.line,
                    f"field self.{attr} of {cls.name} is written from "
                    f"{len(write_roots)} thread roots "
                    f"({_render_roots(write_roots)}) via {methods} with no "
                    "common lock — interleaved updates silently corrupt it; "
                    "hold one lock at every write or make the field "
                    "single-writer (pragma naming the invariant)",
                )


class RacyCheckThenActRule(Rule):
    id = "racy-check-then-act"
    title = "read-test-then-mutate on a shared container outside any lock"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        for cls in _class_index(project, self.scope).values():
            # a field is a shared mutable container when it is container-
            # mutated at all and its accesses span ≥2 roots
            shared: set[str] = set()
            by_field: dict[str, list[_Access]] = {}
            for a in cls.accesses:
                by_field.setdefault(a.attr, []).append(a)
            for attr, accs in by_field.items():
                if not any(a.kind == "mutate" for a in accs):
                    continue
                roots = frozenset().union(*(a.roots for a in accs))
                if len(roots) >= 2:
                    shared.add(attr)
            seen: set[tuple] = set()
            for c in cls.checks:
                if c.attr not in shared:
                    continue
                key = (c.method, c.attr, c.line)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    self.id,
                    cls.relpath,
                    c.line,
                    f"{c.terminal} tests self.{c.attr} and then mutates it "
                    "with no lock held — a concurrent mutation can land "
                    "between the check and the act (TOCTOU); hold the "
                    "class lock across both",
                )
