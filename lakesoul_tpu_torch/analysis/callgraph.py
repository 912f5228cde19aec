"""Project-wide call graph over the shared AST walk.

A per-function lint sees one function at a time, so a Flight handler that
mutates the catalog through a helper that skips ``_check()`` lints clean.
This module gives rules whole-program reach: every module's defs (module
functions, class methods, nested functions) become nodes, and every call
site becomes an edge — *resolved* to a node when name/import/self analysis
can pin the target, or recorded as an **unknown** edge (dynamic dispatch,
duck-typed receivers, builtins) so rules can stay conservative instead of
silently wrong.

Resolution is deliberately syntactic, not a type system:

- plain names resolve through the enclosing function's nested defs, the
  module's top-level defs, then ``from x import y`` / ``import x as y``
  bindings into other *project* modules;
- ``ClassName(...)`` resolves to ``ClassName.__init__`` when defined;
- ``self.m(...)`` / ``cls.m(...)`` resolve through the enclosing class,
  then its project-resolvable base classes (the Flight SQL server's
  handlers call ``self._check`` defined on the base gateway class);
- ``modalias.f(...)`` resolves when ``modalias`` is an imported project
  module;
- everything else (``obj.method(...)`` on locals, attribute chains like
  ``self.catalog.create_table``) becomes an unknown edge that keeps the
  receiver text and attribute name, so rules can pattern-match what the
  resolver cannot prove.

Calls inside *nested* function bodies are attributed to the nested
function, not the enclosing one — a closure's body runs later, outside the
lexical context (lock held, RBAC gate passed) being analyzed.

The graph is built once per :class:`~lakesoul_tpu_torch.analysis.engine.Project`
and cached (``Project.callgraph()``); with ~90 files it costs one extra
pass over the already-shared AST walks (~0.2 s, tracked by the
``benchmarks/micro.py lint`` leg's 10 s budget).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from lakesoul_tpu_torch.analysis.engine import Module, Project, dotted_name

__all__ = ["CallEdge", "FuncInfo", "CallGraph", "iter_calls_in_order"]


def _module_dotted(relpath: str) -> str:
    """``lakesoul_tpu_torch/service/flight.py`` → ``lakesoul_tpu_torch.service.flight``."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = p.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def iter_calls_in_order(body: Iterable[ast.stmt]) -> Iterator[ast.Call]:
    """Calls lexically inside ``body`` in source order, NOT descending into
    nested function/lambda bodies (their calls belong to the nested node)."""
    calls: list[ast.Call] = []
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            calls.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return iter(calls)


@dataclass(frozen=True)
class CallEdge:
    """One call site.  ``callee`` is a qualified name (``relpath::Func`` or
    ``relpath::Class.method``) when resolved, else None with ``receiver``/
    ``attr`` preserving what the source said."""

    caller: str
    callee: str | None
    line: int
    col: int
    raw: str  # the dotted callee text as written ("self.catalog.create_table")
    receiver: str | None  # dotted receiver for attribute calls, else None
    attr: str  # terminal name being called ("create_table", "sleep", "f")
    node: ast.Call = field(compare=False, hash=False, repr=False)

    @property
    def resolved(self) -> bool:
        return self.callee is not None


@dataclass
class FuncInfo:
    """One function/method definition node in the graph."""

    qname: str  # "<relpath>::Outer.inner" — '.'-joined def chain
    relpath: str
    name: str  # the chain without the path ("Class.method", "f.helper")
    node: "ast.FunctionDef | ast.AsyncFunctionDef"
    class_qname: str | None  # "<relpath>::Class" for methods
    is_method: bool

    @property
    def params(self) -> list[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
        if a.vararg:
            names.append(a.vararg.arg)
        names += [p.arg for p in a.kwonlyargs]
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names


@dataclass
class _ClassInfo:
    qname: str
    relpath: str
    name: str
    node: ast.ClassDef
    methods: dict[str, str]  # method name → func qname
    base_names: list[str]  # raw base-class dotted names, resolved lazily


class CallGraph:
    """functions: qname → FuncInfo; edges: caller qname → [CallEdge].

    Module-level code is modeled as a pseudo-function ``<relpath>::<module>``
    so import-time calls still have a caller node.
    """

    def __init__(self) -> None:
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, _ClassInfo] = {}
        self.edges: dict[str, list[CallEdge]] = {}
        # module dotted name → relpath (project modules only)
        self._mod_by_dotted: dict[str, str] = {}
        # relpath → {local name: ("mod", dotted) | ("sym", dotted, symbol)}
        self._imports: dict[str, dict[str, tuple]] = {}
        # relpath → {top-level def/class name: qname}
        self._toplevel: dict[str, dict[str, str]] = {}
        self._resolved_bases: dict[str, list[str]] = {}

    # ------------------------------------------------------------- building

    @classmethod
    def build(cls, project: Project) -> "CallGraph":
        g = cls()
        for mod in project.modules:
            g._mod_by_dotted[_module_dotted(mod.relpath)] = mod.relpath
        for mod in project.modules:
            g._collect_defs(mod)
        for mod in project.modules:
            g._collect_edges(mod)
        return g

    def _collect_defs(self, mod: Module) -> None:
        rel = mod.relpath
        self._imports[rel] = imports = {}
        self._toplevel[rel] = top = {}
        pkg = _module_dotted(rel)

        def record_import(node: ast.AST) -> None:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    imports[local] = ("mod", target)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: resolve against this module's package
                    parts = pkg.split(".")
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + ([base] if base else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    imports[local] = ("sym", base, alias.name)

        def walk_defs(body: list[ast.stmt], prefix: str, class_q: str | None) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                    record_import(stmt)
                elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    chain = f"{prefix}.{stmt.name}" if prefix else stmt.name
                    q = f"{rel}::{chain}"
                    self.functions[q] = FuncInfo(
                        q, rel, chain, stmt, class_q, class_q is not None
                    )
                    if not prefix:
                        top[stmt.name] = q
                    if class_q is not None and "." not in chain.removeprefix(
                        class_q.split("::", 1)[1] + "."
                    ):
                        self.classes[class_q].methods.setdefault(stmt.name, q)
                    # nested defs: methods of nested classes / local helpers
                    walk_defs(stmt.body, chain, None)
                elif isinstance(stmt, ast.ClassDef):
                    chain = f"{prefix}.{stmt.name}" if prefix else stmt.name
                    cq = f"{rel}::{chain}"
                    bases = [b for b in (dotted_name(x) for x in stmt.bases) if b]
                    self.classes[cq] = _ClassInfo(cq, rel, chain, stmt, {}, bases)
                    if not prefix:
                        top[stmt.name] = cq
                    walk_defs(stmt.body, chain, cq)
                else:
                    # imports can hide inside try/if at module level
                    for sub in ast.walk(stmt):
                        if isinstance(sub, (ast.Import, ast.ImportFrom)):
                            record_import(sub)

        walk_defs(mod.tree.body, "", None)

    # ------------------------------------------------------------ resolving

    def _lookup_project_symbol(self, dotted_mod: str, symbol: str) -> str | None:
        rel = self._mod_by_dotted.get(dotted_mod)
        if rel is None:
            return None
        q = self._toplevel.get(rel, {}).get(symbol)
        if q is None:
            # re-exported through the target module's own from-imports
            tgt = self._imports.get(rel, {}).get(symbol)
            if tgt and tgt[0] == "sym":
                return self._lookup_project_symbol(tgt[1], tgt[2])
        return q

    def _resolve_local_name(self, rel: str, name: str) -> str | None:
        """Top-level def/class or import binding in module ``rel``."""
        q = self._toplevel.get(rel, {}).get(name)
        if q is not None:
            return q
        tgt = self._imports.get(rel, {}).get(name)
        if tgt is None:
            return None
        if tgt[0] == "sym":
            return self._lookup_project_symbol(tgt[1], tgt[2])
        return None  # a bare module binding is not callable

    def _callable_qname(self, q: str) -> str | None:
        """A resolved symbol as a function node: classes become __init__."""
        if q in self.functions:
            return q
        cls = self.classes.get(q)
        if cls is not None:
            return cls.methods.get("__init__")
        return None

    def class_mro(self, class_qname: str) -> list[str]:
        """The class plus its project-resolvable bases, depth-first (cycles
        guarded).  Non-project bases simply end the walk down that branch."""
        hit = self._resolved_bases.get(class_qname)
        if hit is not None:
            return hit
        out: list[str] = []
        seen: set[str] = set()

        def visit(cq: str) -> None:
            if cq in seen:
                return
            seen.add(cq)
            info = self.classes.get(cq)
            if info is None:
                return
            out.append(cq)
            for base in info.base_names:
                base_q = self._resolve_local_name(info.relpath, base.split(".")[0])
                if base_q is None and "." in base:
                    # modalias.Class base form
                    head, _, tail = base.rpartition(".")
                    tgt = self._imports.get(info.relpath, {}).get(head.split(".")[0])
                    if tgt and tgt[0] == "mod":
                        dotted = tgt[1] + base[len(head.split(".")[0]):-len(tail) - 1]
                        base_q = self._lookup_project_symbol(dotted, tail)
                if base_q is not None and base_q in self.classes:
                    visit(base_q)

        visit(class_qname)
        self._resolved_bases[class_qname] = out
        return out

    def resolve_method(self, class_qname: str, method: str) -> str | None:
        for cq in self.class_mro(class_qname):
            q = self.classes[cq].methods.get(method)
            if q is not None:
                return q
        return None

    def _resolve_call(self, mod: Module, caller: FuncInfo | None, call: ast.Call):
        """→ (callee qname | None, receiver, attr, raw)."""
        func = call.func
        raw = dotted_name(func) or (
            func.attr if isinstance(func, ast.Attribute) else "<dynamic>"
        )
        if isinstance(func, ast.Name):
            name = func.id
            # nested defs of the lexically enclosing chain first
            if caller is not None:
                chain = caller.name.split(".")
                for i in range(len(chain), 0, -1):
                    q = f"{mod.relpath}::{'.'.join(chain[:i])}.{name}"
                    if q in self.functions:
                        return q, None, name, raw
            q = self._resolve_local_name(mod.relpath, name)
            if q is not None:
                q = self._callable_qname(q)
            return q, None, name, raw
        if isinstance(func, ast.Attribute):
            attr = func.attr
            receiver = dotted_name(func.value)
            if (
                isinstance(func.value, ast.Call)
                and isinstance(func.value.func, ast.Name)
                and func.value.func.id == "super"
                and caller is not None
                and caller.class_qname
            ):
                for cq in self.class_mro(caller.class_qname)[1:]:
                    q = self.classes[cq].methods.get(attr)
                    if q is not None:
                        return q, "super()", attr, f"super().{attr}"
                return None, "super()", attr, f"super().{attr}"
            if receiver in ("self", "cls") and caller is not None and caller.class_qname:
                q = self.resolve_method(caller.class_qname, attr)
                return q, receiver, attr, raw
            if receiver is not None:
                head = receiver.split(".")[0]
                bound = self._resolve_local_name(mod.relpath, head)
                if bound is not None and bound in self.classes and "." not in receiver:
                    # ClassName.method(...) — unbound call
                    q = self.resolve_method(bound, attr)
                    return q, receiver, attr, raw
                tgt = self._imports.get(mod.relpath, {}).get(head)
                if tgt and tgt[0] == "mod":
                    dotted = tgt[1] + receiver[len(head):]
                    q = self._lookup_project_symbol(dotted, attr)
                    if q is not None:
                        q = self._callable_qname(q)
                    return q, receiver, attr, raw
            return None, receiver, attr, raw
        return None, None, raw, raw

    def _collect_edges(self, mod: Module) -> None:
        rel = mod.relpath
        module_caller = f"{rel}::<module>"

        def edges_for(caller_q: str, info: FuncInfo | None, body: list[ast.stmt]):
            out = self.edges.setdefault(caller_q, [])
            for call in iter_calls_in_order(body):
                callee, receiver, attr, raw = self._resolve_call(mod, info, call)
                out.append(
                    CallEdge(
                        caller_q, callee, call.lineno, call.col_offset,
                        raw, receiver, attr, call,
                    )
                )

        for q, info in self.functions.items():
            if info.relpath == rel:
                edges_for(q, info, info.node.body)
        edges_for(module_caller, None, mod.tree.body)

    def resolve_reference(self, relpath: str, caller: "FuncInfo | None",
                          dotted: str) -> str | None:
        """Resolve a *reference* to a project function by its dotted source
        text — same lookup order as call resolution (the caller's nested-def
        chain, module top-level, imports, ``modalias.symbol``,
        ``ClassName.method``) but usable where the function is an argument
        (``lax.scan(layer, ...)``) rather than the thing being called.
        Returns a function qname (classes resolve to ``__init__``), else
        None."""
        if not dotted or dotted.startswith(("self.", "cls.")):
            return None
        head, _, rest = dotted.partition(".")
        if not rest:
            if caller is not None:
                chain = caller.name.split(".")
                for i in range(len(chain), 0, -1):
                    q = f"{relpath}::{'.'.join(chain[:i])}.{head}"
                    if q in self.functions:
                        return q
            q = self._resolve_local_name(relpath, head)
            return self._callable_qname(q) if q is not None else None
        bound = self._resolve_local_name(relpath, head)
        if bound is not None and bound in self.classes and "." not in rest:
            return self.resolve_method(bound, rest)
        tgt = self._imports.get(relpath, {}).get(head)
        if tgt and tgt[0] == "mod":
            mod_dotted, _, symbol = (tgt[1] + "." + rest).rpartition(".")
            q = self._lookup_project_symbol(mod_dotted, symbol)
            return self._callable_qname(q) if q is not None else None
        return None

    # ------------------------------------------------------------- querying

    def callees(self, qname: str) -> list[CallEdge]:
        return self.edges.get(qname, [])

    def functions_in(self, relpath_suffixes: tuple[str, ...]) -> list[FuncInfo]:
        return [
            f for f in self.functions.values()
            if any(f.relpath.endswith(s) for s in relpath_suffixes)
        ]

    def reachable(self, start: str, max_hops: int) -> dict[str, list[CallEdge]]:
        """Resolved-edge BFS: reached qname → the edge path that got there
        (shortest, ≤ max_hops edges)."""
        paths: dict[str, list[CallEdge]] = {}
        frontier: list[tuple[str, list[CallEdge]]] = [(start, [])]
        for _ in range(max_hops):
            nxt: list[tuple[str, list[CallEdge]]] = []
            for q, path in frontier:
                for e in self.callees(q):
                    if e.callee is None or e.callee in paths or e.callee == start:
                        continue
                    paths[e.callee] = path + [e]
                    nxt.append((e.callee, path + [e]))
            frontier = nxt
            if not frontier:
                break
        return paths

    def stats(self) -> dict:
        n_edges = sum(len(v) for v in self.edges.values())
        n_resolved = sum(1 for v in self.edges.values() for e in v if e.resolved)
        return {
            "functions": len(self.functions),
            "classes": len(self.classes),
            "edges": n_edges,
            "resolved_edges": n_resolved,
            "unknown_edges": n_edges - n_resolved,
        }
