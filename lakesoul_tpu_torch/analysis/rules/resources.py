"""``unclosed-reader``: pyarrow readers / IPC streams / memory maps must be
closed or context-managed.

A leaked ``pa.memory_map`` pins a file descriptor and the whole mapping
until GC gets around to it; at loader rates (thousands of scan units per
epoch) that is an fd-exhaustion outage, and on Windows an unclosed map
blocks compaction's file replacement.  The LSF reader leaked exactly this
way until this rule flagged it (``LsfFile`` now closes — see io/lsf.py).

Heuristics, in order:

1. constructor used as a ``with`` context manager → fine;
2. chained use-and-drop (``Ctor(...).attr``) or bare expression → flagged;
3. assigned to a local name → the enclosing function must ``close()`` it,
   ``with`` it, wrap it in ``contextlib.closing``, return/yield it
   (ownership transferred), or pass it onward as a call argument;
4. stored on ``self`` → the class must define ``close``/``__exit__``/
   ``__del__`` (someone has to end the object's lifetime deliberately).
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

_CLOSABLE_CTORS = {
    "pa.memory_map",
    "pyarrow.memory_map",
    "pa.OSFile",
    "pyarrow.OSFile",
    "pa.ipc.open_stream",
    "pyarrow.ipc.open_stream",
    "ipc.open_stream",
    "pa.ipc.open_file",
    "pyarrow.ipc.open_file",
    "ipc.open_file",
    "pa.ipc.new_stream",
    "pyarrow.ipc.new_stream",
    "ipc.new_stream",
    "pa.ipc.new_file",
    "pyarrow.ipc.new_file",
    "ipc.new_file",
    "pq.ParquetFile",
    "pyarrow.parquet.ParquetFile",
    "ParquetFile",
    # project-native closable readers
    "LsfFile",
}


def _nearest(parents, node, kinds):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None


def _name_released(scope: ast.AST, name: str) -> bool:
    """True when ``name`` is closed, context-managed, escapes by return/yield,
    or is handed to another call inside ``scope``."""
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "close"
                and dotted_name(func.value) == name
            ):
                return True
            if dotted_name(func) in ("contextlib.closing", "closing") and any(
                dotted_name(a) == name for a in node.args
            ):
                return True
            if any(dotted_name(a) == name for a in node.args):
                return True  # ownership handed onward
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if dotted_name(item.context_expr) == name:
                    return True
        elif isinstance(node, ast.Return) and node.value is not None:
            if dotted_name(node.value) == name:
                return True
        elif isinstance(node, (ast.Yield, ast.YieldFrom)) and node.value is not None:
            if dotted_name(node.value) == name:
                return True
        elif isinstance(node, ast.Assign):
            # re-homed onto self.<attr>: the attribute rule takes over
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and dotted_name(node.value) == name
                ):
                    return True
    return False


def _class_can_close(cls: ast.ClassDef) -> bool:
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name in (
            "close",
            "__exit__",
            "__del__",
        ):
            return True
    return False


class UnclosedReaderRule(Rule):
    id = "unclosed-reader"
    title = "pyarrow reader / IPC stream / memory map never closed"

    def check(self, module: Module) -> Iterable[Finding]:
        parents = module.parents()
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name not in _CLOSABLE_CTORS:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.withitem):
                continue
            msg = (
                f"{name}(...) holds an fd/mapping — close it, use a `with` "
                "block, or transfer ownership explicitly"
            )
            if isinstance(parent, ast.Attribute):
                # Ctor(...).x — used once and dropped; nothing can close it.
                # Exception: footer-only metadata reads that the ctor itself
                # documents as self-closing would be context-managed instead.
                yield Finding(self.id, module.relpath, node.lineno, msg)
                continue
            if isinstance(parent, ast.Expr):
                yield Finding(self.id, module.relpath, node.lineno, msg)
                continue
            if isinstance(parent, ast.Assign):
                tgt = parent.targets[0]
                scope = _nearest(
                    parents, node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) or module.tree
                if isinstance(tgt, ast.Name):
                    if not _name_released(scope, tgt.id):
                        yield Finding(self.id, module.relpath, node.lineno, msg)
                    elif _stored_on_self_without_close(
                        scope, tgt.id, parents, node
                    ):
                        yield Finding(
                            self.id,
                            module.relpath,
                            node.lineno,
                            f"{name}(...) is stored on self but the class "
                            "defines no close()/__exit__/__del__ — the "
                            "mapping lives until GC",
                        )
                elif (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    cls = _nearest(parents, node, (ast.ClassDef,))
                    if cls is not None and not _class_can_close(cls):
                        yield Finding(
                            self.id,
                            module.relpath,
                            node.lineno,
                            f"{name}(...) is stored on self but "
                            f"{cls.name} defines no close()/__exit__/"
                            "__del__ — the mapping lives until GC",
                        )


def _stored_on_self_without_close(scope, name, parents, node) -> bool:
    """Local name later stashed on ``self`` — walk up to the class and apply
    the attribute criterion."""
    stored = False
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and dotted_name(n.value) == name
                ):
                    stored = True
    if not stored:
        return False
    cls = _nearest(parents, node, (ast.ClassDef,))
    return cls is not None and not _class_can_close(cls)


# -------------------------------------------------------- interprocedural


class InterproceduralUnclosedReaderRule(Rule):
    """Ownership *escape* analysis across call boundaries.  The lexical
    rule treats "passed onward as a call argument" and "returned to the
    caller" as ownership transfers and stops — reasonable per-function,
    but wrong in two refactor shapes this rule closes:

    1. a reader handed to a project helper that neither closes, stores,
       returns, nor forwards it (the helper just *drops* it — nobody ever
       owns the fd);
    2. a project function whose contract is "returns an open reader"
       (``LsfFormat._open``) called by a caller that drops the result.

    Unresolvable callees keep the lexical rule's benefit of the doubt."""

    id = "interprocedural-unclosed-reader"
    title = "reader ownership dropped across a call boundary"

    _MAX_FORWARD = 3  # helper → helper → helper forwarding depth

    def finalize(self, project) -> Iterable[Finding]:
        graph = project.callgraph()
        returns_closable = self._returns_closable_set(graph)
        for fn in graph.functions.values():
            yield from self._check_function(fn, graph, returns_closable)

    # ----------------------------------------------------------- summaries

    def _returns_closable_set(self, graph) -> set[str]:
        """Functions whose return value is an open closable (directly, via
        a local name, or by forwarding another returns-closable call)."""
        out: set[str] = set()
        for _ in range(4):  # fixpoint over forwarding chains
            grew = False
            for qname, fn in graph.functions.items():
                if qname in out:
                    continue
                edges_by_node = {id(e.node): e for e in graph.callees(qname)}
                ctor_names = self._closable_local_names(fn)
                for node in walk_stopping_at_functions(fn.node.body):
                    if not isinstance(node, ast.Return) or node.value is None:
                        continue
                    v = node.value
                    if isinstance(v, ast.Call):
                        if dotted_name(v.func) in _CLOSABLE_CTORS:
                            out.add(qname)
                            grew = True
                            break
                        edge = edges_by_node.get(id(v))
                        if edge is not None and edge.callee in out:
                            out.add(qname)
                            grew = True
                            break
                    elif isinstance(v, ast.Name) and v.id in ctor_names:
                        out.add(qname)
                        grew = True
                        break
            if not grew:
                break
        return out

    @staticmethod
    def _closable_local_names(fn) -> set[str]:
        names: set[str] = set()
        for node in walk_stopping_at_functions(fn.node.body):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if dotted_name(node.value.func) in _CLOSABLE_CTORS:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
        return names

    def _param_released(self, graph, qname: str, param: str, depth: int) -> bool:
        """Does the callee give ``param`` an owner?  close/with/return/
        yield/self-store count; forwarding to a *resolved* callee recurses;
        forwarding to an unresolved callee gets the benefit of the doubt."""
        fn = graph.functions.get(qname)
        if fn is None or depth > self._MAX_FORWARD:
            return True  # can't see it — don't guess
        edges_by_node = {id(e.node): e for e in graph.callees(qname)}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "close"
                    and dotted_name(func.value) == param
                ):
                    return True
                if dotted_name(func) in ("contextlib.closing", "closing") and any(
                    dotted_name(a) == param for a in node.args
                ):
                    return True
                forwarded = [
                    i for i, a in enumerate(node.args)
                    if dotted_name(a) == param
                ]
                if forwarded:
                    edge = edges_by_node.get(id(node))
                    if edge is None or edge.callee is None:
                        return True  # unresolved — lexical rule's benefit
                    callee = graph.functions[edge.callee]
                    params = callee.params
                    off = 1 if callee.is_method and params[:1] in (
                        ["self"], ["cls"]
                    ) else 0
                    for i in forwarded:
                        if i + off < len(params) and self._param_released(
                            graph, edge.callee, params[i + off], depth + 1
                        ):
                            return True
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if dotted_name(item.context_expr) == param:
                        return True
            elif isinstance(node, ast.Return) and node.value is not None:
                if dotted_name(node.value) == param:
                    return True
                if isinstance(node.value, (ast.Tuple, ast.List)) and any(
                    dotted_name(e) == param for e in node.value.elts
                ):
                    return True
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) and node.value is not None:
                if dotted_name(node.value) == param:
                    return True
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and dotted_name(node.value) == param
                    ):
                        return True
        return False

    # ------------------------------------------------------------- checking

    def _check_function(self, fn, graph, returns_closable: set[str]):
        edges_by_node = {id(e.node): e for e in graph.callees(fn.qname)}
        # parent map local to this function body
        parents: dict = {}
        for node in ast.walk(fn.node):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        # findings anchor to THIS function's lexical body only — nested
        # defs are their own call-graph nodes and get their own visit
        for node in walk_stopping_at_functions(fn.node.body):
            if not isinstance(node, ast.Call):
                continue
            is_ctor = dotted_name(node.func) in _CLOSABLE_CTORS
            edge = edges_by_node.get(id(node))
            is_factory = (
                edge is not None
                and edge.callee in returns_closable
                and edge.callee != fn.qname
            )
            if not (is_ctor or is_factory):
                continue
            what = dotted_name(node.func) or (
                node.func.attr if isinstance(node.func, ast.Attribute) else "call"
            )
            parent = parents.get(node)
            if isinstance(parent, ast.withitem):
                continue
            if is_factory and isinstance(parent, (ast.Expr, ast.Attribute)):
                # factory result dropped on the floor (lexical rule only
                # knows ctors; the factory's "returns an open reader"
                # contract comes from the call graph)
                yield Finding(
                    self.id,
                    fn.relpath,
                    node.lineno,
                    f"{what}(...) returns an open reader that is dropped — "
                    "close it, `with` it, or pass ownership on",
                )
                continue
            if not isinstance(parent, ast.Assign):
                continue
            tgt = parent.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            name = tgt.id
            scope = fn.node
            released = self._name_released_interproc(
                scope, name, graph, fn, edges_by_node
            )
            if released is False:
                yield Finding(
                    self.id,
                    fn.relpath,
                    node.lineno,
                    f"{what}(...) is handed to a helper that drops it — no "
                    "function in the chain closes, stores, or returns the "
                    "reader, so the fd lives until GC",
                )
            elif released is None and is_factory:
                yield Finding(
                    self.id,
                    fn.relpath,
                    node.lineno,
                    f"{what}(...) returns an open reader that is never "
                    "closed, context-managed, or passed on in this scope",
                )

    def _name_released_interproc(self, scope, name, graph, fn, edges_by_node):
        """True = released; False = provably dropped across a call
        boundary; None = never released at all (no call transfer either)."""
        transferred_calls: list = []
        for node in ast.walk(scope):
            if isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and dotted_name(func.value) == name
                ):
                    if func.attr == "close":
                        return True
                    continue  # method use is not a transfer
                if dotted_name(func) in ("contextlib.closing", "closing") and any(
                    dotted_name(a) == name for a in node.args
                ):
                    return True
                if any(dotted_name(a) == name for a in node.args):
                    transferred_calls.append(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if dotted_name(item.context_expr) == name:
                        return True
            elif isinstance(node, ast.Return) and node.value is not None:
                if dotted_name(node.value) == name:
                    return True
                if isinstance(node.value, (ast.Tuple, ast.List)) and any(
                    dotted_name(e) == name for e in node.value.elts
                ):
                    return True
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) and node.value is not None:
                if dotted_name(node.value) == name:
                    return True
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and dotted_name(node.value) == name
                    ):
                        return True
        if not transferred_calls:
            return None
        for call in transferred_calls:
            edge = edges_by_node.get(id(call))
            if edge is None or edge.callee is None:
                return True  # unresolved callee — benefit of the doubt
            callee = graph.functions[edge.callee]
            params = callee.params
            off = 1 if callee.is_method and params[:1] in (["self"], ["cls"]) \
                else 0
            for i, a in enumerate(call.args):
                if dotted_name(a) == name and i + off < len(params):
                    if self._param_released(
                        graph, edge.callee, params[i + off], 1
                    ):
                        return True
        return False
