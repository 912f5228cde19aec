"""Interprocedural security rules for the service gateways.

Both rules exist because the per-function rules cannot see the one
refactor that actually happens in practice: a handler's gate or sanitizer
moving into (or being forgotten by) a helper.

- ``rbac-gate-reachability``: every Flight/FlightSQL handler
  (``do_get``/``do_put``/``do_action``/``do_exchange``) must pass an RBAC
  check (``_check``/``_check_statement``/``_check_warehouse_wide``) on
  every path that transitively reaches a catalog/meta mutation.  The
  analysis is a branch-aware "checked" flag walked over each function with
  bottom-up summaries over the call graph: a helper that always checks
  *establishes* the gate for its caller; a helper that mutates without
  checking propagates the violation up to the handler that can be blamed.
- ``taint-path-segments``: request-derived strings in the storage proxy
  and its upstreams must pass the path sanitizer before reaching any
  filesystem/object-store call — tracked across helper functions via
  :mod:`lakesoul_tpu_torch.analysis.dataflow`.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.callgraph import CallGraph, FuncInfo, iter_calls_in_order
from lakesoul_tpu_torch.analysis.engine import Finding, Project, Rule, dotted_name

__all__ = ["RbacGateReachabilityRule", "TaintPathSegmentsRule"]

# gateway modules whose handlers carry the RBAC obligation
_GATEWAY_SCOPE = ("service/flight.py", "service/flight_sql.py")

_HANDLER_NAMES = frozenset({"do_get", "do_put", "do_action", "do_exchange"})

_CHECK_NAMES = frozenset(
    {"_check", "_check_statement", "_check_warehouse_wide"}
)

# attribute calls that mutate catalog/meta state (meta/client.py commit
# APIs + catalog.py write paths + the staged-writer publish calls).  Within
# the gateway modules these names are unambiguous regardless of receiver —
# the resolver cannot type `self.catalog`, but nothing else there is called
# `commit_data_files`.
_MUTATION_ATTRS = frozenset({
    "create_table", "drop_table", "create_namespace", "drop_namespace",
    "commit_data", "commit_data_files", "update_table_schema",
    "write_arrow", "upsert", "delete_partitions", "delete_where",
    "update_where", "compact", "rollback", "add_columns",
    "canonicalize_partition_descs", "meta_cleanup",
    "checkpoint", "checkpoint_replace",
})


class _Unguarded:
    """One mutation reachable with no check yet on the path."""

    __slots__ = ("relpath", "line", "raw", "chain")

    def __init__(self, relpath: str, line: int, raw: str, chain: tuple[str, ...]):
        self.relpath = relpath
        self.line = line
        self.raw = raw
        self.chain = chain


class _Summary:
    __slots__ = ("establishes", "unguarded")

    def __init__(self, establishes: bool, unguarded: list):
        self.establishes = establishes  # every normal exit passed a check
        self.unguarded = unguarded  # list[_Unguarded] assuming unchecked entry


class RbacGateReachabilityRule(Rule):
    id = "rbac-gate-reachability"
    title = "Flight handler reaches a catalog/meta mutation without RBAC"

    def __init__(
        self,
        scope: tuple[str, ...] = _GATEWAY_SCOPE,
        *,
        handlers: frozenset = _HANDLER_NAMES,
        check_names: frozenset = _CHECK_NAMES,
        mutation_attrs: frozenset = _MUTATION_ATTRS,
    ):
        self.scope = scope
        self.handlers = handlers
        self.check_names = check_names
        self.mutation_attrs = mutation_attrs
        self._memo: dict[str, _Summary] = {}
        self._visiting: set[str] = set()

    def finalize(self, project: Project) -> Iterable[Finding]:
        graph: CallGraph = project.callgraph()
        self._memo.clear()
        self._visiting.clear()
        seen: dict[tuple, Finding] = {}
        for fn in graph.functions_in(self.scope):
            if not fn.is_method or fn.name.rsplit(".", 1)[-1] not in self.handlers:
                continue
            handler = fn.name.rsplit(".", 1)[-1]
            for mut in self._summary(fn, graph).unguarded:
                via = " -> ".join((handler,) + mut.chain)
                finding = Finding(
                    self.id,
                    mut.relpath,
                    mut.line,
                    f"{mut.raw}(...) is reachable from {handler} (via {via}) "
                    "on a path with no RBAC check — every gateway path that "
                    "mutates catalog/meta state must pass _check/"
                    "_check_statement/_check_warehouse_wide first",
                )
                key = (mut.relpath, mut.line, mut.raw, handler)
                seen.setdefault(key, finding)
        return list(seen.values())

    # ----------------------------------------------------------- summaries

    def _summary(self, fn: FuncInfo, graph: CallGraph) -> _Summary:
        hit = self._memo.get(fn.qname)
        if hit is not None:
            return hit
        if fn.qname in self._visiting:
            # recursion: assume the cycle neither checks nor mutates — the
            # acyclic entry into the cycle still gets analyzed
            return _Summary(False, [])
        self._visiting.add(fn.qname)
        try:
            edges_by_node = {id(e.node): e for e in graph.callees(fn.qname)}
            unguarded: list[_Unguarded] = []
            checked_out, _ = self._walk(
                fn.node.body, False, fn, graph, edges_by_node, unguarded
            )
            summary = _Summary(checked_out, unguarded)
            self._memo[fn.qname] = summary
            return summary
        finally:
            self._visiting.discard(fn.qname)

    def _walk(self, body: list, checked: bool, fn: FuncInfo, graph: CallGraph,
              edges_by_node: dict, unguarded: list) -> tuple[bool, bool]:
        """→ (checked at block end, block always terminates)."""
        for stmt in body:
            checked, terminated = self._walk_stmt(
                stmt, checked, fn, graph, edges_by_node, unguarded
            )
            if terminated:
                return checked, True
        return checked, False

    def _walk_stmt(self, stmt, checked: bool, fn: FuncInfo, graph: CallGraph,
                   edges_by_node: dict, unguarded: list) -> tuple[bool, bool]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return checked, False  # nested bodies run outside this flow
        if isinstance(stmt, (ast.Return, ast.Raise)):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                checked = self._eval_calls(
                    [stmt.value], checked, fn, graph, edges_by_node, unguarded
                )
            return checked, True
        if isinstance(stmt, ast.If):
            checked = self._eval_calls(
                [stmt.test], checked, fn, graph, edges_by_node, unguarded
            )
            t_checked, t_term = self._walk(
                stmt.body, checked, fn, graph, edges_by_node, unguarded
            )
            # an absent else is a fall-through branch with the entry state
            # (walking [] returns (checked, False)), so the join below is
            # uniform: checked-after = every LIVE branch checked
            e_checked, e_term = self._walk(
                stmt.orelse, checked, fn, graph, edges_by_node, unguarded
            )
            if t_term and e_term:
                return True, True  # both branches leave; after is unreachable
            live = [c for c, term in ((t_checked, t_term), (e_checked, e_term))
                    if not term]
            return all(live), False
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            head = [stmt.iter] if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                else [stmt.test]
            checked = self._eval_calls(
                head, checked, fn, graph, edges_by_node, unguarded
            )
            # the body may run zero times: mutations inside are evaluated
            # with the entry state, but nothing it establishes survives
            self._walk(stmt.body, checked, fn, graph, edges_by_node, unguarded)
            self._walk(stmt.orelse, checked, fn, graph, edges_by_node, unguarded)
            return checked, False
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            checked = self._eval_calls(
                [i.context_expr for i in stmt.items], checked, fn, graph,
                edges_by_node, unguarded,
            )
            return self._walk(
                stmt.body, checked, fn, graph, edges_by_node, unguarded
            )
        if isinstance(stmt, ast.Try):
            b_checked, _ = self._walk(
                stmt.body, checked, fn, graph, edges_by_node, unguarded
            )
            handler_states = []
            for handler in stmt.handlers:
                h_checked, h_term = self._walk(
                    handler.body, checked, fn, graph, edges_by_node, unguarded
                )
                if not h_term:
                    handler_states.append(h_checked)
            o_checked, _ = self._walk(
                stmt.orelse, b_checked, fn, graph, edges_by_node, unguarded
            )
            out = o_checked if stmt.orelse else b_checked
            # conservative join: the check must have happened on the try
            # path AND every live handler path
            joined = out and all(handler_states)
            return self._walk(
                stmt.finalbody, joined, fn, graph, edges_by_node, unguarded
            ) if stmt.finalbody else (joined, False)
        # plain statement: evaluate its calls in order
        exprs = [n for n in ast.iter_child_nodes(stmt) if isinstance(n, ast.expr)]
        checked = self._eval_calls(
            exprs, checked, fn, graph, edges_by_node, unguarded
        )
        return checked, False

    def _eval_calls(self, exprs: list, checked: bool, fn: FuncInfo,
                    graph: CallGraph, edges_by_node: dict,
                    unguarded: list) -> bool:
        wrapper = [ast.Expr(value=e) for e in exprs if e is not None]
        for call in iter_calls_in_order(wrapper):
            name = dotted_name(call.func)
            terminal = (name or "").rsplit(".", 1)[-1] or (
                call.func.attr if isinstance(call.func, ast.Attribute) else ""
            )
            if terminal in self.check_names:
                checked = True
                continue
            edge = edges_by_node.get(id(call))
            callee_q = edge.callee if edge is not None else None
            if not checked and isinstance(call.func, ast.Attribute) \
                    and call.func.attr in self.mutation_attrs:
                unguarded.append(_Unguarded(
                    fn.relpath, call.lineno, name or call.func.attr, ()
                ))
                continue
            if callee_q is not None:
                callee = graph.functions[callee_q]
                sub = self._summary(callee, graph)
                if not checked:
                    for mut in sub.unguarded:
                        unguarded.append(_Unguarded(
                            mut.relpath, mut.line, mut.raw,
                            (callee.name.rsplit(".", 1)[-1],) + mut.chain,
                        ))
                if sub.establishes:
                    checked = True
        return checked


# --------------------------------------------------------------------- taint


class TaintPathSegmentsRule(Rule):
    id = "taint-path-segments"
    title = "request-derived path reaches the store without the sanitizer"

    _PROXY_SCOPE = (
        "service/storage_proxy.py",
        "service/s3_upstream.py",
        "service/azure.py",
    )

    def __init__(self, scope: tuple[str, ...] = _PROXY_SCOPE, *,
                 extra_sanitizers: frozenset = frozenset()):
        self.scope = scope
        self.extra_sanitizers = extra_sanitizers

    def finalize(self, project: Project) -> Iterable[Finding]:
        from lakesoul_tpu_torch.analysis.dataflow import TaintAnalysis, TaintConfig

        config = TaintConfig(
            source_self_attrs=frozenset({"path", "headers", "rfile"}),
            sanitizers=frozenset({
                "sanitize_path_segments",
                "_upload_id_shape_ok",
                "_safe_upload_id",
                "parse_range",
            }) | self.extra_sanitizers,
            sink_functions={"filesystem_for": 0, "ensure_dir": 0, "open": 0},
            sink_methods={
                "open": 0, "rm": 0, "ls": 0, "find": 0, "size": 0,
                "exists": 0, "cat_file": 0, "pipe_file": 0, "makedirs": 0,
                "mkdir": 0, "request": 1,
            },
            sink_keywords=frozenset({"key"}),
        )
        analysis = TaintAnalysis(project.callgraph(), config)
        for hit in analysis.run(self.scope):
            via = " -> ".join(hit.chain)
            yield Finding(
                self.id,
                hit.relpath,
                hit.line,
                f"request-derived value {hit.source_desc!r} reaches "
                f"{hit.sink}(...) (via {via}) without passing the path "
                "sanitizer — an empty/'.'/'..'/encoded segment would escape "
                "the RBAC-checked table directory",
            )
