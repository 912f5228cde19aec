"""Small forward dataflow / taint framework over the call graph.

The security rules need to answer "can a request-derived string reach a
filesystem call without passing the sanitizer?" — a question about *flows*,
not single statements.  This module implements the minimal machinery for
that, tuned for low false positives rather than completeness:

- **Sources** are attribute reads (``self.path``, ``self.headers``,
  ``self.rfile``) plus instance attributes that any method of the class
  assigns from a tainted value (``self._query`` built from the URL —
  computed as a per-class fixpoint, flow-insensitive across methods).
- **Propagation** follows assignments, f-strings/concat/``%``, subscripts
  and attribute reads *of tainted values*, method calls on tainted
  receivers (``tainted.get(...)``), known string helpers
  (``urllib.parse.unquote`` …), and tuple unpacking.  A call whose callee
  is *not* a known propagator returns CLEAN (``int(...)`` launders by
  converting; a linter that tainted every call result would drown the
  gate in noise) — except project-resolved callees, which are analyzed.
- **Sanitizers** clear taint three ways: ``x = sanitize(y)`` (clean return
  value), ``if sanitize(x): <x clean here>`` (guard), and
  ``if not sanitize(x): return/raise`` (early-exit guard — x clean after).
- **Interprocedural**: a tainted argument to a call-graph-resolved project
  function analyzes the callee with that parameter tainted (memoized,
  depth-bounded); sink hits inside the callee are reported with the call
  chain, and tainted returns flow back to the caller.

Nested function bodies are skipped (they execute outside the analyzed
flow); a tainted value captured by a closure is out of scope here, as are
taints stored into containers (``lst.append(tainted)``).  Those are
recorded limitations, not silent ones — see ARCHITECTURE.md §Analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from lakesoul_tpu_torch.analysis.callgraph import CallGraph, FuncInfo, iter_calls_in_order
from lakesoul_tpu_torch.analysis.engine import dotted_name

__all__ = ["TaintConfig", "SinkHit", "TaintAnalysis"]

_MAX_DEPTH = 4

# calls that pass string taint through (terminal dotted-name match)
_PROPAGATOR_CALLS = {
    "str", "repr", "format",
    "urllib.parse.unquote", "parse.unquote", "unquote",
    "urllib.parse.quote", "parse.quote", "quote",
    "urllib.parse.urlsplit", "parse.urlsplit", "urlsplit",
    "urllib.parse.urlparse", "parse.urlparse", "urlparse",
    "urllib.parse.parse_qs", "parse.parse_qs", "parse_qs",
    "urllib.parse.parse_qsl", "parse.parse_qsl", "parse_qsl",
    "os.path.join", "posixpath.join", "ntpath.join",
    "os.path.normpath", "posixpath.normpath",
    "sorted", "list", "tuple", "reversed",
}


@dataclass
class TaintConfig:
    """What a rule considers source, sanitizer, and sink.

    Two lattice policies share this machinery.  The *string-taint* rules
    (path traversal) use the defaults: unknown calls launder (``int(x)``
    converts), self-attr reads are the sources.  The *value-tracking*
    rules (device arrays, 64-bit dtypes) invert both knobs:
    ``propagate_all_calls`` keeps taint flowing through the jnp ops that
    make up traced code, ``attr_sanitizers`` (``.shape``/``.dtype``) are
    the only reads that step a device value back down to a static host
    value, and ``source_call_predicate``/``receiver_sinks`` let a rule
    taint call *results* (``np.asarray(x, np.int64)``) and flag tainted
    *receivers* (``x.item()``)."""

    # self.<attr> reads that are taint roots
    source_self_attrs: frozenset[str] = frozenset({"path", "headers", "rfile"})
    # terminal callable names that return/prove clean values
    sanitizers: frozenset[str] = frozenset()
    sanitizer_prefixes: tuple[str, ...] = ("sanitize",)
    # terminal NAME calls → index of the path-like positional arg
    sink_functions: dict = field(default_factory=dict)
    # attribute calls (any receiver) → index of the path-like positional arg
    #   the receiver itself is never the sink (fs.open(p): p is, fs is not)
    sink_methods: dict = field(default_factory=dict)
    # keyword names that are sinks on those same calls
    sink_keywords: frozenset[str] = frozenset()
    # full dotted-name calls → index of the sink positional arg
    # (``np.asarray`` must sink while ``jnp.asarray`` stays a device op —
    # terminal-name matching cannot tell them apart)
    sink_calls: dict = field(default_factory=dict)
    # terminal names where EVERY positional argument is a sink (calls into
    # jit entry points: any tainted arg crosses the device boundary)
    sink_all_args_names: frozenset[str] = frozenset()
    # attribute READS on a tainted base that return a clean value
    # (x.shape, x.dtype: static metadata of a device value)
    attr_sanitizers: frozenset[str] = frozenset()
    # method calls whose TAINTED RECEIVER is itself the sink (x.item())
    receiver_sinks: frozenset[str] = frozenset()
    # predicate(call, dotted_name) → True when the call RESULT is a source
    # (np.float64(...), np.asarray(x, dtype=np.int64), ...)
    source_call_predicate: "object | None" = None
    # unknown calls with tainted args return tainted (device-value lattice:
    # every jnp op keeps the result on device) instead of laundering
    propagate_all_calls: bool = False

    def is_sanitizer(self, terminal: str) -> bool:
        return terminal in self.sanitizers or any(
            terminal.lstrip("_").startswith(p) for p in self.sanitizer_prefixes
        )


@dataclass(frozen=True)
class SinkHit:
    """A tainted expression reaching a sink argument."""

    relpath: str
    line: int
    sink: str  # rendered call text ("filesystem_for")
    source_desc: str  # what was tainted ("self._query['uploadId']")
    chain: tuple[str, ...]  # function names from entry to the sink's owner


class _FuncState:
    """Per-analysis mutable environment for one function body walk."""

    def __init__(self, tainted: set[str], attr_sink: "set[str] | None" = None):
        self.tainted = tainted  # local names currently tainted
        # when set, `self.<attr> = <tainted>` assignments record the attr
        # here (the class-attribute fixpoint); shared across branch copies
        # on purpose — attr taint is additive across paths
        self.attr_sink = attr_sink

    def copy(self) -> "_FuncState":
        return _FuncState(set(self.tainted), self.attr_sink)


class TaintAnalysis:
    """Run taint over the functions of the modules in ``scope``."""

    def __init__(self, graph: CallGraph, config: TaintConfig):
        self.graph = graph
        self.config = config
        # (qname, frozenset tainted params) → (returns_tainted, [SinkHit])
        self._summaries: dict[tuple, tuple[bool, list[SinkHit]]] = {}
        self._in_progress: set[tuple] = set()
        # class qname → names of tainted instance attributes
        self._class_attrs: dict[str, frozenset[str]] = {}
        # qname → {id(call node): edge} — resolved per function ONCE; a
        # linear edge scan per lookup would make the walk O(calls²)
        self._edges_by_node: dict[str, dict[int, object]] = {}
        # id(expr) → [ast.Call] in source order — the sink scan visits the
        # same statement expressions once per fixpoint pass AND once per
        # memoized call-site summary; re-walking the subtree each time
        # dominated the read-modify-write rule's wall time (the AST nodes
        # live as long as the Project, so id() keys are stable)
        self._calls_cache: dict[int, list] = {}
        # qname → whether the function body lexically contains a raw taint
        # source (a source_self_attrs read or a source_call_predicate hit).
        # With no tainted parameters, taint can ONLY enter through one of
        # those (a call with clean arguments never returns taint — see
        # _call_tainted), so source-free functions are skipped by both the
        # attr fixpoint and the entry pass.
        self._has_source: dict[str, bool] = {}

    # ------------------------------------------------------------- entry

    def run(self, scope: tuple[str, ...]) -> list[SinkHit]:
        # converge every in-scope class's attribute-taint fixpoint FIRST,
        # then drop summaries memoized against the not-yet-converged sets —
        # the checking pass must see only final attr taint
        for fn in self.graph.functions_in(scope):
            self._tainted_attrs(fn.class_qname)
        self._summaries.clear()
        hits: list[SinkHit] = []
        for fn in self.graph.functions_in(scope):
            # a function with no tainted params acquires taint only from a
            # lexical source or a tainted attr of its own class — everything
            # else is summary-clean by construction and need not be walked
            if not self._raw_source_in(fn) and not self._tainted_attrs(
                fn.class_qname
            ):
                continue
            _, fn_hits = self._analyze(fn, frozenset(), depth=0)
            hits.extend(fn_hits)
        # dedupe: the same sink inside a shared helper is reported once per
        # (location, source), keeping the shortest chain
        best: dict[tuple, SinkHit] = {}
        for h in hits:
            key = (h.relpath, h.line, h.sink)
            if key not in best or len(h.chain) < len(best[key].chain):
                best[key] = h
        return sorted(best.values(), key=lambda h: (h.relpath, h.line))

    def analyze_entry(self, qname: str,
                      tainted_params: frozenset[str]) -> list[SinkHit]:
        """Analyze ONE function with the given parameters tainted — the
        entry form the device rules use (a jit boundary's array arguments
        are the sources, not any self-attribute)."""
        fn = self.graph.functions[qname]
        _, hits = self._analyze(fn, tainted_params, depth=0)
        return hits

    # ---------------------------------------------------- class attr taint

    def _tainted_attrs(self, class_qname: str | None) -> frozenset[str]:
        """Instance attributes assigned from tainted values anywhere in the
        class — fixpoint over methods so ``self._query`` (built from
        ``self.path``) taints its readers in *other* methods."""
        if class_qname is None:
            return frozenset()
        hit = self._class_attrs.get(class_qname)
        if hit is not None:
            return hit
        self._class_attrs[class_qname] = frozenset()  # cycle guard
        methods = [
            f for f in self.graph.functions.values()
            if f.class_qname == class_qname
        ]
        if not any(self._raw_source_in(f) for f in methods):
            # attr taint must START at a lexical source in SOME method of
            # the class (the fixpoint begins with zero tainted attrs and a
            # clean-arg call never returns taint) — a source-free class
            # converges to ∅ without the 8-pass walk
            return frozenset()
        attrs: set[str] = set()
        for _ in range(8):  # fixpoint: attr taint can chain attr→attr
            before = set(attrs)
            self._class_attrs[class_qname] = frozenset(attrs)
            for fn in methods:
                # the REAL walker runs the scan: source order, sanitizer
                # guards and clean-reassignment semantics must match the
                # checking pass or `self._x = sanitized` stays tainted
                state = _FuncState(set(), attr_sink=attrs)
                self._walk_block(fn.node.body, fn, state, [], _MAX_DEPTH)
            if attrs == before:
                break
        self._class_attrs[class_qname] = frozenset(attrs)
        return self._class_attrs[class_qname]

    def _raw_source_in(self, fn: FuncInfo) -> bool:
        """Whether ``fn``'s body lexically contains a raw taint source.
        Conservative over-approximation (nested defs are included even
        though the walkers skip them) — used only to SKIP provably clean
        work, never to report."""
        hit = self._has_source.get(fn.qname)
        if hit is not None:
            return hit
        cfg = self.config
        found = False
        for node in ast.walk(fn.node):
            if (
                cfg.source_call_predicate is not None
                and isinstance(node, ast.Call)
                and cfg.source_call_predicate(node, dotted_name(node.func))
            ):
                found = True
                break
            if (
                cfg.source_self_attrs
                and isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in cfg.source_self_attrs
            ):
                found = True
                break
        self._has_source[fn.qname] = found
        return found

    # ------------------------------------------------------ function bodies

    def _analyze(self, fn: FuncInfo, tainted_params: frozenset[str],
                 depth: int) -> tuple[bool, list[SinkHit]]:
        key = (fn.qname, tainted_params)
        hit = self._summaries.get(key)
        if hit is not None:
            return hit
        if key in self._in_progress or depth > _MAX_DEPTH:
            return False, []  # recursion/depth bound: assume clean
        self._in_progress.add(key)
        try:
            state = _FuncState(set(tainted_params))
            hits: list[SinkHit] = []
            returns = self._walk_block(fn.node.body, fn, state, hits, depth)
            result = (returns, hits)
            self._summaries[key] = result
            return result
        finally:
            self._in_progress.discard(key)

    def _walk_block(self, body: list, fn: FuncInfo, state: _FuncState,
                    hits: list[SinkHit], depth: int) -> bool:
        """Walk statements, mutate ``state``, collect sink hits; returns
        True when a ``return``/``yield`` in this block carries taint."""
        returns_tainted = False
        for stmt in body:
            returns_tainted |= self._walk_stmt(stmt, fn, state, hits, depth)
        return returns_tainted

    def _walk_stmt(self, stmt, fn: FuncInfo, state: _FuncState,
                   hits: list[SinkHit], depth: int) -> bool:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return False  # nested bodies run outside this flow
        if isinstance(stmt, ast.If):
            self._check_expr(stmt.test, fn, state, hits, depth)
            then_state = state.copy()
            else_state = state.copy()
            cleaned = self._guard_cleans(stmt.test)
            if cleaned is not None:
                name, positive = cleaned
                if positive:
                    then_state.tainted.discard(name)
                elif _terminates(stmt.body):
                    # `if not sanitize(x): return` — x clean afterwards
                    else_state.tainted.discard(name)
            rt = self._walk_block(stmt.body, fn, then_state, hits, depth)
            re_ = self._walk_block(stmt.orelse, fn, else_state, hits, depth)
            fall_through = []
            if not _terminates(stmt.body):
                fall_through.append(then_state)
            if not _terminates(stmt.orelse):
                fall_through.append(else_state)
            state.tainted = set().union(*(s.tainted for s in fall_through)) \
                if fall_through else set()
            return rt or re_
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._check_expr(stmt.iter, fn, state, hits, depth)
            if self._expr_tainted(stmt.iter, fn, state):
                for n in ast.walk(stmt.target):
                    if isinstance(n, ast.Name):
                        state.tainted.add(n.id)
            rt = False
            for _ in range(2):  # loop-carried taint needs one extra pass
                rt |= self._walk_block(stmt.body, fn, state, hits, depth)
            rt |= self._walk_block(stmt.orelse, fn, state, hits, depth)
            return rt
        if isinstance(stmt, ast.While):
            self._check_expr(stmt.test, fn, state, hits, depth)
            rt = False
            for _ in range(2):
                rt |= self._walk_block(stmt.body, fn, state, hits, depth)
            return rt
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._check_expr(item.context_expr, fn, state, hits, depth)
                if item.optional_vars is not None and self._expr_tainted(
                    item.context_expr, fn, state
                ):
                    for n in ast.walk(item.optional_vars):
                        if isinstance(n, ast.Name):
                            state.tainted.add(n.id)
            return self._walk_block(stmt.body, fn, state, hits, depth)
        if isinstance(stmt, ast.Try):
            rt = self._walk_block(stmt.body, fn, state, hits, depth)
            for handler in stmt.handlers:
                rt |= self._walk_block(handler.body, fn, state, hits, depth)
            rt |= self._walk_block(stmt.orelse, fn, state, hits, depth)
            rt |= self._walk_block(stmt.finalbody, fn, state, hits, depth)
            return rt
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = stmt.value
            if value is None:
                return False
            self._check_expr(value, fn, state, hits, depth)
            tainted = self._expr_tainted(value, fn, state, depth=depth)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for tgt in targets:
                if (
                    state.attr_sink is not None
                    and isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and tainted
                ):
                    state.attr_sink.add(tgt.attr)
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        if tainted:
                            state.tainted.add(n.id)
                        else:
                            state.tainted.discard(n.id)
            return False
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._check_expr(stmt.value, fn, state, hits, depth)
                return self._expr_tainted(stmt.value, fn, state, depth=depth)
            return False
        if isinstance(stmt, ast.Expr):
            self._check_expr(stmt.value, fn, state, hits, depth)
            if isinstance(stmt.value, (ast.Yield, ast.YieldFrom)):
                v = stmt.value.value
                if v is not None and self._expr_tainted(v, fn, state, depth=depth):
                    return True
            return False
        # default: still scan contained expressions for sinks
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._check_expr(node, fn, state, hits, depth)
        return False

    # ----------------------------------------------------------- expressions

    def _guard_cleans(self, test: ast.expr) -> tuple[str, bool] | None:
        """``sanitize(x)`` → (x, True); ``not sanitize(x)`` → (x, False)."""
        positive = True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            positive = False
            test = test.operand
        if not isinstance(test, ast.Call) or not test.args:
            return None
        name = dotted_name(test.func)
        if name is None:
            return None
        if not self.config.is_sanitizer(name.rsplit(".", 1)[-1]):
            return None
        arg = test.args[0]
        if isinstance(arg, ast.Name):
            return arg.id, positive
        return None

    def _expr_tainted(self, expr: ast.expr, fn: FuncInfo, state: _FuncState,
                      *, depth: int = _MAX_DEPTH) -> bool:
        cfg = self.config
        if isinstance(expr, ast.Name):
            return expr.id in state.tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in cfg.attr_sanitizers:
                return False  # static metadata of a tainted value (.shape)
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self":
                if expr.attr in cfg.source_self_attrs:
                    return True
                if expr.attr in self._tainted_attrs(fn.class_qname):
                    return True
                return False
            return self._expr_tainted(base, fn, state, depth=depth)
        if isinstance(expr, ast.Subscript):
            return self._expr_tainted(expr.value, fn, state, depth=depth)
        if isinstance(expr, ast.JoinedStr):
            return any(
                self._expr_tainted(v.value, fn, state, depth=depth)
                for v in expr.values
                if isinstance(v, ast.FormattedValue)
            )
        if isinstance(expr, ast.BinOp):
            return (
                self._expr_tainted(expr.left, fn, state, depth=depth)
                or self._expr_tainted(expr.right, fn, state, depth=depth)
            )
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(
                self._expr_tainted(e, fn, state, depth=depth) for e in expr.elts
            )
        if isinstance(expr, ast.IfExp):
            return (
                self._expr_tainted(expr.body, fn, state, depth=depth)
                or self._expr_tainted(expr.orelse, fn, state, depth=depth)
            )
        if isinstance(expr, ast.BoolOp):
            return any(
                self._expr_tainted(v, fn, state, depth=depth) for v in expr.values
            )
        if isinstance(expr, ast.Starred):
            return self._expr_tainted(expr.value, fn, state, depth=depth)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # coarse: tainted if any referenced name/source inside is tainted
            for node in ast.walk(expr):
                if isinstance(node, ast.Name) and node.id in state.tainted:
                    return True
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and (
                        node.attr in cfg.source_self_attrs
                        or node.attr in self._tainted_attrs(fn.class_qname)
                    )
                ):
                    return True
            return False
        if isinstance(expr, ast.Call):
            return self._call_tainted(expr, fn, state, depth)
        return False

    def _call_tainted(self, call: ast.Call, fn: FuncInfo, state: _FuncState,
                      depth: int) -> bool:
        cfg = self.config
        name = dotted_name(call.func)
        terminal = (name or "").rsplit(".", 1)[-1]
        if cfg.source_call_predicate is not None and cfg.source_call_predicate(
            call, name
        ):
            return True
        if name is not None and cfg.is_sanitizer(terminal):
            return False
        args_tainted = any(
            self._expr_tainted(a, fn, state, depth=depth) for a in call.args
        ) or any(
            kw.value is not None
            and self._expr_tainted(kw.value, fn, state, depth=depth)
            for kw in call.keywords
        )
        # method call on a tainted receiver: tainted.get(...), tainted[0].split()
        if isinstance(call.func, ast.Attribute) and self._expr_tainted(
            call.func.value, fn, state, depth=depth
        ):
            return True
        # "x".join(tainted_parts) — str-constant receiver propagates
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "join"
            and isinstance(call.func.value, ast.Constant)
            and args_tainted
        ):
            return True
        if name in _PROPAGATOR_CALLS and args_tainted:
            return True
        # project function: its return taint is its summary's
        edge_callee = self._resolved_callee(call, fn)
        if edge_callee is not None and args_tainted:
            callee = self.graph.functions[edge_callee]
            tainted_params = self._map_tainted_params(call, callee, fn, state, depth)
            returns, _ = self._analyze(callee, tainted_params, depth + 1)
            return returns
        if cfg.propagate_all_calls and args_tainted:
            return True  # device-value lattice: jnp ops keep taint flowing
        return False

    def _resolved_callee(self, call: ast.Call, fn: FuncInfo) -> str | None:
        # resolve through the graph's edges for this caller (edges keep the
        # ast node, so identity lookup is exact)
        by_node = self._edges_by_node.get(fn.qname)
        if by_node is None:
            by_node = {id(e.node): e for e in self.graph.callees(fn.qname)}
            self._edges_by_node[fn.qname] = by_node
        edge = by_node.get(id(call))
        return edge.callee if edge is not None else None

    def _map_tainted_params(self, call: ast.Call, callee: FuncInfo,
                            fn: FuncInfo, state: _FuncState,
                            depth: int) -> frozenset[str]:
        params = callee.params
        offset = 1 if callee.is_method and params and params[0] in ("self", "cls") \
            else 0
        tainted: set[str] = set()
        for i, a in enumerate(call.args):
            idx = i + offset
            if idx < len(params) and self._expr_tainted(a, fn, state, depth=depth):
                tainted.add(params[idx])
        for kw in call.keywords:
            if kw.arg and kw.arg in params and self._expr_tainted(
                kw.value, fn, state, depth=depth
            ):
                tainted.add(kw.arg)
        return frozenset(tainted)

    # ---------------------------------------------------------------- sinks

    def _calls_in(self, expr: ast.expr) -> list:
        calls = self._calls_cache.get(id(expr))
        if calls is None:
            calls = list(iter_calls_in_order([ast.Expr(value=expr)]))
            self._calls_cache[id(expr)] = calls
        return calls

    def _check_expr(self, expr: ast.expr, fn: FuncInfo, state: _FuncState,
                    hits: list[SinkHit], depth: int) -> None:
        if state.attr_sink is not None:
            # attr-fixpoint pass: its hits are discarded and sink scanning
            # has no effect on taint state — only the checking pass pays
            # for the per-call-site descent
            return
        cfg = self.config
        for call in self._calls_in(expr):
            name = dotted_name(call.func)
            terminal = (name or "").rsplit(".", 1)[-1]
            if (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in cfg.receiver_sinks
                and self._expr_tainted(call.func.value, fn, state, depth=depth)
            ):
                hits.append(SinkHit(
                    fn.relpath, call.lineno, name or terminal,
                    _render(call.func.value), (fn.name,),
                ))
            sink_idx = None
            if isinstance(call.func, ast.Name) and call.func.id in cfg.sink_functions:
                sink_idx = cfg.sink_functions[call.func.id]
            elif isinstance(call.func, ast.Attribute) and call.func.attr in cfg.sink_methods:
                sink_idx = cfg.sink_methods[call.func.attr]
            elif name in cfg.sink_calls:
                sink_idx = cfg.sink_calls[name]
            if sink_idx is not None or terminal in cfg.sink_all_args_names:
                exprs = []
                if terminal in cfg.sink_all_args_names:
                    exprs.extend(call.args)
                    exprs += [kw.value for kw in call.keywords]
                elif sink_idx is not None and sink_idx < len(call.args):
                    exprs.append(call.args[sink_idx])
                exprs += [
                    kw.value for kw in call.keywords
                    if kw.arg in cfg.sink_keywords
                ]
                for arg in exprs:
                    if self._expr_tainted(arg, fn, state, depth=depth):
                        hits.append(SinkHit(
                            fn.relpath, call.lineno, name or terminal,
                            _render(arg), (fn.name,),
                        ))
            # interprocedural: tainted args into a resolved project callee
            callee_q = self._resolved_callee(call, fn)
            if callee_q is not None:
                callee = self.graph.functions[callee_q]
                tainted_params = self._map_tainted_params(
                    call, callee, fn, state, depth
                )
                if tainted_params:
                    _, callee_hits = self._analyze(callee, tainted_params, depth + 1)
                    for h in callee_hits:
                        hits.append(SinkHit(
                            h.relpath, h.line, h.sink, h.source_desc,
                            (fn.name,) + h.chain,
                        ))


def _terminates(body: list) -> bool:
    """Block always leaves the enclosing flow (return/raise/continue/break).
    An absent else-branch falls through (with the entry state) — not
    terminating."""
    if not body:
        return False
    last = body[-1]
    return isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _render(expr: ast.expr) -> str:
    try:
        return ast.unparse(expr)
    except Exception:  # pragma: no cover — unparse covers all 3.9+ nodes
        return "<expr>"
