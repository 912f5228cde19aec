"""Thread-root inference over the project call graph.

The lockset rules (``rules/races.py``) need to answer "which *threads* can
be executing this method?" — a question the call graph alone cannot: a
``Thread(target=...)`` or ``pool.submit(fn)`` is a *reference*, not a call
edge, yet it is exactly where a second thread of control enters the
program.  This module enumerates the codebase's **thread roots** — every
place the runtime hands a function to another thread — and tags each
function with the set of roots that can reach it:

- ``thread:<entry>`` — ``threading.Thread(target=f)`` (the pipeline pumps,
  the lease heartbeat, the ANN batching worker, server accept loops);
- ``pool:<entry>`` — ``<anything>.submit(f, ...)`` where ``f`` resolves to
  a project function (the shared worker pool's tasks);
- ``pipeline:<entry>`` — functions registered as pipeline stages
  (``.map(f)`` / ``.map_parallel(f)`` / ``.flat_map_parallel(f)``) or as a
  generator source (``.source(f(...))``): stage fns run on pool workers,
  and the source generator's body runs on whichever thread iterates it
  (the prefetch pump);
- ``handler:<entry>`` — ``do_*`` methods (Flight ``do_get``/``do_put``/
  ``do_action``/``do_exchange``, ``http.server`` ``do_GET``/…): the server
  substrate invokes them on its own request threads, so no static edge
  exists.  Classes deriving from ``*HTTPRequestHandler`` get ONE collapsed
  ``handler`` root per class — ``http.server`` constructs a fresh handler
  instance per request, so two verb methods of the same class never share
  instance state across threads (a Flight server instance, by contrast, is
  shared across concurrent RPCs, so each of its verbs is a distinct root);
- ``main`` — reachable from module level or from an uncalled public
  surface (API methods invoked by code outside the package: tests,
  training loops, the console).

Reachability is a BFS over *resolved* call edges from each entry, so a
field write three helpers deep below a pump function still carries the
pump's root.  Calls the resolver cannot pin (dynamic receivers) simply
don't propagate roots — the rules stay conservative (fewer findings), the
known trade of the whole interprocedural layer.

Built once per :class:`~lakesoul_tpu_torch.analysis.engine.Project` and cached
(:func:`thread_roots`), same contract as the call graph and device index.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from lakesoul_tpu_torch.analysis.engine import Project, dotted_name

__all__ = ["MAIN_ROOT", "ThreadRootIndex", "thread_roots"]

MAIN_ROOT = "main"

_THREAD_CTOR_TERMINALS = {"Thread"}
_STAGE_METHODS = {"map", "map_parallel", "flat_map_parallel"}
_HANDLER_RE = re.compile(r"^do_[A-Za-z]\w*$")
# per-request-instance server substrates: one handler object per request,
# so the class's verb methods never race each other on instance state
_PER_REQUEST_BASES = ("HTTPRequestHandler",)


@dataclass
class ThreadRootIndex:
    """``roots``: function qname → frozenset of root labels (``main`` and/or
    ``<kind>:<entry qname>``).  ``entries``: the discovered background
    entries as ``(kind, entry qname)``."""

    entries: set = field(default_factory=set)
    roots: dict = field(default_factory=dict)

    def roots_of(self, qname: str) -> frozenset:
        """Root labels for ``qname``; a function nothing reaches is treated
        as main-callable (public surface the package doesn't call itself)."""
        return self.roots.get(qname) or frozenset((MAIN_ROOT,))

    @staticmethod
    def render(label: str) -> str:
        """``pool:lakesoul_tpu_torch/runtime/pipeline.py::PipelineIterator._run_item``
        → ``pool:PipelineIterator._run_item`` (messages stay readable AND
        stable — no line numbers)."""
        kind, _, entry = label.partition(":")
        if not entry:
            return label
        return f"{kind}:{entry.rsplit('::', 1)[-1]}"


def _resolve_ref(graph, relpath: str, caller, node: "ast.expr | None"):
    """A function *reference* (Thread target, submit arg, stage fn) resolved
    to a project function qname, or None."""
    if node is None:
        return None
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        if caller is not None and caller.class_qname:
            return graph.resolve_method(caller.class_qname, node.attr)
        return None
    name = dotted_name(node)
    if name is None:
        return None
    return graph.resolve_reference(relpath, caller, name)


def _collect_entries(graph) -> set:
    entries: set = set()
    for caller_q, edges in graph.edges.items():
        relpath = caller_q.split("::", 1)[0]
        caller = graph.functions.get(caller_q)  # None for <module>
        for e in edges:
            call = e.node
            if e.attr in _THREAD_CTOR_TERMINALS:
                target = next(
                    (kw.value for kw in call.keywords if kw.arg == "target"),
                    None,
                )
                q = _resolve_ref(graph, relpath, caller, target)
                if q is not None:
                    entries.add(("thread", q))
            elif e.attr == "submit" and call.args:
                q = _resolve_ref(graph, relpath, caller, call.args[0])
                if q is not None:
                    entries.add(("pool", q))
            elif e.attr in _STAGE_METHODS and call.args:
                q = _resolve_ref(graph, relpath, caller, call.args[0])
                if q is not None:
                    entries.add(("pipeline", q))
            elif e.attr == "source" and call.args and isinstance(call.args[0], ast.Call):
                # .source(f(...)): the generator f builds runs on whichever
                # thread iterates the pipeline — the prefetch pump
                q = _resolve_ref(graph, relpath, caller, call.args[0].func)
                if q is not None:
                    entries.add(("pipeline", q))
    for fn in graph.functions.values():
        terminal = fn.name.rsplit(".", 1)[-1]
        if fn.is_method and _HANDLER_RE.match(terminal):
            entries.add(("handler", fn.qname))
    return entries


def _per_request_class(graph, class_qname: str) -> bool:
    for cq in graph.class_mro(class_qname):
        info = graph.classes.get(cq)
        if info is None:
            continue
        for base in info.base_names:
            if base.rsplit(".", 1)[-1].endswith(_PER_REQUEST_BASES):
                return True
    return False


def build(project: Project) -> ThreadRootIndex:
    graph = project.callgraph()
    idx = ThreadRootIndex()
    idx.entries = _collect_entries(graph)

    roots: dict[str, set[str]] = {}

    def mark_reachable(entry_q: str, label: str) -> None:
        seen = {entry_q}
        stack = [entry_q]
        while stack:
            q = stack.pop()
            roots.setdefault(q, set()).add(label)
            for e in graph.callees(q):
                if e.callee is not None and e.callee not in seen:
                    seen.add(e.callee)
                    stack.append(e.callee)

    for kind, entry_q in idx.entries:
        label = f"{kind}:{entry_q}"
        if kind == "handler":
            fn = graph.functions.get(entry_q)
            if fn is not None and fn.class_qname and _per_request_class(
                graph, fn.class_qname
            ):
                # fresh handler object per request: every verb of the class
                # is the same single thread of control over instance state
                label = f"handler:{fn.class_qname}"
        mark_reachable(entry_q, label)

    # ``main`` reachability: module-level code plus every function the
    # package itself never calls (the public API surface — tests, training
    # loops, and the console enter there), propagated along resolved edges.
    incoming: set[str] = set()
    for edges in graph.edges.values():
        for e in edges:
            if e.callee is not None:
                incoming.add(e.callee)
    entry_qnames = {q for _, q in idx.entries}
    seeds = [q for q in graph.edges if q.endswith("::<module>")]
    seeds += [
        q for q in graph.functions
        if q not in incoming and q not in entry_qnames
    ]
    seen = set(seeds)
    stack = list(seeds)
    while stack:
        q = stack.pop()
        roots.setdefault(q, set()).add(MAIN_ROOT)
        for e in graph.callees(q):
            if e.callee is not None and e.callee not in seen:
                seen.add(e.callee)
                stack.append(e.callee)

    idx.roots = {q: frozenset(r) for q, r in roots.items()}
    return idx


def thread_roots(project: Project) -> ThreadRootIndex:
    """The project's thread-root index, built once and cached (the same
    build-once contract as ``Project.callgraph()``)."""
    if project._thread_roots is None:
        project._thread_roots = build(project)
    return project._thread_roots
