"""Resource-boundedness & lifecycle rules — what a soak run dies of.

Every prior pack proved a *safety* property (locks, traces, races,
durability, isolation).  None proved the property an hours-long mixed
workload needs: **bounded memory and clean resource lifecycles**.
Sustained-throughput pipelines die of unbounded queues and leaked handles,
not crashes (arxiv 2604.21275) — slowly, in production, where pytest
never runs long enough to notice.  Five rules make the discipline
mechanical, riding the cached thread-root and call-graph indexes
(:mod:`~lakesoul_tpu_torch.analysis.threadroots`) plus one per-class lifecycle
index built once per run:

- ``unbounded-queue``: ``Queue()``/``deque()`` constructed without
  ``maxsize``/``maxlen`` in the data-path, serving, scanplane, fleet, and
  freshness modules.  Backpressure must be structural — an unbounded
  buffer between a fast producer and a slow consumer is RAM with a fuse.
- ``unbounded-growth``: append/add/setitem on a ``self.`` container
  inside a background-thread-reachable service loop with no eviction,
  clear, or rebind path anywhere in the class — the slow-leak shape that
  kills soaks.
- ``thread-lifecycle``: every started ``Thread`` must have a reachable
  ``join`` or stop-event wiring (an ``Event`` the class both constructs
  and ``.set()``s).  A thread nobody can stop outlives its owner and
  races teardown; sanctioned daemon publishers carry pragmas.
- ``child-reap``: every ``Popen`` in scanplane/fleet/compaction must
  reach ``wait``/``poll``/``kill`` on all exits — try/finally or a
  registered reaper — so the autoscaler can never orphan (or zombie) a
  worker.  A terminated-but-never-waited child is a zombie until *its
  parent* exits.
- ``shm-debris``: paths created under /dev/shm, the spool, or via
  ``mkdtemp``/``mkstemp`` must flow into a registered prune/unlink seam
  (``rmtree``/``unlink``/``atexit.register``/``sweep``/``prune``) — a
  SIGKILLed owner must not leave tmpfs debris nobody sweeps.

Known limits, on purpose (low false positives over completeness): join
detection is name-based over the module (a ``.join()`` on an attribute of
the right name anywhere satisfies the thread site — false-negative
leaning); growth is only flagged inside a lexical ``while`` loop reachable
from a background root (a handler that grows per request is the runtime
leakcheck's job); and cleanup seams are matched lexically in the creating
function or its class.  The runtime half of this pack
(:mod:`~lakesoul_tpu_torch.analysis.leakcheck`) catches what the lexical
approximations miss, with creation stacks.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Project,
    Rule,
    dotted_name,
    enclosing_function_bodies,
    walk_stopping_at_functions,
)
from lakesoul_tpu_torch.analysis.threadroots import MAIN_ROOT, thread_roots

# the package scope the repo gate runs with; fixtures override
SCOPE = ("lakesoul_tpu_torch/",)

# modules where queue boundedness is load-bearing (data path, serving,
# process planes, freshness) — a bounded queue elsewhere is still good
# style, but these are where an unbounded one takes the soak down
QUEUE_SCOPE = (
    "runtime/", "service/", "vector/", "scanplane/", "fleet/", "freshness/",
)

# Popen supervision scope: the layers allowed to spawn (rules/process.py)
# minus runtime/ (its parallelism is threads, not children)
CHILD_SCOPE = ("scanplane/", "fleet/", "compaction/")

_QUEUE_CTOR_TERMINALS = {"Queue", "LifoQueue", "PriorityQueue"}
_GROW_MUTATORS = {"append", "appendleft", "extend", "extendleft", "add"}
_SHRINK_MUTATORS = {
    "pop", "popleft", "popitem", "clear", "remove", "discard",
}
_CONTAINER_CTOR_TERMINALS = {
    "list", "dict", "set", "deque", "OrderedDict", "defaultdict", "Counter",
}
_CLEANUP_TERMINALS = {
    "rmtree", "unlink", "remove", "removedirs", "rmdir", "cleanup",
    "register", "sweep_tmp_debris", "sweep", "prune", "prune_stale_spools",
}
_TMPFILE_CTOR_TERMINALS = {"mkdtemp", "mkstemp"}
_DEBRIS_TERMINALS = _TMPFILE_CTOR_TERMINALS | {"mkdir", "makedirs"}


def _terminal(func: ast.expr) -> str:
    return (dotted_name(func) or "").rsplit(".", 1)[-1]


def _self_attr(node: ast.AST) -> "str | None":
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _in_scope(relpath: str, scope: tuple) -> bool:
    return any(s in relpath for s in scope)


# ----------------------------------------------------------- unbounded-queue


def _queue_bound(call: ast.Call, terminal: str) -> bool:
    """Whether the queue/deque construction carries a structural bound."""
    if terminal == "deque":
        if len(call.args) >= 2:
            return not (
                isinstance(call.args[1], ast.Constant)
                and call.args[1].value in (None, 0)
            )
        for kw in call.keywords:
            if kw.arg == "maxlen":
                return not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value in (None, 0)
                )
        return False
    # queue.Queue family: first positional / maxsize kw; <=0 means infinite
    cap = call.args[0] if call.args else None
    if cap is None:
        for kw in call.keywords:
            if kw.arg == "maxsize":
                cap = kw.value
    if cap is None:
        return False
    if isinstance(cap, ast.Constant):
        return isinstance(cap.value, (int, float)) and cap.value > 0
    return True  # a computed capacity is a bound the author chose


class UnboundedQueueRule(Rule):
    id = "unbounded-queue"
    title = "Queue()/deque() without maxsize/maxlen in a bounded-path module"

    def __init__(self, scope: tuple = QUEUE_SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not _in_scope(module.relpath, self.scope):
            return
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            terminal = _terminal(node.func)
            if terminal == "SimpleQueue":
                yield Finding(
                    self.id, module.relpath, node.lineno,
                    "SimpleQueue() cannot be bounded — a fast producer "
                    "grows it until the process dies; use Queue(maxsize=N) "
                    "so backpressure is structural",
                )
                continue
            if terminal not in _QUEUE_CTOR_TERMINALS and terminal != "deque":
                continue
            if _queue_bound(node, terminal):
                continue
            what = "deque() without maxlen" if terminal == "deque" else \
                f"{terminal}() without maxsize"
            yield Finding(
                self.id, module.relpath, node.lineno,
                f"{what} on the data path — an unbounded buffer between a "
                "fast producer and a slow consumer grows until the soak "
                "dies of RSS; pass a capacity (or pragma naming the "
                "structural bound)",
            )


# ------------------------------------------------------- per-class lifecycle
# One walk over every in-scope class collects everything the three
# cross-file rules need: container growth/shrink sites, thread creations
# and join/stop wiring, child spawns and reap wiring.  Built once per
# (project, scope) and cached on the Project, the same contract as the
# race/durability/isolation indexes.


@dataclass(frozen=True)
class _Growth:
    method: str  # qname
    terminal: str  # method name as written
    attr: str
    line: int
    in_while: bool


@dataclass(frozen=True)
class _ThreadSite:
    method: str
    terminal: str
    line: int
    binding: str  # "anonymous" | "local:<name>" | "attr:<name>"


@dataclass(frozen=True)
class _ChildSite:
    method: str
    terminal: str
    line: int
    binding: str  # "local:<name>" | "attr:<name>" | "anonymous"


@dataclass
class _ClassInfo:
    qname: str
    relpath: str
    name: str
    container_attrs: set = field(default_factory=set)  # unbounded ctors
    bounded_attrs: set = field(default_factory=set)  # deque(maxlen=N) etc.
    growth: list = field(default_factory=list)  # [_Growth]
    shrink_attrs: set = field(default_factory=set)  # evicted/cleared/rebound
    threads: list = field(default_factory=list)  # [_ThreadSite]
    children: list = field(default_factory=list)  # [_ChildSite]
    event_attrs: set = field(default_factory=set)  # threading.Event() attrs
    set_attrs: set = field(default_factory=set)  # self.<a>.set() called
    reaped_attrs: set = field(default_factory=set)  # wait/poll/kill reaches
    child_attrs: set = field(default_factory=set)  # Popen registries
    zombies: list = field(default_factory=list)  # [(method, terminal, line)]


@dataclass
class _BoundedIndex:
    classes: dict = field(default_factory=dict)  # class qname -> _ClassInfo
    # relpath -> attr names something .join()s on (any receiver — module-
    # wide so a handle stored on a server object still counts)
    joined_attrs: dict = field(default_factory=dict)
    # function qname -> thread/child sites defined OUTSIDE classes
    free_threads: list = field(default_factory=list)
    free_children: list = field(default_factory=list)


_REAP_TERMINALS = {"wait", "poll", "kill"}


def _iter_alias(expr: ast.expr) -> "tuple[set, set]":
    """(self attrs, local names) referenced anywhere in an iterable
    expression — ``list(self._threads)`` aliases to ``_threads``."""
    attrs: set = set()
    names: set = set()
    for sub in ast.walk(expr):
        a = _self_attr(sub)
        if a is not None:
            attrs.add(a)
        elif isinstance(sub, ast.Name):
            names.add(sub.id)
    return attrs, names


class _FnScan:
    """One pass over a function body collecting lifecycle facts."""

    def __init__(self):
        self.thread_locals: dict = {}  # name -> creation line
        self.child_locals: dict = {}
        self.popped_children: dict = {}  # name -> source attr
        self.joined_locals: set = set()
        self.joined_attrs: set = set()
        self.reaped_locals: set = set()
        self.terminated_locals: dict = {}  # name -> line
        self.registered_locals: dict = {}  # name -> attr appended into
        self.assign_alias: dict = {}  # local -> (attrs, names) it was built from
        self.for_vars: dict = {}  # loop var -> (attrs, names) iterated

    def resolve_to_attrs(self, name: str, depth: int = 3) -> set:
        """Self-attrs a local name transitively aliases (one or two hops:
        ``threads = list(self._threads); for t in threads: ...``)."""
        out: set = set()
        seen: set = set()
        frontier = {name}
        for _ in range(depth):
            nxt: set = set()
            for n in frontier:
                if n in seen:
                    continue
                seen.add(n)
                for src in (self.assign_alias, self.for_vars):
                    hit = src.get(n)
                    if hit is not None:
                        out |= hit[0]
                        nxt |= hit[1]
            frontier = nxt
        return out


def _scan_function(fn_node, scan: _FnScan, cls: "_ClassInfo | None",
                   qname: str, terminal_name: str) -> None:
    """Collect thread/child/join/reap facts from one function body."""

    def visit(node: ast.AST, in_while: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.While):
            for child in ast.iter_child_nodes(node):
                visit(child, True)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if isinstance(node.target, ast.Name):
                scan.for_vars[node.target.id] = _iter_alias(node.iter)
            for child in ast.iter_child_nodes(node):
                visit(child, in_while)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # `[p for p in self._children if p.poll() ...]` — the reap-by-
            # comprehension idiom aliases exactly like a for statement
            for gen in node.generators:
                if isinstance(gen.target, ast.Name):
                    scan.for_vars[gen.target.id] = _iter_alias(gen.iter)
            for child in ast.iter_child_nodes(node):
                visit(child, in_while)
            return
        if isinstance(node, ast.Assign):
            value = node.value
            term = _terminal(value.func) if isinstance(value, ast.Call) else ""
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if isinstance(tgt, ast.Name):
                    if term == "Thread":
                        scan.thread_locals[tgt.id] = value.lineno
                    elif term == "Popen":
                        scan.child_locals[tgt.id] = value.lineno
                    elif (isinstance(value, ast.Call)
                          and isinstance(value.func, ast.Attribute)
                          and value.func.attr in ("pop", "popleft")):
                        src = _self_attr(value.func.value)
                        if src is not None:
                            scan.popped_children[tgt.id] = src
                    elif isinstance(value, (ast.Call, ast.Name, ast.Attribute,
                                            ast.ListComp, ast.List)):
                        scan.assign_alias[tgt.id] = _iter_alias(value)
                elif attr is not None and cls is not None:
                    if term == "Thread":
                        cls.threads.append(_ThreadSite(
                            qname, terminal_name, value.lineno, f"attr:{attr}",
                        ))
                    elif term == "Popen":
                        cls.children.append(_ChildSite(
                            qname, terminal_name, value.lineno, f"attr:{attr}",
                        ))
                        cls.child_attrs.add(attr)
                    elif term == "Event":
                        cls.event_attrs.add(attr)
                    elif terminal_name != "__init__":
                        # non-init rebind of a container attr is a reset path
                        if isinstance(value, (ast.List, ast.Dict, ast.Set,
                                              ast.ListComp, ast.DictComp,
                                              ast.SetComp, ast.Subscript,
                                              ast.Call)):
                            cls.shrink_attrs.add(attr)
            for child in ast.iter_child_nodes(node):
                visit(child, in_while)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                attr = _self_attr(base)
                if attr is not None and cls is not None:
                    cls.shrink_attrs.add(attr)
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            m = node.func.attr
            recv_attr = _self_attr(node.func.value)
            recv_name = (node.func.value.id
                         if isinstance(node.func.value, ast.Name) else None)
            if m == "join" and not isinstance(node.func.value, ast.Constant):
                # thread-handle join (str-constant receivers are str.join)
                if isinstance(node.func.value, ast.Attribute):
                    scan.joined_attrs.add(node.func.value.attr)
                elif recv_name is not None:
                    scan.joined_locals.add(recv_name)
            elif m in _REAP_TERMINALS:
                if recv_attr is not None:
                    if cls is not None:
                        cls.reaped_attrs.add(recv_attr)
                elif recv_name is not None:
                    scan.reaped_locals.add(recv_name)
            elif m == "terminate" and recv_name is not None:
                scan.terminated_locals.setdefault(recv_name, node.lineno)
            elif m == "set" and recv_attr is not None and cls is not None:
                cls.set_attrs.add(recv_attr)
            elif m in ("append", "add") and node.args:
                # registering a handle into a self container
                tgt_attr = _self_attr(node.func.value)
                if tgt_attr is not None and isinstance(node.args[0], ast.Name):
                    scan.registered_locals[node.args[0].id] = tgt_attr
            if cls is not None:
                if m in _GROW_MUTATORS and recv_attr is not None:
                    cls.growth.append(_Growth(
                        qname, terminal_name, recv_attr, node.lineno, in_while,
                    ))
                elif m in _SHRINK_MUTATORS and recv_attr is not None:
                    cls.shrink_attrs.add(recv_attr)
                elif m == "setdefault" and recv_attr is not None:
                    cls.growth.append(_Growth(
                        qname, terminal_name, recv_attr, node.lineno, in_while,
                    ))
            for child in ast.iter_child_nodes(node):
                visit(child, in_while)
            return
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store,)
        ):
            attr = _self_attr(node.value)
            if attr is not None and cls is not None:
                cls.growth.append(_Growth(
                    qname, terminal_name, attr, node.lineno, in_while,
                ))
            for child in ast.iter_child_nodes(node):
                visit(child, in_while)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, in_while)

    for stmt in fn_node.body:
        visit(stmt, False)


def _anonymous_sites(fn_node) -> "list[tuple[str, int]]":
    """Thread(...)/Popen(...) whose result is consumed without a binding —
    ``Thread(...).start()`` or a bare expression: no handle, no lifecycle."""
    out = []
    for node in walk_stopping_at_functions(fn_node.body):
        if not isinstance(node, ast.Call):
            continue
        term = _terminal(node.func)
        if term in ("Thread", "Popen"):
            continue  # bindings handled by _scan_function
        # a Thread(...) used as a receiver (Thread(...).start()) or passed
        # bare shows up as the .value of an Attribute / an Expr statement
        if isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Call
        ):
            inner = _terminal(node.func.value.func)
            if inner in ("Thread", "Popen"):
                out.append((inner, node.func.value.lineno))
    for stmt in walk_stopping_at_functions(fn_node.body):
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            if _terminal(stmt.value.func) in ("Thread", "Popen"):
                out.append((_terminal(stmt.value.func), stmt.value.lineno))
    return out


def _class_container_attrs(graph, cls_info) -> "tuple[set, set]":
    """(unbounded container attrs, bounded container attrs) over every
    method's ``self.<attr> = <container ctor>`` assignment."""
    unbounded: set = set()
    bounded: set = set()
    for mq in cls_info.methods.values():
        fn = graph.functions[mq]
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            is_ctor = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                         ast.ListComp, ast.DictComp,
                                         ast.SetComp))
            is_bounded = False
            if isinstance(value, ast.Call):
                term = _terminal(value.func)
                if term in _CONTAINER_CTOR_TERMINALS:
                    is_ctor = True
                    if term == "deque" and _queue_bound(value, "deque"):
                        is_bounded = True
            if not is_ctor:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                (bounded if is_bounded else unbounded).add(attr)
    return unbounded, bounded


def _build_index(project: Project, scope: tuple) -> _BoundedIndex:
    graph = project.callgraph()
    idx = _BoundedIndex()

    # module-wide joined attrs + free-function thread/child sites
    per_fn_scans: dict = {}
    for fq, fn in graph.functions.items():
        if not _in_scope(fn.relpath, scope):
            continue
        cls = None
        if fn.class_qname is not None:
            cls = idx.classes.get(fn.class_qname)
            if cls is None:
                cinfo = graph.classes.get(fn.class_qname)
                if cinfo is None:
                    continue
                cls = _ClassInfo(fn.class_qname, cinfo.relpath, cinfo.name)
                ub, b = _class_container_attrs(graph, cinfo)
                cls.container_attrs = ub
                cls.bounded_attrs = b
                idx.classes[fn.class_qname] = cls
        scan = _FnScan()
        terminal = fn.name.rsplit(".", 1)[-1]
        _scan_function(fn.node, scan, cls, fq, terminal)
        per_fn_scans[fq] = scan
        mod_joined = idx.joined_attrs.setdefault(fn.relpath, set())
        mod_joined |= scan.joined_attrs
        # joins on bare names count too (a shutdown closure joining the
        # handle it closed over), and for-vars / aliases resolve back to
        # the attrs they iterate — name-based, the documented limit
        mod_joined |= scan.joined_locals
        for name in scan.joined_locals:
            mod_joined |= scan.resolve_to_attrs(name)
        for name in scan.reaped_locals:
            attrs = scan.resolve_to_attrs(name)
            attrs |= {scan.popped_children[name]} \
                if name in scan.popped_children else set()
            if cls is not None:
                cls.reaped_attrs |= attrs
        # local Thread()/Popen() handles
        for name, line in scan.thread_locals.items():
            reg = scan.registered_locals.get(name)
            binding = f"attr:{reg}" if reg is not None else f"local:{name}"
            site = _ThreadSite(fq, terminal, line, binding)
            joined_here = (
                name in scan.joined_locals
                or any(name in hit[1]
                       for hit in scan.for_vars.values())
            )
            if joined_here:
                continue  # joined in the creating function: done
            (cls.threads if cls is not None else idx.free_threads).append(site)
        for name, line in scan.child_locals.items():
            reg = scan.registered_locals.get(name)
            binding = f"attr:{reg}" if reg is not None else f"local:{name}"
            site = _ChildSite(fq, terminal, line, binding)
            if name in scan.reaped_locals:
                continue
            (cls.children if cls is not None else idx.free_children).append(site)
        # zombie shape: popped child terminated but never waited in-method
        for name, line in scan.terminated_locals.items():
            if name not in scan.popped_children:
                continue
            if name in scan.reaped_locals:
                continue
            if name in scan.registered_locals:
                continue  # handed to another registry — its reaper's job
            if cls is not None:
                cls.zombies.append((fq, terminal, line, name,
                                    scan.popped_children[name]))
        # anonymous Thread(...).start() / bare Popen(...)
        for kind, line in _anonymous_sites(fn.node):
            site_cls = cls
            if kind == "Thread":
                t = _ThreadSite(fq, terminal, line, "anonymous")
                (site_cls.threads if site_cls is not None
                 else idx.free_threads).append(t)
            else:
                c = _ChildSite(fq, terminal, line, "anonymous")
                (site_cls.children if site_cls is not None
                 else idx.free_children).append(c)
    return idx


def _bounded_index(project: Project, scope: tuple) -> _BoundedIndex:
    cache = project._boundedness_index
    if cache is None:
        cache = project._boundedness_index = {}
    hit = cache.get(scope)
    if hit is None:
        hit = cache[scope] = _build_index(project, scope)
    return hit


# ---------------------------------------------------------- unbounded-growth


class UnboundedGrowthRule(Rule):
    id = "unbounded-growth"
    title = "self-container grows in a background service loop with no eviction"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = _bounded_index(project, self.scope)
        roots = thread_roots(project)
        for cls in idx.classes.values():
            seen: set = set()
            for g in cls.growth:
                if not g.in_while:
                    continue
                if g.attr not in cls.container_attrs:
                    continue  # bounded deque or not a builtin container
                if g.attr in cls.shrink_attrs or g.attr in cls.bounded_attrs:
                    continue
                rts = roots.roots_of(g.method)
                background = [r for r in rts if r != MAIN_ROOT]
                if not background:
                    continue
                key = (g.attr, g.line)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    self.id, cls.relpath, g.line,
                    f"self.{g.attr} of {cls.name} grows inside {g.terminal}'s "
                    "service loop (reachable from "
                    f"{', '.join(sorted(roots.render(r) for r in background))}) "
                    "and nothing in the class ever evicts, clears, or "
                    "rebinds it — the slow leak that kills a soak; bound it "
                    "(deque(maxlen=...)), add an eviction path, or pragma "
                    "the structural budget",
                )


# --------------------------------------------------------- thread-lifecycle


class ThreadLifecycleRule(Rule):
    id = "thread-lifecycle"
    title = "started Thread with no reachable join or stop-event wiring"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = _bounded_index(project, self.scope)
        for cls in idx.classes.values():
            stop_wired = bool(cls.event_attrs & cls.set_attrs)
            mod_joined = idx.joined_attrs.get(cls.relpath, set())
            for t in cls.threads:
                yield from self._judge(t, cls.relpath, mod_joined, stop_wired)
        for t in idx.free_threads:
            relpath = t.method.split("::", 1)[0]
            mod_joined = idx.joined_attrs.get(relpath, set())
            yield from self._judge(t, relpath, mod_joined, False)

    def _judge(self, t: _ThreadSite, relpath: str, mod_joined: set,
               stop_wired: bool) -> Iterable[Finding]:
        if t.binding == "anonymous":
            yield Finding(
                self.id, relpath, t.line,
                f"{t.terminal} starts a Thread without keeping the handle — "
                "nothing can ever join or stop it, so it outlives its owner "
                "and races teardown; keep the handle and join it on the "
                "shutdown path (or wire a stop event)",
            )
            return
        kind, _, name = t.binding.partition(":")
        if kind == "attr":
            if name in mod_joined or stop_wired:
                return
            yield Finding(
                self.id, relpath, t.line,
                f"thread handle self.{name} (started in {t.terminal}) is "
                "never joined and the class has no stop-event wiring — the "
                "shutdown path cannot prove the thread exited; join it (or "
                "construct an Event the stop path .set()s)",
            )
            return
        # local handle that escaped the creating function un-joined
        if name in mod_joined:
            return
        yield Finding(
            self.id, relpath, t.line,
            f"Thread bound to {name!r} in {t.terminal} is started but never "
            "joined on any path — store the handle where the shutdown path "
            "can join it, or wire a stop event",
        )


# --------------------------------------------------------------- child-reap


class ChildReapRule(Rule):
    id = "child-reap"
    title = "spawned child process with no wait/poll/kill on some exit path"

    def __init__(self, scope: tuple = CHILD_SCOPE):
        self.scope = scope

    def finalize(self, project: Project) -> Iterable[Finding]:
        idx = _bounded_index(project, self.scope)
        for cls in idx.classes.values():
            for c in cls.children:
                kind, _, name = c.binding.partition(":")
                if kind == "attr" and name in cls.reaped_attrs:
                    continue
                if c.binding == "anonymous":
                    msg = (
                        f"{c.terminal} spawns a child without keeping the "
                        "Popen handle — it can never be waited, killed, or "
                        "reaped; keep the handle in a registry a reaper "
                        "drains"
                    )
                else:
                    msg = (
                        f"child registry self.{name} (spawned in "
                        f"{c.terminal}) never reaches wait/poll/kill in "
                        f"{cls.name} — a crashed or SIGKILLed worker stays "
                        "a zombie and a live one is orphaned at shutdown; "
                        "add a reap path over the registry"
                    )
                yield Finding(self.id, cls.relpath, c.line, msg)
            for (mq, terminal, line, name, src) in cls.zombies:
                yield Finding(
                    self.id, cls.relpath, line,
                    f"{terminal} pops a child from self.{src} and "
                    f"terminates it, but {name!r} is never waited/polled "
                    "in that method and no longer lives in any reaped "
                    "registry — the exit makes a zombie that survives "
                    "until this process dies; wait it (with a kill "
                    "fallback) or hand it to a reaped retire list",
                )
        for c in idx.free_children:
            relpath = c.method.split("::", 1)[0]
            yield Finding(
                self.id, relpath, c.line,
                f"{c.terminal} spawns a child whose handle never reaches "
                "wait/poll/kill — try/finally the wait or register the "
                "child with a reaper",
            )


# --------------------------------------------------------------- shm-debris


class ShmDebrisRule(Rule):
    id = "shm-debris"
    title = "tmpfs/spool/tempdir creation with no registered prune seam"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not _in_scope(module.relpath, self.scope):
            return
        # cheap prefilter on the shared walk: most modules never touch a
        # tmpfile ctor, so skip the per-scope re-walks entirely
        if not any(
            isinstance(n, ast.Call) and _terminal(n.func) in _DEBRIS_TERMINALS
            for n in module.walk()
        ):
            return
        parents = None
        for scope_node, body in enclosing_function_bodies(module.tree):
            cleans: "bool | None" = None  # computed lazily per scope
            for node in walk_stopping_at_functions(body):
                if not isinstance(node, ast.Call):
                    continue
                terminal = _terminal(node.func)
                hit = None
                if terminal in _TMPFILE_CTOR_TERMINALS:
                    hit = f"{terminal}(...)"
                elif terminal in ("mkdir", "makedirs"):
                    if any(self._shm_str(a) for a in
                           list(node.args) + [kw.value for kw in node.keywords]):
                        hit = f"{terminal}(...) under /dev/shm"
                if hit is None:
                    continue
                if cleans is None:
                    if parents is None:
                        parents = module.parents()
                    cleans = self._scope_cleans(scope_node, module, parents)
                if cleans:
                    continue
                yield Finding(
                    self.id, module.relpath, node.lineno,
                    f"{hit} creates scratch state but neither this function "
                    "nor its class references a prune/unlink seam "
                    "(rmtree/unlink/atexit.register/sweep/prune) — a "
                    "SIGKILLed owner leaves tmpfs debris nobody sweeps; "
                    "register the path with a pruner that survives crashes",
                )

    def _scope_cleans(self, scope_node, module: Module, parents: dict) -> bool:
        """Cleanup referenced in the creating function (nested closures
        count — a teardown lambda registered from here still prunes) or in
        any lexically enclosing class (its stop/close path owns the dir)."""
        if scope_node is module.tree:
            # module-level creation: only sibling module-level code counts
            return any(
                isinstance(n, ast.Call) and _terminal(n.func) in _CLEANUP_TERMINALS
                for n in walk_stopping_at_functions(module.tree.body)
            )
        if self._has_cleanup(scope_node):
            return True
        node = scope_node
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.ClassDef) and self._has_cleanup(node):
                return True
        return False

    @staticmethod
    def _shm_str(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if "/dev/shm" in sub.value:
                    return True
        return False

    @staticmethod
    def _has_cleanup(scope_node: ast.AST) -> bool:
        for node in ast.walk(scope_node):
            if isinstance(node, ast.Call):
                if _terminal(node.func) in _CLEANUP_TERMINALS:
                    return True
        return False
