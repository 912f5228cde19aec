"""Zero-copy buffer-lifetime rules for the loader's collate machinery.

The scan path's speed comes from *borrowing*: ``_np_column_views`` hands
out numpy views over Arrow batch buffers, and the opt-in
``LAKESOUL_COLLATE_REUSE`` ring hands out output-buffer sets that are
**overwritten in place** once the ring wraps.  Both are only sound inside
a window discipline — a view travels with the batch that owns its bytes,
and a ring slot is dead the moment the ring wraps back to it.  Nothing
type-checks that discipline, and a violation is not a crash but silently
corrupt training data.  Two rules pin it:

- ``view-escapes-release``: the result of ``_np_column_views(batch)`` or
  ``<ring>.next_slot()`` must stay inside the borrowing function's window:
  passing it as a call argument is the sanctioned hand-off
  (``window.collate(slot)``), and storing a *view* together with its
  owning batch in one tuple is the rebatcher's keep-alive idiom
  (``self._pending.append((b, views))``).  A *slot* travels on only with
  the batch collated into it (``batch = window.collate(slot, ...)`` then
  ``return rows, batch, slot``): that is the hand-off to the delivery,
  which records the copy's event on the slot, and ``next_slot()`` waits on
  that event before the slot is refilled.  Everything else escapes the
  release point: storing a bare view/slot on ``self`` or into a
  container, returning it, or closing over it in a nested function — the
  borrower then outlives the slot and reads bytes a later window already
  overwrote.
- ``ring-aliasing``: every ``_BufferRing(...)`` construction must sit in
  the body of a guard that selects a consumer whose delivery copies: a
  host consumer (``not device_put``: batches are copied out before the
  ring wraps) or pinned slots on the card (``self._pin``: each slot's
  ``next_slot()`` waits on the event of the copy out of it).  On the CPU a
  delivered tensor aliases its collate buffer, and ``cache='device'``
  keeps every delivered batch — a ring there would overwrite live data in
  place.  The guard lives in one ``if`` today; this rule keeps any future
  ring construction honest.

The reference package's runtime half (its ``analysis/racecheck.py``,
which has no counterpart here yet) closes what the lexical rules cannot
see: its ring canary checks, at each slot hand-out, that no
borrower still holds the previous window's buffers, and poisons the slot
so a stale read is loud garbage instead of plausible data.
"""

from __future__ import annotations

import ast
from typing import Iterable

from lakesoul_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Rule,
    dotted_name,
    enclosing_function_bodies,
    walk_stopping_at_functions,
)

# the zero-copy loader module the rules default-scope to; fixtures override
SCOPE = ("data/torch_iter.py",)

_VIEW_FACTORY = "_np_column_views"
_SLOT_METHOD = "next_slot"
_RING_CTOR = "_BufferRing"

# container methods a borrowed value must not be handed into
_STORE_METHODS = {
    "append", "appendleft", "add", "insert", "extend", "update",
    "setdefault", "put", "put_nowait",
}


def _tracked_call(value: ast.expr) -> "str | tuple[str, str | None] | None":
    """Classify an RHS: ``("view", source_name)`` for ``_np_column_views(x)``,
    ``("slot", None)`` for ``<ring>.next_slot()``, else None.  IfExp arms
    are checked too (``views = _np_column_views(b) if cap else None``)."""
    if isinstance(value, ast.IfExp):
        return _tracked_call(value.body) or _tracked_call(value.orelse)
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func)
    terminal = (name or "").rsplit(".", 1)[-1]
    if terminal == _VIEW_FACTORY:
        src = value.args[0].id if (
            value.args and isinstance(value.args[0], ast.Name)
        ) else None
        return ("view", src)
    if isinstance(value.func, ast.Attribute) and value.func.attr == _SLOT_METHOD:
        return ("slot", None)
    return None


def _slot_owners(nodes, slots: set) -> "dict[str, set[str]]":
    """``{slot name: {batch names}}``: the names bound to a call that took
    the slot as an argument (``batch = window.collate(slot, alloc)``) — the
    batch whose buffers ARE the slot's, so the slot may travel with it."""
    owners: dict[str, set[str]] = {}
    for node in nodes:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        args = {a.id for a in node.value.args if isinstance(a, ast.Name)}
        for slot in args & slots:
            owners.setdefault(slot, set()).update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
    return owners


class ViewEscapesReleaseRule(Rule):
    id = "view-escapes-release"
    title = "borrowed view / ring slot escapes its release point"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(s in module.relpath for s in self.scope):
            return
        for _, body in enclosing_function_bodies(module.tree):
            nodes = list(walk_stopping_at_functions(body))
            views: dict[str, str | None] = {}  # name -> owning-batch name
            slots: set[str] = set()
            for node in nodes:
                if isinstance(node, ast.Assign):
                    kind = _tracked_call(node.value)
                    if kind is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            if kind[0] == "view":
                                views[t.id] = kind[1]
                            else:
                                slots.add(t.id)
            if not views and not slots:
                continue
            owners = _slot_owners(nodes, slots)
            yield from self._scan_escapes(module, nodes, views, slots, owners)

    # ------------------------------------------------------------- escapes
    def _borrowed(self, expr: ast.expr, views, slots,
                  owners) -> "tuple[str, str] | None":
        """``(kind, name)`` when ``expr`` hands a borrowed value onward
        WITHOUT its keep-alive: a bare tracked name, or a tuple/list that
        contains a tracked view but NOT the batch that owns its bytes, or a
        tracked slot but NOT a batch collated into it."""
        if isinstance(expr, ast.Name):
            if expr.id in slots:
                return ("ring slot", expr.id)
            if expr.id in views:
                return ("view", expr.id)
            return None
        if isinstance(expr, (ast.Tuple, ast.List)):
            names = {e.id for e in expr.elts if isinstance(e, ast.Name)}
            for n in names & slots:
                if not names & owners.get(n, set()):
                    return ("ring slot", n)  # travelling without its batch
            for n in names & set(views):
                src = views[n]
                if src is None or src not in names:
                    return ("view", n)  # travelling without its batch
            return None
        return None

    def _scan_escapes(self, module, nodes, views, slots,
                      owners) -> Iterable[Finding]:
        def finding(line: int, kind: str, name: str, how: str) -> Finding:
            return Finding(
                self.id,
                module.relpath,
                line,
                f"{kind} {name!r} {how} — it escapes the release point: the "
                "borrower can outlive the window and read bytes a later "
                "window already overwrote (views must travel with their "
                "owning batch; ring slots only with the batch collated into "
                "them)",
            )

        for node in nodes:
            if isinstance(node, ast.Assign):
                if _tracked_call(node.value) is not None:
                    continue  # the tracking assignment itself
                hit = self._borrowed(node.value, views, slots, owners)
                if hit is not None:
                    kind, name = hit
                    target = node.targets[0]
                    if isinstance(target, ast.Name):
                        continue  # local rebind stays inside the window
                    yield finding(node.lineno, kind, name, "is stored")
            elif isinstance(node, ast.Return) and node.value is not None:
                hit = self._borrowed(node.value, views, slots, owners)
                if hit is not None:
                    kind, name = hit
                    yield finding(node.lineno, kind, name, "is returned")
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr not in _STORE_METHODS:
                    continue
                for arg in node.args:
                    hit = self._borrowed(arg, views, slots, owners)
                    if hit is not None:
                        kind, name = hit
                        yield finding(
                            node.lineno, kind, name,
                            f"is stored via .{node.func.attr}(...)",
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                captured = {
                    n.id for n in ast.walk(node)
                    if isinstance(n, ast.Name)
                } & (set(views) | slots)
                for name in sorted(captured):
                    kind = "ring slot" if name in slots else "view"
                    yield finding(
                        node.lineno, kind, name, "is closed over"
                    )


class RingAliasingRule(Rule):
    id = "ring-aliasing"
    title = "_BufferRing built without an aliasing guard"

    # the guards that select a copying delivery: a host consumer
    # (`not device_put`) or pinned slots whose next_slot() waits on their
    # copy's event (`self._pin`)
    _HOST_ONLY = "device_put"
    _PINNED = "_pin"

    def __init__(self, scope: tuple = SCOPE):
        self.scope = scope

    def check(self, module: Module) -> Iterable[Finding]:
        if not any(s in module.relpath for s in self.scope):
            return
        parents = module.parents()
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if (name or "").rsplit(".", 1)[-1] != _RING_CTOR:
                continue
            if self._aliasing_guarded(node, parents):
                continue
            yield Finding(
                self.id,
                module.relpath,
                node.lineno,
                "_BufferRing(...) constructed without an aliasing guard — "
                "arm it only for a host consumer (not device_put: batches "
                "are copied out before the ring wraps) or for pinned slots "
                "(self._pin: next_slot() waits on the event of the copy out "
                "of a slot): on the CPU a delivered tensor aliases its "
                "collate buffer and cache='device' keeps every delivered "
                "batch, so an unguarded reuse ring would overwrite live data "
                "in place",
            )

    @classmethod
    def _aliasing_guarded(cls, call: ast.Call, parents) -> bool:
        """The ctor sits in the BODY of an ``if`` (or the true arm of a
        conditional expression) whose test holds one of the guards
        un-negated: building the ring in the else branch, or under ``not
        self._pin``, is the inverted-guard bug this rule exists to catch."""
        prev: ast.AST = call
        node: ast.AST = call
        while node in parents:
            prev, node = node, parents[node]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            if isinstance(node, (ast.If, ast.IfExp)) and \
                    cls._in_if_body(node, prev) and cls._guard_in(node.test):
                return True
        return False

    @staticmethod
    def _in_if_body(branch: ast.AST, child: ast.AST) -> bool:
        if isinstance(branch, ast.If):
            return any(child is stmt for stmt in branch.body)
        if isinstance(branch, ast.IfExp):
            return child is branch.body
        return False

    @classmethod
    def _guard_in(cls, test: ast.expr) -> bool:
        def terminal(n: ast.AST) -> "str | None":
            name = dotted_name(n)
            return name.rsplit(".", 1)[-1] if name else None

        negated: set = set()
        host_only = False
        for sub in ast.walk(test):
            if isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not):
                if terminal(sub.operand) == cls._HOST_ONLY and sub not in negated:
                    host_only = True
                negated.update(ast.walk(sub.operand))
        pinned = any(
            terminal(sub) == cls._PINNED and sub not in negated
            for sub in ast.walk(test)
        )
        return host_only or pinned
