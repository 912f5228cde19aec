"""Runtime lock-order / race detector (opt-in: ``LAKESOUL_LOCKCHECK=1``).

The port of ``lakesoul_tpu/analysis/lockgraph.py``: the same contract,
aimed at this package's pool.

Static rules can't see dynamic lock ordering, so this half of lakelint
instruments the locks themselves: :func:`enable` patches
``threading.Lock``/``threading.RLock`` with checked wrappers (locks created
*before* enabling are untouched — the detector targets per-object data-path
locks, not interpreter internals) and hooks
:meth:`~lakesoul_tpu_torch.runtime.pool.WorkerPool.submit`.

What it catches:

- **Lock-order cycles.**  Every thread keeps its held-lock stack; acquiring
  B while holding A records the global edge A→B with the acquiring stack.
  An acquisition that would close a cycle (B→…→A already recorded from any
  thread) is a potential deadlock even if this run got lucky with timing —
  exactly the class that's unreproducible under pytest and fatal in
  production.
- **Lock-held-across-``pool.submit``.**  Submitting pool work while holding
  a lock is the nested-pool deadlock shape: a worker that needs that lock
  parks, the submitter blocks on the worker, the pool wedges.  (The static
  ``lock-held-call`` rule catches the lexical version; this catches it
  through any call depth.)

Violations are *recorded*, not raised — the data path must not change
behavior under instrumentation; :func:`analysis.arm.armed` hands them to
the armed suite's fixture, which fails the test at teardown instead.
Per-thread state is bookkept unconditionally on checked locks so
enable/disable cycles can't desync the stacks; only violation *recording*
is gated on the enabled flag.
"""

from __future__ import annotations

import itertools
import os
import threading
import traceback
from dataclasses import dataclass

__all__ = [
    "Violation",
    "enable",
    "disable",
    "reset",
    "violations",
    "enabled",
    "env_requested",
    "watch",
    "current_held",
    "instrument_locks",
    "uninstrument_locks",
    "real_lock",
]

_ENV = "LAKESOUL_LOCKCHECK"

# originals captured at import: the wrappers and the detector's own state
# must keep working while threading.Lock/RLock point at the factories
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


@dataclass
class Violation:
    kind: str  # "lock-cycle" | "submit-while-locked"
    message: str
    stacks: tuple[str, ...] = ()

    def render(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for s in self.stacks:
            out.append(s.rstrip())
        return "\n".join(out)


class _State:
    def __init__(self):
        self.lock = _REAL_LOCK()
        # (serial_a, serial_b) -> (name_a, name_b, acquiring stack summary).
        # Keyed by per-wrapper monotonic serials, NOT id(): a GC'd lock's
        # address gets reused and would inherit the dead lock's edges,
        # producing false cycles on correctly ordered code.
        self.edges: dict[tuple[int, int], tuple[str, str, str]] = {}
        self.successors: dict[int, set[int]] = {}
        self.violations: list[Violation] = []
        self.reported: set[tuple] = set()
        self.enabled = False


_STATE = _State()
_TLS = threading.local()


def _held_stack() -> list:
    stack = getattr(_TLS, "held", None)
    if stack is None:
        stack = _TLS.held = []
    return stack


def _site(depth_skip: int = 3) -> str:
    frames = traceback.extract_stack()[:-depth_skip]
    for fr in reversed(frames):
        if "lakesoul_tpu_torch/analysis/lockgraph" not in fr.filename.replace("\\", "/"):
            return f"{fr.filename}:{fr.lineno} in {fr.name}"
    return "<unknown>"


def _stack_summary() -> str:
    frames = traceback.extract_stack()[:-3]
    keep = [
        f"  {fr.filename}:{fr.lineno} in {fr.name}"
        for fr in frames[-8:]
        if "lakesoul_tpu_torch/analysis/lockgraph" not in fr.filename.replace("\\", "/")
    ]
    return "\n".join(keep)


def _path_exists(src: int, dst: int) -> bool:
    """DFS over recorded edges: is there a held-before path src →* dst?"""
    seen = set()
    stack = [src]
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(_STATE.successors.get(cur, ()))
    return False


def _before_acquire(lock: "_CheckedBase") -> None:
    held = _held_stack()
    if any(entry[0] is lock for entry in held):
        return  # re-entrant acquire: no new ordering information
    if not held or not _STATE.enabled:
        return
    with _STATE.lock:
        for held_lock, _count in held:
            a, b = held_lock.serial, lock.serial
            if a == b:
                continue
            if (a, b) not in _STATE.edges:
                # would acquiring b while holding a close a cycle b →* a?
                if _STATE.enabled and _path_exists(b, a):
                    key = ("cycle", frozenset((a, b)))
                    if key not in _STATE.reported:
                        _STATE.reported.add(key)
                        back = next(
                            (
                                e
                                for (x, y), e in _STATE.edges.items()
                                if x == b and y == a
                            ),
                            None,
                        )
                        stacks = [f"second order ({held_lock.name} -> {lock.name}):\n{_stack_summary()}"]
                        if back is not None:
                            stacks.insert(
                                0,
                                f"first order ({back[0]} -> {back[1]}):\n{back[2]}",
                            )
                        _STATE.violations.append(
                            Violation(
                                "lock-cycle",
                                f"acquiring {lock.name} while holding "
                                f"{held_lock.name} inverts an existing "
                                "lock order — potential deadlock",
                                tuple(stacks),
                            )
                        )
                _STATE.edges[(a, b)] = (
                    held_lock.name,
                    lock.name,
                    _stack_summary(),
                )
                _STATE.successors.setdefault(a, set()).add(b)


def _on_acquired(lock: "_CheckedBase", n: int = 1) -> None:
    held = _held_stack()
    for entry in held:
        if entry[0] is lock:
            entry[1] += n
            return
    held.append([lock, n])
    # remember WHICH thread's stack holds this lock: a plain Lock may
    # legally be released from another thread (handoff/gate pattern), and
    # the release must clear the acquirer's entry, not leave a phantom hold
    lock._hold_lists.append(held)


def _drop_entry(held: list, lock: "_CheckedBase", n: int) -> bool:
    for i in range(len(held) - 1, -1, -1):  # lakelint: ignore[ad-hoc-retry] reverse index scan with a concurrent-remove guard, returns on first hit — not a retry loop
        if held[i][0] is lock:
            held[i][1] -= n
            if held[i][1] <= 0:
                del held[i]
                try:
                    lock._hold_lists.remove(held)
                except ValueError:
                    pass
            return True
    return False


def _on_released(lock: "_CheckedBase", n: int = 1) -> None:
    if _drop_entry(_held_stack(), lock, n):
        return
    # not held by this thread: cross-thread release — clear the hold from
    # whichever thread acquired it
    for held in list(lock._hold_lists):
        if _drop_entry(held, lock, n):
            return


class _CheckedBase:
    """Duck-typed Lock/RLock wrapper: bookkeeping around the real primitive.
    ``__getattr__`` falls through so hasattr-probing callers (Condition)
    see exactly the inner lock's capabilities."""

    _serials = itertools.count(1)  # never reused, unlike id()

    def __init__(self, inner):
        self._inner = inner
        self.serial = next(_CheckedBase._serials)
        self._hold_lists: list = []  # held-stacks currently containing us
        self.name = f"{type(inner).__name__.lstrip('_')}@{_site()}"

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _on_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        _on_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, item):
        # hasattr probes (threading.Condition) must see exactly the inner
        # primitive's capabilities; guard against recursion before _inner set
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(item)
        return getattr(inner, item)

    def __repr__(self):
        return f"<checked {self.name}>"


class CheckedLock(_CheckedBase):
    def locked(self):
        return self._inner.locked()


class CheckedRLock(_CheckedBase):
    # Condition(lock) binds these if present; the bookkeeping must ride
    # along or cond.wait() would leave a phantom hold on the stack
    def _release_save(self):
        state = self._inner._release_save()
        # an RLock _release_save drops EVERY recursion level
        count = state[0] if isinstance(state, tuple) else 1
        _on_released(self, n=count)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        count = state[0] if isinstance(state, tuple) else 1
        _on_acquired(self, n=count)

    def _is_owned(self):
        return self._inner._is_owned()


def _make_lock():
    return CheckedLock(_REAL_LOCK())


def _make_rlock():
    return CheckedRLock(_REAL_RLOCK())


# ------------------------------------------------------- lock instrumentation
# The checked-lock wrappers serve TWO detectors: this module's lock-order
# graph and racecheck's per-field lockset tracking (it reads current_held()).
# Both may be armed independently per test, so the threading.Lock/RLock
# patch is refcounted — the real primitives come back only when the last
# detector lets go.

_PATCH_COUNT = 0


def real_lock():
    """An UNchecked lock for detector-internal state — the detectors must
    never trace their own bookkeeping locks."""
    return _REAL_LOCK()


def instrument_locks() -> None:
    """Patch ``threading.Lock``/``threading.RLock`` to checked wrappers
    (refcounted; see above)."""
    global _PATCH_COUNT
    _PATCH_COUNT += 1
    if _PATCH_COUNT == 1:
        threading.Lock = _make_lock
        threading.RLock = _make_rlock


def uninstrument_locks() -> None:
    global _PATCH_COUNT
    if _PATCH_COUNT == 0:
        return
    _PATCH_COUNT -= 1
    if _PATCH_COUNT == 0:
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK


# --------------------------------------------------------------- pool hook


def _patched_submit(orig):
    def submit(self, fn, /, *args, **kwargs):
        if _STATE.enabled:
            held = current_held()
            if held:
                with _STATE.lock:
                    key = ("submit", tuple(l.name for l in held))
                    if key not in _STATE.reported:
                        _STATE.reported.add(key)
                        _STATE.violations.append(
                            Violation(
                                "submit-while-locked",
                                "pool.submit while holding "
                                + ", ".join(l.name for l in held)
                                + " — a worker needing that lock deadlocks "
                                "the pool",
                                (_stack_summary(),),
                            )
                        )
        return orig(self, fn, *args, **kwargs)

    submit._lockgraph_orig = orig
    return submit


# ----------------------------------------------------------------- control


def enabled() -> bool:
    return _STATE.enabled


def env_requested() -> bool:
    return os.environ.get(_ENV, "").strip() == "1"


def current_held() -> list:
    """Checked locks the CURRENT thread holds right now."""
    return [entry[0] for entry in _held_stack()]


def violations() -> list[Violation]:
    with _STATE.lock:
        return list(_STATE.violations)


def reset() -> None:
    """Drop recorded edges and violations (held stacks stay — they mirror
    real lock state)."""
    with _STATE.lock:
        _STATE.edges.clear()
        _STATE.successors.clear()
        _STATE.violations.clear()
        _STATE.reported.clear()


def enable() -> None:
    """Patch lock construction + pool submit.  Idempotent."""
    if _STATE.enabled:
        return
    instrument_locks()
    from lakesoul_tpu_torch.runtime.pool import WorkerPool

    if not hasattr(WorkerPool.submit, "_lockgraph_orig"):
        WorkerPool.submit = _patched_submit(WorkerPool.submit)
    _STATE.enabled = True


def disable() -> None:
    """Restore the real primitives.  Checked locks already handed out keep
    working (bookkeeping stays consistent); recording stops."""
    if not _STATE.enabled:
        return
    uninstrument_locks()
    from lakesoul_tpu_torch.runtime.pool import WorkerPool

    orig = getattr(WorkerPool.submit, "_lockgraph_orig", None)
    if orig is not None:
        WorkerPool.submit = orig
    _STATE.enabled = False


class Watch:
    """Handle yielded by :func:`watch`: the violations recorded since the
    watch began."""

    def __init__(self, mark: int):
        self._mark = mark

    @property
    def violations(self) -> list[Violation]:
        return violations()[self._mark :]


class watch:
    """``with watch() as w:`` — enable for the block, inspect
    ``w.violations`` after (detector state is NOT reset on exit so nested
    watches compose; call :func:`reset` between independent scenarios)."""

    def __enter__(self) -> Watch:
        self._was_enabled = _STATE.enabled
        enable()
        return Watch(len(violations()))

    def __exit__(self, *exc):
        if not self._was_enabled:
            disable()
        return False
