"""Runtime shape-signature and rebuild detector (opt-in: ``LAKESOUL_TRACECHECK=1``).

The counterpart of ``lakesoul_tpu/analysis/tracecheck.py``.  The reference
counted XLA compilations: every distinct abstract signature a jit entry
saw was a fresh trace.  This package has no jit, but it kept the
reference's shape-bucketing contract — pow2 row buckets in the search
bodies (``vector/kernels.py`` ``_pow2_bucket``) and pow2 query buckets
in the batch search (``vector/index.py``) — so that the hot functions see
a bounded set of shapes whatever the data, and the device's caching
allocator and the kernels' launch geometry stay in a few steady states.
That contract is what this detector guards, and it guards the port's own
recompile: a rebuilt kernel library.

Mechanics:

- :func:`enable` replaces the hot functions of :data:`HOT_FUNCTIONS` — the
  hand-kernel wrappers (the functions that count ``launches``) and the
  search, k-means and estimator bodies around them in ``vector/kernels``,
  ``vector/kmeans``, ``vector/rabitq`` and ``annplane/ragged`` — with
  counting proxies, in place on their modules and on every module of this
  package that imported them by name, so calls through the module
  (``K.packed_dot(...)``), the module's own calls to its functions and
  ``vector/index.py``'s calls are counted.  A proxy forwards attribute
  reads and writes to the function it wraps: a wrapper's ``launches``
  count stays one count.
- Each top-level call computes the **abstract signature** — per-leaf
  ``(shape, dtype)`` for tensors and arrays, ``repr`` for scalars and
  strings, the type's name for anything else — and records it per
  function.  A call made while another counted call runs on the same
  thread (a search body calling its kernel wrapper) is part of that call
  and is not counted, as the reference did not count a jit called inside
  another's trace.
- A function whose distinct-signature count exceeds its **budget**
  (:data:`DEFAULT_BUDGET`, overridable per function via :func:`set_budget`)
  records a :class:`Violation` carrying the full signature history.
- ``_build.build`` is wrapped too: each ``nvcc`` compilation of a kernel
  source is counted (:func:`build_counts`; :func:`load_counts` counts the
  ``_build.load`` calls that asked for it).  A source built more than once
  in one process records a ``kernel-rebuild`` violation: its library was
  lost or its hash changed under a running program.

Violations are *recorded*, not raised — instrumentation must never change
program behavior; :func:`analysis.arm.armed` arms the detector for the
suites that name it and their fixture fails the test at teardown, exactly
like the lockgraph detector.
"""

from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass, field

from lakesoul_tpu_torch.analysis.lockgraph import real_lock

__all__ = [
    "DEFAULT_BUDGET",
    "HOT_FUNCTIONS",
    "Violation",
    "build_counts",
    "disable",
    "enable",
    "enabled",
    "env_requested",
    "instrument",
    "load_counts",
    "reset",
    "set_budget",
    "signature_counts",
    "violations",
    "watch",
]

_ENV = "LAKESOUL_TRACECHECK"

DEFAULT_BUDGET = 8

# module -> its hot functions: the hand-kernel wrappers, then the bodies
# the reference jitted (the mirrored _HOT_MODULES, plus the ragged plane)
HOT_FUNCTIONS = {
    "lakesoul_tpu_torch.vector.kernels": (
        "packed_dot", "packed_estimate", "packed_dot_batch", "packed_estimate_batch",
        "packed_scan", "bruteforce_distances", "bruteforce_topk", "_fused_search",
        "_fused_search_resident", "_fused_search_resident_batch", "_fused_search_ex",
        "_fused_search_resident_ex_batch",
    ),
    "lakesoul_tpu_torch.vector.kmeans": ("kmeans",),
    "lakesoul_tpu_torch.vector.rabitq": ("estimate_distances",),
    "lakesoul_tpu_torch.annplane.ragged": ("ragged_score",),
}

_BUILD_MODULE = "lakesoul_tpu_torch._build"


@dataclass
class Violation:
    kind: str  # "retrace-budget" | "kernel-rebuild"
    function: str
    count: int
    budget: int
    signatures: tuple[str, ...] = field(default_factory=tuple)

    def render(self) -> str:
        if self.kind == "kernel-rebuild":
            head = (f"[{self.kind}] {self.function} was compiled {self.count} times in "
                    f"one process (budget {self.budget}) — a kernel library is built "
                    "once and loaded from then on; a rebuild means it was lost or its "
                    "source hash changed under a running program")
        else:
            head = (f"[{self.kind}] {self.function} saw {self.count} distinct "
                    f"signatures (budget {self.budget}) — the shape-bucketing contract "
                    "keeps hot functions on a few shapes; bucket/pad the thrashing "
                    "dimension or raise this function's budget on purpose")
        return "\n".join([head, *(f"  {s}" for s in self.signatures)])


class _State:
    def __init__(self):
        self.lock = real_lock()
        self.enabled = False
        self.signatures: dict[str, list[str]] = {}
        self.budgets: dict[str, int] = {}
        self.violations: list[Violation] = []
        self.reported: set[str] = set()
        self.builds: dict[str, int] = {}
        self.loads: dict[str, int] = {}
        # (module, attr, original) to restore on disable
        self.patched: list[tuple] = []


_STATE = _State()
_TLS = threading.local()


def _leaf_sig(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{str(dtype).removeprefix('torch.')}[{','.join(map(str, shape))}]"
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return repr(x)
    return type(x).__name__


def _leaves(obj, out: list) -> None:
    if isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            out.append(f"{k}=")
            _leaves(obj[k], out)
    else:
        out.append(_leaf_sig(obj))


def _signature(args, kwargs) -> str:
    out: list[str] = []
    _leaves((args, kwargs), out)
    return "(" + ", ".join(out) + ")"


def _record(label: str, sig: str) -> None:
    with _STATE.lock:
        if not _STATE.enabled:
            return
        seen = _STATE.signatures.setdefault(label, [])
        if sig in seen:
            return
        seen.append(sig)
        budget = _STATE.budgets.get(label, DEFAULT_BUDGET)
        if len(seen) <= budget:
            return
        if label not in _STATE.reported:
            _STATE.reported.add(label)
            _STATE.violations.append(
                Violation("retrace-budget", label, len(seen), budget, tuple(seen)))
            return
        # keep the violation's history current past the first overrun
        for v in _STATE.violations:
            if v.function == label and v.kind == "retrace-budget":
                v.count = len(seen)
                v.signatures = tuple(seen)


class _CountedFn:
    """Counting proxy around one hot function.  Attribute reads and writes
    go to the function itself, so ``wrapper.launches += 1`` inside the
    function (which finds the proxy under its module name) still counts
    once, on the function."""

    def __init__(self, inner, label: str):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_label", label)
        object.__setattr__(self, "__wrapped__", inner)
        object.__setattr__(self, "__doc__", getattr(inner, "__doc__", None))

    def __call__(self, *args, **kwargs):
        if not _STATE.enabled:
            return self._inner(*args, **kwargs)
        depth = getattr(_TLS, "depth", 0)
        if depth == 0:
            _record(self._label, _signature(args, kwargs))
        _TLS.depth = depth + 1
        try:
            return self._inner(*args, **kwargs)
        finally:
            _TLS.depth = depth

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_inner"), item)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def __repr__(self):
        return f"<tracechecked {self._label}>"


def instrument(module, attr: str) -> "_CountedFn":
    """Count ``module.attr``'s top-level calls (idempotent); public so tests
    can instrument a fixture module's function."""
    obj = getattr(module, attr)
    if isinstance(obj, _CountedFn):
        return obj
    proxy = _CountedFn(obj, f"{module.__name__}.{attr}")
    setattr(module, attr, proxy)
    _STATE.patched.append((module, attr, obj))
    return proxy


def _rebind_imports(proxies: dict) -> None:
    """Point this package's ``from module import fn`` bindings of the hot
    functions at their proxies too (``vector/index.py`` calls the search
    bodies through such names)."""
    import sys

    for name, mod in list(sys.modules.items()):
        if not name.startswith("lakesoul_tpu_torch.") or mod is None:
            continue
        for attr, obj in list(vars(mod).items()):
            proxy = proxies.get(id(obj))
            if proxy is not None and proxy._inner is obj:
                setattr(mod, attr, proxy)
                _STATE.patched.append((mod, attr, obj))


def _counted_build(orig):
    def build(names=None):
        report = orig() if names is None else orig(names)
        with _STATE.lock:
            if _STATE.enabled:
                for name in report:
                    n = _STATE.builds[name] = _STATE.builds.get(name, 0) + 1
                    if n > 1 and ("build", name) not in _STATE.reported:
                        _STATE.reported.add(("build", name))
                        _STATE.violations.append(
                            Violation("kernel-rebuild", f"csrc/{name}.cu", n, 1))
                    elif n > 1:
                        for v in _STATE.violations:
                            if v.kind == "kernel-rebuild" and v.function == f"csrc/{name}.cu":
                                v.count = n
        return report

    return build


def _counted_load(orig):
    def load(name):
        with _STATE.lock:
            if _STATE.enabled:
                _STATE.loads[name] = _STATE.loads.get(name, 0) + 1
        return orig(name)

    return load


def _instrument_all() -> None:
    proxies = {}
    for modname, names in HOT_FUNCTIONS.items():
        mod = importlib.import_module(modname)
        for attr in names:
            obj = getattr(mod, attr, None)
            if callable(obj) and not isinstance(obj, _CountedFn):
                proxies[id(obj)] = instrument(mod, attr)
    _rebind_imports(proxies)
    build_mod = importlib.import_module(_BUILD_MODULE)
    for attr, wrap in (("build", _counted_build), ("load", _counted_load)):
        orig = getattr(build_mod, attr)
        setattr(build_mod, attr, wrap(orig))
        _STATE.patched.append((build_mod, attr, orig))


# ------------------------------------------------------------------ control


def enabled() -> bool:
    return _STATE.enabled


def env_requested() -> bool:
    return os.environ.get(_ENV, "").strip() == "1"


def set_budget(function_label: str, budget: int) -> None:
    """Declare a per-function signature budget (label as rendered in
    violations: ``module.name``).  Applies to future recordings."""
    with _STATE.lock:
        _STATE.budgets[function_label] = budget


def signature_counts() -> dict[str, int]:
    with _STATE.lock:
        return {k: len(v) for k, v in _STATE.signatures.items()}


def build_counts() -> dict[str, int]:
    """``nvcc`` compilations per kernel source since :func:`reset`."""
    with _STATE.lock:
        return dict(_STATE.builds)


def load_counts() -> dict[str, int]:
    """``_build.load`` calls per kernel source since :func:`reset`."""
    with _STATE.lock:
        return dict(_STATE.loads)


def violations() -> list[Violation]:
    with _STATE.lock:
        return list(_STATE.violations)


def reset() -> None:
    """Drop recorded signatures, builds and violations (instrumentation
    stays)."""
    with _STATE.lock:
        _STATE.signatures.clear()
        _STATE.violations.clear()
        _STATE.reported.clear()
        _STATE.builds.clear()
        _STATE.loads.clear()


def enable() -> None:
    """Instrument the hot functions and the kernel build.  Idempotent."""
    if _STATE.enabled:
        return
    _instrument_all()
    _STATE.enabled = True


def disable() -> None:
    """Restore every instrumented attribute.  Proxies already handed out
    keep delegating; recording stops."""
    if not _STATE.enabled:
        return
    for mod, attr, obj in reversed(_STATE.patched):
        setattr(mod, attr, obj)
    _STATE.patched.clear()
    _STATE.enabled = False


class Watch:
    """Handle yielded by :func:`watch`: violations recorded since entry."""

    def __init__(self, mark: int):
        self._mark = mark

    @property
    def violations(self) -> list[Violation]:
        return violations()[self._mark:]


class watch:
    """``with watch() as w:`` — enable for the block, inspect
    ``w.violations`` after (state is NOT reset on exit so nested watches
    compose; call :func:`reset` between independent scenarios)."""

    def __enter__(self) -> Watch:
        self._was_enabled = _STATE.enabled
        enable()
        return Watch(len(violations()))

    def __exit__(self, *exc):
        if not self._was_enabled:
            disable()
        return False
