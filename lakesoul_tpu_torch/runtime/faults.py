"""Fault injection for pipeline stages and object-store calls
(robustness-test hook).

``LAKESOUL_FAULTS`` names fault points and what should go wrong in them,
so tests (and chaos runs) can prove that errors, latency, truncation and
hangs anywhere in the stack surface correctly — propagated exception,
trace id in the log, backpressure held, retry absorbed — without
monkeypatching internals:

    LAKESOUL_FAULTS="decode:0.5"                # stage 'decode' raises, p=0.5
    LAKESOUL_FAULTS="scan_unit.decode:1"        # fully-qualified stage name
    LAKESOUL_FAULTS="fetch:0.2:delay:0.05"      # 50 ms latency, p=0.2
    LAKESOUL_FAULTS="object_store.cat_file:0.3:flaky"   # transient GET errors
    LAKESOUL_FAULTS="object_store.cat_file:0.1:truncate:0.5"  # short reads
    LAKESOUL_FAULTS="meta.commit.phase2:1:hang:30"      # stall mid-commit

Fault points come in two families: pipeline stages (``pipeline.stage``
qualified names from runtime/pipeline.py) and object-store operations
(``object_store.cat_file``, ``object_store.open``, ``page_cache.fetch``,
``meta.commit.phase2`` — called from io/object_store.py, io/page_cache.py
and meta/client.py).  A spec matches a point when it equals the qualified
name or its bare last segment.

Spec grammar: ``stage:probability[:kind[:seconds]]`` with kinds

- ``error`` (default): raise :class:`FaultInjected` (permanent-looking)
- ``flaky``: raise ``ConnectionError`` — the transient taxonomy in
  runtime/resilience.py retries these, so chaos runs exercise the real
  retry path instead of a bespoke test double
- ``delay``: sleep ``seconds`` (default 0.01) before proceeding
- ``hang``: sleep ``seconds`` (default 5.0) — long enough to trip
  deadlines or to hold a window open for a kill-mid-commit test
- ``truncate``: only applies at byte-returning points (via
  :func:`filter_bytes`); keeps the leading ``seconds`` fraction of the
  payload (default 0.5) — a short read the checksum/decode layer must
  catch and the retry layer must absorb

Injection draws from a process-wide deterministic RNG seeded by
``LAKESOUL_FAULTS_SEED`` (default 0), so a failing chaos run reproduces.

Tests install specs programmatically with :func:`install` (no env needed);
:func:`clear` removes them.  The hot-path cost with no faults configured is
one module-level boolean check.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass

from lakesoul_tpu_torch.errors import LakeSoulError

__all__ = [
    "FaultInjected",
    "FaultSpec",
    "install",
    "clear",
    "maybe_inject",
    "filter_bytes",
    "active",
]

logger = logging.getLogger(__name__)

_ENV = "LAKESOUL_FAULTS"
_ENV_SEED = "LAKESOUL_FAULTS_SEED"

KINDS = ("error", "delay", "flaky", "hang", "truncate")

_DEFAULT_SECONDS = {"delay": 0.01, "hang": 5.0, "truncate": 0.5}


class FaultInjected(LakeSoulError):
    """Deliberate failure from the fault-injection hook (never raised in
    production unless ``LAKESOUL_FAULTS`` is set)."""


@dataclass(frozen=True)
class FaultSpec:
    stage: str          # qualified ("pipeline.stage") or bare stage name
    probability: float  # 0..1
    kind: str = "error"  # one of KINDS
    seconds: float = 0.0  # delay/hang duration; truncate keep-fraction

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        parts = text.strip().split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault spec {text!r} must be stage:probability[:kind[:seconds]]"
            )
        stage = parts[0]
        try:
            prob = float(parts[1])
        except ValueError:
            raise ValueError(
                f"bad fault spec {text!r}: probability {parts[1]!r} is not a number"
            ) from None
        if not stage or not 0.0 <= prob <= 1.0:
            raise ValueError(f"bad fault spec {text!r}")
        kind = parts[2] if len(parts) > 2 else "error"
        if kind not in KINDS:
            raise ValueError(
                f"fault kind must be one of {'|'.join(KINDS)}, got {kind!r}"
            )
        if len(parts) > 3:
            try:
                seconds = float(parts[3])
            except ValueError:
                raise ValueError(
                    f"bad fault spec {text!r}: seconds {parts[3]!r} is not a number"
                ) from None
        else:
            seconds = _DEFAULT_SECONDS.get(kind, 0.01)
        if kind == "truncate" and not 0.0 <= seconds <= 1.0:
            raise ValueError(
                f"bad fault spec {text!r}: truncate keep-fraction must be in [0, 1]"
            )
        return cls(stage, prob, kind, seconds)


_LOCK = threading.Lock()
_SPECS: list[FaultSpec] = []
_ENABLED = False  # hot-path guard: one bool read when no faults configured
_RNG = random.Random(int(os.environ.get(_ENV_SEED, "0") or "0"))
_ENV_LOADED = False


def _load_env_once() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    with _LOCK:
        if _ENV_LOADED:
            return
        raw = os.environ.get(_ENV, "").strip()
        if raw:
            for item in raw.split(","):
                if item.strip():
                    _install_locked(FaultSpec.parse(item))
        _set_env_loaded()


def _set_env_loaded() -> None:
    global _ENV_LOADED
    _ENV_LOADED = True


def _install_locked(spec: FaultSpec) -> None:
    global _ENABLED
    _SPECS.append(spec)
    _ENABLED = True


def install(spec: FaultSpec | str) -> FaultSpec:
    """Add one fault spec (tests).  Accepts a spec object or the env string
    form ``stage:p[:kind[:seconds]]``."""
    if isinstance(spec, str):
        spec = FaultSpec.parse(spec)
    with _LOCK:
        _install_locked(spec)
    return spec


def clear() -> None:
    """Remove every installed spec (including env-loaded ones)."""
    global _ENABLED
    with _LOCK:
        _SPECS.clear()
        _ENABLED = False
        _set_env_loaded()  # a cleared config must not resurrect from env


def active() -> list[FaultSpec]:
    _load_env_once()
    with _LOCK:
        return list(_SPECS)


def _matching(qualname: str) -> list[tuple[FaultSpec, float]]:
    """(spec, draw) pairs for the specs that name this point; draws are
    taken under the lock so concurrent injection stays deterministic
    per-seed regardless of which thread gets here first with the lock."""
    bare = qualname.rsplit(".", 1)[-1]
    with _LOCK:
        specs = [s for s in _SPECS if s.stage in (qualname, bare)]
        return [(s, _RNG.random()) for s in specs]


def maybe_inject(qualname: str) -> None:
    """Called by pipeline stage wrappers and object-store fault points with
    the point's qualified name.  Raises :class:`FaultInjected` /
    ``ConnectionError`` or sleeps according to the matching spec, if any
    fires.  ``truncate`` specs are ignored here (they only act on bytes —
    see :func:`filter_bytes`)."""
    if not _ENABLED and _ENV_LOADED:
        return
    _load_env_once()
    if not _ENABLED:
        return
    for spec, draw in _matching(qualname):
        if draw >= spec.probability:
            continue
        if spec.kind in ("delay", "hang"):
            time.sleep(spec.seconds)
        elif spec.kind == "flaky":
            logger.warning("flaky fault injected into %s", qualname)
            raise ConnectionError(f"injected flaky fault in {qualname}")
        elif spec.kind == "truncate":
            continue  # byte-level kind; no control-flow effect here
        else:
            logger.warning("fault injected into stage %s", qualname)
            raise FaultInjected(f"injected fault in stage {qualname}")


def filter_bytes(qualname: str, data: bytes) -> bytes:
    """Apply matching ``truncate`` specs to a byte payload: keep the leading
    ``seconds`` fraction.  Byte-returning fault points (object-store GETs)
    call this on their result so chaos runs can prove short reads are
    detected rather than silently merged."""
    if not _ENABLED and _ENV_LOADED:
        return data
    _load_env_once()
    if not _ENABLED or not data:
        return data
    for spec, draw in _matching(qualname):
        if spec.kind != "truncate" or draw >= spec.probability:
            continue
        keep = int(len(data) * spec.seconds)
        logger.warning(
            "truncate fault injected into %s: %d -> %d bytes",
            qualname, len(data), keep,
        )
        return data[:keep]
    return data
