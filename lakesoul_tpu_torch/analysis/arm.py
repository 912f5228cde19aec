"""Arm the runtime detectors around one test suite, by its module name.

The six detectors (:mod:`lockgraph`, :mod:`racecheck`, :mod:`leakcheck`,
:mod:`fscheck`, :mod:`txncheck`, :mod:`tracecheck`) are opt-in: each arms
only when its variable is ``1`` (``LAKESOUL_LOCKCHECK``,
``LAKESOUL_RACECHECK``, ``LAKESOUL_LEAKCHECK``, ``LAKESOUL_FSCHECK``,
``LAKESOUL_TXNCHECK``, ``LAKESOUL_TRACECHECK``) and only for the suites its
list below names — the suites that drive the detector's seams hardest.  A
suite arms itself with one autouse fixture::

    @pytest.fixture(autouse=True)
    def _detectors():
        with armed(__name__, device="cpu") as found:
            yield
        assert not found, found.render()

:func:`armed` enables each named detector that nothing else manages yet,
runs the crash-prefix and transaction replays at exit (``device`` is where
the crash replay opens an ANN plane), and fills ``found`` with every
violation recorded meanwhile.  With no variable set it does nothing at
all.  This module imports no test framework.
"""

from __future__ import annotations

import contextlib
import importlib

__all__ = ["DETECTORS", "Findings", "armed", "requested"]

# detector module -> the suites it arms for
DETECTORS = {
    "lockgraph": ("test_torch_loader", "test_torch_compaction"),
    "racecheck": ("test_torch_loader", "test_torch_vector_serving", "test_torch_compaction"),
    "leakcheck": ("test_torch_scanplane", "test_torch_autoscale", "test_torch_freshness"),
    "fscheck": ("test_torch_scanplane", "test_torch_fleet_train"),
    "txncheck": ("test_torch_compaction", "test_torch_streaming"),
    "tracecheck": ("test_torch_vector_kernels", "test_torch_vector_index", "test_torch_loader"),
}


class Findings(list):
    """The violations of one armed block, each tagged with its detector."""

    def render(self) -> str:
        return "\n\n".join(f"{name}: {v.render()}" for name, v in self)


def _module(name: str):
    return importlib.import_module(f"lakesoul_tpu_torch.analysis.{name}")


def requested(suite: str) -> list[str]:
    """The detectors whose variable is set and whose list names ``suite``
    (a module name; its last dotted part is matched)."""
    short = suite.rpartition(".")[2]
    return [name for name, suites in DETECTORS.items()
            if short in suites and _module(name).env_requested()]


@contextlib.contextmanager
def armed(suite: str, *, device=None):
    """Enable the detectors :func:`requested` names for ``suite`` (those
    another caller already enabled are left to it), and at exit run their
    replays, disable and reset them, and put what they recorded in the
    yielded :class:`Findings`."""
    found = Findings()
    mods = {}
    for name in requested(suite):
        mod = _module(name)
        if not mod.enabled():
            mod.reset()
            mod.enable()
            mods[name] = mod
    scope = None
    if "leakcheck" in mods:
        scope = mods["leakcheck"].scope(suite)
        scope.__enter__()
    try:
        yield found
    finally:
        try:
            if scope is not None:
                scope.__exit__(None, None, None)
            if "fscheck" in mods:
                mods["fscheck"].replay(device=device)
            if "txncheck" in mods:
                mods["txncheck"].replay()
        finally:
            for name, mod in mods.items():
                found.extend((name, v) for v in mod.violations())
                mod.disable()
                mod.reset()
