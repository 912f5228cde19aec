"""Process memory accounting helpers (a copy of
``lakesoul_tpu/utils/memory.py``)."""

from __future__ import annotations


def current_rss_mb() -> float:
    """This process's CURRENT resident set, in MiB (``/proc/self/statm``).

    Unlike the high-water counters (``ru_maxrss``, ``VmHWM``), the current
    RSS can never leak a forked parent's footprint through ``execve`` —
    see :func:`peak_rss_mb` for why that matters — so a subprocess that
    samples this at its own cadence (e.g. once per consumed batch) gets a
    peak that is genuinely ITS OWN on every kernel, emulated or not.
    Returns 0.0 where /proc is absent."""
    import os

    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except (OSError, ValueError, IndexError):
        return 0.0


def peak_rss_mb() -> float:
    """This process's peak resident set, in MiB — with a caveat.

    ``getrusage(RUSAGE_SELF).ru_maxrss`` is the obvious API but carries a
    Linux quirk that poisons subprocess measurements: ``maxrss`` lives on
    the signal struct, which SURVIVES ``execve`` — a worker forked from a
    large parent (pytest after a long session, a bench driver that just
    built a 100M-row table) reports the PARENT's high-water mark, not its
    own.  ``VmHWM`` in ``/proc/self/status`` is per-``mm`` and resets at
    exec on mainline Linux, so it is preferred; ru_maxrss remains the
    fallback where /proc is absent.

    CAVEAT (proven in tests/test_stream_ceiling.py's history): sandboxed
    kernels that emulate /proc (gVisor reports "Linux 4.4.0") serve VmHWM
    from the same exec-surviving usage counter as ru_maxrss, so under
    those a fresh child still reports max(parent peak, own peak).  A
    subprocess asserting a ceiling on ITSELF must sample
    :func:`current_rss_mb` instead of trusting any high-water counter."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    import sys

    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # linux reports KiB; macOS reports BYTES (the only common /proc-less host)
    return maxrss / (1 << 20) if sys.platform == "darwin" else maxrss / 1024.0
