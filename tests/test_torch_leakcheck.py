"""leakcheck in the port (``lakesoul_tpu_torch/analysis/leakcheck.py``),
case for case the reference's ``tests/test_leakcheck.py``: the runtime
resource-leak detector catches seeded thread/child/debris/fd/heap leaks
(each with its creation stack), stays silent on well-behaved lifecycles
and sanctioned pool threads, instruments/restores the port's creation
seams cleanly, and records, never raises — plus the pins of the port's
exporter serve-thread join, autoscaler retire reaping and stale-spool
pruning, and the ``/dev/shm`` scope: any tmpfs handle that outlives its
scope is a leak, NCCL's process-group segments included."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from lakesoul_tpu_torch.analysis import leakcheck


@pytest.fixture()
def armed():
    leakcheck.reset()
    leakcheck.enable()
    yield
    leakcheck.disable()
    leakcheck.reset()


# ----------------------------------------------------------- control surface


def test_env_gate(monkeypatch):
    monkeypatch.delenv("LAKESOUL_LEAKCHECK", raising=False)
    assert not leakcheck.env_requested()
    monkeypatch.setenv("LAKESOUL_LEAKCHECK", "1")
    assert leakcheck.env_requested()
    monkeypatch.setenv("LAKESOUL_LEAKCHECK", "0")
    assert not leakcheck.env_requested()


def test_instrument_and_restore():
    """enable() swaps the four creation seams; disable() puts the real
    callables back — no wrapper may survive, other suites patch the same
    seams."""
    from lakesoul_tpu_torch.runtime import atomicio

    real_start = threading.Thread.start
    real_init = subprocess.Popen.__init__
    real_stage = atomicio.stage_stream
    real_mkdtemp = tempfile.mkdtemp
    leakcheck.reset()
    leakcheck.enable()
    try:
        assert leakcheck.enabled()
        assert threading.Thread.start is not real_start
        assert subprocess.Popen.__init__ is not real_init
        assert atomicio.stage_stream is not real_stage
        assert tempfile.mkdtemp is not real_mkdtemp
        leakcheck.enable()  # idempotent: no double wrap
    finally:
        leakcheck.disable()
        leakcheck.reset()
    assert not leakcheck.enabled()
    assert threading.Thread.start is real_start
    assert subprocess.Popen.__init__ is real_init
    assert atomicio.stage_stream is real_stage
    assert tempfile.mkdtemp is real_mkdtemp


# ------------------------------------------------------------- seeded leaks


def test_seeded_thread_leak_with_creation_stack(armed):
    stop = threading.Event()
    leaked = threading.Thread(target=stop.wait, name="seeded-leak", daemon=True)
    try:
        with leakcheck.scope("seeded") as s:
            leaked.start()
        kinds = [v.kind for v in s.leaks]
        assert kinds == ["thread-leak"]
        v = s.leaks[0]
        assert "seeded-leak" in v.message
        # the creation stack rides on the report — it names THIS file
        assert v.stacks and "test_torch_leakcheck" in v.stacks[0]
        # recorded, never raised: the scope exits normally and the
        # violation sits in the module registry for the fixture to assert
        assert v in leakcheck.violations()
    finally:
        stop.set()
        leaked.join(timeout=5.0)


def test_joined_thread_and_sanctioned_pool_thread_silent(armed):
    stop = threading.Event()
    with leakcheck.scope("clean") as s:
        # joined before scope end — not a leak
        t = threading.Thread(target=stop.wait, daemon=True)
        t.start()
        stop.set()
        t.join(timeout=5.0)
        # the process-wide pool singleton's threads outlive scopes by
        # design; the sanctioned prefix exempts them
        hold = threading.Event()
        pool_t = threading.Thread(
            target=hold.wait, name="lakesoul-rt-sanctioned", daemon=True
        )
        pool_t.start()
    try:
        assert s.leaks == [], "\n".join(v.render() for v in s.leaks)
    finally:
        hold.set()
        pool_t.join(timeout=5.0)


def test_seeded_child_leak_then_reaped_clean(armed):
    with leakcheck.scope("spawned") as s:
        child = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
    try:
        assert [v.kind for v in s.leaks] == ["child-leak"]
        assert str(child.pid) in s.leaks[0].message
        assert s.leaks[0].stacks and "test_torch_leakcheck" in s.leaks[0].stacks[0]
    finally:
        child.kill()
        child.wait(timeout=10.0)
    # a reaped child is not a leak
    leakcheck.reset()
    with leakcheck.scope("reaped") as s2:
        done = subprocess.Popen([sys.executable, "-c", "pass"])
        done.wait(timeout=30.0)
    assert s2.leaks == [], "\n".join(v.render() for v in s2.leaks)


def test_staged_tmp_debris_vs_committed(armed, tmp_path):
    from lakesoul_tpu_torch.runtime import atomicio

    with leakcheck.scope("staged") as s:
        staged = atomicio.stage_stream(
            str(tmp_path / "doc.json"), lambda f: f.write(b"{}"), holder="seed"
        )
        # ... and nothing ever commits or aborts it
    assert [v.kind for v in s.leaks] == ["debris"]
    assert staged.tmp in s.leaks[0].message
    os.unlink(staged.tmp)  # the port's StagedFile has no abort: the producer unlinks
    leakcheck.reset()
    with leakcheck.scope("committed") as s2:
        ok = atomicio.stage_stream(
            str(tmp_path / "ok.json"), lambda f: f.write(b"{}"), holder="seed"
        )
        ok.commit()
    assert s2.leaks == [], "\n".join(v.render() for v in s2.leaks)
    assert (tmp_path / "ok.json").read_bytes() == b"{}"


def test_mkdtemp_debris_vs_pruned(armed):
    import shutil

    with leakcheck.scope("scratch") as s:
        d = tempfile.mkdtemp(prefix="leakcheck-seed-")
    try:
        assert [v.kind for v in s.leaks] == ["debris"]
        assert d in s.leaks[0].message
    finally:
        shutil.rmtree(d, ignore_errors=True)
    leakcheck.reset()
    with leakcheck.scope("pruned") as s2:
        d2 = tempfile.mkdtemp(prefix="leakcheck-seed-")
        shutil.rmtree(d2)
    assert s2.leaks == [], "\n".join(v.render() for v in s2.leaks)


def test_fd_leak_only_for_scratch_targets(armed, tmp_path):
    scratch = tmp_path / "spool.tmp-seed"
    scratch.write_bytes(b"x")
    plain = tmp_path / "warehouse.bin"
    plain.write_bytes(b"y")
    with leakcheck.scope("fds") as s:
        held_scratch = open(scratch, "rb")
        held_plain = open(plain, "rb")  # legitimate cache shape: silent
    try:
        assert [v.kind for v in s.leaks] == ["fd-leak"]
        assert ".tmp-" in s.leaks[0].message
    finally:
        held_scratch.close()
        held_plain.close()


def test_heap_budget_gate(armed):
    import tracemalloc

    tracemalloc.start()
    try:
        with leakcheck.scope("heap", heap_budget=1_000_000) as s:
            ballast = bytearray(8_000_000)
        assert [v.kind for v in s.leaks] == ["heap-growth"]
        assert "budget 1000000" in s.leaks[0].message
        del ballast
        leakcheck.reset()
        with leakcheck.scope("flat", heap_budget=1_000_000) as s2:
            small = bytearray(1024)
            del small
        assert s2.leaks == []
    finally:
        tracemalloc.stop()


def test_disabled_records_nothing():
    leakcheck.reset()
    assert not leakcheck.enabled()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    with leakcheck.scope("dark") as s:
        t.start()
        d = tempfile.mkdtemp(prefix="leakcheck-dark-")
    try:
        # untracked artifacts can't be reported; the un-instrumented
        # thread IS visible via threading.enumerate, but carries no stack
        assert all(v.kind == "thread-leak" for v in s.leaks)
        for v in s.leaks:
            assert v.stacks == ()
    finally:
        stop.set()
        t.join(timeout=5.0)
        os.rmdir(d)
        leakcheck.reset()


# ------------------------------------------- regression pins (fixed leaks)


def test_exporter_shutdown_joins_serve_thread(armed):
    """PIN: serve_prometheus used to start an anonymous un-joinable
    thread; shutdown() must now join it — under leakcheck the serve scope
    ends thread-clean."""
    from lakesoul_tpu_torch.obs.exporter import serve_prometheus

    with leakcheck.scope("exporter") as s:
        srv = serve_prometheus(port=0, host="127.0.0.1")
        thread = srv._serve_thread
        assert thread.name == "lakesoul-metrics-exporter"
        srv.shutdown()
        srv.server_close()
        assert not thread.is_alive()
    assert s.leaks == [], "\n".join(v.render() for v in s.leaks)


def test_autoscaler_retire_reaps_terminated_child(armed, tmp_path):
    """PIN: retire() used to pop+terminate and drop the handle — a zombie
    until interpreter exit.  It must now park the child on a retiring
    list that reap()/stop_all() waits, collecting the exit status."""
    from lakesoul_tpu_torch.fleet.autoscale import WorkerSpawner

    spawner = WorkerSpawner(str(tmp_path), str(tmp_path))
    spawner.worker_argv = lambda worker_id: [
        sys.executable, "-c", "import time; time.sleep(60)",
    ]
    with leakcheck.scope("retire") as s:
        spawner.spawn()
        child = spawner._children[0]
        spawner.retire()
        deadline = time.monotonic() + 10.0
        while child.poll() is None and time.monotonic() < deadline:
            spawner.reap()
            time.sleep(0.05)
        spawner.stop_all()
        # the exit status was collected — not a zombie, not a leak
        assert child.returncode is not None
        assert spawner._retiring == [] and spawner._children == []
    assert s.leaks == [], "\n".join(v.render() for v in s.leaks)


def test_prune_stale_spools_sweeps_dead_owner(tmp_path):
    """PIN: spool dirs are pid-stamped at creation; a dir whose owner died
    without atexit (SIGKILL) must be swept by the next process's prune,
    while live-owner and markerless dirs are spared."""
    from lakesoul_tpu_torch.runtime import atomicio
    from lakesoul_tpu_torch.scanplane.delivery import (
        _OWNER_MARKER,
        _SPOOL_PREFIX,
        prune_stale_spools,
    )

    base = tmp_path / "shm"
    base.mkdir()
    dead = base / (_SPOOL_PREFIX + "dead")
    dead.mkdir()
    # a pid that cannot exist: max_pid is bounded well below 2**22 + 7
    atomicio.publish_bytes(str(dead / _OWNER_MARKER), str(2**22 + 7).encode())
    live = base / (_SPOOL_PREFIX + "live")
    live.mkdir()
    atomicio.publish_bytes(str(live / _OWNER_MARKER), str(os.getpid()).encode())
    foreign = base / (_SPOOL_PREFIX + "markerless")
    foreign.mkdir()
    unrelated = base / "not-a-spool"
    unrelated.mkdir()

    removed = prune_stale_spools(str(base))
    assert str(dead) in removed and not dead.exists()
    assert live.exists() and foreign.exists() and unrelated.exists()


def test_default_spool_dir_is_owned_and_sweepable(tmp_path, monkeypatch):
    """PIN: default_spool_dir stamps the owner pid so a successor can
    tell live scratch from debris."""
    import lakesoul_tpu_torch.scanplane.delivery as delivery

    monkeypatch.setattr(delivery, "_spool_base", lambda: str(tmp_path))
    d = delivery.default_spool_dir()
    assert os.path.isdir(d)
    marker = os.path.join(d, delivery._OWNER_MARKER)
    with open(marker) as f:
        assert int(f.read()) == os.getpid()
    # own live spool survives a prune pass
    assert d not in delivery.prune_stale_spools(str(tmp_path))
    import shutil

    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------- the port's additions


def test_watch_scopes_a_block(armed):
    """The port's ``watch``: enable for the block inside one scope."""
    leakcheck.disable()
    stop = threading.Event()
    leaked = threading.Thread(target=stop.wait, name="watched-leak", daemon=True)
    try:
        with leakcheck.watch("watched") as w:
            leaked.start()
        assert [v.kind for v in w.violations] == ["thread-leak"]
        assert not leakcheck.enabled()
    finally:
        stop.set()
        leaked.join(timeout=5.0)


def _shm_path(name: str) -> str:
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm on this host")
    return os.path.join("/dev/shm", f"{name}-{os.getpid()}-{threading.get_ident()}")


def test_shm_handle_outliving_its_scope_is_a_leak(armed):
    """Any tmpfs handle that outlives its scope is a leak (the reference's
    scope, kept): a torch shared-memory file or a spool segment alike."""
    path = _shm_path("torch_leakcheck")
    with leakcheck.scope("shm") as s:
        held = open(path, "wb")
    try:
        assert [v.kind for v in s.leaks] == ["fd-leak"]
        assert path in s.leaks[0].message
    finally:
        held.close()
        os.unlink(path)


def test_an_nccl_segment_outliving_its_scope_is_a_leak_too(armed):
    """No tmpfs holder is exempt, NCCL's ``/dev/shm/nccl-*`` segments
    included; a handle closed inside the scope is no leak."""
    nccl = _shm_path("nccl-leakcheck")
    other = _shm_path("lakesoul-leakcheck")
    with leakcheck.scope("nccl") as s:
        held = open(nccl, "wb")
        closed = open(other, "wb")
        closed.close()
    try:
        assert [v.kind for v in s.leaks] == ["fd-leak"]
        assert nccl in s.leaks[0].message
    finally:
        held.close()
        os.unlink(nccl)
        os.unlink(other)
