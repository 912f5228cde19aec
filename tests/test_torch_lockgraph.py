"""lockgraph in the port (``lakesoul_tpu_torch/analysis/lockgraph.py``), case
for case the reference's lockgraph cases (``tests/test_analysis.py``): the
lock-order cycle and the pool submit under a held lock are recorded, with
their stacks, on the port's pool; correct code, ``Condition`` / ``Queue``,
recycled addresses and cross-thread releases stay silent; ``disable``
restores the primitives; the port's pipeline and catalog run clean.

The last cases hold the port's detector against the reference's on the same
seeded shapes: ``tests/fixtures/lockbugs.py`` as it stands (its
``submit_while_locked`` uses the reference's pool), and a copy of that
shape on the port's pool.  Both lockgraphs patch ``threading.Lock``, so
they are never enabled together: each side is disabled and reset before
the other runs."""

from __future__ import annotations

import threading
from collections import Counter

import pytest

from lakesoul_tpu_torch.analysis import lockgraph


@pytest.fixture()
def clean_lockgraph():
    lockgraph.reset()
    yield
    lockgraph.disable()
    lockgraph.reset()


def submit_while_locked_on_the_ports_pool() -> None:
    """``fixtures/lockbugs.py``'s ``submit_while_locked``, on the port's pool."""
    from lakesoul_tpu_torch.runtime.pool import get_pool

    guard = threading.Lock()
    with guard:
        fut = get_pool().submit(lambda: 1)
    assert fut.result() == 1


def test_lockgraph_catches_seeded_inversion(clean_lockgraph):
    from fixtures import lockbugs

    with lockgraph.watch() as w:
        lockbugs.lock_order_inversion()
    kinds = [v.kind for v in w.violations]
    assert kinds == ["lock-cycle"]
    v = w.violations[0]
    assert "inverts an existing lock order" in v.message
    assert v.stacks


def test_lockgraph_catches_submit_while_locked(clean_lockgraph):
    from lakesoul_tpu_torch.runtime.pool import shutdown_pool

    try:
        with lockgraph.watch() as w:
            submit_while_locked_on_the_ports_pool()
    finally:
        shutdown_pool()
    kinds = [v.kind for v in w.violations]
    assert kinds == ["submit-while-locked"]
    assert "pool.submit while holding" in w.violations[0].message


def test_lockgraph_hooks_the_ports_pool_not_the_references(clean_lockgraph):
    from lakesoul_tpu.runtime.pool import WorkerPool as RefPool
    from lakesoul_tpu_torch.runtime.pool import WorkerPool

    ref_submit = RefPool.submit
    with lockgraph.watch():
        assert hasattr(WorkerPool.submit, "_lockgraph_orig")
        assert RefPool.submit is ref_submit
    assert not hasattr(WorkerPool.submit, "_lockgraph_orig")


def test_lockgraph_silent_on_correct_code(clean_lockgraph):
    from fixtures import lockbugs

    with lockgraph.watch() as w:
        lockbugs.well_ordered()
    assert w.violations == []


def test_lockgraph_handles_condition_and_queue(clean_lockgraph):
    import queue

    with lockgraph.watch() as w:
        q: queue.Queue = queue.Queue(maxsize=2)

        def produce():
            for i in range(10):
                q.put(i)

        t = threading.Thread(target=produce)
        t.start()
        got = [q.get() for _ in range(10)]
        t.join()
        assert got == list(range(10))

        cond = threading.Condition()
        hits = []

        def waiter():
            with cond:
                while not hits:
                    cond.wait(timeout=5)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            hits.append(1)
            cond.notify_all()
        t.join()
    assert w.violations == []


def test_lockgraph_no_false_cycle_from_address_reuse(clean_lockgraph):
    with lockgraph.watch() as w:
        for _ in range(200):
            a, b = threading.Lock(), threading.Lock()
            with a:
                with b:
                    pass
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_lockgraph_cross_thread_release_clears_hold(clean_lockgraph):
    from lakesoul_tpu_torch.runtime.pool import get_pool, shutdown_pool

    try:
        with lockgraph.watch() as w:
            gate = threading.Lock()
            gate.acquire()

            def release_from_other_thread():
                gate.release()

            t = threading.Thread(target=release_from_other_thread)
            t.start()
            t.join()
            assert lockgraph.current_held() == []
            assert get_pool().submit(lambda: 1).result() == 1
    finally:
        shutdown_pool()
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_lockgraph_disable_restores_primitives(clean_lockgraph):
    real_lock, real_rlock = threading.Lock, threading.RLock
    with lockgraph.watch():
        assert threading.Lock is not real_lock
        assert threading.RLock is not real_rlock
    assert threading.Lock is real_lock
    assert threading.RLock is real_rlock


def test_lockgraph_clean_on_real_data_path(clean_lockgraph, tmp_path):
    """The port's runtime pipeline, catalog and loader under
    instrumentation: zero violations."""
    import numpy as np
    import pyarrow as pa

    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.runtime.pipeline import pipeline
    from lakesoul_tpu_torch.runtime.pool import shutdown_pool

    try:
        with lockgraph.watch() as w:
            it = (
                pipeline("lockcheck")
                .source(range(64))
                .map_parallel(lambda x: x * 2, workers=4, name="double")
                .prefetch(2)
                .run()
            )
            assert list(it) == [x * 2 for x in range(64)]
            it.close()

            catalog = LakeSoulCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "meta.db"))
            t = catalog.create_table("lockcheck_t", pa.schema([("id", pa.int64())]),
                                     primary_keys=["id"], hash_bucket_num=2)
            t.write_arrow(pa.table({"id": np.arange(100, dtype=np.int64)}))
            assert t.to_arrow().num_rows == 100
            rows = sum(len(b["id"]) for b in t.scan().batch_size(16).to_torch_iter(
                device="cpu", drop_remainder=False))
            assert rows == 100
    finally:
        shutdown_pool()
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_env_gate(monkeypatch):
    monkeypatch.delenv("LAKESOUL_LOCKCHECK", raising=False)
    assert not lockgraph.env_requested()
    monkeypatch.setenv("LAKESOUL_LOCKCHECK", "1")
    assert lockgraph.env_requested()


# ------------------------------------------- the port against the reference


def _kinds(violations) -> list:
    return sorted(Counter(v.kind for v in violations).items())


def _reference_side(fn):
    from lakesoul_tpu.analysis import lockgraph as ref
    from lakesoul_tpu.runtime.pool import shutdown_pool as ref_shutdown

    assert not lockgraph.enabled()
    ref.reset()
    try:
        with ref.watch() as rw:
            fn()
        return _kinds(rw.violations), [v.message.split(" while ")[0] for v in rw.violations]
    finally:
        ref.disable()
        ref.reset()
        ref_shutdown()


def _port_side(fn):
    from lakesoul_tpu_torch.runtime.pool import shutdown_pool

    lockgraph.reset()
    try:
        with lockgraph.watch() as w:
            fn()
        return _kinds(w.violations), [v.message.split(" while ")[0] for v in w.violations]
    finally:
        lockgraph.disable()
        lockgraph.reset()
        shutdown_pool()


@pytest.mark.parametrize("case", ["lock_order_inversion", "well_ordered"])
def test_lockbugs_record_what_the_references_detector_records(case, clean_lockgraph):
    from fixtures import lockbugs

    fn = getattr(lockbugs, case)
    want = _reference_side(fn)
    got = _port_side(fn)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])


def test_submit_while_locked_on_each_packages_pool_records_the_same(clean_lockgraph):
    """The fixture's shape on the reference's pool under the reference's
    detector, and its copy on the port's pool under the port's: one
    ``submit-while-locked`` each.  Each detector hooks only its own pool."""
    from fixtures import lockbugs

    want = _reference_side(lockbugs.submit_while_locked)
    got = _port_side(submit_while_locked_on_the_ports_pool)
    assert got[0] == want[0] == [("submit-while-locked", 1)]
    assert got[1] == want[1] == ["pool.submit"]
    # crossed over, neither detector sees the other package's pool
    assert _port_side(lockbugs.submit_while_locked)[0] == []
