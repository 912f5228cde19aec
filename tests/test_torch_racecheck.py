"""racecheck in the port (``lakesoul_tpu_torch/analysis/racecheck.py``), case
for case the reference's ``tests/test_racecheck.py``: the runtime Eraser
detector catches the seeded shared-state race (with both access stacks),
stays silent on locked and init-phase writes, instruments/restores the
port's hot classes cleanly, and its ring canary proves the
``LAKESOUL_COLLATE_REUSE`` contract under the port's loader.

The port's ring feeds the card from pinned slots whose bytes an H2D copy
reads after the call that dispatched it has returned: there the canary
checks the copy's CUDA event, not a refcount, and poisons a slot only once
its copy has completed.  Those cases run here with an event stand-in that
has ``query`` / ``synchronize``.  The last cases hold the port's detector
against the reference's on the same seeded fixtures: the same violation
kinds and counts."""

from __future__ import annotations

import threading

import numpy as np
import pyarrow as pa
import pytest

from lakesoul_tpu_torch.analysis import racecheck
from lakesoul_tpu_torch.data.torch_iter import _BufferRing, _Slot


@pytest.fixture()
def clean_racecheck():
    racecheck.reset()
    yield
    racecheck.disable()
    racecheck.reset()


# ------------------------------------------------------------ lockset core


def test_catches_seeded_unsynchronized_writes(clean_racecheck):
    from fixtures import racebugs

    with racecheck.watch() as w:
        racecheck.instrument_class(racebugs.UnsyncCounter)
        c = racebugs.unsynchronized_writes()
    assert c.value == 100  # instrumentation must not change behavior
    kinds = {v.kind for v in w.violations}
    assert kinds == {"shared-state-write"}
    v = w.violations[0]
    assert "UnsyncCounter.value" in v.message
    assert "no common lock" in v.message
    assert len(v.stacks) == 2
    assert "first writer" in v.stacks[0]
    assert "racing writer" in v.stacks[1]


def test_silent_on_synchronized_writes(clean_racecheck):
    from fixtures import racebugs

    with racecheck.watch() as w:
        racecheck.instrument_class(racebugs.SyncCounter)
        c = racebugs.synchronized_writes()
    assert c.value == 100
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_silent_on_init_phase_then_locked_publish(clean_racecheck):
    from fixtures import racebugs

    with racecheck.watch() as w:
        racecheck.instrument_class(racebugs.HandoffFlag)
        f = racebugs.locked_publish_after_init()
    assert f.fenced is True
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_lockset_refines_not_first_lock(clean_racecheck):
    class TwoLocks:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()
            self.field = 0

        def via_a(self):
            with self.a:
                self.field += 1

        def via_b(self):
            with self.b:
                self.field += 1

    with racecheck.watch() as w:
        racecheck.instrument_class(TwoLocks)
        obj = TwoLocks()
        for fn in (obj.via_a, obj.via_b):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
    assert {v.kind for v in w.violations} == {"shared-state-write"}
    assert "TwoLocks.field" in w.violations[0].message


def test_instrumentation_restores_on_disable(clean_racecheck):
    from lakesoul_tpu_torch.runtime.lease import LeaseHeartbeat
    from lakesoul_tpu_torch.runtime.resilience import CircuitBreaker

    racecheck.enable()
    assert hasattr(CircuitBreaker.__dict__.get("__setattr__"), "_racecheck_orig")
    assert hasattr(LeaseHeartbeat.__dict__.get("__setattr__"), "_racecheck_orig")
    assert hasattr(_BufferRing.next_slot, "_racecheck_orig")
    racecheck.disable()
    for cls in (CircuitBreaker, LeaseHeartbeat):
        assert "__setattr__" not in cls.__dict__ or not hasattr(
            cls.__dict__["__setattr__"], "_racecheck_orig")
    assert not hasattr(_BufferRing.next_slot, "_racecheck_orig")


def test_hot_classes_are_the_ports():
    """Every hot class names a class of this package (none of the
    reference's), and each one exists."""
    import importlib

    for modname, clsname in racecheck.HOT_CLASSES:
        assert modname.startswith("lakesoul_tpu_torch."), modname
        assert isinstance(getattr(importlib.import_module(modname), clsname), type)
    assert racecheck._RING_MODULE == "lakesoul_tpu_torch.data.torch_iter"


def test_hot_classes_run_clean_under_instrumentation(clean_racecheck):
    from lakesoul_tpu_torch.runtime.resilience import AdmissionController, CircuitBreaker

    with racecheck.watch() as w:
        breaker = CircuitBreaker("racecheck-probe", failure_threshold=2)
        gate = AdmissionController("racecheck-probe", max_inflight=2, max_queue=8)

        def hammer():
            for _ in range(50):
                try:
                    breaker.call(lambda: 1)
                except Exception:
                    pass
                with gate.admit():
                    pass

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_env_gate(monkeypatch):
    monkeypatch.delenv("LAKESOUL_RACECHECK", raising=False)
    assert not racecheck.env_requested()
    monkeypatch.setenv("LAKESOUL_RACECHECK", "1")
    assert racecheck.env_requested()


# ------------------------------------------------------------- ring canary


def test_ring_canary_detects_use_after_release(clean_racecheck):
    with racecheck.watch() as w:
        ring = _BufferRing(2)
        held = []
        for i in range(4):
            slot = ring.next_slot()
            if "c" not in slot:
                slot["c"] = np.zeros(8)
            held.append(slot["c"])  # borrower never lets go: contract broken
    kinds = {v.kind for v in w.violations}
    assert kinds == {"ring-use-after-release"}
    assert "borrowed view is still live" in w.violations[0].message


def test_ring_canary_poisons_released_slots(clean_racecheck):
    with racecheck.watch():
        ring = _BufferRing(1)
        slot = ring.next_slot()
        slot["c"] = np.zeros(8, dtype=np.float64)
        ring.next_slot()  # wrap: the slot is dead, its bytes poisoned
        assert all(b == 0xAB for b in slot["c"].view("uint8").tobytes())


def test_ring_canary_silent_for_conforming_borrower(clean_racecheck):
    with racecheck.watch() as w:
        ring = _BufferRing(2)
        for i in range(6):
            slot = ring.next_slot()
            if "c" not in slot:
                slot["c"] = np.zeros(8)
            slot["c"][...] = i  # fills and forgets, exactly one window
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


class _CopyEvent:
    """Stand-in for the CUDA event a card delivery records after the H2D
    copy out of a slot: ``query`` is True once the copy has completed,
    ``synchronize`` waits for it (here: completes it at once, unless the
    copy is stuck)."""

    def __init__(self, stuck: bool = False):
        self.done = False
        self.stuck = stuck

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        if not self.stuck:
            self.done = True


def _card_slot(ring: _BufferRing, value: float, event) -> _Slot:
    slot = ring.next_slot()
    slot["c"] = np.full(8, value)
    slot.event = event  # the delivery's copy out of the slot
    return slot


def test_ring_canary_waits_on_the_copy_event_not_a_refcount(clean_racecheck):
    """A card slot is referenced by the delivery's in-flight queue until its
    copy completes: a refcount says nothing there.  The ring waits on the
    copy's event; once it has completed the slot is free (no violation,
    however many references remain) and poisoned."""
    with racecheck.watch() as w:
        ring = _BufferRing(1)
        ev = _CopyEvent()
        slot = _card_slot(ring, 1.0, ev)
        inflight = [dict(slot)]  # the delivery still references the batch
        assert ring.next_slot() is slot
        assert ev.done and slot.event is None
        assert all(b == 0xAB for b in slot["c"].view("uint8").tobytes())
    assert w.violations == [], "\n".join(v.render() for v in w.violations)
    assert inflight


def test_ring_canary_catches_a_slot_reused_before_its_copy(clean_racecheck):
    """A ring that hands a slot out while the copy reading it is still in
    flight is recorded, and the slot is NOT poisoned: poison would overwrite
    bytes the device has not read yet."""
    with racecheck.watch() as w:
        ring = _BufferRing(1)
        slot = _card_slot(ring, 7.0, _CopyEvent(stuck=True))
        ring.next_slot()
    assert [v.kind for v in w.violations] == ["ring-use-after-release"]
    assert "still in flight" in w.violations[0].message
    assert np.array_equal(slot["c"], np.full(8, 7.0))


# ----------------------------------------------- loader ring stress (e2e)


def _ring_table(tmp_warehouse, rows: int = 20_000):
    from lakesoul_tpu_torch import LakeSoulCatalog

    catalog = LakeSoulCatalog(str(tmp_warehouse))
    schema = pa.schema([("id", pa.int64()), ("v", pa.float64())])
    t = catalog.create_table("ring_stress", schema)
    rng = np.random.default_rng(7)
    t.write_arrow(pa.table({
        "id": np.arange(rows, dtype=np.int64),
        "v": rng.normal(size=rows),
    }, schema=schema))
    return t


def test_collate_reuse_ring_stress_canary_and_byte_identity(
    tmp_warehouse, monkeypatch, clean_racecheck
):
    """With the reuse ring ON and the canary ARMED, a conforming host
    consumer (copies each batch out) triggers zero use-after-release across
    epochs, byte-identical to the ring-off run; the CPU delivery (tensors
    alias their buffers, so the ring stays down) matches too."""
    t = _ring_table(tmp_warehouse)
    baseline = [
        {k: np.copy(v) for k, v in b.items()}
        for b in t.scan().batch_size(256).to_torch_iter(
            device_put=False, prefetch=4, drop_remainder=False
        )
    ]

    monkeypatch.setenv("LAKESOUL_COLLATE_REUSE", "1")
    with racecheck.watch() as w:
        for _ in range(2):
            it = t.scan().batch_size(256).to_torch_iter(
                device_put=False, prefetch=4, drop_remainder=False
            )
            assert it._ring is not None
            got = [{k: np.copy(v) for k, v in b.items()} for b in it]
            assert len(got) == len(baseline)
            for a, b in zip(got, baseline):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes(), k
        it = t.scan().batch_size(256).to_torch_iter(
            device="cpu", prefetch=4, device_prefetch=2, drop_remainder=False
        )
        assert it._ring is None
        dev = [{k: v.numpy().copy() for k, v in b.items()} for b in it]
        for a, b in zip(dev, baseline):
            for k in a:
                assert np.array_equal(a[k], b[k]), k
    assert w.violations == [], "\n".join(v.render() for v in w.violations)


def test_collate_reuse_ring_disarms_on_measured_aliasing(
    tmp_warehouse, monkeypatch, clean_racecheck
):
    """The port's counterpart of the reference's aliasing disarm: on the
    CPU a delivered tensor aliases its collate buffer, so the ring must stay
    down there whatever the dtypes; a host consumer keeps the ring."""
    from lakesoul_tpu_torch import LakeSoulCatalog

    catalog = LakeSoulCatalog(str(tmp_warehouse))
    schema = pa.schema([("id", pa.int64()), ("v", pa.float32())])
    t = catalog.create_table("ring_alias", schema)
    rng = np.random.default_rng(11)
    t.write_arrow(pa.table({
        "id": np.arange(4_000, dtype=np.int64),
        "v": rng.normal(size=4_000).astype(np.float32),
    }, schema=schema))
    monkeypatch.setenv("LAKESOUL_COLLATE_REUSE", "1")
    it = t.scan().batch_size(256).to_torch_iter(
        device="cpu", prefetch=4, device_prefetch=2, drop_remainder=False
    )
    assert it._ring is None
    it2 = t.scan().batch_size(256).to_torch_iter(device_put=False)
    assert it2._ring is not None
    list(it)
    list(it2)


def test_collate_reuse_ring_stress_catches_hoarding_consumer(
    tmp_warehouse, monkeypatch, clean_racecheck
):
    t = _ring_table(tmp_warehouse, rows=8_000)
    monkeypatch.setenv("LAKESOUL_COLLATE_REUSE", "1")
    with racecheck.watch() as w:
        it = t.scan().batch_size(256).to_torch_iter(
            device_put=False, prefetch=4, drop_remainder=False
        )
        assert it._ring is not None
        hoard = list(it)  # every batch kept: contract broken
    assert len(hoard) > 0
    assert any(v.kind == "ring-use-after-release" for v in w.violations)


# ------------------------------------------- the port against the reference


def _kinds_and_counts(violations) -> list:
    from collections import Counter

    return sorted(Counter(v.kind for v in violations).items())


@pytest.mark.parametrize("case", [
    ("UnsyncCounter", "unsynchronized_writes"),
    ("SyncCounter", "synchronized_writes"),
    ("HandoffFlag", "locked_publish_after_init"),
])
def test_racebugs_record_what_the_references_detector_records(case, clean_racecheck):
    """The same seeded fixture through both detectors, one after the other
    (both patch ``threading.Lock``: never armed together): the same
    violation kinds and counts, and the fixture's result unchanged."""
    from fixtures import racebugs

    from lakesoul_tpu.analysis import racecheck as ref

    cls, fn = getattr(racebugs, case[0]), getattr(racebugs, case[1])
    ref.reset()
    try:
        with ref.watch() as rw:
            ref.instrument_class(cls)
            ref_out = fn()
        want = _kinds_and_counts(rw.violations)
        want_messages = [v.message for v in rw.violations]
    finally:
        ref.disable()
        ref.reset()
    with racecheck.watch() as w:
        racecheck.instrument_class(cls)
        out = fn()
    got = _kinds_and_counts(w.violations)
    assert got == want
    assert vars(out).get("value", None) == vars(ref_out).get("value", None)
    assert [v.message for v in w.violations] == want_messages
