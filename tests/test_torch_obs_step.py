"""The port's spans inside the training step (``models/train.py``,
``models/bert.py``) and the device timing of ``obs/tracing.py``, on the
CPU.

A CPU profiler turns the spans on; the tree, the profiler's ranges and the
arithmetic are read from a tiny BERT's real step.  CUDA events do not exist
here, so the device side (the pending list, the gaps, the bound, the
sessions, the parents across threads) runs against a stand-in card whose clock the test moves: its
events stamp the card's time when recorded and count as run once the card
has reached it.  The five step readers of the benchmark
(``cellbench/metrics/``) are read against the same stand-in."""

import importlib.util
import sys
import threading
from collections import deque
from pathlib import Path

import pytest
import torch

from lakesoul_tpu_torch.models import BertConfig, make_bert_train_state, make_bert_train_step
from lakesoul_tpu_torch.models.bert import bert_mlm_loss
from lakesoul_tpu_torch.obs import metrics, tracing

ROOT = Path(__file__).resolve().parent.parent
STEP_SPANS = ("train.step", "train.forward", "bert.head", "train.backward",
              "bert.head.backward", "train.optimizer")
READERS = ("step_forward_share.bert", "step_backward_share.bert", "step_optimizer_share.bert",
           "head_share.bert", "step_gap_share.bert")


def _bert(seed=0):
    cfg = BertConfig.tiny(vocab_size=256, max_len=32)
    model, opt = make_bert_train_state(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    labels = torch.where(torch.rand(4, 16, generator=g) < 0.3, ids, -100)
    mask = torch.ones(4, 16, dtype=torch.bool)
    return model, make_bert_train_step(model, opt, device="cpu"), (ids, labels, mask)


@pytest.fixture
def fresh(monkeypatch):
    """A registry, a ring and a device clock of the test's own."""
    monkeypatch.setattr(metrics, "_REGISTRY", metrics.MetricsRegistry())
    monkeypatch.setattr(tracing, "_RECENT", deque(maxlen=512))
    monkeypatch.setattr(tracing, "_CLOCK", tracing._DeviceClock())


class Card:
    """A stand-in card: ``now`` is the time its stream has been given work
    up to, ``ran`` the time its work has run up to."""

    def __init__(self):
        self.now = self.ran = 0.0
        self.syncs = self.events = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None
                card.events += 1

            def record(self, stream=None):
                self.t = card.now

            def query(self):
                return self.t <= card.ran

            def synchronize(self):
                card.ran = max(card.ran, self.t)

            def elapsed_time(self, other):
                assert self.query() and other.query()
                return (other.t - self.t) * 1e3

        self.Event = Event

    def synchronize(self, device=None):
        self.syncs += 1
        self.ran = self.now


@pytest.fixture
def card(fresh, monkeypatch):
    """Device timing on (a profiler's flag up) against a stand-in card."""
    c = Card()
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", c.synchronize)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(tracing, "_cuda_index", lambda device: torch.device(device).index or 0)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    return c


def _device(family):
    return {labels["name"]: h.value for labels, h in metrics.registry().series(family)}


def _timed(card, name, seconds, gap=0.0):
    card.now += gap
    with tracing.span(name, device="cuda") as s:
        card.now += seconds
    return s


# ------------------------------------------------------------ on the CPU
def test_a_profiled_step_records_the_step_tree(fresh):
    _, step, batch = _bert()
    with torch.profiler.profile():
        step(*batch)
    spans = {s["name"]: s for s in tracing.recent_spans()}
    assert set(spans) == set(STEP_SPANS)
    root = spans["train.step"]
    assert root["parent_id"] is None
    for child in ("train.forward", "train.backward", "train.optimizer"):
        assert spans[child]["parent_id"] == root["span_id"]
        assert spans[child]["trace_id"] == root["trace_id"]
    assert spans["bert.head"]["parent_id"] == spans["train.forward"]["span_id"]
    assert spans["bert.head.backward"]["parent_id"] == spans["train.backward"]["span_id"]
    assert _device("lakesoul_span_device_seconds") == {}  # no card: host time only
    assert set(_device("lakesoul_span_seconds")) == set(STEP_SPANS)


def test_the_profilers_events_hold_the_programs_spans(fresh):
    _, step, batch = _bert()
    with torch.profiler.profile() as prof:
        step(*batch)
    names = {e.name for e in prof.events()}
    assert {"lakesoul." + n for n in STEP_SPANS} <= names


def test_without_a_profiler_a_step_makes_no_span_event_hook_or_sample(fresh, monkeypatch):
    made = {"spans": 0, "hooks": 0, "events": 0}
    span_init, register_hook = tracing.Span.__init__, torch.Tensor.register_hook

    def counted_span(self, *a, **kw):
        made["spans"] += 1
        span_init(self, *a, **kw)

    def counted_hook(self, hook):
        made["hooks"] += 1
        return register_hook(self, hook)

    def counted_event(*a, **kw):
        made["events"] += 1
        raise AssertionError("a CUDA event outside a profiler")

    monkeypatch.setattr(tracing.Span, "__init__", counted_span)
    monkeypatch.setattr(torch.Tensor, "register_hook", counted_hook)
    monkeypatch.setattr(torch.cuda, "Event", counted_event)
    _, step, batch = _bert()
    assert not tracing.device_timing()
    step(*batch)
    step(*batch)
    assert made == {"spans": 0, "hooks": 0, "events": 0}
    assert tracing.recent_spans() == []
    assert _device("lakesoul_span_seconds") == {}
    assert _device("lakesoul_span_device_seconds") == {}


def test_loss_and_parameters_are_bitwise_the_same_with_the_profiler_on(fresh):
    def two_steps(profiled):
        model, step, batch = _bert(seed=3)
        if profiled:
            with torch.profiler.profile():
                losses = [step(*batch), step(*batch)]
        else:
            losses = [step(*batch), step(*batch)]
        return losses, {k: p.detach().clone() for k, p in model.named_parameters()}

    (l_off, p_off), (l_on, p_on) = two_steps(False), two_steps(True)
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert p_off.keys() == p_on.keys()
    assert all(torch.equal(p_off[k], p_on[k]) for k in p_off)


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_an_eval_loss_under_a_profiler_times_the_head_alone(fresh, mode):
    model, _, (ids, labels, mask) = _bert()
    with torch.profiler.profile(), mode():
        loss = bert_mlm_loss(model, ids, labels, mask)
    assert not loss.requires_grad
    assert [s["name"] for s in tracing.recent_spans()] == ["bert.head"]


def test_a_frozen_encoder_under_a_profiler_trains_the_head_bias_alone(fresh):
    model, _, (ids, labels, mask) = _bert()
    for name, p in model.named_parameters():
        p.requires_grad_(name == "mlm_bias")
    with torch.profiler.profile():
        bert_mlm_loss(model, ids, labels, mask).backward()
    assert model.mlm_bias.grad is not None
    assert [s["name"] for s in tracing.recent_spans()] == ["bert.head"]


# ------------------------------------------------ against a stand-in card
def test_timed_spans_wait_for_their_events_without_blocking(card):
    first = _timed(card, "train.step", 0.2)
    second = _timed(card, "train.step", 0.2, gap=0.01)
    assert first.device_s is None and len(tracing._CLOCK.pending) == 2
    assert _device("lakesoul_span_device_seconds") == {}  # the card has not run them
    card.ran = 0.25  # the first has run; the next span to open resolves it
    _timed(card, "train.step", 0.2, gap=0.02)
    assert first.device_s == pytest.approx(0.2) and second.device_s is None
    assert tracing.flush_device_spans() == 2
    dev = _device("lakesoul_span_device_seconds")["train.step"]
    gap = _device("lakesoul_span_device_gap_seconds")["train.step"]
    assert (dev["count"], dev["sum"]) == (3, pytest.approx(0.6))
    assert (gap["count"], gap["sum"]) == (2, pytest.approx(0.03))
    assert card.syncs == 0


def test_ring_records_carry_their_device_time(card):
    a = _timed(card, "train.forward", 0.1)
    b = _timed(card, "train.forward", 0.3, gap=0.05)
    ra, rb = tracing.recent_spans("train.forward")
    assert "device_ms" not in ra  # pending until its events resolve
    tracing.flush_device_spans()
    assert ra["span_id"] == a.span_id and rb["span_id"] == b.span_id
    assert ra["device_ms"] == pytest.approx(100.0) and rb["device_ms"] == pytest.approx(300.0)


def test_only_an_outermost_timed_span_reads_a_gap(card):
    for _ in range(3):
        card.now += 0.01
        with tracing.span("train.step", device="cuda:0"):
            _timed(card, "train.forward", 0.1, gap=0.01)
        _timed(card, "ann.search", 0.1, gap=0.01)  # outermost on the device too
    tracing.flush_device_spans()
    gap = _device("lakesoul_span_device_gap_seconds")
    assert {k: v["count"] for k, v in gap.items()} == {"train.step": 2, "ann.search": 2}
    assert _device("lakesoul_span_device_seconds")["train.forward"]["count"] == 3


def test_the_pending_list_is_bounded_and_no_gap_crosses_a_dropped_span(card, monkeypatch):
    monkeypatch.setattr(tracing, "_CLOCK", tracing._DeviceClock(pending_max=3))
    for _ in range(5):
        _timed(card, "train.step", 0.1, gap=0.01)
    assert len(tracing._CLOCK.pending) == 3
    tracing.flush_device_spans()
    assert _device("lakesoul_span_device_seconds")["train.step"]["count"] == 3
    gap = _device("lakesoul_span_device_gap_seconds")["train.step"]
    assert (gap["count"], gap["sum"]) == (2, pytest.approx(0.02))


def test_no_gap_spans_two_profiling_sessions(card, monkeypatch):
    _timed(card, "train.step", 0.1)
    _timed(card, "train.step", 0.1, gap=0.01)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    assert not tracing.device_timing()
    with tracing.span("train.step", device="cuda") as off:
        card.now += 5.0
    assert off._events is None  # no profiler: no events
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    _timed(card, "train.step", 0.1, gap=1.0)
    _timed(card, "train.step", 0.1, gap=0.02)
    tracing.flush_device_spans()
    assert card.syncs == 0
    assert _device("lakesoul_span_device_seconds")["train.step"]["count"] == 4
    gap = _device("lakesoul_span_device_gap_seconds")["train.step"]
    assert (gap["count"], gap["sum"]) == (2, pytest.approx(0.03))


def test_a_timed_span_on_another_thread_takes_the_innermost_open_timed_span(card):
    """Two steps in two threads, one a device: the span a hook opens on the
    engine's thread for cuda:0 joins the step on cuda:0, whichever opened
    last."""
    other_open, done = threading.Event(), threading.Event()
    others = []

    def other_step():
        with tracing.span("train.step", device="cuda:1"):
            with tracing.span("train.backward", device="cuda:1") as sp:
                others.append(sp)
                other_open.set()
                done.wait(timeout=10)

    seen = []
    other = threading.Thread(target=other_step)
    with tracing.span("train.step", device="cuda:0"):
        with tracing.span("train.backward", device="cuda:0") as outer:
            other.start()
            assert other_open.wait(timeout=10)
            hook = threading.Thread(target=lambda: seen.append(
                _timed(card, "bert.head.backward", 0.01)))
            hook.start()
            hook.join(timeout=10)
    done.set()
    other.join(timeout=10)
    assert not hook.is_alive() and not other.is_alive() and len(seen) == 1
    assert seen[0].parent_id == outer.span_id and seen[0].trace_id == outer.trace_id
    assert others[0].parent_id != outer.span_id


def test_a_step_on_the_card_times_each_part_and_the_gap_between_steps(card):
    _, step, batch = _bert()
    step(*batch)
    step(*batch)
    tracing.flush_device_spans()
    dev = _device("lakesoul_span_device_seconds")
    assert {k: v["count"] for k, v in dev.items()} == {n: 2 for n in STEP_SPANS}
    gap = _device("lakesoul_span_device_gap_seconds")
    assert {k: v["count"] for k, v in gap.items()} == {"train.step": 1}
    assert card.syncs == 0 and card.events == 2 * 2 * len(STEP_SPANS)
    assert not any(tracing._CLOCK.open.values())


# ------------------------------------------------- the benchmark's readers
@pytest.fixture
def readers(monkeypatch):
    spec = importlib.util.spec_from_file_location("harness", ROOT / "cellbench" / "harness.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    monkeypatch.setitem(sys.modules, "harness", harness)
    return {name: harness.metric_reader(name) for name in READERS}


def _steps(card, n):
    """``n`` steps of 100 ms a window of 1 s: forward 30, of it the head
    10; backward 60, of it the head 20; optimizer 5; 5 between steps."""
    for _ in range(n):
        card.now += 0.005
        with tracing.span("train.step", device="cuda"):
            with tracing.span("train.forward", device="cuda"):
                card.now += 0.02
                _timed(card, "bert.head", 0.01)
            with tracing.span("train.backward", device="cuda"):
                _timed(card, "bert.head.backward", 0.02)
                card.now += 0.04
            _timed(card, "train.optimizer", 0.005)


@pytest.mark.parametrize("name,share", [
    ("step_forward_share.bert", 30.0), ("step_backward_share.bert", 60.0),
    ("step_optimizer_share.bert", 5.0), ("head_share.bert", 30.0),
    ("step_gap_share.bert", 4.5)])
def test_each_reader_gives_its_share_of_the_window(card, readers, name, share):
    _steps(card, 10)
    run = {"window_s": 1.0, "counters": {"steps": 10}}
    assert readers[name](run) == pytest.approx(share)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_nothing_without_device_spans_or_with_a_step_missing(
        card, readers, name):
    run = {"window_s": 1.0, "counters": {"steps": 10}}
    assert readers[name](run) is None
    _steps(card, 9)
    assert readers[name](run) is None
    _steps(card, 1)
    assert readers[name](run) is not None
