"""The spans and counters of the DeepSeek-V3 decoder's step
(``models/deepseek.py``, ``parallel/experts.py``) on the CPU, as
``test_torch_obs_step.py`` holds BERT's: a CPU profiler turns the spans on,
and the device side runs against that file's stand-in card."""

import pytest
import torch

from lakesoul_tpu_torch.models import DeepseekConfig, make_lm_train_state, make_lm_train_step
from lakesoul_tpu_torch.obs import metrics, tracing
from lakesoul_tpu_torch.parallel.experts import publish_counters
from test_torch_obs_step import _device, card, fresh  # noqa: F401  (fixtures)

CFG = DeepseekConfig(vocab_size=128, hidden=32, layers=3, heads=2, kv_rank=16, qk_nope=8,
                     qk_rope=8, v_dim=8, ff=64, n_experts=8, held=(2, 2), top_k=2,
                     expert_ff=16, dtype="float32", init_std=0.05)
MOE_LAYERS, LAYERS = CFG.layers - CFG.dense_layers, CFG.layers
FORWARD = ("lm.attention", "moe", "moe.route", "moe.experts")
BACKWARD = ("lm.attention.backward", "moe.backward", "moe.experts.backward")
COUNTS = {"train.step": 1, "train.forward": 1, "train.backward": 1, "train.optimizer": 1,
          "lm.attention": LAYERS, "lm.attention.backward": LAYERS,
          **{n: MOE_LAYERS for n in ("moe", "moe.route", "moe.experts", "moe.backward",
                                     "moe.experts.backward")}}


def _lm(seed=0):
    model, opt = make_lm_train_state(CFG, seed=seed, device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    return model, make_lm_train_step(model, opt, device="cpu"), tokens


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_a_profiled_step_records_the_attention_and_expert_spans(fresh):
    _, step, tokens = _lm()
    with torch.profiler.profile() as prof:
        step(tokens)
    spans = _by_name(tracing.recent_spans())
    assert {k: len(v) for k, v in spans.items()} == COUNTS
    fwd, bwd = spans["train.forward"][0]["span_id"], spans["train.backward"][0]["span_id"]
    moe_ids = {s["span_id"] for s in spans["moe"]}
    assert all(s["parent_id"] == fwd for s in spans["lm.attention"] + spans["moe"])
    assert all(s["parent_id"] in moe_ids for s in spans["moe.route"] + spans["moe.experts"])
    # no device: a detached backward span takes the current span, the backward
    assert all(s["parent_id"] == bwd for n in BACKWARD for s in spans[n])
    assert {"lakesoul." + n for n in COUNTS} <= {e.name for e in prof.events()}


def test_without_a_profiler_the_step_makes_no_span_event_or_hook(fresh, monkeypatch):
    made = {"spans": 0, "hooks": 0}
    span_init, register_hook = tracing.Span.__init__, torch.Tensor.register_hook

    def counted_span(self, *a, **kw):
        made["spans"] += 1
        span_init(self, *a, **kw)

    def counted_hook(self, hook):
        made["hooks"] += 1
        return register_hook(self, hook)

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event outside a profiler")

    monkeypatch.setattr(tracing.Span, "__init__", counted_span)
    monkeypatch.setattr(torch.Tensor, "register_hook", counted_hook)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _, step, tokens = _lm()
    step(tokens)
    step(tokens)
    assert made == {"spans": 0, "hooks": 0}
    assert tracing.recent_spans() == []


def test_loss_parameters_and_biases_are_bitwise_the_same_with_the_profiler_on(fresh):
    def two_steps(profiled):
        model, step, tokens = _lm(seed=3)
        if profiled:
            with torch.profiler.profile():
                losses = [step(tokens), step(tokens)]
        else:
            losses = [step(tokens), step(tokens)]
        return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}

    (l_off, s_off), (l_on, s_on) = two_steps(False), two_steps(True)
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert s_off.keys() == s_on.keys() and any("selection_bias" in k for k in s_off)
    assert all(torch.equal(s_off[k], s_on[k]) for k in s_off)


def test_on_the_card_each_span_is_timed_and_only_the_step_reads_a_gap(card):
    _, step, tokens = _lm()
    step(tokens)
    step(tokens)
    tracing.flush_device_spans()
    dev = _device("lakesoul_span_device_seconds")
    assert {k: v["count"] for k, v in dev.items()} == {k: 2 * n for k, n in COUNTS.items()}
    gap = _device("lakesoul_span_device_gap_seconds")
    assert {k: v["count"] for k, v in gap.items()} == {"train.step": 1}
    assert card.syncs == 0 and not any(tracing._CLOCK.open.values())


def test_the_counters_reach_the_registry_once_read(fresh):
    model, step, tokens = _lm()
    step(tokens)
    step(tokens)
    held = sum(int(((m.last_selection >= 2) & (m.last_selection < 4)).sum())
               for m in model.moe_layers())
    got = publish_counters(model.moe_layers())
    reg = metrics.registry()
    slots = reg.counter("lakesoul_moe_routed_slots_total").value
    assert got["routed_slots"] == slots and got["dropped"] == 0
    assert reg.counter("lakesoul_moe_dropped_total").value == 0
    assert slots >= held  # two steps' forwards, the last one's held selections among them
    assert reg.gauge("lakesoul_moe_held_load_mean").value == pytest.approx(slots / (
        2 * MOE_LAYERS))
    assert reg.gauge("lakesoul_moe_held_load_max").value >= got["held_load_mean"]
    assert publish_counters(model.moe_layers())["routed_slots"] == 0
