"""The DeepSeek-V3 decoder's step on the card: at a tiny width, a step of
``make_lm_train_step`` in the bf16 compute dtype (the grouped products of
the held experts, the fused causal attention) synchronises nothing, makes no
span, CUDA event or tensor hook without a profiler, and its loss is the
CPU's float32 step's within bf16's tolerance.  Run on the card with
``python -m pytest tests -m chip``; here it skips."""

import dataclasses

import pytest
import torch

from lakesoul_tpu_torch.models import DeepseekConfig, make_lm_train_state, make_lm_train_step
from lakesoul_tpu_torch.obs import tracing

# bf16 products summed in float32 against float32 throughout: a loss near
# ln 256 ≈ 5.5 moves by a few parts in 1e4; 2e-3 leaves room, and a step
# that dropped a held expert's rows or routed by another bias moves more
LOSS_RTOL = 2e-3
CFG = DeepseekConfig(vocab_size=256, hidden=64, layers=3, heads=4, kv_rank=32, qk_nope=16,
                     qk_rope=8, v_dim=16, ff=128, n_experts=16, held=(4, 4), top_k=4,
                     expert_ff=32, init_std=0.05)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


def _steps(device, dtype, tokens, n):
    model, opt = make_lm_train_state(dataclasses.replace(CFG, dtype=dtype), device=device)
    cpu, _ = make_lm_train_state(CFG, seed=0, device="cpu")  # the CPU's draw on both sides
    model.load_state_dict(cpu.state_dict())
    step = make_lm_train_step(model, opt, device=device)
    return model, step, [float(step(tokens.to(device))) for _ in range(n)]


@pytest.mark.chip
def test_a_step_on_the_card_synchronises_nothing_and_keeps_the_cpus_loss(card, monkeypatch):
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, CFG.vocab_size, (4, 512), generator=g)
    _, _, want = _steps("cpu", "float32", tokens, 2)
    model, step, got = _steps(card, "bfloat16", tokens, 1)  # first calls: handles, state
    tokens = tokens.to(card)  # a copy from pageable host memory synchronises: not the step's
    made = {"spans": 0, "hooks": 0, "events": 0}
    span_init, register_hook, event = (tracing.Span.__init__, torch.Tensor.register_hook,
                                       torch.cuda.Event)

    def counted(key, fn):
        def wrapped(*a, **kw):
            made[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tracing.Span, "__init__", counted("spans", span_init))
    monkeypatch.setattr(torch.Tensor, "register_hook", counted("hooks", register_hook))
    monkeypatch.setattr(torch.cuda, "Event", counted("events", event))
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step(tokens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got.append(float(loss))
    assert made == {"spans": 0, "hooks": 0, "events": 0}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert all(float(m.selection_bias.abs().sum()) > 0 for m in model.moe_layers())
