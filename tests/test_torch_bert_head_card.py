"""BERT's MLM loss path on the card: the step enqueues the head at the
labelled rows with no synchronise of ATen's (the one wait is on the event
behind the label count, which is not one), and its loss is the full
logits'.  Run on the card with ``python -m pytest tests -m chip``; here it
skips."""

import pytest
import torch

from lakesoul_tpu_torch.models import BertConfig, make_bert_train_state, make_bert_train_step
from lakesoul_tpu_torch.models.bert import bert_forward, masked_nll


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
def test_a_step_on_the_card_synchronises_nothing_and_keeps_the_full_logits_loss(card):
    cfg = BertConfig.tiny()  # bfloat16 body, float32 head
    model, opt = make_bert_train_state(cfg, seed=0, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    # 8,192 positions: past 4,096, where the sort of the index takes the cell's path
    ids = torch.randint(0, cfg.vocab_size, (64, 128), device=card, generator=g)
    labels = torch.where(torch.rand(ids.shape, device=card, generator=g) < 0.15, ids, -100)
    mask = torch.ones_like(ids, dtype=torch.bool)
    step = make_bert_train_step(model, opt, device=card)
    step(ids, labels, mask)  # first calls: the optimizer's state, the libraries' handles
    with torch.no_grad():
        want = float(masked_nll(bert_forward(model, ids, mask), labels))
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step(ids, labels, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert float(loss) == pytest.approx(want, rel=1e-5)
