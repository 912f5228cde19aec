"""Model FLOPs of one BERT masked-LM training step.

A frozen copy of ``chip_smoke.py``'s ``bert_flops`` (the port's chip
script, ``:2299``), amended in one way: the tied head is counted only at the
positions the loss reads, the labelled ones, and not at every token.  So a
change that stops computing logits nobody reads raises ``step_mfu``, and
does not lower it.  The encoder's products and attention are counted at
every token, as before:

- encoder: 6 × (4·h² + 2·h·f) × L FLOP a token (forward 2, backward 4, per
  multiply-add of q, k, v, o and the FFN's two matrices);
- attention: 12 · T · h · L a token (QKᵀ and P·V, 2 · T · h each forward,
  × 3 with the backward);
- head: 6 · V · h a labelled position.
"""

from __future__ import annotations


def bert_step_flops(*, hidden: int, ff: int, layers: int, vocab: int, seq: int, tokens: int,
                    labelled: int) -> dict:
    encoder = 6.0 * layers * (4 * hidden * hidden + 2 * hidden * ff) * tokens
    attention = 12.0 * seq * hidden * layers * tokens
    head = 6.0 * vocab * hidden * labelled
    return {"encoder": encoder, "attention": attention, "head": head,
            "total": encoder + attention + head}
