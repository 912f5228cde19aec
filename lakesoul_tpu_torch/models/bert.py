"""BERT-style encoder for MLM training, the port of
``lakesoul_tpu/models/bert.py`` (BASELINE.json config 3: C4 → BERT-base
MLM), on one device.

The reference's numerics, kept where torch's defaults differ:

- pre-LN blocks; layer norm with eps 1e-6 taken in float32 and cast back to
  its input's dtype (the embedding's output then goes to the compute dtype;
  the head's goes through it and back to float32);
- ``jax.nn.gelu`` is the tanh approximation;
- attention is the explicit formula: scores of the compute dtype's products
  summed in float32, the mask True = attend with a −1e30 fill (a fully
  padded row gives a uniform softmax, not NaN), softmax in float32 cast to
  v's dtype, P·V accumulated in float32;
- params are float32 masters; q/k/v/o and the FFN cast theirs to the compute
  dtype inside the layer; the MLM head is tied to ``tok_emb`` in float32;
- ``masked_nll`` ignores labels < 0 and divides by max(count, 1).

The reference stacks its layers on a leading axis for one ``lax.scan``;
here they are ``layers.{i}`` modules (``models/convert.py`` moves between
the two).  Mixture-of-experts FFNs (``n_experts > 0``) are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import ConfigError

LN_EPS = 1e-6
MASK_FILL = -1e30
INIT_STD = 0.02


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ff: int = 3072
    max_len: int = 512
    dtype: str = "bfloat16"
    # the reference's MoE fields: any n_experts > 0 raises here (not ported yet)
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab_size: int = 1024, max_len: int = 128) -> "BertConfig":
        return BertConfig(
            vocab_size=vocab_size, hidden=128, layers=2, heads=4, ff=256, max_len=max_len
        )

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


class _LN(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(h))
        self.bias = nn.Parameter(torch.zeros(h))


class _Layer(nn.Module):
    def __init__(self, norm, h: int, f: int):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (norm(h, h) for _ in range(4))
        self.ln1, self.ln2 = _LN(h), _LN(h)
        self.w1, self.w2 = norm(h, f), norm(f, h)
        self.b1 = nn.Parameter(torch.zeros(f))
        self.b2 = nn.Parameter(torch.zeros(h))


class Bert(nn.Module):
    """``Bert(cfg)``: the reference's param tree as modules, drawn by a CPU
    ``torch.Generator`` seeded with ``seed`` (normal × 0.02, layer norms 1
    and 0, biases 0).  ``device=None`` is the card."""

    def __init__(self, cfg: BertConfig = BertConfig(), *, seed: int = 0, device=None):
        super().__init__()
        if cfg.n_experts:
            raise ConfigError("MoE is not ported yet")
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)

        def norm(*shape):
            return nn.Parameter(torch.randn(*shape, generator=g) * INIT_STD)

        h = cfg.hidden
        self.tok_emb = norm(cfg.vocab_size, h)
        self.pos_emb = norm(cfg.max_len, h)
        self.emb_ln = _LN(h)
        self.layers = nn.ModuleList(_Layer(norm, h, cfg.ff) for _ in range(cfg.layers))
        self.mlm_ln = _LN(h)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None):
        return bert_forward(self, input_ids, attn_mask)


def layer_norm(x: torch.Tensor, p: _LN, eps: float = LN_EPS) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), p.scale, p.bias, eps)
    return y.to(x.dtype)


def default_attention(q, k, v, mask):
    """Plain full attention [B, H, T, D]; ``mask`` [B, T] True = attend."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[:, None, None, :], MASK_FILL)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return p @ v


def bert_layer(x: torch.Tensor, lp: _Layer, attn_mask: torch.Tensor, *,
               cfg: BertConfig) -> torch.Tensor:
    """One pre-LN transformer block: x [B, T, h] → x.  (The reference also
    returns its MoE auxiliary loss, 0 for a dense FFN.)"""
    dtype = getattr(torch, cfg.dtype)
    B, T = x.shape[0], x.shape[1]
    y = layer_norm(x, lp.ln1)

    def heads(w):
        return (y @ w.to(dtype)).view(B, T, cfg.heads, cfg.head_dim).transpose(1, 2)

    a = default_attention(heads(lp.wq), heads(lp.wk), heads(lp.wv), attn_mask)
    x = x + a.transpose(1, 2).reshape(B, T, cfg.hidden) @ lp.wo.to(dtype)
    y = layer_norm(x, lp.ln2)
    hdn = F.gelu(y @ lp.w1.to(dtype) + lp.b1.to(dtype), approximate="tanh")
    return x + (hdn @ lp.w2.to(dtype) + lp.b2.to(dtype))


def bert_embed(model: Bert, input_ids: torch.Tensor) -> torch.Tensor:
    T = input_ids.shape[1]
    x = F.embedding(input_ids, model.tok_emb) + model.pos_emb[:T][None]
    return layer_norm(x, model.emb_ln).to(getattr(torch, model.cfg.dtype))


def bert_head(model: Bert, x: torch.Tensor) -> torch.Tensor:
    """Weight-tied MLM head → logits [B, T, vocab] float32."""
    x = layer_norm(x, model.mlm_ln)
    return x.float() @ model.tok_emb.T + model.mlm_bias


def bert_forward(model: Bert, input_ids: torch.Tensor,
                 attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder forward → MLM logits [B, T, vocab]."""
    if attn_mask is None:
        attn_mask = torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
    attn_mask = attn_mask.bool()
    x = bert_embed(model, input_ids)
    for lp in model.layers:
        x = bert_layer(x, lp, attn_mask, cfg=model.cfg)
    return bert_head(model, x)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over positions with labels >= 0 (-100 = ignore); 0 when none is."""
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.where(valid, labels, -100).reshape(-1).long(),
                          ignore_index=-100, reduction="sum")
    return nll / valid.sum().clamp(min=1)


def bert_mlm_loss(model: Bert, input_ids: torch.Tensor, labels: torch.Tensor,
                  attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked-LM loss: labels < 0 are ignored."""
    return masked_nll(bert_forward(model, input_ids, attn_mask), labels)
