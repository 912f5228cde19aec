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
- ``masked_nll`` ignores labels < 0 and divides by max(count, 1); the
  training loss, ``bert_mlm_loss``, runs the head at the labelled positions
  alone, which gives the same loss.

The reference stacks its layers on a leading axis for one ``lax.scan``;
here they are ``layers.{i}`` modules (``models/convert.py`` moves between
the two).  ``n_experts > 0`` swaps every FFN for a top-1 Switch MoE layer
(``layers.{i}.moe``, ``parallel/moe.py``) whose load-balancing term joins
the loss at ``moe_aux_weight``.

Sharded (``plan=`` a ``parallel.mesh.MeshPlan``), a model holds this rank's
slice of every parameter (``param_sharding_rules``, ``models/convert.py``
``shard_params``) and its batch shard ``[B / dp, T / sp]``: q/k/v and w1
are split by columns over tp and wo and w2 by rows (Megatron: the layer's
input enters the tp region through ``copy_to``, the row-parallel product
leaves it through ``reduce_from``, and ``b2`` is added once, after the
sum); positions are this rank's sequence block of ``pos_emb``; MoE
experts are split over ep.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.obs.tracing import device_timing, span, span_backward
from lakesoul_tpu_torch.parallel.collectives import copy_to, reduce_from
from lakesoul_tpu_torch.parallel.mesh import DATA_AXES
from lakesoul_tpu_torch.parallel.moe import init_moe_ffn_params, moe_ffn, moe_param_rules

LN_EPS = 1e-6
MASK_FILL = -1e30
INIT_STD = 0.02
_UNTIMED = contextlib.nullcontext()


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ff: int = 3072
    max_len: int = 512
    dtype: str = "bfloat16"
    # MoE: n_experts > 0 swaps every FFN for a top-1 Switch MoE layer
    # (parallel/moe.py) with experts sharded over the 'ep' mesh axis
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


class _Moe(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(v))


class _Layer(nn.Module):
    def __init__(self, norm, h: int, f: int, moe: dict | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (norm(h, h) for _ in range(4))
        self.ln1, self.ln2 = _LN(h), _LN(h)
        if moe is not None:
            self.moe = _Moe(moe)
            return
        self.w1, self.w2 = norm(h, f), norm(f, h)
        self.b1 = nn.Parameter(torch.zeros(f))
        self.b2 = nn.Parameter(torch.zeros(h))


class Bert(nn.Module):
    """``Bert(cfg)``: the reference's param tree as modules, drawn by a CPU
    ``torch.Generator`` seeded with ``seed`` (normal × 0.02, layer norms 1
    and 0, biases 0).  ``device=None`` is the card."""

    def __init__(self, cfg: BertConfig = BertConfig(), *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)

        def norm(*shape):
            return nn.Parameter(torch.randn(*shape, generator=g) * INIT_STD)

        h = cfg.hidden
        self.tok_emb = norm(cfg.vocab_size, h)
        self.pos_emb = norm(cfg.max_len, h)
        self.emb_ln = _LN(h)

        def moe():
            return init_moe_ffn_params(g, h, cfg.ff, cfg.n_experts, INIT_STD)

        self.layers = nn.ModuleList(_Layer(norm, h, cfg.ff, moe() if cfg.n_experts else None)
                                    for _ in range(cfg.layers))
        self.mlm_ln = _LN(h)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None):
        return bert_forward(self, input_ids, attn_mask)


def param_sharding_rules(plan=None, *, n_experts: int = 0) -> dict:
    """Which dim of each parameter splits over which mesh axis, as the
    reference's PartitionSpecs (``bert.py:96-127``) over its param tree:
    ``layers`` leaves carry the leading layer axis.  FFN and QKV/out
    projections are tensor-sharded over 'tp' (Megatron column/row split),
    embeddings replicated; with MoE, expert weights over 'ep'."""
    layers = {
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "ln1": {"scale": (), "bias": ()},
        "ln2": {"scale": (), "bias": ()},
    }
    if n_experts:
        layers["moe"] = moe_param_rules()
    else:
        layers.update(w1=(None, None, "tp"), w2=(None, "tp", None), b1=(None, "tp"),
                      b2=(None, None))
    return {
        "tok_emb": (),
        "pos_emb": (),
        "emb_ln": {"scale": (), "bias": ()},
        "layers": layers,
        "mlm_ln": {"scale": (), "bias": ()},
        "mlm_bias": (),
    }


def layer_norm(x: torch.Tensor, p: _LN, eps: float = LN_EPS) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), p.scale, p.bias, eps)
    return y.to(x.dtype)


def default_attention(q, k, v, mask):
    """Plain full attention [B, H, T, D]; ``mask`` [B, T] True = attend."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[:, None, None, :], MASK_FILL)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return p @ v


def bert_layer(x: torch.Tensor, lp: _Layer, attn_mask: torch.Tensor, *, cfg: BertConfig,
               attention_fn=None, plan=None, token_index=None):
    """One pre-LN transformer block: x [B, T, h] → (x, aux), aux the MoE
    load-balancing term (0 for a dense FFN).  With ``plan``, x is this
    rank's [B/dp, T/sp, h] and ``lp`` its slice; ``token_index`` gives the
    MoE each local token's index in the global row-major order."""
    dtype = getattr(torch, cfg.dtype)
    B, T = x.shape[0], x.shape[1]
    tp = plan.group("tp") if plan is not None else None
    heads = lp.wq.shape[1] // cfg.head_dim  # this rank's heads
    if attention_fn is None:
        attention_fn = default_attention
    y = copy_to(layer_norm(x, lp.ln1), tp)

    def split(w):
        return (y @ w.to(dtype)).view(B, T, heads, cfg.head_dim).transpose(1, 2)

    a = attention_fn(split(lp.wq), split(lp.wk), split(lp.wv), attn_mask)
    a = a.transpose(1, 2).reshape(B, T, heads * cfg.head_dim)
    x = x + reduce_from(a @ lp.wo.to(dtype), tp)
    y = layer_norm(x, lp.ln2)
    if cfg.n_experts:
        m = lp.moe
        out, aux = moe_ffn(
            y.reshape(B * T, cfg.hidden), m.gate_w, m.w1, m.b1, m.w2, m.b2,
            capacity_factor=cfg.capacity_factor,
            token_group=plan.group(*DATA_AXES) if plan is not None else None,
            token_index=token_index, ep_group=plan.group("ep") if plan is not None else None)
        return x + out.reshape(B, T, cfg.hidden), aux
    y = copy_to(y, tp)
    hdn = F.gelu(y @ lp.w1.to(dtype) + lp.b1.to(dtype), approximate="tanh")
    x = x + (reduce_from(hdn @ lp.w2.to(dtype), tp) + lp.b2.to(dtype))
    return x, x.new_zeros((), dtype=torch.float32)


def bert_embed(model: Bert, input_ids: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
    """Token + position embeddings (positions ``pos_offset`` on: a sequence
    block's), layer norm, in the compute dtype."""
    T = input_ids.shape[1]
    x = F.embedding(input_ids, model.tok_emb) + model.pos_emb[pos_offset:pos_offset + T][None]
    return layer_norm(x, model.emb_ln).to(getattr(torch, model.cfg.dtype))


def bert_head(model: Bert, x: torch.Tensor) -> torch.Tensor:
    """Weight-tied MLM head: x [..., h] → logits [..., vocab] float32 (from
    :func:`bert_forward`, [B, T, vocab])."""
    x = layer_norm(x, model.mlm_ln)
    return x.float() @ model.tok_emb.T + model.mlm_bias


def bert_encode(model: Bert, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None,
                *, attention_fn=None, plan=None):
    """The encoder, embeddings and layers → (x [B, T, h] in the compute
    dtype, aux: the summed MoE load-balancing loss).  Arguments as
    :func:`bert_forward`'s."""
    if attn_mask is None:
        attn_mask = torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
    attn_mask = attn_mask.bool()
    B, T = input_ids.shape
    offset, token_index = 0, None
    if plan is not None:
        offset = plan.coord("sp") * T
        rows = plan.coord("dp") * B + torch.arange(B, device=input_ids.device)
        cols = offset + torch.arange(T, device=input_ids.device)
        token_index = (rows[:, None] * (T * plan.sp) + cols[None, :]).reshape(-1)
    x = bert_embed(model, input_ids, offset)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, a = bert_layer(x, lp, attn_mask, cfg=model.cfg, attention_fn=attention_fn, plan=plan,
                          token_index=token_index)
        aux = aux + a
    return x, aux


def bert_forward(model: Bert, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None,
                 *, attention_fn=None, with_aux: bool = False, plan=None):
    """Encoder forward → MLM logits [B, T, vocab] (or (logits, aux) with
    ``with_aux``: aux is the summed MoE load-balancing loss).

    ``attention_fn(q, k, v, mask)`` defaults to plain full attention; pass
    ``parallel.make_ring_attention(plan)`` for sequence parallelism.  With
    ``plan``, ``input_ids`` is this rank's [B/dp, T/sp] block."""
    x, aux = bert_encode(model, input_ids, attn_mask, attention_fn=attention_fn, plan=plan)
    logits = bert_head(model, x)
    return (logits, aux) if with_aux else logits


def masked_nll(logits: torch.Tensor, labels: torch.Tensor, count=None) -> torch.Tensor:
    """Mean NLL over positions with labels >= 0 (-100 = ignore); 0 when none
    is.  ``count``: the divisor's label count when it is not this batch's
    (a rank's share of a batch split over ranks: its sum over the global
    count)."""
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.where(valid, labels, -100).reshape(-1).long(),
                          ignore_index=-100, reduction="sum")
    return nll / (valid.sum() if count is None else count).clamp(min=1)


def bert_mlm_loss(model: Bert, input_ids: torch.Tensor, labels: torch.Tensor,
                  attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked-LM loss: labels < 0 are ignored.  With MoE configs the Switch
    load-balancing auxiliary joins at ``cfg.moe_aux_weight``.

    The head runs only at the K labelled positions: their rows of the
    encoder's output are gathered, and the head's layer norm, float32 tied
    product, bias and cross-entropy see those rows alone, the loss divided
    by max(K, 1) as :func:`masked_nll`'s.  Every part of the head acts row
    by row, so the loss and every gradient are the full logits' up to the
    order of float32 sums; the gather's backward adds each labelled row's
    gradient once onto zeros.  K reaches the host without a synchronise
    (:func:`_labelled_rows`); the host reads it before ``bert.head`` opens,
    so that span does not time the wait.

    While a profiler records, the head (the gather, its layer norm, the
    float32 tied product and bias, the cross-entropy) runs in the span
    ``bert.head``, and its backward, from the loss's gradient to the encoder
    output's, is the span ``bert.head.backward`` (where both take part in
    autograd: not under ``torch.no_grad()`` or with the encoder frozen)."""
    rows = _labelled_rows(labels)
    x, aux = bert_encode(model, input_ids, attn_mask)
    index = rows()
    timed = device_timing()
    with span("bert.head", device=x.device) if timed else _UNTIMED:
        loss = masked_nll(bert_head(model, x.flatten(0, -2).index_select(0, index)),
                          labels.flatten().index_select(0, index))
    if timed and loss.requires_grad and x.requires_grad:
        span_backward("bert.head.backward", loss, x)
    if model.cfg.n_experts:
        loss = loss + model.cfg.moe_aux_weight * aux
    return loss


def _labelled_rows(labels: torch.Tensor):
    """Enqueue the flat indices of the labelled positions (labels >= 0), in
    order: the first K of a stable sort of the unlabelled flag, K their
    count.  → ``rows()``, which gives those K indices.

    Call it before the encoder's forward.  On the card the count is copied
    to a pinned host scalar behind an event, and ``rows()`` waits on that
    event alone: by then the encoder's forward is queued behind it, so the
    card keeps working while the host reads K and enqueues the head and the
    backward.  A ``nonzero`` or boolean index would wait for the card's
    whole queue instead."""
    unlabelled = labels.flatten() < 0
    order = torch.argsort(unlabelled.to(torch.uint8), stable=True)
    count = unlabelled.numel() - unlabelled.sum()
    if not labels.is_cuda:
        k = int(count)
        return lambda: order[:k]
    host = torch.empty((), dtype=count.dtype, pin_memory=True)
    host.copy_(count, non_blocking=True)
    counted = torch.cuda.Event()
    counted.record(torch.cuda.current_stream(labels.device))

    def rows() -> torch.Tensor:
        counted.synchronize()
        return order[:int(host)]

    return rows
