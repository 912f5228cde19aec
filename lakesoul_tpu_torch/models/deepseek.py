"""A DeepSeek-V3 decoder for next-token training on one device: by default
at the widths of Moonlight-16B-A3B (the published ``config.json`` of
moonshotai/Moonlight-16B-A3B, ``model_type`` ``deepseek_v3``), or one
rank's share of it: fewer layers (a pipeline stage), ``held`` experts of
each MoE layer, a slice of the vocabulary.

Each layer is pre-norm: ``x + attention(rms(x))``, then ``x + ffn(rms(x))``.

- Attention is multi-head latent attention (MLA) without a q-LoRA: ``q = x ·
  wq`` gives each head ``qk_nope`` + ``qk_rope`` dims; ``x · wkv_a`` gives
  the ``kv_rank``-wide latent (RMS-normed, ``kv_norm``) and one rope key
  shared by every head; ``latent · wkv_b`` gives each head's ``k_nope`` and
  ``v``.  RoPE (θ ``rope_theta``, no YaRN) rotates the interleaved pairs of
  the rope dims of q and of the shared key, as DeepSeek's release does.
  Causal attention, scaled by 1/√(qk_nope + qk_rope), through
  ``F.scaled_dot_product_attention``; on CUDA only its fused backends
  (cuDNN, flash, memory-efficient) are allowed, so it never builds the [T,
  T] scores.
- The first ``dense_layers`` layers' FFN is a dense SwiGLU of width ``ff``;
  the rest are ``parallel/experts.py``'s ``DroplessMoe``: ``n_experts``
  routed SwiGLU experts of width ``expert_ff`` over which each token picks
  ``top_k`` by sigmoid scores and a selection bias, of which this model
  holds ``held`` (all by default), plus ``n_shared`` shared experts as one
  SwiGLU of width ``n_shared · expert_ff``.
- An untied head over the vocabulary (a rank's slice of it, where the
  vocabulary is split); the loss, :func:`lm_loss`, is the mean next-token
  NLL over the T − 1 predicted positions of each row plus ``aux_alpha`` ×
  the sequence-wise balance terms summed over the MoE layers.

Precision (``dtype`` the compute dtype): float32 master weights, cast to
the compute dtype in the layer; the projections, the attention, the experts
and the head are compute-dtype products summed in float32; RMSNorm in
float32, its result rounded to the compute dtype (``torch.rms_norm``'s
fused kernel, as DeepSeek's release rounds it); the router, its top-k and
its weights in float32, from the normed input upcast; the logits upcast to
float32 for the loss.  The residual stream is
in the compute dtype.

While a ``torch.profiler`` records, each layer's attention (from the normed
input to the output projection's result) runs in the span ``lm.attention``
and each MoE block in ``moe``; their backwards, from the output's gradient
to the normed input's, are ``lm.attention.backward`` and ``moe.backward``,
opened and closed by two tensor hooks (``obs/tracing.py``
``span_backward``), as ``bert.head.backward`` is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.obs.tracing import device_timing, span, span_backward
from lakesoul_tpu_torch.parallel.experts import DroplessMoe, swiglu


@dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 163840
    hidden: int = 2048
    layers: int = 27
    heads: int = 16
    kv_rank: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    ff: int = 11264
    dense_layers: int = 1
    n_experts: int = 64
    held: tuple[int, int] | None = None  # (first, count) of the routed experts held here
    top_k: int = 6
    expert_ff: int = 1408
    n_shared: int = 2
    routed_scaling: float = 2.446
    rms_eps: float = 1e-5
    rope_theta: float = 50000.0
    aux_alpha: float = 1e-4
    bias_speed: float = 1e-3  # γ of the selection bias's update
    init_std: float = 0.006
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.qk_nope + self.qk_rope


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of x (compute dtype) by the float32 master ``w`` cast to x's
    dtype: ``torch.rms_norm``'s fused kernel, which takes the mean square,
    the scaling and the weight in float32 and rounds the result once to x's
    dtype."""
    return torch.rms_norm(x, (x.shape[-1],), w.to(x.dtype), eps)


def rope_rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on the interleaved pairs (x[2i], x[2i+1]) of x [..., T, d], pair i
    at angle pos · θ^(−2i/d): each pair a complex number turned by
    e^(i · angle), in float32 → x's dtype."""
    T, d = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    turn = torch.polar(torch.ones_like(ang), ang)
    pairs = torch.view_as_complex(x.float().unflatten(-1, (d // 2, 2)).contiguous())
    return torch.view_as_real(pairs * turn).flatten(-2).to(x.dtype)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention [B, H, T, d]; on CUDA through a fused backend only."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION], set_priority=True):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)


class _Attention(nn.Module):
    def __init__(self, cfg: DeepseekConfig, draw):
        super().__init__()
        h, H = cfg.hidden, cfg.heads
        self.wq = draw(h, H * cfg.q_dim)
        self.wkv_a = draw(h, cfg.kv_rank + cfg.qk_rope)
        self.kv_norm = nn.Parameter(torch.ones(cfg.kv_rank))
        self.wkv_b = draw(cfg.kv_rank, H * (cfg.qk_nope + cfg.v_dim))
        self.wo = draw(H * cfg.v_dim, h)


class _Dense(nn.Module):
    def __init__(self, h: int, ff: int, draw):
        super().__init__()
        self.w13 = draw(h, 2 * ff)
        self.w2 = draw(ff, h)


class _Layer(nn.Module):
    def __init__(self, cfg: DeepseekConfig, i: int, draw):
        super().__init__()
        h = cfg.hidden
        self.attn_norm = nn.Parameter(torch.ones(h))
        self.attn = _Attention(cfg, draw)
        self.ffn_norm = nn.Parameter(torch.ones(h))
        if i < cfg.dense_layers:
            self.ffn = _Dense(h, cfg.ff, draw)
        else:
            self.moe = DroplessMoe(h, cfg.expert_ff, cfg.n_experts, cfg.top_k, draw,
                                   held=cfg.held, shared_ff=cfg.n_shared * cfg.expert_ff,
                                   scaling=cfg.routed_scaling, bias_speed=cfg.bias_speed)


class Deepseek(nn.Module):
    """``Deepseek(cfg)``: the decoder's parameters as modules (``embed``,
    ``layers.{i}.attn_norm`` / ``.attn.{wq, wkv_a, kv_norm, wkv_b, wo}`` /
    ``.ffn_norm``, ``layers.{i}.ffn.{w13, w2}`` for a dense layer and
    ``layers.{i}.moe.*`` for an MoE one, ``norm``, ``head``), every matrix
    [in, out], drawn normal × ``init_std`` by a generator on ``device``
    seeded with ``seed``, norms 1.  ``device=None`` is the card."""

    def __init__(self, cfg: DeepseekConfig = DeepseekConfig(), *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)

        def draw(*shape):
            return nn.Parameter(torch.randn(*shape, generator=g, device=dev) * cfg.init_std)

        self.embed = draw(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList(_Layer(cfg, i, draw) for i in range(cfg.layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden))
        self.head = draw(cfg.hidden, cfg.vocab_size)
        self.to(dev)

    def moe_layers(self) -> list[DroplessMoe]:
        return [lp.moe for lp in self.layers if hasattr(lp, "moe")]

    @torch.no_grad()
    def update_selection_bias(self) -> None:
        """Every MoE layer's selection-bias update for its latest forward:
        the step calls it after the optimizer's."""
        for m in self.moe_layers():
            m.update_bias()


def mla(x: torch.Tensor, a: _Attention, cfg: DeepseekConfig) -> torch.Tensor:
    """Multi-head latent attention of the normed x [B, T, h] (compute dtype)
    → [B, T, h] before the residual add."""
    B, T, _ = x.shape
    H, dt = cfg.heads, x.dtype
    q = (x @ a.wq.to(dt)).view(B, T, H, cfg.q_dim).transpose(1, 2)
    kva = x @ a.wkv_a.to(dt)
    latent = rms_norm(kva[..., :cfg.kv_rank], a.kv_norm, cfg.rms_eps)
    k_rope = rope_rotate(kva[..., None, cfg.kv_rank:].transpose(1, 2), cfg.rope_theta)
    kv = (latent @ a.wkv_b.to(dt)).view(B, T, H, cfg.qk_nope + cfg.v_dim).transpose(1, 2)
    q = torch.cat((q[..., :cfg.qk_nope], rope_rotate(q[..., cfg.qk_nope:], cfg.rope_theta)), -1)
    k = torch.cat((kv[..., :cfg.qk_nope], k_rope.expand(B, H, T, cfg.qk_rope)), -1)
    o = causal_attention(q, k, kv[..., cfg.qk_nope:], 1.0 / math.sqrt(cfg.q_dim))
    return o.transpose(1, 2).reshape(B, T, H * cfg.v_dim) @ a.wo.to(dt)


def _timed_block(name: str, fn, x: torch.Tensor, timed: bool):
    """``fn(x)`` in the span ``name``; its backward, from the output's
    gradient to x's, in ``name.backward`` (``span_backward``)."""
    if not timed:
        return fn(x)
    with span(name, device=x.device):
        out = fn(x)
    first = out[0] if isinstance(out, tuple) else out
    if first.requires_grad and x.requires_grad:
        span_backward(f"{name}.backward", first, x)
    return out


def decoder_layer(x: torch.Tensor, lp: _Layer, cfg: DeepseekConfig, timed: bool = False):
    """One block: x [B, T, h] (compute dtype) → (x, the balance term)."""
    B, T, h = x.shape
    y = rms_norm(x, lp.attn_norm, cfg.rms_eps)
    x = x + _timed_block("lm.attention", lambda t: mla(t, lp.attn, cfg), y, timed)
    y = rms_norm(x, lp.ffn_norm, cfg.rms_eps)
    if not hasattr(lp, "moe"):
        return x + swiglu(y, lp.ffn.w13, lp.ffn.w2), x.new_zeros((), dtype=torch.float32)
    out, bal = _timed_block("moe", lambda t: lp.moe(t.reshape(B * T, h), sequences=B), y, timed)
    return x + out.view(B, T, h), bal


def _decode(model: Deepseek, tokens: torch.Tensor):
    cfg = model.cfg
    timed = device_timing()
    x = F.embedding(tokens.long(), model.embed).to(getattr(torch, cfg.dtype))
    bal = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, b = decoder_layer(x, lp, cfg, timed)
        bal = bal + b
    return x, bal


def _head(model: Deepseek, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    return rms_norm(x, model.norm, cfg.rms_eps) @ model.head.to(x.dtype)


def lm_loss(model: Deepseek, tokens: torch.Tensor) -> torch.Tensor:
    """The training loss of tokens [B, T]: the mean next-token NLL over the
    B · (T − 1) predicted positions (logits upcast to float32) plus
    ``aux_alpha`` × the balance terms summed over the MoE layers."""
    x, bal = _decode(model, tokens)
    logits = _head(model, x[:, :-1]).float()
    nll = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten().long())
    return nll + model.cfg.aux_alpha * bal
