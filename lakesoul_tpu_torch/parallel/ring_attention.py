"""Ring attention: sequence-parallel exact attention over the ``sp`` group,
the port of ``lakesoul_tpu/parallel/ring_attention.py``.

Each rank holds a sequence shard of Q, K, V.  K/V blocks, and the mask
with them, rotate around the ring (``collectives.ring_shift``, whose
backward is the reverse rotation) while every rank accumulates the
online-softmax statistics (running max ``m``, normaliser ``l``, weighted
sum ``o``, all float32) against its local Q block; after ``sp`` blocks
every Q row has seen every K/V block.

The reference's numerics: scores of the inputs' dtype summed in float32,
the mask filled with −1e30 (not −inf: a fully padded shard gives
``exp(0) = 1`` terms that the next real block's rescale wipes out, never
NaN), ``p`` cast to V's dtype for P·V, and ``o / max(l, 1e-30)``.
"""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.parallel.collectives import group_size, ring_shift

MASK_FILL = -1e30


def _block_attn(q, k, v, scale: float, mask=None):
    """One Q-block × K-block contribution: q [B, H, Tq, D], k/v [B, H, Tk, D],
    mask [B, Tk] bool → (max, exp-sum, weighted V), float32."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], MASK_FILL)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = p.to(v.dtype).float() @ v.float()
    return m, l, o


def ring_attention(q, k, v, *, group, kv_mask=None):
    """Exact attention with K/V rotating over ``group`` (this rank's view).

    q/k/v [B, H, T_local, D]; kv_mask [B, T_local] bool (True = attend)
    travels with K/V.  → [B, H, T_local, D] in q's dtype."""
    sp = group_size(group)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    m, l, o = _block_attn(q, k, v, scale, kv_mask)
    for _ in range(sp - 1):
        if kv_mask is None:
            k, v = ring_shift(k, v, group=group)
        else:
            k, v, kv_mask = ring_shift(k, v, kv_mask, group=group)
        m_new, l_new, o_new = _block_attn(q, k, v, scale, kv_mask)
        m_tot = torch.maximum(m, m_new)
        a = torch.exp(m - m_tot)
        b = torch.exp(m_new - m_tot)
        l = l * a + l_new * b
        o = o * a[..., None] + o_new * b[..., None]
        m = m_tot
    out = o / l[..., None].clamp(min=1e-30)
    return out.to(q.dtype)


def make_ring_attention(plan):
    """``attention_fn(q, k, v, mask)`` over the plan's ``sp`` group, the
    calling convention of ``models/bert.py`` (this rank's batch, heads and
    sequence shard)."""
    group = plan.group("sp")

    def attention(q, k, v, mask):
        return ring_attention(q, k, v, group=group, kv_mask=mask)

    return attention
