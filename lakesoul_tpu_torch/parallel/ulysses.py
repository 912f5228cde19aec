"""Ulysses-style all-to-all sequence parallelism, the port of
``lakesoul_tpu/parallel/ulysses.py``.

Each rank swaps its SEQUENCE shard for a HEAD shard with one all-to-all
before attention and swaps back after:

    in :  q/k/v [B, H,    T/sp, D]   (sequence-parallel)
    a2a:  q/k/v [B, H/sp, T,    D]   (head-parallel)
    attn: plain full-sequence attention per head group
    a2a:  out   [B, H,    T/sp, D]

``sp`` must divide the head count; the mask's sequence shards are gathered
to the full [B, T] mask.  Ring attention (``parallel/ring_attention.py``)
never holds the full T × T scores but pays ``sp − 1`` shifts; Ulysses pays
two all-to-alls and runs one full attention.
"""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.parallel.collectives import all_gather, all_to_all, group_size

MASK_FILL = -1e30


def _full_attention(q, k, v, scale: float, kv_mask=None):
    """Plain softmax attention: q/k/v [B, h, T, D] → [B, h, T, D]."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], MASK_FILL)
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def ulysses_attention(q, k, v, *, group, kv_mask=None):
    """All-to-all sequence-parallel attention (this rank's view).

    q/k/v [B, H, T_local, D], H divisible by the group's size; kv_mask
    [B, T_local] bool (True = attend).  → [B, H, T_local, D]."""
    sp = group_size(group)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if sp == 1:
        return _full_attention(q, k, v, scale, kv_mask)
    H = q.shape[1]
    if H % sp != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by sp ({sp})")

    def seq_to_head(x):  # [B, H, T/sp, D] → [B, H/sp, T, D]
        return all_to_all(x, group, split_dim=1, concat_dim=2)

    full_mask = None if kv_mask is None else all_gather(kv_mask, group, dim=1)
    out = _full_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v), scale, full_mask)
    return all_to_all(out, group, split_dim=2, concat_dim=1)


def make_ulysses_attention(plan):
    """The same calling convention as ``make_ring_attention``: the two
    strategies are drop-in interchangeable in the trainer."""
    group = plan.group("sp")

    def attention(q, k, v, mask):
        return ulysses_attention(q, k, v, group=group, kv_mask=mask)

    return attention
