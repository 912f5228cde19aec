"""Mixture-of-Experts FFN with expert parallelism over the ``ep`` group, the
port of ``lakesoul_tpu/parallel/moe.py``.

It computes what the reference computes:

- top-1 routing in float32 (softmax of ``x · gate_w``; the lower expert
  wins a tie, as ``argmax`` does);
- each token's rank within its expert in GLOBAL token order, in integers;
- capacity ``C = ceil(N / E · capacity_factor)`` over the global token
  count: first come keeps, an overflow token contributes exactly 0 (its
  residual stream passes through);
- the experts' FFNs in the compute dtype with the tanh GELU;
- the combine in float32 times the gate, cast back;
- ``aux = E · Σ_e mean(onehot)_e · mean(probs)_e`` over the global batch.

The reference builds dense one-hot ``dispatch``/``combine`` tensors of
[N, E, C]; at Switch-Base-8's step (32,768 tokens, E 8, C 5,120) each is
5.37 GB in float32 a layer, kept for the backward.  Here the dispatch is by
index: every kept token is copied into its (expert, slot) row of an
[E_local, C_local, h] buffer and its expert's output gathered back times
its gate.  Each slot receives exactly one token, so the result equals the
einsum's (one nonzero term); no float ``index_add_`` (whose atomics add in
no fixed order on CUDA) is on the path.

Sharded (the token batch split over ``token_group``, the dp × sp group, and
replicated over ``ep_group``): the int expert ids are all-gathered over the
token group to take each local token's global rank; the aux's two means are
global sums (``all_reduce_sum``); each ep rank runs its ``E / ep`` experts
on the tokens routed to them and the partial outputs are summed over ep
(``reduce_from``), while the expert input and the combine's gate enter
through ``copy_to``, so the replicated router's gradient is the
single-device one on every ep rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lakesoul_tpu_torch.parallel.collectives import (
    all_gather_stack,
    all_reduce_sum,
    copy_to,
    group_rank,
    group_size,
    reduce_from,
)


def moe_capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


def _rank_within(ids: torch.Tensor, n: int, keep=None):
    """→ (each token's 0-based rank among the tokens before it with its id,
    the count of each id), ``ids`` in [0, n), ``keep`` masking the tokens
    that count.  The one-hot is [n, N], so the running count is a scan
    along the inner dim (along the outer dim of [N, n] it runs n threads:
    35 % of Switch-Base-8's step on the H100)."""
    hot = F.one_hot(ids, n).T.contiguous()
    if keep is not None:
        hot = hot * keep
    return (hot.cumsum(1) * hot).sum(0) - 1, hot.sum(1)


def _global_rank_in_expert(expert: torch.Tensor, E: int, token_index, token_group):
    """→ (each local token's 0-based rank within its expert over the whole
    batch in global token order, the global token count, per-expert token
    counts of the whole batch)."""
    if token_group is None:
        every = expert
    else:
        ids = all_gather_stack(expert, token_group).reshape(-1)
        where = all_gather_stack(token_index, token_group).reshape(-1)
        every = torch.empty_like(ids)
        every[where] = ids  # global token order
    rank, counts = _rank_within(every, E)
    local = rank if token_group is None else rank[token_index]
    return local, every.shape[0], counts


def moe_ffn(x: torch.Tensor, gate_w, w1, b1, w2, b2, *, capacity_factor: float = 1.25,
            token_group=None, token_index=None, ep_group=None):
    """Top-1 MoE FFN over flattened tokens.

    Shapes: x [N, h] (this rank's tokens); gate_w [h, E]; w1 [E_local, h, f];
    b1 [E_local, f]; w2 [E_local, f, h]; b2 [E_local, h], with E_local =
    E / size(ep_group), this rank's experts ``[r · E_local, (r+1) · E_local)``.
    ``token_index`` [N] int64: each local token's index in the global
    row-major token order (needed with ``token_group``).  → (out [N, h] in
    x's dtype, aux float32 scalar: the same value on every rank)."""
    N, h = x.shape
    E = gate_w.shape[1]
    E_local = w1.shape[0]
    if E_local * group_size(ep_group) != E:
        raise ValueError(f"{E_local} local experts x {group_size(ep_group)} ep ranks != {E}")

    # ---- router (float32)
    probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)  # [N, E]
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    pos, n_global, counts = _global_rank_in_expert(expert, E, token_index, token_group)
    C = moe_capacity(n_global, E, capacity_factor)

    # ---- index dispatch to this rank's experts: slot = the token's rank
    # among the kept tokens of its expert on this rank (< min(C, N))
    e_local = expert - group_rank(ep_group) * E_local
    mine = (pos < C) & (e_local >= 0) & (e_local < E_local)
    e_local = torch.where(mine, e_local, 0)
    slot, _ = _rank_within(e_local, E_local, mine)
    C_local = min(C, N)
    dump = E_local * C_local  # one spare row takes every token not routed here
    dest = torch.where(mine, e_local * C_local + slot, dump)
    xe = copy_to(x, ep_group)
    xin = xe.new_zeros(dump + 1, h).index_copy(0, dest, xe)[:dump].view(E_local, C_local, h)

    # ---- expert FFNs (compute dtype)
    hdn = F.gelu(torch.bmm(xin, w1.to(x.dtype)) + b1[:, None, :].to(x.dtype), approximate="tanh")
    out_e = torch.bmm(hdn, w2.to(x.dtype)) + b2[:, None, :].to(x.dtype)

    # ---- combine: each token's slot back, times its gate, in float32
    rows = torch.cat([out_e.reshape(dump, h), out_e.new_zeros(1, h)])
    out = rows[dest].float() * copy_to(gate, ep_group)[:, None]
    out = reduce_from(out, ep_group)

    # ---- Switch aux loss over the whole batch
    frac_tokens = counts.float() / n_global
    frac_probs = all_reduce_sum(probs.sum(0), token_group) / n_global
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out.to(x.dtype), aux


def init_moe_ffn_params(g: torch.Generator, hidden: int, ff: int, n_experts: int,
                        std: float = 0.02) -> dict:
    """One layer's MoE FFN params (``gate_w``, ``w1``, ``b1``, ``w2``,
    ``b2``), drawn by ``g`` from the reference's distributions (normal ×
    std, biases 0)."""
    E = n_experts
    return {
        "gate_w": torch.randn(hidden, E, generator=g) * std,
        "w1": torch.randn(E, hidden, ff, generator=g) * std,
        "b1": torch.zeros(E, ff),
        "w2": torch.randn(E, ff, hidden, generator=g) * std,
        "b2": torch.zeros(E, hidden),
    }


def moe_param_rules() -> dict:
    """Specs for the layer-stacked MoE params (leading axis: the layer):
    experts sharded over ep (weights live where their tokens go)."""
    return {
        "gate_w": (),
        "w1": (None, "ep", None, None),
        "b1": (None, "ep", None),
        "w2": (None, "ep", None, None),
        "b2": (None, "ep", None),
    }
