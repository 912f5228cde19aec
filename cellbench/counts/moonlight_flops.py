"""Model FLOPs of one next-token training step of Moonlight-16B-A3B's
block as ``configs/moonlight_16b_a3b_ep8.json`` cuts it, and of the held
experts' products.

A step's FLOPs are 3 × the forward's (forward 2, backward 4 a multiply-add
of every product); a token's forward:

- MLA projections, each layer: 2 · (h · H · (nope + rope) + h · (rank + rope)
  + rank · H · (nope + v) + H · v · h);
- causal attention, each layer: 2 · H · (nope + rope + v) a (query, key)
  pair, the pairs of a row T (T + 1) / 2: QKᵀ and P·V on the causal half;
- the router, each MoE layer: 2 · h · E;
- the shared experts, each MoE layer: 6 · h · fs (SwiGLU's three matrices);
- the held experts, each MoE layer, at the dropless mean of k · held / E
  slots a token: 6 · h · fe a slot;
- the dense layers' SwiGLU: 6 · h · ff;
- the head: 2 · h · V at the T − 1 predicted positions of a row.

Nothing the recomputation of the held experts' products in the backward
adds is counted: it is not the model's work.
"""

from __future__ import annotations


def moonlight_step_flops(cfg: dict, *, rows: int) -> dict:
    """FLOPs of a step of ``rows`` rows of ``cfg["seq_len"]`` tokens, by part,
    and ``total``."""
    h, H, T = cfg["hidden_size"], cfg["num_attention_heads"], cfg["seq_len"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, E, k = cfg["kv_lora_rank"], cfg["router_experts"], cfg["num_experts_per_tok"]
    held, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * fe
    L = cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    moe = L - dense
    tokens = rows * T
    proj = 2.0 * (h * H * (nope + rope) + h * (rank + rope) + rank * H * (nope + vd)
                  + H * vd * h) * L * tokens
    attention = 2.0 * H * (nope + rope + vd) * (T * (T + 1) / 2) * rows * L
    router = 2.0 * h * E * moe * tokens
    shared = 6.0 * h * fs * moe * tokens
    routed = held_expert_flops(cfg, slots=k * held / E * tokens * moe)
    ffn = 6.0 * h * cfg["intermediate_size"] * dense * tokens
    head = 2.0 * h * cfg["vocab_size"] * rows * (T - 1)
    parts = {"projections": proj, "attention": attention, "router": router,
             "shared_experts": shared, "held_experts": routed, "dense_ffn": ffn, "head": head}
    out = {k_: 3.0 * v for k_, v in parts.items()}
    out["total"] = sum(out.values())
    return out


def held_expert_flops(cfg: dict, *, slots: float, passes: float = 1.0) -> float:
    """The forward FLOPs of the held experts' SwiGLU over ``slots`` (token,
    held expert) selections, × ``passes`` (3: forward and backward)."""
    return 6.0 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * slots * passes
