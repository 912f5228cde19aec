"""Plain PyTorch next-token training steps of Moonlight-16B-A3B's block
(DeepSeek-V3: MLA, a dense SwiGLU layer, then MoE layers of sigmoid-routed
experts with a selection bias and shared experts), one rank's share as
``configs/moonlight_16b_a3b_ep8.json`` cuts it: the reference the program's
first steps are held against.

The architecture is the configuration's, written out from the published
equations (the HF ``config.json``, DeepSeek-V3's report arXiv:2412.19437):

- pre-norm blocks, RMSNorm with ``rms_norm_eps``;
- MLA without a q-LoRA: q [H, qk_nope + qk_rope] from ``wq``; the latent
  [kv_lora_rank] (RMS-normed by ``kv_norm``) and one shared rope key
  [qk_rope] from ``wkv_a``; each head's k_nope and v from ``wkv_b``; RoPE
  (θ ``rope_theta``) on the interleaved pairs (x[2i], x[2i+1]) of the rope
  dims, angle pos · θ^(−2i/d); causal softmax attention scaled by
  1/√(qk_nope + qk_rope), computed in query blocks (forward and backward:
  the [T, T] scores are never held whole);
- the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; then the router's sigmoid scores over
  ``router_experts``, the choice the top ``num_experts_per_tok`` of the
  scores plus the selection bias, the weights the chosen scores normalised
  to sum 1 times ``routed_scaling_factor``; the held experts
  ``[held_expert_first, + n_routed_experts)`` computed by a plain loop, each
  on the tokens that chose it (a mask), and the ``n_shared_experts``
  shared experts as one SwiGLU of their summed width;
- the sequence-wise balance term (Σ_i f_i P_i a sequence, f_i = E/(k·T) ×
  the selections of expert i, P_i the sequence's mean of the scores
  normalised to sum 1), summed over the MoE layers, at ``aux_loss_alpha``;
- an untied head; the loss the mean next-token NLL over every row's T − 1
  predicted positions;
- AdamW as optax has it; after each update every selection bias moves by
  ``bias_update_speed`` × sign(mean load − load), the load the step's
  selections of every routed expert.  The biases a run starts from are
  ``balanced_biases``: those of a job whose routing the bias has balanced.

A batch is computed one sequence at a time, the gradients summed: every part
of the loss is a sum over sequences.  ``precision="float32"`` is the
reference: every product in float32 with TF32 off.  ``precision="control"``
takes each product the configuration states in bfloat16 (the projections,
the attention, the experts, the head) as fp8 training does (``bert_ref``'s
fp8 matmul: e4m3 forward operands, e5m2 backward gradients, per-tensor
scales, float32 sums) and the router in bfloat16 (operands, logits and
scores rounded).  Nothing here comes from the program: names and shapes
are the configuration's, the weights the benchmark's.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F


def _sibling(name: str):
    spec = importlib.util.spec_from_file_location(f"moonlight_ref_{name}",
                                                  Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BERT = _sibling("bert_ref")
QUERY_BLOCK = 1024
BALANCE_ITERS = 400


def moe_layers(cfg: dict) -> list[int]:
    return list(range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"]))


def param_shapes(cfg: dict) -> dict:
    """name → (shape, init) of every leaf, in a fixed order."""
    h, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, E = cfg["kv_lora_rank"], cfg["router_experts"]
    held, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * fe
    out = {"embed": ((cfg["vocab_size"], h), "normal")}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out[p + "attn_norm"] = ((h,), "ones")
        out[p + "attn.wq"] = ((h, H * (nope + rope)), "normal")
        out[p + "attn.wkv_a"] = ((h, rank + rope), "normal")
        out[p + "attn.kv_norm"] = ((rank,), "ones")
        out[p + "attn.wkv_b"] = ((rank, H * (nope + vd)), "normal")
        out[p + "attn.wo"] = ((H * vd, h), "normal")
        out[p + "ffn_norm"] = ((h,), "ones")
        if i < cfg["first_k_dense_replace"]:
            out[p + "ffn.w13"] = ((h, 2 * cfg["intermediate_size"]), "normal")
            out[p + "ffn.w2"] = ((cfg["intermediate_size"], h), "normal")
        else:
            out[p + "moe.router"] = ((h, E), "normal")
            out[p + "moe.expert_w13"] = ((held, h, 2 * fe), "normal")
            out[p + "moe.expert_w2"] = ((held, fe, h), "normal")
            out[p + "moe.shared_w13"] = ((h, 2 * fs), "normal")
            out[p + "moe.shared_w2"] = ((fs, h), "normal")
    out["norm"] = ((h,), "ones")
    out["head"] = ((h, cfg["vocab_size"]), "normal")
    return out


def bias_name(i: int) -> str:
    return f"layers.{i}.moe.selection_bias"


def bias_after(selections, cfg: dict, start: dict) -> dict:
    """Every MoE layer's selection bias after steps whose top-k ids are
    ``selections`` (one [layers, B · T, k] a step), from ``start`` (layer →
    bias): each step adds ``bias_update_speed`` × sign(mean load − load),
    the load each expert's selections in that step."""
    E = cfg["router_experts"]
    layers = moe_layers(cfg)
    b = torch.stack([start[i] for i in layers]).clone()
    for sel in selections:
        flat = sel.reshape(len(layers), -1)
        load = torch.zeros_like(b).scatter_add_(1, flat, torch.ones(flat.shape, device=b.device))
        b += cfg["bias_update_speed"] * torch.sign(load.mean(1, keepdim=True) - load)
    return {bias_name(i): b[j] for j, i in enumerate(layers)}


def _balance(scores: torch.Tensor, k: int, iters: int = BALANCE_ITERS) -> torch.Tensor:
    """A bias under which the top-k of ``scores`` [N, E] + bias gives every
    expert about N · k / E selections: sign steps toward the mean load,
    each step smaller by a fixed factor, from a tenth of the scores' spread
    down to a millionth of it."""
    E = scores.shape[1]
    b = torch.zeros(E, device=scores.device)
    step = 0.1 * float(scores.std())
    shrink = 1e-5 ** (1.0 / iters)
    ones = torch.ones(scores.shape[0] * k, device=scores.device)
    for _ in range(iters):
        idx = torch.topk(scores + b, k, -1).indices.flatten()
        load = torch.zeros(E, device=scores.device).scatter_add_(0, idx, ones)
        b += step * torch.sign(load.mean() - load)
        step *= shrink
    return b


def balanced_biases(weights: dict, tokens, cfg: dict) -> dict:
    """The selection biases of a job whose routing the bias has balanced:
    layer by layer in the float32 forward of ``tokens`` [B, T], each MoE
    layer's bias balances the top-k choices of that layer's input (every
    routed expert near B · T · k / E), and the next layer is fed by the
    routing it gives.  layer → bias [E]."""
    layers = moe_layers(cfg)
    bias = {i: torch.zeros(cfg["router_experts"], device=tokens.device) for i in layers}
    with torch.no_grad():
        seq = _Seq(weights, bias, cfg, "float32")
        p, eps, T = weights, seq.eps, tokens.shape[1]
        xs = [p["embed"][row.long()] for row in tokens]
        for i in range(cfg["num_hidden_layers"]):
            pre = f"layers.{i}."
            xs = [x + seq.attention(_rms(x, p[pre + "attn_norm"], eps), pre) for x in xs]
            y = torch.cat([_rms(x, p[pre + "ffn_norm"], eps) for x in xs])
            if i < cfg["first_k_dense_replace"]:
                out = seq.swiglu(y, p[pre + "ffn.w13"], p[pre + "ffn.w2"])
            else:
                bias[i] = _balance(torch.sigmoid(y @ p[pre + "moe.router"]),
                                   cfg["num_experts_per_tok"])
                out = seq.moe(y, i)[0]
            xs = [x + o for x, o in zip(xs, out.split(T))]
    return bias


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [..., T, d]: each pair (x[2i], x[2i+1]) turned by pos · θ^(−2i/d)."""
    T, d = x.shape[-2], x.shape[-1]
    freq = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.outer(torch.arange(T, device=x.device, dtype=torch.float32), freq)
    c, s = torch.cos(ang), torch.sin(ang)
    even, odd = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * c - odd * s
    out[..., 1::2] = even * s + odd * c
    return out


def _q8(t, grad=False):
    if grad:
        return _BERT._q(t, torch.float8_e5m2, _BERT.E5M2_MAX)
    return _BERT._q(t, torch.float8_e4m3fn, _BERT.E4M3_MAX)


class _BlockCausal(torch.autograd.Function):
    """softmax(q kᵀ · scale, causal) v for one sequence, q, k [H, T, dq], v
    [H, T, dv], in query blocks of ``QUERY_BLOCK``, the backward recomputing
    each block's scores.  ``fp8``: the operands of both products (q, k; each
    block's P, v) in e4m3 and the incoming gradients in e5m2."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fp8):
        if fp8:
            q, k, v = _q8(q), _q8(k), _q8(v)
        H, T, _ = q.shape
        o = torch.empty(H, T, v.shape[-1], device=q.device)
        lse = torch.empty(H, T, device=q.device)
        for s in range(0, T, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, T)
            S = (q[:, s:e] @ k[:, :e].transpose(1, 2)) * scale
            S = S.masked_fill(_future(s, e, q.device), float("-inf"))
            lse[:, s:e] = torch.logsumexp(S, -1)
            P = torch.exp(S - lse[:, s:e, None])
            o[:, s:e] = (_q8(P) if fp8 else P) @ v[:, :e]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.fp8 = scale, fp8
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, fp8 = ctx.scale, ctx.fp8
        if fp8:
            do = _q8(do, grad=True)
        D = (do * o).sum(-1)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        T = q.shape[1]
        for s in range(0, T, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, T)
            S = (q[:, s:e] @ k[:, :e].transpose(1, 2)) * scale
            S = S.masked_fill(_future(s, e, q.device), float("-inf"))
            P = torch.exp(S - lse[:, s:e, None])
            dv[:, :e] += (_q8(P) if fp8 else P).transpose(1, 2) @ do[:, s:e]
            dP = do[:, s:e] @ v[:, :e].transpose(1, 2)
            dS = P * (dP - D[:, s:e, None])
            if fp8:
                dS = _q8(dS, grad=True)
            dq[:, s:e] = (dS @ k[:, :e]) * scale
            dk[:, :e] += (dS.transpose(1, 2) @ q[:, s:e]) * scale
        return dq, dk, dv, None, None


def _future(s, e, device):
    """[e − s, e]: True where key j lies after query s + i."""
    return torch.arange(e, device=device)[None, :] > torch.arange(s, e, device=device)[:, None]


class _Seq:
    """One sequence's forward under the precision's products."""

    def __init__(self, p: dict, bias: dict, cfg: dict, precision: str):
        self.p, self.bias, self.cfg = p, bias, cfg
        self.fp8 = precision == "control"
        self.mm = _BERT._Fp8Matmul.apply if self.fp8 else torch.matmul
        self.eps = float(cfg["rms_norm_eps"])

    def swiglu(self, x, w13, w2):
        h13 = self.mm(x, w13)
        f = h13.shape[-1] // 2
        return self.mm(F.silu(h13[:, :f]) * h13[:, f:], w2)

    def attention(self, y, pre):
        cfg, p = self.cfg, self.p
        T = y.shape[0]
        H = cfg["num_attention_heads"]
        nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        rank = cfg["kv_lora_rank"]
        q = self.mm(y, p[pre + "attn.wq"]).view(T, H, nope + rope).transpose(0, 1)
        kva = self.mm(y, p[pre + "attn.wkv_a"])
        latent = _rms(kva[:, :rank], p[pre + "attn.kv_norm"], self.eps)
        k_rope = _rope(kva[:, rank:], cfg["rope_theta"])
        kv = self.mm(latent, p[pre + "attn.wkv_b"]).view(T, H, nope + vd).transpose(0, 1)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg["rope_theta"])], -1)
        k = torch.cat([kv[..., :nope], k_rope.expand(H, T, rope)], -1)
        o = _BlockCausal.apply(q, k, kv[..., nope:], 1.0 / math.sqrt(nope + rope), self.fp8)
        return self.mm(o.transpose(0, 1).reshape(T, H * vd), p[pre + "attn.wo"])

    def route(self, y, i):
        cfg, router = self.cfg, self.p[f"layers.{i}.moe.router"]
        if self.fp8:
            logits = (y.to(torch.bfloat16) @ router.to(torch.bfloat16)).float()
            scores = torch.sigmoid(logits).to(torch.bfloat16).float()
        else:
            scores = torch.sigmoid(y @ router)
        idx = torch.topk(scores.detach() + self.bias[i], cfg["num_experts_per_tok"], -1).indices
        w = scores.gather(1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
        return scores, idx, w

    def moe(self, y, i):
        cfg, p = self.cfg, self.p
        pre = f"layers.{i}.moe."
        T, E, k = y.shape[0], cfg["router_experts"], cfg["num_experts_per_tok"]
        scores, idx, w = self.route(y, i)
        out = self.swiglu(y, p[pre + "shared_w13"], p[pre + "shared_w2"])
        first = cfg["held_expert_first"]
        for e in range(cfg["n_routed_experts"]):
            hit = idx == first + e
            rows = hit.any(-1).nonzero()[:, 0]
            if rows.numel():
                we = (w * hit)[rows].sum(-1)
                part = self.swiglu(y[rows], p[pre + "expert_w13"][e], p[pre + "expert_w2"][e])
                out = out.index_add(0, rows, part * we[:, None])
        picks = torch.zeros(E, device=y.device).scatter_add_(
            0, idx.flatten(), torch.ones(idx.numel(), device=y.device))
        frac = scores / scores.sum(-1, keepdim=True)
        bal = (picks * (E / (k * T)) * frac.mean(0)).sum()
        return out, bal, idx, picks

    def loss(self, tokens, rows: int):
        """This sequence's share of the batch loss (its NLL sum over the
        batch's B · (T − 1) positions, its balance terms over B), its
        selections by MoE layer and its loads."""
        cfg, p = self.cfg, self.p
        T = tokens.shape[0]
        x = p["embed"][tokens.long()]
        bal, sel, loads = 0.0, {}, {}
        for i in range(cfg["num_hidden_layers"]):
            pre = f"layers.{i}."
            x = x + self.attention(_rms(x, p[pre + "attn_norm"], self.eps), pre)
            y = _rms(x, p[pre + "ffn_norm"], self.eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + self.swiglu(y, p[pre + "ffn.w13"], p[pre + "ffn.w2"])
            else:
                out, b, sel[i], loads[i] = self.moe(y, i)
                x = x + out
                bal = bal + b
        logits = self.mm(_rms(x[:-1], p["norm"], self.eps), p["head"])
        nll = F.cross_entropy(logits, tokens[1:].long(), reduction="sum") / (rows * (T - 1))
        return nll + cfg["aux_loss_alpha"] * bal / rows, sel, loads


def train(weights: dict, biases: dict, batches, cfg: dict, opt: dict,
          precision: str = "float32") -> dict:
    """Steps of AdamW from ``weights`` (float32, left untouched) and the
    selection ``biases`` (layer → [E]) over ``batches`` (token tensors [B,
    T]): each step's loss, each leaf's norm
    of the first gradient, each leaf's norm of its change after the last
    step, each step's top-k ids of every MoE layer ([layers, B · T, k] a
    step), and the selection biases at the end."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        dev = next(iter(weights.values())).device
        p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
        bias = {i: biases[i].detach().clone().float().to(dev) for i in moe_layers(cfg)}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        s = {k: torch.zeros_like(v) for k, v in p.items()}
        b1, b2 = opt["betas"]
        lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
        losses, grad_norms, selections = [], None, []
        for t, tokens in enumerate(batches, start=1):
            seq = _Seq(p, bias, cfg, precision)
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            load = {i: torch.zeros_like(b) for i, b in bias.items()}
            total, sel = 0.0, {i: [] for i in bias}
            for row in tokens:
                val, s_sel, s_load = seq.loss(row, tokens.shape[0])
                # a held expert no token of this row chose takes no gradient from it
                for g_acc, g in zip(grads.values(), torch.autograd.grad(
                        val, list(p.values()), allow_unused=True)):
                    if g is not None:
                        g_acc += g
                total += float(val.detach())
                for i in bias:
                    load[i] += s_load[i]
                    sel[i].append(s_sel[i])
                del val
            losses.append(total)
            selections.append(torch.stack([torch.cat(sel[i]) for i in bias]))
            with torch.no_grad():
                if grad_norms is None:
                    grad_norms = {k: float(g.norm()) for k, g in grads.items()}
                for k, w in p.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[k] / (1 - b1 ** t)) / ((s[k] / (1 - b2 ** t)).sqrt() + eps)
                    w.sub_(lr * (upd + wd * w))
                for i, b in bias.items():
                    b.add_(torch.sign(load[i].mean() - load[i]), alpha=cfg["bias_update_speed"])
            del grads
        with torch.no_grad():
            update_norms = {k: float((p[k] - weights[k].float()).norm()) for k in p}
        return {"losses": losses, "grad_norms": grad_norms, "update_norms": update_norms,
                "selections": selections,
                "biases": {bias_name(i): b.clone() for i, b in bias.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
