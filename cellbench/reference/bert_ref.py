"""Plain PyTorch BERT masked-LM training steps: the reference the program's
first steps are held against.

The architecture is the configuration's (``configs/bert_base_mlm_c4.json``):
BERT-Base's widths with the program's stated departures from the published
model, each a key of that file: pre-LN blocks, layer norm eps 1e-6, the
tanh form of GELU, no dropout, no token types, a weight-tied MLM head with
a bias, the mean NLL over the labelled positions.  AdamW as optax has it:
eps outside the square root, decoupled weight decay of every leaf.

``body="float32"`` and ``head="float32"`` is the reference: every product
in float32 with TF32 off.  ``body="fp8"`` takes the encoder's products (q,
k, v, o, the FFN, QKᵀ and P·V) as fp8 training does: their forward
operands in float8 e4m3 and their backward's incoming gradient in e5m2,
each under a per-tensor scale, summed in float32.  ``head="bfloat16"``
takes the tied head's product (its logits, and through them the gradient
of the hidden state and of ``tok_emb``) in bfloat16: operands and logits
rounded to it, products summed in float32, the softmax and the loss in
float32 over the rounded logits.

Nothing here comes from the program: names and shapes are the
configuration's, the weights are the benchmark's (``inputs.bert_weights``).
The head is computed only at the labelled positions, which is the whole of
what the loss reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def param_shapes(cfg: dict) -> dict:
    """name → (shape, init) of every leaf, in a fixed order."""
    h, f, v, t = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["max_position_embeddings"]
    out = {"tok_emb": ((v, h), "normal"), "pos_emb": ((t, h), "normal"),
           "emb_ln.scale": ((h,), "ones"), "emb_ln.bias": ((h,), "zeros")}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for w in ("wq", "wk", "wv", "wo"):
            out[p + w] = ((h, h), "normal")
        for ln in ("ln1", "ln2"):
            out[p + ln + ".scale"] = ((h,), "ones")
            out[p + ln + ".bias"] = ((h,), "zeros")
        out[p + "w1"] = ((h, f), "normal")
        out[p + "w2"] = ((f, h), "normal")
        out[p + "b1"] = ((f,), "zeros")
        out[p + "b2"] = ((h,), "zeros")
    out["mlm_ln.scale"] = ((h,), "ones")
    out["mlm_ln.bias"] = ((h,), "zeros")
    out["mlm_bias"] = ((v,), "zeros")
    return out


def _q(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 ``dtype`` under a per-tensor scale (amax →
    the type's largest), back in t's dtype."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as fp8 training takes it: the forward's operands in e4m3, the
    backward's incoming gradient in e5m2, each under a per-tensor scale,
    products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q(a, torch.float8_e4m3fn, E4M3_MAX), _q(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        g = _q(g, torch.float8_e5m2, E5M2_MAX)
        ga = g @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ g
        # broadcast operands (a weight under a batch) sum back to their shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".scale"], p[name + ".bias"], eps)


def _head_logits(z, emb, head: str) -> torch.Tensor:
    if head == "bfloat16":
        return (z.to(torch.bfloat16) @ emb.to(torch.bfloat16).T).float()
    return z @ emb.T


def loss(p: dict, ids, labels, mask, cfg: dict, body: str = "float32",
         head: str = "float32") -> torch.Tensor:
    mm = _Fp8Matmul.apply if body == "fp8" else torch.matmul
    eps = float(cfg["layer_norm_eps"])
    heads = cfg["num_attention_heads"]
    B, T = ids.shape
    h = cfg["hidden_size"]
    dh = h // heads
    x = p["tok_emb"][ids.long()] + p["pos_emb"][:T][None]
    x = _ln(x, p, "emb_ln", eps)
    keep = mask.bool()[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        y = _ln(x, p, pre + "ln1", eps)

        def split(w):
            return mm(y, p[pre + w]).view(B, T, heads, dh).transpose(1, 2)

        q, k, v = split("wq"), split("wk"), split("wv")
        s = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
        a = mm(torch.softmax(s.masked_fill(~keep, -1e30), dim=-1), v)
        x = x + mm(a.transpose(1, 2).reshape(B, T, h), p[pre + "wo"])
        y = _ln(x, p, pre + "ln2", eps)
        hid = F.gelu(mm(y, p[pre + "w1"]) + p[pre + "b1"], approximate="tanh")
        x = x + mm(hid, p[pre + "w2"]) + p[pre + "b2"]
    read = labels >= 0
    z = _ln(x[read], p, "mlm_ln", eps)
    logits = _head_logits(z, p["tok_emb"], head) + p["mlm_bias"]
    return F.cross_entropy(logits, labels[read].long(), reduction="sum") / read.sum().clamp(min=1)


def train(weights: dict, batches, cfg: dict, opt: dict, body: str = "float32",
          head: str = "float32") -> dict:
    """Steps of AdamW from ``weights`` (float32, left untouched) over
    ``batches`` [(ids, labels, mask)]: each step's loss, each leaf's norm of
    the first gradient, and each leaf's norm of its change after the last
    step."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        s = {k: torch.zeros_like(v) for k, v in p.items()}
        b1, b2 = opt["betas"]
        lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
        losses, grad_norms = [], None
        for t, (ids, labels, mask) in enumerate(batches, start=1):
            val = loss(p, ids, labels, mask, cfg, body, head)
            grads = torch.autograd.grad(val, list(p.values()))
            losses.append(float(val.detach()))
            with torch.no_grad():
                if grad_norms is None:
                    grad_norms = {k: float(g.norm()) for k, g in zip(p, grads)}
                for (k, w), g in zip(p.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[k] / (1 - b1 ** t)) / ((s[k] / (1 - b2 ** t)).sqrt() + eps)
                    w.sub_(lr * (upd + wd * w))
            del grads, val
        with torch.no_grad():
            update_norms = {k: float((p[k] - weights[k].float()).norm()) for k in p}
        return {"losses": losses, "grad_norms": grad_norms, "update_norms": update_norms}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
