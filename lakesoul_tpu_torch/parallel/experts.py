"""A dropless top-k mixture-of-experts layer that is told which experts it
holds: DeepSeek-V3's routed and shared experts (arXiv:2412.19437 §2.1.2),
one rank's share under expert parallelism.

The router keeps its whole width: it scores every one of the
``n_experts`` routed experts, and each token picks ``top_k`` of them.  The
layer holds ``held = (first, count)``, experts ``[first, first + count)``,
and computes only their part of the result; on one device the exchange
that would carry the other experts' tokens to their ranks is left out, and
what the absent experts would add is absent.  The shared experts are
computed by every rank alike.  So over ranks whose held ranges cover the
experts, the routed parts and one rank's shared part add up to the whole
layer.

- Routing, in float32 (``noaux_tc`` with one group): sigmoid scores of the
  input upcast to float32 times the router; the choice is the top-k of the
  scores plus a per-expert selection bias, which takes no part in the
  weights; the k weights are the chosen scores, normalised to sum 1
  (``norm_topk_prob``) and scaled by ``scaling``.
- Dropless: no capacity.  Every (token, held expert) selection is computed.
  The selections are grouped by expert on the device: a stable sort of the
  held expert of each selection (the others sort last), one row a
  selection, and ``torch._grouped_mm`` over the groups' offsets computes
  each expert's SwiGLU on its own rows.  The row count is the data's, so
  the buffers have the bound ``tokens · min(top_k, count)`` and the
  products stop at the last group's end; nothing reads a row past it.  No
  host synchronise: every size the host sees is a shape.
- The combine and its transposes are gathers and batched products: each
  token gathers its k rows and sums them times their weights in float32
  (a selection not held weighs 0), and the backward gathers each row's
  gradient from its token, so no float ``index_add_`` (atomics, in no fixed
  order on CUDA) is on the path.  The held experts' products are recomputed
  in the backward from the saved input and the grouping: the buffers are
  sized for the bound, not for the rows the data gives.  SwiGLU saves its
  input alone (``silu_mul``).
- The sequence-wise balance term (``seq_aux``): for each sequence, Σ_i f_i
  P_i with f_i = E / (k · T) × the selections of expert i and P_i the mean
  over the sequence of each token's scores normalised to sum 1; the mean
  over sequences.  Only P carries a gradient.
- The selection bias is a float32 buffer.  ``update_bias()``, called after
  the optimizer's step, moves it by ``b_i += γ · sign(mean(load) − load_i)``
  with ``load`` the selections of every routed expert in the latest
  forward, on the device.

Counters, accumulated on the device in one int64 buffer a layer and read
by :func:`publish_counters` once the caller has synchronised: the routed
selections that landed on held experts, the rows the grouped products
computed (their difference is the dropped count: 0 by construction, and
read so), and each held expert's load.

While a ``torch.profiler`` records, the layer's forward opens ``moe.route``
(the router, the top-k, the grouping) and ``moe.experts`` (the held
experts' products and the combine), and the held experts' backward,
recomputation included, is ``moe.experts.backward``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.obs.metrics import registry
from lakesoul_tpu_torch.obs.tracing import device_timing, span

_UNTIMED = contextlib.nullcontext()


class _SwiGLUFn(torch.autograd.Function):
    """silu(gate) · up of h13 = [gate | up] [..., 2f]; saves h13 alone and
    writes both halves of its gradient into one buffer."""

    @staticmethod
    def forward(ctx, h13):
        f = h13.shape[-1] // 2
        ctx.save_for_backward(h13)
        return F.silu(h13[..., :f]) * h13[..., f:]

    @staticmethod
    def backward(ctx, ga):
        (h13,) = ctx.saved_tensors
        f = h13.shape[-1] // 2
        gate, up = h13[..., :f], h13[..., f:]
        g = torch.empty_like(h13)
        torch.mul(ga, F.silu(gate), out=g[..., f:])
        torch.ops.aten.silu_backward.grad_input(ga * up, gate, grad_input=g[..., :f])
        return g


def silu_mul(h13: torch.Tensor) -> torch.Tensor:
    return _SwiGLUFn.apply(h13)


def swiglu(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN with the gate and up projections in one matrix: x [..., h]
    @ w13 [h, 2f] → silu(gate) · up → @ w2 [f, h], in x's dtype."""
    return silu_mul(x @ w13.to(x.dtype)) @ w2.to(x.dtype)


class Grouping:
    """Where each selection of the held experts sits in the expert-sorted
    rows: built in the route phase from the top-k ids, all on the device.

    ``src`` [R]: the token of each sorted row (R = tokens · min(k, count));
    ``rows`` [R]: the flat selection (token · k + slot) of each sorted row;
    ``slot_row`` [N, k]: each held selection's sorted row, and row 0 for
    the others; ``held`` [N, k]; ``offs`` [count] int32: the end of each
    expert's group; ``any_held``: whether any row is computed (row 0 then
    is); ``held_load`` [count]; ``load`` [n_experts]: selections of every
    routed expert."""

    def __init__(self, idx: torch.Tensor, first: int, count: int, n_experts: int):
        N, k = idx.shape
        dev = idx.device
        local = (idx - first).flatten()
        held = (local >= 0) & (local < count)
        self.held = held.view(N, k)
        key = torch.where(held, local, count)
        order = torch.argsort(key, stable=True)
        per = torch.zeros(count + 1, dtype=torch.int64, device=dev).scatter_add_(
            0, key, torch.ones_like(key))
        self.held_load = per[:count]
        self.offs = self.held_load.cumsum(0).to(torch.int32)
        self.any_held = self.offs[-1] > 0
        R = N * min(k, count)
        self.rows = order[:R]
        self.src = self.rows // k
        pos = torch.empty_like(order)
        pos[order] = torch.arange(order.numel(), device=dev)
        self.slot_row = torch.where(held, pos, 0)
        self.load = torch.zeros(n_experts, dtype=torch.int64, device=dev).scatter_add_(
            0, idx.flatten(), torch.ones_like(key))


def _held_products(xg, w13, w2, offs):
    return torch._grouped_mm(silu_mul(torch._grouped_mm(xg, w13, offs=offs)), w2, offs=offs)


def _per_selection(rows: torch.Tensor, g: Grouping, k: int) -> torch.Tensor:
    """[N, k, h]: each held selection's row of the sorted ``rows`` [R, h];
    row 0 for a selection not held, which its caller weighs by 0 or masks
    (row 0 is computed wherever any row is; nothing reads a row past the
    groups' end)."""
    return rows.index_select(0, g.slot_row.flatten()).unflatten(0, (-1, k))


class _HeldExperts(torch.autograd.Function):
    """The held experts' weighted sum [N, h] in float32, from x [N, h]
    (compute dtype), the routing weights w [N, k] (float32), the experts'
    w13 [count, h, 2f] and w2 [count, f, h] (compute dtype) and a
    :class:`Grouping`.  Each reduction over a token's k selections is one
    batched product; a selection not held weighs 0."""

    @staticmethod
    def forward(ctx, x, w, w13, w2, g: Grouping, timed: bool):
        with torch.no_grad():
            y = _held_products(x.index_select(0, g.src), w13, w2, g.offs)
            wz = torch.where(g.held, w, 0).unsqueeze(1)
            out = torch.bmm(wz, _per_selection(y, g, w.shape[1]).float()).squeeze(1)
            out = torch.where(g.any_held, out, 0)
        ctx.save_for_backward(x, w, w13, w2)
        ctx.g, ctx.timed = g, timed
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w, w13, w2 = ctx.saved_tensors
        g, k = ctx.g, w.shape[1]
        timed = ctx.timed and device_timing()
        with span("moe.experts.backward", device=x.device, detached=True) if timed else _UNTIMED:
            with torch.enable_grad():
                xg = x.index_select(0, g.src).detach().requires_grad_(True)
                w13_ = w13.detach().requires_grad_(True)
                w2_ = w2.detach().requires_grad_(True)
                y = _held_products(xg, w13_, w2_, g.offs)
            with torch.no_grad():
                gw = torch.bmm(_per_selection(y.detach(), g, k).float(), grad.unsqueeze(-1))
                gw = torch.where(g.held, gw.squeeze(-1), 0)
                w_row = w.flatten().index_select(0, g.rows).to(y.dtype)
                gy = grad.to(y.dtype).index_select(0, g.src) * w_row[:, None]
            gxg, gw13, gw2 = torch.autograd.grad(y, (xg, w13_, w2_), gy)
            with torch.no_grad():
                mask = g.held.to(gxg.dtype).unsqueeze(1)
                gx = torch.bmm(mask, _per_selection(gxg, g, k)).squeeze(1)
                gx = torch.where(g.any_held, gx, 0)
        return gx, gw, gw13, gw2, None, None


# the device counters' layout: routed selections on held experts, rows the
# grouped products computed, then each held expert's load
_SLOTS, _ROWS, _LOAD = 0, 1, 2


class DroplessMoe(nn.Module):
    """One layer's routed and shared experts.  Parameters, each drawn by
    ``draw(*shape)``: ``router`` [h, n_experts], ``expert_w13`` [count, h,
    2f], ``expert_w2`` [count, f, h], ``shared_w13`` [h, 2fs], ``shared_w2``
    [fs, h] (float32 masters); buffers: ``selection_bias`` [n_experts]
    float32, ``counters``."""

    def __init__(self, hidden: int, ff: int, n_experts: int, top_k: int, draw, *,
                 shared_ff: int, scaling: float, bias_speed: float,
                 held: tuple[int, int] | None = None):
        super().__init__()
        first, count = held if held is not None else (0, n_experts)
        if not (0 <= first and count >= 1 and first + count <= n_experts):
            raise ValueError(f"held experts {held} do not lie in [0, {n_experts})")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} of {n_experts} experts")
        self.first, self.count, self.n_experts, self.top_k = first, count, n_experts, top_k
        self.scaling, self.bias_speed = scaling, bias_speed
        self.router = draw(hidden, n_experts)
        self.expert_w13 = draw(count, hidden, 2 * ff)
        self.expert_w2 = draw(count, ff, hidden)
        self.shared_w13 = draw(hidden, 2 * shared_ff)
        self.shared_w2 = draw(shared_ff, hidden)
        self.register_buffer("selection_bias", torch.zeros(n_experts))
        self.register_buffer("counters", torch.zeros(_LOAD + count, dtype=torch.int64),
                             persistent=False)
        self.load = None  # the latest forward's selections of every routed expert
        self.last_selection = None  # and its top-k ids [N, k]

    def route(self, x: torch.Tensor):
        """→ (scores [N, n_experts] float32, the top-k ids [N, k], their
        weights [N, k] float32)."""
        scores = torch.sigmoid(x.float() @ self.router.float())
        idx = torch.topk(scores.detach() + self.selection_bias, self.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        return scores, idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.scaling

    def forward(self, x: torch.Tensor, sequences: int = 1):
        """x [N, h] (compute dtype), ``sequences`` rows of N / sequences
        tokens each → (out [N, h] in x's dtype, the balance term, float32)."""
        timed = device_timing()
        dev = x.device

        def phase(name):
            return span(name, device=dev) if timed else _UNTIMED

        with phase("moe.route"):
            scores, idx, w = self.route(x)
            g = Grouping(idx, self.first, self.count, self.n_experts)
        with phase("moe.experts"):
            out = _HeldExperts.apply(x, w, self.expert_w13.to(x.dtype),
                                     self.expert_w2.to(x.dtype), g, timed)
        out = out + swiglu(x, self.shared_w13, self.shared_w2).float()
        self.load, self.last_selection = g.load, idx
        with torch.no_grad():
            self.counters += torch.cat([g.held.sum().view(1), g.offs[-1:].long(), g.held_load])
        return out.to(x.dtype), self.balance(scores, idx, sequences)

    def balance(self, scores: torch.Tensor, idx: torch.Tensor, sequences: int) -> torch.Tensor:
        """The sequence-wise balance term of ``scores`` [N, E] and the top-k
        ids [N, k], the N tokens ``sequences`` rows of equal length."""
        E, k = self.n_experts, self.top_k
        T = scores.shape[0] // sequences
        ones = torch.ones(sequences, T * k, device=scores.device)
        picks = torch.zeros(sequences, E, device=scores.device).scatter_add_(
            1, idx.view(sequences, T * k), ones)
        f = picks * (E / (k * T))
        p = (scores / scores.sum(-1, keepdim=True)).view(sequences, T, E).mean(1)
        return (f * p).sum(-1).mean()

    @torch.no_grad()
    def update_bias(self) -> None:
        """``selection_bias += γ · sign(mean(load) − load)`` for the latest
        forward's load; nothing before the first forward."""
        if self.load is None:
            return
        load = self.load.float()
        self.selection_bias.add_(torch.sign(load.mean() - load), alpha=self.bias_speed)


def publish_counters(layers) -> dict:
    """Read and zero the device counters of ``layers`` (one synchronise:
    call it where the caller has synchronised anyway), add them to the
    registry's ``lakesoul_moe_routed_slots_total`` and
    ``lakesoul_moe_dropped_total``, set the gauges
    ``lakesoul_moe_held_load_max`` and ``lakesoul_moe_held_load_mean`` (the
    held experts' load per layer, over what was read), and → those four
    numbers."""
    layers = list(layers)
    if not layers:
        return {}
    with torch.no_grad():
        c = torch.stack([m.counters for m in layers]).cpu()
        for m in layers:
            m.counters.zero_()
    slots, rows = int(c[:, _SLOTS].sum()), int(c[:, _ROWS].sum())
    load = c[:, _LOAD:].double()
    out = {"routed_slots": slots, "dropped": slots - rows,
           "held_load_max": float(load.max()), "held_load_mean": float(load.mean())}
    reg = registry()
    reg.counter("lakesoul_moe_routed_slots_total").inc(slots)
    reg.counter("lakesoul_moe_dropped_total").inc(slots - rows)
    reg.gauge("lakesoul_moe_held_load_max").set(out["held_load_max"])
    reg.gauge("lakesoul_moe_held_load_mean").set(out["held_load_mean"])
    return out
