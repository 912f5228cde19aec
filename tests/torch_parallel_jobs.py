"""What the port's gloo ranks run for the multi-rank tests
(``tests/test_torch_parallel.py``, ``test_torch_moe.py``,
``test_torch_train_parallel.py``, ``test_torch_collective.py``).

Each job runs on every rank of one ``parallel.launch.run_ranks`` call
(torch and the port only: no jax in the ranks), builds its meshes with
``make_mesh(device_type="cpu")``, takes its inputs as numpy arrays from
the test, and returns numpy arrays: full (gathered) outputs, gradients and
parameters, the same on every rank.  Not a test module (no ``test_``
prefix): the tests import it only to name its functions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from lakesoul_tpu_torch.annplane.collective import cross_chip_topk
from lakesoul_tpu_torch.models import train as TR
from lakesoul_tpu_torch.models.bert import BertConfig, param_sharding_rules
from lakesoul_tpu_torch.models.convert import gather_params, pipeline_rules
from lakesoul_tpu_torch.models.mlp import MLP
from lakesoul_tpu_torch.models.resnet import ResNet, ResNetConfig
from lakesoul_tpu_torch.parallel import collectives as C
from lakesoul_tpu_torch.parallel.mesh import make_mesh
from lakesoul_tpu_torch.parallel.moe import moe_ffn
from lakesoul_tpu_torch.parallel.pipeline import make_pipeline
from lakesoul_tpu_torch.parallel.ring_attention import make_ring_attention
from lakesoul_tpu_torch.parallel.ulysses import make_ulysses_attention

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gather_bt(t: torch.Tensor, plan, b_dim: int, t_dim: int | None) -> torch.Tensor:
    """This rank's [.., B/dp, .., T/sp, ..] block → the full array."""
    if t_dim is not None:
        t = torch.cat(list(C.all_gather_stack(t.contiguous(), plan.group("sp"))), dim=t_dim)
    return torch.cat(list(C.all_gather_stack(t.contiguous(), plan.group("dp"))), dim=b_dim)


def _local_bhtd(a: np.ndarray, plan) -> torch.Tensor:
    """A global [B, H, T, D] array → this rank's (dp, sp) block."""
    t = torch.from_numpy(a)
    t = t.chunk(plan.dp, 0)[plan.coord("dp")]
    return t.chunk(plan.sp, 2)[plan.coord("sp")].contiguous()


# ---------------------------------------------------------------- attention
def attention(cases: list) -> dict:
    """Each case: (name, mesh sizes, "ring" | "ulysses", q, k, v, mask, cot)
    → name: {"out", "dq", "dk", "dv"} (the gradient of Σ out · cot), or
    {"raised": message}."""
    res = {}
    for name, sizes, kind, q, k, v, mask, cot in cases:
        plan = make_mesh(**sizes, device_type="cpu")
        make = make_ring_attention if kind == "ring" else make_ulysses_attention
        ql, kl, vl = (_local_bhtd(a, plan).requires_grad_() for a in (q, k, v))
        m = torch.from_numpy(mask).chunk(plan.dp, 0)[plan.coord("dp")]
        m = m.chunk(plan.sp, 1)[plan.coord("sp")].contiguous()
        try:
            out = make(plan)(ql, kl, vl, m)
        except ValueError as e:
            res[name] = {"raised": str(e)}
            continue
        (out * _local_bhtd(cot, plan)).sum().backward()
        res[name] = {key: _np(_gather_bt(t, plan, 0, 2))
                     for key, t in (("out", out), ("dq", ql.grad), ("dk", kl.grad),
                                    ("dv", vl.grad))}
    return res


def pipeline_primitive(pp: int, n_micro: int, width: int) -> dict:
    """Stage i adds 10^i through ``make_pipeline`` over pp ranks: → the
    output and the gradients of Σ out · cot (cot = 1 + the element index)
    with respect to the input and to this stage's addend, every stage's."""
    plan = make_mesh(dp=1, tp=1, sp=1, pp=pp, device_type="cpu")
    add = torch.nn.Parameter(torch.tensor(10.0 ** plan.coord("pp")))
    x = torch.zeros(n_micro, width, requires_grad=True)

    def stage_fn(inp):
        return {"x": inp["x"] + add, "mask": inp["mask"]}

    run = make_pipeline(stage_fn, group=plan.group("pp"))
    out = run({"x": x, "mask": torch.ones(n_micro, width, dtype=torch.int32)})
    cot = torch.arange(1.0, n_micro * width + 1).reshape(n_micro, width)
    (out["x"] * cot).sum().backward()
    return {"out": _np(out["x"]), "mask": _np(out["mask"]), "dx": _np(x.grad),
            "dadd": _np(C.all_gather_stack(add.grad.reshape(1), plan.group("pp")))}


def collective_grads(seed: int) -> dict:
    """Each differentiable collective over the world group: this rank's
    input x (seeded by rank), output y, and the gradient of Σ y · c_rank."""
    rank, n = dist.get_rank(), dist.get_world_size()
    world = dist.group.WORLD
    rng = np.random.default_rng(seed + rank)
    ops = {
        "ring_shift": lambda t: C.ring_shift(t, group=world)[0],
        "all_to_all": lambda t: C.all_to_all(t, world, split_dim=0, concat_dim=1),
        "all_gather": lambda t: C.all_gather(t, world, dim=1),
        "all_reduce_sum": lambda t: C.all_reduce_sum(t, world),
        "copy_to": lambda t: C.copy_to(t, world),
        "reduce_from": lambda t: C.reduce_from(t, world),
    }
    out = {}
    for name, op in ops.items():
        x = torch.from_numpy(rng.normal(size=(2 * n, 3)).astype(np.float32)).requires_grad_()
        y = op(x)
        c = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
        (y * c).sum().backward()
        out[name] = {"x": _np(x), "y": _np(y), "c": _np(c), "dx": _np(x.grad)}
    return out


# ---------------------------------------------------------------------- MoE
def moe_sharded(sizes: dict, x: np.ndarray, params: dict, capacity_factor: float,
                cot: np.ndarray) -> dict:
    """``moe_ffn`` on this rank's tokens of a [B, T, h] batch (rows over dp,
    columns over sp, experts over ep): → the full output, aux and the
    gradients of Σ out · cot + aux (gate_w whole, experts gathered)."""
    plan = make_mesh(**sizes, device_type="cpu")
    B, T, h = x.shape
    xl = torch.from_numpy(x).chunk(plan.dp, 0)[plan.coord("dp")].chunk(plan.sp, 1)[plan.coord("sp")]
    Bl, Tl = xl.shape[:2]
    xl = xl.reshape(-1, h).contiguous().requires_grad_()
    rows = plan.coord("dp") * Bl + torch.arange(Bl)
    cols = plan.coord("sp") * Tl + torch.arange(Tl)
    index = (rows[:, None] * T + cols[None, :]).reshape(-1)
    ep = plan.coord("ep")
    p = {k: torch.nn.Parameter(torch.from_numpy(v if k == "gate_w" else
                                                np.array_split(v, plan.ep)[ep]).contiguous())
         for k, v in params.items()}
    out, aux = moe_ffn(xl, p["gate_w"], p["w1"], p["b1"], p["w2"], p["b2"],
                       capacity_factor=capacity_factor, token_group=plan.group("dp", "sp"),
                       token_index=index, ep_group=plan.group("ep"))
    cl = torch.from_numpy(cot).chunk(plan.dp, 0)[plan.coord("dp")].chunk(plan.sp, 1)[
        plan.coord("sp")].reshape(-1, h)
    # this rank's share of Σ out · cot + aux (aux is global: 1 / ranks of it each)
    ((out.float() * cl).sum() + aux / plan.size("dp", "sp")).backward()
    grads = {}
    for k, t in p.items():
        g = C.all_reduce_(t.grad.clone(), plan.group("dp", "sp"))
        if k != "gate_w":
            g = torch.cat(list(C.all_gather_stack(g, plan.group("ep"))), dim=0)
        grads[k] = _np(g)
    full = _gather_bt(out.reshape(Bl, Tl, h), plan, 0, 1)
    dx = _gather_bt(xl.grad.reshape(Bl, Tl, h), plan, 0, 1)
    return {"out": _np(full), "aux": float(aux), "grads": grads, "dx": _np(dx)}


# ------------------------------------------------------------------ training
def _bert_run(plan, model, step, batch, rules, seq: bool, steps: int) -> dict:
    local = [plan.shard_batch(a, seq=seq) for a in batch]
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(*local)))
        if i == 0:
            grads = gather_params({n: p.grad for n, p in model.named_parameters()}, plan, rules)
    params = gather_params(dict(model.named_parameters()), plan, rules)
    return {"losses": losses, "grads": {k: _np(v) for k, v in grads.items()},
            "params": {k: _np(v) for k, v in params.items()}}


def bert(cases: list) -> dict:
    """Each case: (name, mesh sizes, BertConfig fields, sequence_parallel |
    "pipeline", (ids, labels, mask), lr, steps) → name: the losses of
    ``steps`` SGD steps, the first step's gathered gradients and the
    gathered parameters after the last."""
    res = {}
    for name, sizes, cfg_fields, mode, batch, lr, steps in cases:
        plan = make_mesh(**sizes, device_type="cpu")
        cfg = BertConfig(**cfg_fields)
        if mode == "pipeline":
            model, _ = TR.make_bert_pipeline_train_state(cfg, plan)
            step = TR.make_bert_pipeline_train_step(model, TR.sgd(model.parameters(), lr), plan)
            rules = pipeline_rules(param_sharding_rules(plan))
            res[name] = _bert_run(plan, model, step, batch, rules, False, steps)
        else:
            model, _ = TR.make_bert_train_state(cfg, plan=plan)
            step = TR.make_bert_train_step(model, TR.sgd(model.parameters(), lr), plan=plan,
                                           sequence_parallel=mode)
            res[name] = _bert_run(plan, model, step, batch, None, True, steps)  # default rules
    return res


def _replicated_run(plan, model, step, batch, steps: int) -> dict:
    local = [plan.shard_batch(a, seq=False) for a in batch]
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(*local)))
        if i == 0:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads,
            "params": {n: _np(p) for n, p in model.named_parameters()}}


def resnet(dp: int, cfg_fields: dict, images, labels, lr: float, steps: int) -> dict:
    """ResNet data parallel over dp (the batch norm over the global batch);
    a float64 config gets float64 parameters too."""
    plan = make_mesh(dp=dp, tp=1, sp=1, device_type="cpu")
    model = ResNet(ResNetConfig(**cfg_fields), device="cpu")
    if cfg_fields.get("dtype") == "float64":
        model = model.double()
    step = TR.make_resnet_train_step(model, TR.sgd(model.parameters(), lr), plan=plan)
    return _replicated_run(plan, model, step, (images, labels), steps)


def mlp(dp: int, in_dim: int, hidden: int, x, y, lr: float, steps: int) -> dict:
    """The MLP data parallel over dp."""
    plan = make_mesh(dp=dp, tp=1, sp=1, device_type="cpu")
    model = MLP(in_dim, hidden=hidden, device="cpu")
    step = TR.make_mlp_train_step(model, TR.sgd(model.parameters(), lr), plan=plan)
    return _replicated_run(plan, model, step, (x, y), steps)


def many(calls: list) -> list:
    """Several jobs in one rank run: ``[(function name, args), ...]`` → their
    results in order."""
    return [globals()[name](*args) for name, args in calls]


# ---------------------------------------------------------------- collective
def topk(dists: np.ndarray, rows: np.ndarray, k: int) -> tuple:
    """``cross_chip_topk`` of this rank's row of [n, k_local] candidates."""
    me = dist.get_rank()
    d, r, src = cross_chip_topk(dists[me], rows[me], k=k, group=dist.group.WORLD)
    return _np(d), _np(r), _np(src)


# ------------------------------------------------------------------ launcher
def hang() -> None:
    """Rank 0 waits for a message no rank sends: a hung collective."""
    if dist.get_rank() == 0:
        dist.recv(torch.zeros(1), src=1)


def fail_on(rank: int) -> int:
    """Rank ``rank`` raises; the others return their rank."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()
