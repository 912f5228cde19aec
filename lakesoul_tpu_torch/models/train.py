"""Training steps, the port of ``lakesoul_tpu/models/train.py``.

Each builder returns ``step(*batch) → loss``: it moves the batch (numpy
arrays or tensors) to the step's device, takes the gradient of the model's
loss, and applies one update of a ``torch.optim`` optimizer.  The
optimizers below are optax's, with optax's defaults: ``adamw``'s weight
decay is 1e-4 (torch's ``AdamW`` defaults to 1e-2) on every parameter,
Adam's eps 1e-8 is added outside the square root (in both), and ``sgd`` has
no momentum.

With ``plan=`` (a ``parallel.mesh.MeshPlan``) a step runs on one rank of
the mesh: the model holds this rank's slice of the parameters
(``make_bert_train_state(plan=)``) and the step takes this rank's shard of
the batch (``MeshPlan.shard_batch``).  The reference's steps are GSPMD
programs over global arrays, so every reduction there is global; here:

- each rank's loss is its share, its local sum over the GLOBAL count
  (``masked_nll``'s label count, the batch for ResNet and the MLP), and the
  MoE auxiliary term divided by the ranks that split the tokens;
- after the backward, the gradients and the shares are summed over the
  group that splits the data in one all-reduce (dp × sp for BERT, dp for
  the pipeline, ResNet and the MLP), so every replica steps the same;
- the rest — tensor-parallel sums, the ring, the all-to-alls, the MoE's
  global token order and capacity, ResNet's global batch norm — happens
  inside the models (``models/bert.py``, ``models/resnet.py``,
  ``parallel/``).
"""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models.bert import (
    Bert,
    BertConfig,
    bert_embed,
    bert_forward,
    bert_head,
    bert_layer,
    bert_mlm_loss,
    masked_nll,
    param_sharding_rules,
)
from lakesoul_tpu_torch.models.convert import load_local, pipeline_rules, shard_params
from lakesoul_tpu_torch.models.mlp import mlp_forward, mlp_loss
from lakesoul_tpu_torch.models.resnet import resnet_forward, resnet_loss
from lakesoul_tpu_torch.parallel.collectives import all_reduce_
from lakesoul_tpu_torch.parallel.mesh import DATA_AXES
from lakesoul_tpu_torch.parallel.pipeline import (
    make_pipeline,
    merge_microbatches,
    split_microbatches,
)
from lakesoul_tpu_torch.parallel.ring_attention import make_ring_attention
from lakesoul_tpu_torch.parallel.ulysses import make_ulysses_attention

BETAS, EPS = (0.9, 0.999), 1e-8  # optax.adam / optax.adamw defaults
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
SEQUENCE_PARALLEL = ("ring", "ulysses")


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)


def adamw(params, lr: float, weight_decay: float = ADAMW_WEIGHT_DECAY) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)``: decoupled decay of every param."""
    return torch.optim.AdamW(params, lr=lr, betas=BETAS, eps=EPS, weight_decay=weight_decay)


def sgd(params, lr: float) -> torch.optim.SGD:
    """``optax.sgd(lr)``: plain gradient descent, no momentum."""
    return torch.optim.SGD(params, lr=lr)


def _check_device(model: torch.nn.Module, dev: torch.device) -> None:
    wrong = sorted({str(p.device) for p in model.parameters() if p.device.type != dev.type})
    if wrong:
        raise ConfigError(f"the model's params are on {wrong}, the step's device is {dev}")


def _make_step(model: torch.nn.Module, opt: torch.optim.Optimizer, loss_fn, device):
    dev = resolve_device(device)
    _check_device(model, dev)

    def step(*batch) -> torch.Tensor:
        batch = [torch.as_tensor(b).to(dev, non_blocking=True) for b in batch]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _make_plan_step(model: torch.nn.Module, opt: torch.optim.Optimizer, share_fn, group, plan):
    """``share_fn(*batch)`` → this rank's loss share; the step sums every
    gradient and the shares over ``group`` in one all-reduce before the
    update, and returns the global loss."""
    dev = plan.device
    _check_device(model, dev)
    params = list(model.parameters())

    def step(*batch) -> torch.Tensor:
        batch = [torch.as_tensor(b).to(dev, non_blocking=True) for b in batch]
        opt.zero_grad(set_to_none=True)
        share = share_fn(*batch)
        share.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [share.detach().float().reshape(1)])
        all_reduce_(flat, group)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        opt.step()
        return flat[-1]

    return step


def _global_count(labels: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_((labels >= 0).sum(), group)


def make_mlp_train_step(model, opt, *, plan=None, device=None):
    """``step(x, y) → loss``: the tabular (Titanic) config's step; with
    ``plan``, data parallel over dp (``x``, ``y``: this rank's rows)."""
    if plan is None:
        return _make_step(model, opt, mlp_loss, device)
    group = plan.group("dp")

    def share(x, y):
        logits = mlp_forward(model, x)
        return torch.nn.functional.cross_entropy(logits, y.long(), reduction="sum") / (
            y.shape[0] * plan.dp)

    return _make_plan_step(model, opt, share, group, plan)


def make_resnet_train_step(model, opt, *, plan=None, device=None):
    """``step(images, labels) → loss``: the ImageNet config's step; with
    ``plan``, data parallel over dp, the batch norm over the global batch."""
    if plan is None:
        return _make_step(model, opt, resnet_loss, device)
    group = plan.group("dp")

    def share(images, labels):
        logits = resnet_forward(model, images, group)
        return torch.nn.functional.cross_entropy(logits, labels.long(), reduction="sum") / (
            labels.shape[0] * plan.dp)

    return _make_plan_step(model, opt, share, group, plan)


def make_bert_train_state(cfg: BertConfig, *, plan=None, lr: float = 1e-4, seed: int = 0,
                          device=None):
    """→ (model, optimizer): ``Bert(cfg)`` and ``adamw(lr)``, as the
    reference's state (params, ``optax.adamw(lr)``'s state).  With
    ``plan``, the model holds this rank's slice of ``Bert(cfg, seed=seed)``
    (``param_sharding_rules``) on the plan's device."""
    if plan is None:
        model = Bert(cfg, seed=seed, device=device)
    else:
        model = _sliced(cfg, plan, param_sharding_rules(plan, n_experts=cfg.n_experts), seed)
    return model, adamw(model.parameters(), lr)


def _sliced(cfg: BertConfig, plan, rules: dict, seed: int) -> Bert:
    model = Bert(cfg, seed=seed, device="cpu")
    load_local(model, shard_params(model.state_dict(), plan, rules))
    return model.to(plan.device)


def make_bert_train_step(model: Bert, opt, *, plan=None, sequence_parallel: str = "ring",
                         device=None):
    """``step(input_ids, labels, mask) → loss``: the MLM step.

    With ``plan``, the batch is this rank's [B/dp, T/sp] block and
    ``sequence_parallel`` picks the long-context strategy when sp > 1:
    "ring" (K/V rotation) or "ulysses" (two all-to-alls around one full
    attention; heads % sp == 0)."""
    if sequence_parallel not in SEQUENCE_PARALLEL:
        # validate regardless of sp: a typo must fail on the dev box, not
        # first surface when the script scales onto an sp>1 mesh
        raise ValueError(f"unknown sequence_parallel {sequence_parallel!r} (ring|ulysses)")
    if plan is None:
        return _make_step(model, opt, bert_mlm_loss, device)
    attention_fn = None
    if plan.sp > 1:
        make = make_ring_attention if sequence_parallel == "ring" else make_ulysses_attention
        attention_fn = make(plan)
    group = plan.group(*DATA_AXES)
    cfg = model.cfg

    def share(input_ids, labels, mask):
        count = _global_count(labels, group)
        logits, aux = bert_forward(model, input_ids, mask, attention_fn=attention_fn,
                                   with_aux=True, plan=plan)
        loss = masked_nll(logits, labels, count)
        if cfg.n_experts:
            loss = loss + cfg.moe_aux_weight * aux / plan.size(*DATA_AXES)
        return loss

    return _make_plan_step(model, opt, share, group, plan)


def make_bert_pipeline_train_state(cfg: BertConfig, plan, *, lr: float = 1e-4, seed: int = 0):
    """(model, optimizer) for the PIPELINE layout: this rank holds its
    stage's layers (the layer stack split over 'pp', the memory win
    pipelining exists for) and the rest whole.  As in the reference's
    pipeline step, the other axes hold replicas (its stages see whole
    layers), and the batch splits over dp only."""
    if cfg.n_experts:
        # a pipelined MoE stage would all-gather every expert into every
        # stage in the reference: rejected there, rejected here
        raise ValueError("pipeline layout does not support MoE configs")
    if cfg.layers % max(plan.pp, 1):
        raise ValueError(f"{cfg.layers} layers do not split over pp={plan.pp}")
    model = _sliced(cfg, plan, pipeline_rules(param_sharding_rules(plan)), seed)
    return model, adamw(model.parameters(), lr)


def make_bert_pipeline_train_step(model: Bert, opt, plan, *, n_micro: int = 4):
    """MLM step with the encoder pipelined over 'pp': embeddings and head
    run on every stage; microbatches stream through the stage ring
    (``parallel/pipeline.py``) and autograd through the shifts is the
    reverse pipeline.  The batch is this rank's [B/dp, T] block, split into
    ``n_micro`` microbatches inside the step."""
    cfg = model.cfg
    group = plan.group("dp")

    def stage_fn(inp):
        x, mask = inp["x"], inp["mask"] != 0
        for lp in model.layers:
            x, _ = bert_layer(x, lp, mask, cfg=cfg)
        return {"x": x, "mask": inp["mask"]}

    pipeline = make_pipeline(stage_fn, group=plan.group("pp"))

    def share(input_ids, labels, mask):
        count = _global_count(labels, group)
        x = bert_embed(model, input_ids)
        # the mask rides the ring as int32: the collection sum over pp takes no bools
        micro = split_microbatches({"x": x, "mask": mask.to(torch.int32)}, n_micro)
        x = merge_microbatches(pipeline(micro), input_ids.shape[0])["x"]
        return masked_nll(bert_head(model, x), labels, count)

    return _make_plan_step(model, opt, share, group, plan)
