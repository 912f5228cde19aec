"""Training steps on one device, the port of the single-device parts of
``lakesoul_tpu/models/train.py``.

Each builder returns ``step(*batch) → loss``: it moves the batch (numpy
arrays or tensors) to the step's device, takes the gradient of the model's
loss, and applies one update of a ``torch.optim`` optimizer.  The
optimizers below are optax's, with optax's defaults: ``adamw``'s weight
decay is 1e-4 (torch's ``AdamW`` defaults to 1e-2) on every parameter,
Adam's eps 1e-8 is added outside the square root (in both), and ``sgd`` has
no momentum.

The mesh, tensor, sequence and pipeline parallel steps of the reference
(``MeshPlan``, ring and Ulysses attention, the pipeline) are not ported yet:
no step takes a ``plan``.
"""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models.bert import Bert, BertConfig, bert_mlm_loss
from lakesoul_tpu_torch.models.mlp import mlp_loss
from lakesoul_tpu_torch.models.resnet import resnet_loss

BETAS, EPS = (0.9, 0.999), 1e-8  # optax.adam / optax.adamw defaults
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)


def adamw(params, lr: float, weight_decay: float = ADAMW_WEIGHT_DECAY) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)``: decoupled decay of every param."""
    return torch.optim.AdamW(params, lr=lr, betas=BETAS, eps=EPS, weight_decay=weight_decay)


def sgd(params, lr: float) -> torch.optim.SGD:
    """``optax.sgd(lr)``: plain gradient descent, no momentum."""
    return torch.optim.SGD(params, lr=lr)


def _make_step(model: torch.nn.Module, opt: torch.optim.Optimizer, loss_fn, device):
    dev = resolve_device(device)
    wrong = sorted({str(p.device) for p in model.parameters() if p.device.type != dev.type})
    if wrong:
        raise ConfigError(f"the model's params are on {wrong}, the step's device is {dev}")

    def step(*batch) -> torch.Tensor:
        batch = [torch.as_tensor(b).to(dev, non_blocking=True) for b in batch]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def make_mlp_train_step(model, opt, *, device=None):
    """``step(x, y) → loss``: the tabular (Titanic) config's step."""
    return _make_step(model, opt, mlp_loss, device)


def make_resnet_train_step(model, opt, *, device=None):
    """``step(images, labels) → loss``: the ImageNet config's step."""
    return _make_step(model, opt, resnet_loss, device)


def make_bert_train_state(cfg: BertConfig, *, lr: float = 1e-4, seed: int = 0, device=None):
    """→ (model, optimizer): ``Bert(cfg)`` and ``adamw(lr)``, as the
    reference's state (params, ``optax.adamw(lr)``'s state)."""
    model = Bert(cfg, seed=seed, device=device)
    return model, adamw(model.parameters(), lr)


def make_bert_train_step(model: Bert, opt, *, device=None):
    """``step(input_ids, labels, mask) → loss``: the MLM step."""
    return _make_step(model, opt, bert_mlm_loss, device)
