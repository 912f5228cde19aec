"""The model and train-step layer, the port of ``lakesoul_tpu/models/``.

Ported: the MLP of the tabular config (``mlp``), ResNet-50 (``resnet``),
the BERT MLM encoder (``bert``), their single-device train steps with
optax's optimizers (``train``), ``TrainCheckpointer`` (``checkpoint``) and
the weight converters to and from the JAX package's param trees
(``convert``); BERT's mixture-of-experts FFN, and the steps that take a
``plan`` (data, tensor, sequence, expert and pipeline parallel, over
``parallel/``).  Not yet: sharded checkpoints (``torch.distributed.checkpoint``).

The reference computes its models with plain ``jnp`` / ``lax`` ops and no
Pallas kernel, so the port computes them with torch ops: no hand kernel.
"""

from lakesoul_tpu_torch.models.bert import (
    Bert,
    BertConfig,
    bert_forward,
    bert_mlm_loss,
    masked_nll,
    param_sharding_rules,
)
from lakesoul_tpu_torch.models.checkpoint import TrainCheckpointer
from lakesoul_tpu_torch.models.convert import from_reference_params, to_reference_params
from lakesoul_tpu_torch.models.mlp import MLP, mlp_forward, mlp_loss
from lakesoul_tpu_torch.models.resnet import ResNet, ResNetConfig, resnet_forward, resnet_loss
from lakesoul_tpu_torch.models.train import (
    adam,
    adamw,
    make_bert_pipeline_train_state,
    make_bert_pipeline_train_step,
    make_bert_train_state,
    make_bert_train_step,
    make_mlp_train_step,
    make_resnet_train_step,
    sgd,
)

__all__ = [
    "MLP", "mlp_forward", "mlp_loss",
    "ResNet", "ResNetConfig", "resnet_forward", "resnet_loss",
    "Bert", "BertConfig", "bert_forward", "bert_mlm_loss", "masked_nll",
    "param_sharding_rules",
    "adam", "adamw", "sgd",
    "make_mlp_train_step", "make_resnet_train_step",
    "make_bert_train_state", "make_bert_train_step",
    "make_bert_pipeline_train_state", "make_bert_pipeline_train_step",
    "TrainCheckpointer", "from_reference_params", "to_reference_params",
]
