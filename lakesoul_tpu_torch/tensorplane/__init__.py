"""Tensor plane of the port: fixed-shape tensor column declarations
(:mod:`columns`, a copy of ``lakesoul_tpu/tensorplane/columns.py``) and the
device replay cache (:mod:`replay`, ``to_torch_iter(cache="device")``).
The writer validates declared columns and the loader reshapes to the
declared shapes.  The reference's DLPack hand-off is replaced by the
loader's pinned side-stream copy (``data/torch_iter.py``)."""

from lakesoul_tpu_torch.tensorplane.columns import (
    TensorSpec,
    tensor_field,
    tensor_shape_of,
    tensor_specs,
    validate_tensor_batch,
)
from lakesoul_tpu_torch.tensorplane.replay import ENV_BUDGET, DeviceReplayCache, ReplaySpill

__all__ = [
    "DeviceReplayCache",
    "ENV_BUDGET",
    "ReplaySpill",
    "TensorSpec",
    "tensor_field",
    "tensor_shape_of",
    "tensor_specs",
    "validate_tensor_batch",
]
