"""Tensor plane of the port: fixed-shape tensor column declarations
(:mod:`columns`, a copy of ``lakesoul_tpu/tensorplane/columns.py``).  The
writer validates declared columns with them and the loader reshapes to the
declared shapes.  The reference's DLPack hand-off is replaced by the
loader's pinned side-stream copy (``data/torch_iter.py``); its device replay
cache is not ported yet."""

from lakesoul_tpu_torch.tensorplane.columns import (
    TensorSpec,
    tensor_field,
    tensor_shape_of,
    tensor_specs,
    validate_tensor_batch,
)

__all__ = [
    "TensorSpec",
    "tensor_field",
    "tensor_shape_of",
    "tensor_specs",
    "validate_tensor_batch",
]
