"""Device selection for the port's entry points.

The counterpart of ``_on_tpu`` (``lakesoul_tpu/vector/kernels.py``), with one
difference in kind: the JAX package picked its kernels by the platform it
found, while the port never drifts.  ``device=None`` means the CUDA card; if
there is none the call raises.  The CPU runs only when a caller names it,
as the tests do."""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.errors import ConfigError


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises
    :class:`ConfigError` instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {dev}")
    return dev
