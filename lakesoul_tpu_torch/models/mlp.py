"""Small MLP for tabular training, the port of ``lakesoul_tpu/models/mlp.py``
(BASELINE.json config 1, the Titanic-style config).

``layers.{i}.w`` is [in, out] and the forward is ``x @ w + b``, as the
reference's param list ``[{"w", "b"}, ...]``, so ``models/convert.py``
carries weights across without a transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.device import resolve_device


class _Dense(nn.Module):
    def __init__(self, a: int, b: int, g: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch.randn(a, b, generator=g) * (2.0 / a) ** 0.5)
        self.b = nn.Parameter(torch.zeros(b))


class MLP(nn.Module):
    """ReLU MLP ``in_dim → hidden × (layers − 1) → out_dim``; weights drawn
    from normal × (2 / fan_in)^½ by a CPU ``torch.Generator`` seeded with
    ``seed``, biases zero (the reference's init).  ``device=None`` is the
    card."""

    def __init__(self, in_dim: int, hidden: int = 64, out_dim: int = 2, layers: int = 2, *,
                 seed: int = 0, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
        self.layers = nn.ModuleList(_Dense(a, b, g) for a, b in zip(dims[:-1], dims[1:]))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self, x)


def mlp_forward(model: MLP, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(model.layers):
        x = x @ layer.w + layer.b
        if i < len(model.layers) - 1:
            x = torch.relu(x)
    return x


def mlp_loss(model: MLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the integer labels ``y`` under ``log_softmax`` of the logits."""
    return F.cross_entropy(mlp_forward(model, x), y.long())
