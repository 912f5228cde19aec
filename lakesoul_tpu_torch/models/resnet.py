"""ResNet-50 in PyTorch, the port of ``lakesoul_tpu/models/resnet.py``
(BASELINE.json config 2, the ImageNet consumer of the data plane).

It keeps the reference's layouts at its edges and its numerics inside:

- images come in as [B, H, W, 3] (NHWC) and run NHWC in memory (the
  permute to NCHW is a view: channels-last strides); logits are [B, classes];
- conv weights are OIHW here, HWIO in the reference (``models/convert.py``
  moves them); ``head.w`` is [in, out] in both;
- ``padding="SAME"`` is XLA's: total = max((out − 1)·s + k − in, 0), lo =
  total // 2, hi = total − lo, asymmetric at stride 2 on even sizes, so a
  conv pads explicitly where ``padding=k // 2`` would shift every window;
  the max-pool pads with −inf the same way;
- BatchNorm takes batch statistics only (biased variance, eps 1e-5) in
  float32 and casts back to the compute dtype, in training and out of it:
  the reference carries no running statistics, whatever its docstring says;
- params are float32 masters; each conv casts its weight to the compute
  dtype and accumulates in float32 (cuDNN and oneDNN both do), the global
  mean and the head run in float32.  Casts are explicit, never autocast.

Data parallel (``resnet_forward(..., group=)``, the dp group): the batch
norm is the global batch's, as in the reference's GSPMD step, whose
``jnp.mean`` / ``jnp.var`` run over the whole batch: the mean, then the
mean of the centred squares, each a sum over the group
(``all_reduce_sum``, so the backward reaches every rank's share).  Local
statistics would give another model; ``nn.SyncBatchNorm`` would also keep
running buffers the reference does not have.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.parallel.collectives import all_reduce_sum, group_size

BLOCKS = {  # ResNet-50 stage configuration
    50: (3, 4, 6, 3),
}
BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"


def _conv_init(g: torch.Generator, o: int, i: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(o, i, k, k, generator=g) * (2.0 / (i * k * k)) ** 0.5)


class _BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class _Stem(nn.Module):
    def __init__(self, g: torch.Generator, w: int):
        super().__init__()
        self.conv = _conv_init(g, w, 3, 7)
        self.bn = _BN(w)


class _Block(nn.Module):
    def __init__(self, g: torch.Generator, in_c: int, mid: int, out_c: int, proj: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv_init(g, mid, in_c, 1), _BN(mid)
        self.conv2, self.bn2 = _conv_init(g, mid, mid, 3), _BN(mid)
        self.conv3, self.bn3 = _conv_init(g, out_c, mid, 1), _BN(out_c)
        if proj:
            self.proj, self.proj_bn = _conv_init(g, out_c, in_c, 1), _BN(out_c)


class _Head(nn.Module):
    def __init__(self, g: torch.Generator, a: int, b: int):
        super().__init__()
        self.w = nn.Parameter(torch.randn(a, b, generator=g) * 0.01)
        self.b = nn.Parameter(torch.zeros(b))


class ResNet(nn.Module):
    """``ResNet(cfg)``: the reference's param tree as modules (``stem``,
    ``stages.{s}.{b}``, ``head``), drawn by a CPU ``torch.Generator`` seeded
    with ``seed`` from the reference's distributions (He-normal convs,
    BN scale 1 and bias 0, head normal × 0.01).  ``device=None`` is the card."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(), *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        w = cfg.width
        self.stem = _Stem(g, w)
        self.stages = nn.ModuleList()
        in_c = w
        for stage, nblocks in enumerate(BLOCKS[cfg.depth]):
            mid = w * 2**stage
            blocks = nn.ModuleList()
            for b in range(nblocks):
                blocks.append(_Block(g, in_c, mid, mid * 4, proj=b == 0))
                in_c = mid * 4
            self.stages.append(blocks)
        self.head = _Head(g, w * 32, cfg.num_classes)
        self.to(resolve_device(device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return resnet_forward(self, images)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of XLA's ``padding="SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """→ (x, symmetric padding left to the op): pads ``x`` explicitly only
    where SAME is asymmetric."""
    (t, b), (l, r) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with OIHW ``w`` cast to ``x``'s dtype."""
    x, pad = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """SAME max-pool: the padding is −inf, so it never wins."""
    x, pad = _pad_same(x, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=pad)  # its own padding is −inf too


def bn(x: torch.Tensor, p: _BN, group=None) -> torch.Tensor:
    """Batch statistics over N, H, W in float32 (float64 for float64 input),
    out in ``x``'s dtype; over the batch of every rank of ``group`` when one
    is given."""
    if group is None:
        return F.batch_norm(x, None, None, p.scale, p.bias, training=True, momentum=0.0,
                            eps=BN_EPS)
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # as F.batch_norm takes it
    n = x.shape[0] * x.shape[2] * x.shape[3] * group_size(group)
    mu = all_reduce_sum(x32.sum((0, 2, 3)), group) / n
    d = x32 - mu[None, :, None, None]
    var = all_reduce_sum((d * d).sum((0, 2, 3)), group) / n
    y = d * torch.rsqrt(var + BN_EPS)[None, :, None, None]
    return (y * p.scale[None, :, None, None] + p.bias[None, :, None, None]).to(x.dtype)


def resnet_forward(model: ResNet, images: torch.Tensor, group=None) -> torch.Tensor:
    """images [B, H, W, 3] → logits [B, num_classes] float32; ``group``:
    the ranks whose batches the batch norm spans."""
    def norm(y, p):
        return bn(y, p, group)

    x = images.permute(0, 3, 1, 2).to(getattr(torch, model.cfg.dtype))
    x = torch.relu(norm(conv(x, model.stem.conv, stride=2), model.stem.bn))
    x = max_pool(x)
    for stage, blocks in enumerate(model.stages):
        for b, blk in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            resid = x
            y = torch.relu(norm(conv(x, blk.conv1), blk.bn1))
            y = torch.relu(norm(conv(y, blk.conv2, stride=stride), blk.bn2))
            y = norm(conv(y, blk.conv3), blk.bn3)
            if hasattr(blk, "proj"):
                resid = norm(conv(x, blk.proj, stride=stride), blk.proj_bn)
            x = torch.relu(y + resid)
    x = x.to(model.head.w.dtype).mean((2, 3))  # float32, the params' dtype
    return x @ model.head.w + model.head.b


def resnet_loss(model: ResNet, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(resnet_forward(model, images), labels.long())
