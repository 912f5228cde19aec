"""Device-mesh construction and sharding plans, the port of
``lakesoul_tpu/parallel/mesh.py``.

The same five axes, named ``("dp", "tp", "sp", "pp", "ep")``:

- ``dp``  — data parallel over batch
- ``tp``  — tensor parallel over heads / ffn
- ``sp``  — sequence parallel (ring attention / Ulysses) for long context
- ``pp``  — pipeline parallel over the layer stack (``parallel/pipeline.py``)
- ``ep``  — expert parallel over MoE experts (``parallel/moe.py``)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, whose ranks lie on it in row-major order as the reference
reshapes its devices.  Where the reference's GSPMD program reads global
arrays, each rank here holds its shard, so a ``MeshPlan`` gives the
process group and this rank's coordinate of each axis, and the group of
the data axes together (``("dp", "sp")``: the token batch is split over
both).

The caller starts the process group (its backend, store, rank and world
size: nothing on the machine tells a program of a cluster); ``make_mesh``
lays the mesh over it.  ``device_type=None`` is ``"cuda"`` (NCCL) and
raises without a card; ``"cpu"`` is gloo, as the tests run it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from lakesoul_tpu_torch.errors import ConfigError

AXES = ("dp", "tp", "sp", "pp", "ep")
DATA_AXES = ("dp", "sp")  # the axes that split the token batch


@dataclass(frozen=True)
class MeshPlan:
    """A named mesh, its axis sizes, and this rank's groups and coordinates."""

    mesh: object  # DeviceMesh
    dp: int
    tp: int
    sp: int
    pp: int = 1
    ep: int = 1
    groups: dict = field(default_factory=dict, repr=False)
    coords: dict = field(default_factory=dict)

    @property
    def axis_names(self):
        return AXES

    @property
    def device_type(self) -> str:
        return self.mesh.device_type

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= getattr(self, a)
        return n

    def group(self, *axes: str):
        """The process group of this rank along ``axes`` (one axis, or
        ``DATA_AXES``)."""
        return self.groups[axes]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def shard_batch(self, x, *, seq: bool = True) -> torch.Tensor:
        """This rank's block of a global batch: rows over dp and, with
        ``seq``, columns over sp (the reference's ``P("dp", "sp")``;
        ``seq=False`` is ``P("dp")``)."""
        x = torch.as_tensor(x)
        for dim, axis in ((0, "dp"), (1, "sp"))[:2 if seq else 1]:
            n = getattr(self, axis)
            if x.shape[dim] % n:
                raise ValueError(f"batch dim {dim} ({x.shape[dim]}) does not split over {axis}={n}")
            x = x.chunk(n, dim)[self.coord(axis)]
        return x


def _factor(n: int) -> tuple[int, int, int]:
    """Split n devices into (dp, tp, sp) with dp ≥ 2 preserved: data
    parallelism is the default axis for a data-loading framework, so tp/sp
    only peel a factor of 2 each while at least dp=2 remains."""
    dp, tp, sp = n, 1, 1
    if dp % 2 == 0 and dp >= 4:
        dp //= 2
        tp = 2
    if dp % 2 == 0 and dp >= 4:
        dp //= 2
        sp = 2
    return dp, tp, sp


def _sizes(n: int, dp, tp, sp, pp, ep) -> tuple[int, ...]:
    pp = pp or 1
    ep = ep or 1
    if dp is None and tp is None and sp is None:
        if n % (pp * ep):
            raise ValueError(f"pp*ep={pp * ep} does not divide {n} devices")
        dp, tp, sp = _factor(n // (pp * ep))
    else:
        dp = dp or 1
        tp = tp or 1
        sp = sp or max(1, n // (dp * tp * pp * ep))
    if dp * tp * sp * pp * ep != n:
        raise ValueError(f"mesh {dp}x{tp}x{sp}x{pp}x{ep} != {n} devices")
    return dp, tp, sp, pp, ep


def _subgroups(ranks: torch.Tensor, axes: tuple[str, ...]):
    """One ``new_group`` for every line of the mesh along ``axes`` (every
    rank creates every group, in one order); → this rank's."""
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in keep]
    width = 1
    for i in keep:
        width *= ranks.shape[i]
    lines = ranks.permute(*rest, *keep).reshape(-1, width)
    mine = None
    me = dist.get_rank()
    for line in lines.tolist():
        g = dist.new_group(line)
        if me in line:
            mine = g
    return mine


def make_mesh(*, dp: int | None = None, tp: int | None = None, sp: int | None = None,
              pp: int | None = None, ep: int | None = None, device_type: str | None = None
              ) -> MeshPlan:
    """Build a (dp, tp, sp, pp, ep) mesh over the default process group's
    ranks.  Unspecified axis sizes are inferred from the world size (pp/ep
    default to 1 — they are opted into explicitly)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise ConfigError("CUDA is not available; pass device_type='cpu' for a gloo mesh")
    if device_type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device type {device_type}")
    if not dist.is_initialized():
        raise ConfigError("make_mesh needs a started process group "
                          "(torch.distributed.init_process_group)")
    sizes = _sizes(dist.get_world_size(), dp, tp, sp, pp, ep)
    mesh = init_device_mesh(device_type, sizes, mesh_dim_names=AXES)
    ranks = mesh.mesh
    me = dist.get_rank()
    where = (ranks == me).nonzero()[0].tolist()
    groups = {(a,): mesh.get_group(a) for a in AXES}
    groups[DATA_AXES] = _subgroups(ranks, DATA_AXES)
    return MeshPlan(mesh, *sizes, groups=groups, coords=dict(zip(AXES, where)))
