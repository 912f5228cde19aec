"""Differentiable collectives over a process group: what ``shard_map`` gives
the reference for free (``lax.ppermute``, ``lax.all_to_all``,
``lax.all_gather``, ``lax.psum``), here as ``torch.autograd.Function`` s
whose backward is the forward's transpose.

Plain ``torch.distributed`` calls are not differentiable; a ring whose
backward is not the reverse rotation trains silently wrong.  So:

- ``ring_shift`` — rank ``j`` sends to ``j + 1`` (mod n); backward shifts
  the gradients back, from ``j + 1`` to ``j``.  Integer tensors ride along without
  a gradient (the attention mask travels with K/V).
- ``all_to_all`` — ``lax.all_to_all(..., tiled=True)``: chunk ``j`` of
  ``split_dim`` goes to rank ``j``, the received chunks concatenate along
  ``concat_dim``; backward is the inverse all-to-all.
- ``all_gather`` — concatenation along ``dim``; backward sums each rank's
  gradient of the whole and keeps this rank's slice (an all-reduce and a
  slice: gloo has no reduce-scatter).
- the Megatron pair: ``copy_to`` (identity forward, all-reduce backward)
  enters a region whose ranks each compute a part; ``reduce_from``
  (all-reduce forward, identity backward) leaves it.  Their composition
  ``all_reduce_sum`` (all-reduce both ways) is the transpose of a sum that
  every rank goes on with: the statistics of a batch sharded over ranks.

The loss convention these transposes serve: over a group that splits the
data (dp, sp), the objective is the sum of the ranks' losses, each rank's
share its local sum over the global count; over a group of replicas that
split the work (tp, ep, pp), every rank computes the same loss.

``group=None`` means no group: every function is then the identity, as is
every one over a group of one rank, except the plain ``all_reduce_`` and
``all_gather_stack``, which always call the backend (the train steps' one
gradient reduction goes through NCCL even on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _shift(tensors, group, offset: int):
    """Each tensor from this rank to rank + offset, from rank − offset to here."""
    n, r = group_size(group), group_rank(group)
    dst = dist.get_global_rank(group, (r + offset) % n)
    src = dist.get_global_rank(group, (r - offset) % n)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, buf, src, group)]
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, *tensors):
        ctx.group, ctx.offset = group, offset
        ctx.grads = [_float(t) for t in tensors]
        outs = _shift(tensors, group, offset)
        ctx.mark_non_differentiable(*[o for o in outs if not _float(o)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g, f in zip(grads, ctx.grads) if f]
        back = iter(_shift(live, ctx.group, -ctx.offset))
        return (None, None, *[next(back) if f else None for f in ctx.grads])


def ring_shift(*tensors, group):
    """``lax.ppermute(x, perm=[(j, (j + 1) % n)])`` for each tensor."""
    if group_size(group) == 1:
        return tensors
    return _RingShift.apply(group, 1, *tensors)


def _a2a(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group, *, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim, tiled=True)``."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split over "
                         f"{n} ranks")
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous(), ctx.group)
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, group, *, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(x, axis=dim, tiled=True)``, differentiable for floats."""
    if group_size(group) == 1:
        return x
    if not _float(x):
        return _gather(x, group, dim)
    return _AllGather.apply(x, group, dim)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` stacked in group-rank order (no
    gradient); the backend is called even for one rank."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient); the backend is called even
    for one rank."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, gradients summed over ``group``."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: summed over ``group`` forward, identity backward."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum every rank goes on with, summed back in the
    backward (the Megatron pair composed)."""
    return reduce_from(copy_to(x, group), group)
