"""Pipeline parallelism over the ``pp`` group (GPipe schedule), the port of
``lakesoul_tpu/parallel/pipeline.py``.

The layer stack is split into ``pp`` stages; each rank holds one stage
(``models/convert.py`` ``shard_params`` by ``pipeline_rules``: the
reference's ``split_stages`` has no counterpart, since no rank holds the
whole stack).
Microbatches stream through the ring: at every one of ``M + pp − 1`` steps
each rank applies its stage to its current microbatch and the activation
moves one stage on (``collectives.ring_shift``).  Stage 0 takes microbatch
``t`` at step ``t`` (the bubble steps after the last feed a clamped repeat
that is never recorded); the last stage finishes microbatch ``t − (pp − 1)``
at step ``t``.  The backward needs no schedule of its own: autograd through
the shifts is the reverse pipeline (a shift's backward is the reverse
rotation).

The activation travelling the ring is a dict of tensors, so per-microbatch
side inputs (the attention mask, as int32) ride along with the hidden state.
"""

from __future__ import annotations

import torch

from lakesoul_tpu_torch.parallel.collectives import (
    copy_to,
    group_rank,
    group_size,
    reduce_from,
    ring_shift,
)


def pipeline_apply(stage_fn, micro: dict, *, group) -> dict:
    """Run the pipeline on this rank's stage.

    ``micro``: dict of [M, ...] tensors, the same on every rank of the
    group.  → the same dict shape holding the LAST stage's outputs on the
    last stage and zeros elsewhere (``make_pipeline`` sums them over the
    group).

    Every rank's every step stays on the path to its outputs, as in the
    reference's ``jnp.where`` form: stage 0 selects its feed with
    ``torch.where`` beside the state it received, and each step's output
    joins its slot through ``torch.where`` (zeros unless it is the last
    stage's finished microbatch).  So every rank runs the backward of every
    shift, in the same order (the last step's first), and no rank waits on
    a shift another rank skipped."""
    idx, pp = group_rank(group), group_size(group)
    keys = list(micro)
    M = micro[keys[0]].shape[0]
    first = torch.tensor(idx == 0)
    state = {k: torch.zeros_like(v[0]) for k, v in micro.items()}
    outputs = {k: torch.zeros_like(v).unbind(0) for k, v in micro.items()}
    outputs = {k: list(v) for k, v in outputs.items()}
    for t in range(M + pp - 1):
        inp = {k: torch.where(first, v[min(t, M - 1)], state[k]) for k, v in micro.items()}
        out = stage_fn(inp)
        # the last stage finishes microbatch t - (pp - 1) at step t
        mb = t - (pp - 1)
        valid = torch.tensor(idx == pp - 1 and mb >= 0)
        slot = min(max(mb, 0), M - 1)
        for k in keys:
            outputs[k][slot] = outputs[k][slot] + torch.where(valid, out[k], 0)
        if pp > 1 and t < M + pp - 2:  # the last step's shift would be unused
            state = dict(zip(keys, ring_shift(*[out[k] for k in keys], group=group)))
    return {k: torch.stack(v) for k, v in outputs.items()}


def make_pipeline(stage_fn, *, group):
    """→ ``f(micro) → last-stage outputs`` on every rank of ``group``.

    ``micro`` enters through ``copy_to`` (every stage's gradient of it is
    summed: only stage 0 reads it) and the outputs leave through
    ``reduce_from`` (non-last stages contributed zeros; the sum replicates
    the real values, and each rank's loss on them is the same).  Leaves
    must be numeric (masks as ints, not bools)."""

    def run(micro: dict) -> dict:
        micro = {k: copy_to(v, group) if v.is_floating_point() else v for k, v in micro.items()}
        outs = pipeline_apply(stage_fn, micro, group=group)
        return {k: reduce_from(v, group) for k, v in outs.items()}

    return run


def split_microbatches(tree: dict, n_micro: int) -> dict:
    """[B, ...] dict → [M, B/M, ...]."""
    def f(a):
        B = a.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        return a.reshape((n_micro, B // n_micro) + tuple(a.shape[1:]))

    return {k: f(v) for k, v in tree.items()}


def merge_microbatches(tree: dict, batch: int) -> dict:
    """[M, mb, ...] dict → [M·mb, ...] (undo split_microbatches)."""
    return {k: v.reshape((batch,) + tuple(v.shape[2:])) for k, v in tree.items()}
