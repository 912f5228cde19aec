"""Device-resident dataset replay: the memory-budgeted residency manager
(the port of ``lakesoul_tpu/tensorplane/replay.py``).

Epoch 1 of a training run streams the table — decode, merge, collate, the
pinned H2D copy — and *offers* every delivered device batch to a
:class:`DeviceReplayCache`.  The cache pins offered batches until the
declared budget (``LAKESOUL_REPLAY_BUDGET_BYTES``) is reached.  From epoch
2 on, the loader serves the pinned batches straight from device memory —
no storage, host or link traffic — optionally re-permuted on the device
each epoch under a pinned seed.

Budget overflow is not an error: the first offer that would cross the
budget flips the cache into *spilled* mode — a typed
:class:`ReplaySpill` record, metered in
``lakesoul_replay_spilled_batches_total`` /
``lakesoul_replay_spilled_bytes_total`` — after which later epochs
replay the resident prefix from the device and re-stream only the tail
through the normal streaming path (the offers stop at the first rejection,
so the resident set is always a contiguous prefix and the tail resume
position is exactly ``resident_rows``).

State machine::

    filling --offer() within budget--> filling (batch pinned)
    filling --offer() over budget----> filling/spilled (typed + metered)
    filling --seal()  (epoch done)---> ready          (replay serves)
    filling --abandon() (epoch broken)-> empty        (partial replay
                                                       would drop data)

Residency accounting: each tensor leaf bills the bytes its storage holds
(a storage two leaves share is billed once).  The port has one device and
no sharding, so there is no shard to divide by.

Permutation: the reference draws ``jax.random.permutation`` under
``fold_in(fold_in(PRNGKey(seed), epoch), pos)``.  torch cannot reproduce
that stream, so the port draws ``torch.randperm`` from a
``torch.Generator`` on the batch's device, seeded from the same
``(seed, epoch, pos)`` triple through numpy's ``SeedSequence``: the same
contract (deterministic per epoch under a seed, different across epochs,
nothing lost), not the same rows.  The batch order of a permuted replay is
numpy's ``default_rng((seed, epoch))``, bit-identical to the reference's.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.obs import registry

ENV_BUDGET = "LAKESOUL_REPLAY_BUDGET_BYTES"


@dataclass(frozen=True)
class ReplaySpill:
    """The typed record of one cache's budget overflow: which offer
    crossed the line and what stayed resident.  Carried by
    :attr:`DeviceReplayCache.spill` (and logged once); later epochs keep
    working — resident prefix from the device, tail from the stream."""

    budget_bytes: int
    batch_rows: int
    batch_bytes: int
    resident_batches: int
    resident_bytes: int


def _leaves(tree) -> list:
    """The leaves of a pytree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_leaves(fn: Callable[[Any, str], Any], tree, path: str = ""):
    """``fn(leaf, path)`` over a pytree of dicts, lists and tuples (the
    port's stand-in for ``jax.tree_util.tree_map``); ``path`` names the
    leaf (its column, for a collated batch)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{path}.{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, path)


def fresh_containers(batch):
    """Rebuild the pytree's containers (the leaves stay shared): consumers
    that mutate a yielded dict in place must never poison the cached
    epoch."""
    return _map_leaves(lambda x, _: x, batch)


def _batch_device_bytes(batch) -> int:
    """Residency cost of one delivered batch: each tensor leaf bills the
    bytes its storage holds on its device — a view of a larger storage pins
    all of it — and a storage shared by several leaves is billed once.  A
    leaf that is not a tensor (a host array) bills its ``nbytes``."""
    total, seen = 0, set()
    for leaf in _leaves(batch):
        if isinstance(leaf, torch.Tensor):
            storage = leaf.untyped_storage()
            key = (leaf.device, storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += storage.nbytes()
        else:
            total += int(getattr(leaf, "nbytes", 0))
    return total


def _draw_seed(seed: int, epoch: int, pos: int) -> int:
    """One 64-bit generator seed from the ``(seed, epoch, pos)`` triple —
    the port's counterpart of the reference's ``fold_in`` chain."""
    state = np.random.SeedSequence([seed % (1 << 64), epoch, pos]).generate_state(1, np.uint64)
    return int(state[0])


def _permute_on_device(batch, seed: int, epoch: int, pos: int):
    """Row-permute every leading-dim leaf of ``batch`` on its device: the
    index is drawn by a generator on that device and applied by
    ``index_select`` — no host traffic, which is the whole point of
    replay."""
    leaves = [x for x in _leaves(batch) if isinstance(x, torch.Tensor)]
    n = leaves[0].shape[0] if leaves and leaves[0].ndim else 0
    if n == 0:
        return fresh_containers(batch)
    dev = leaves[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(_draw_seed(seed, epoch, pos))
    idx = torch.randperm(n, generator=gen, device=dev)
    return _map_leaves(
        lambda x, _: x.index_select(0, idx)
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] == n else x,
        batch,
    )


class DeviceReplayCache:
    """Memory-budgeted residency manager for one loader's epochs.

    Args:
        budget_bytes: pin budget; default from
            ``LAKESOUL_REPLAY_BUDGET_BYTES``; ``None``/unset = unbounded
            (the caller opted into whole-epoch residency knowing
            rows × bytes/row).
        permute: re-permute rows *within* each resident batch on the device
            every replay epoch (seeded, deterministic); batch order is
            shuffled too.  Only honoured while fully resident — a spilled
            cache replays its prefix in stream order so the hybrid epoch
            stays position-exact against the streamed tail.
        seed: permutation seed; the (seed, epoch, batch) triple fully
            determines every draw, so two runs under one seed deliver
            identical epochs.
    """

    def __init__(self, *, budget_bytes: int | None = None,
                 permute: bool = False, seed: int = 0):
        if budget_bytes is None:
            raw = os.environ.get(ENV_BUDGET)
            if raw is not None:
                try:
                    budget_bytes = int(raw)
                except ValueError:
                    raise ConfigError(
                        f"{ENV_BUDGET} must be an integer byte count, got"
                        f" {raw!r}"
                    )
        if budget_bytes is not None and budget_bytes <= 0:
            raise ConfigError(
                f"replay budget must be positive, got {budget_bytes}"
            )
        self.budget_bytes = budget_bytes
        self.permute = permute
        self.seed = seed
        self.ready = False
        self.spill: ReplaySpill | None = None
        self._batches: list[tuple[int, object]] = []  # (rows, device pytree)
        self._resident_bytes = 0
        self._resident_rows = 0
        self._epochs_served = 0
        reg = registry()
        self._g_bytes = reg.gauge("lakesoul_replay_resident_bytes")
        self._g_batches = reg.gauge("lakesoul_replay_resident_batches")
        self._c_spill_b = reg.counter("lakesoul_replay_spilled_batches_total")
        self._c_spill_bytes = reg.counter("lakesoul_replay_spilled_bytes_total")
        self._c_epochs = reg.counter("lakesoul_replay_epochs_total")
        self._c_rows = reg.counter("lakesoul_replay_served_rows_total")

    # ------------------------------------------------------------- filling
    @property
    def spilled(self) -> bool:
        return self.spill is not None

    @property
    def resident_rows(self) -> int:
        """Rows covered by the pinned prefix — the streamed-tail resume
        position of a spilled cache (the scan's deterministic unit order
        makes a row count a complete position, same as the loader
        checkpoint)."""
        return self._resident_rows

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    @property
    def resident_batches(self) -> int:
        return len(self._batches)

    def offer(self, rows: int, batch) -> bool:
        """Offer one delivered device batch for pinning during the filling
        epoch.  Returns True when pinned (the cache now holds a reference;
        the caller must hand its consumer fresh containers).  The first
        offer past the budget records the typed spill and every later
        offer is refused without accounting — the resident set stays a
        contiguous prefix."""
        if self.ready:
            raise ConfigError("offer() after seal(): the cache is serving")
        cost = _batch_device_bytes(batch)
        if self.spilled:
            # EVERY refused batch is metered, not just the one that crossed
            # the budget: the spilled_* counters are what an operator sizes
            # LAKESOUL_REPLAY_BUDGET_BYTES from
            self._c_spill_b.inc()
            self._c_spill_bytes.inc(cost)
            return False
        if self.budget_bytes is not None and \
                self._resident_bytes + cost > self.budget_bytes:
            self.spill = ReplaySpill(
                budget_bytes=self.budget_bytes,
                batch_rows=rows,
                batch_bytes=cost,
                resident_batches=len(self._batches),
                resident_bytes=self._resident_bytes,
            )
            self._c_spill_b.inc()
            self._c_spill_bytes.inc(cost)
            logging.getLogger(__name__).info(
                "replay cache spilled: batch of %d rows (%d B) would cross the"
                " %d B budget; %d batches / %d B stay resident, later epochs"
                " re-stream the tail",
                rows, cost, self.budget_bytes, len(self._batches),
                self._resident_bytes,
            )
            return False
        self._batches.append((rows, batch))
        self._resident_bytes += cost
        self._resident_rows += rows
        self._g_bytes.set(self._resident_bytes)
        self._g_batches.set(len(self._batches))
        return True

    def seal(self) -> None:
        """The filling epoch completed: the cache starts serving.  A
        spilled cache seals too — it serves its prefix; only an *abandoned*
        epoch (consumer break) discards, partial replay would silently
        drop data."""
        self.ready = True

    def abandon(self) -> None:
        """The filling epoch did not complete: drop every pin (the device
        memory comes back) and stay in streaming mode."""
        if self.ready:
            return
        self._batches.clear()
        self._resident_bytes = 0
        self._resident_rows = 0
        self.spill = None
        self._g_bytes.set(0)
        self._g_batches.set(0)

    # ------------------------------------------------------------- serving
    def replay(self):
        """Yield ``(rows, device_batch)`` for one replay epoch, entirely
        from device memory.  With ``permute`` on a fully-resident cache:
        batch order is shuffled and each batch's rows are permuted on the
        device, both drawn from (seed, epoch) so replays are deterministic
        per epoch and different across epochs."""
        if not self.ready:
            raise ConfigError("replay() before seal(): the cache is filling")
        epoch = self._epochs_served
        self._epochs_served += 1
        self._c_epochs.inc()
        order = range(len(self._batches))
        do_permute = self.permute and not self.spilled
        if do_permute:
            order = np.random.default_rng((self.seed, epoch)).permutation(
                len(self._batches)
            )
        for pos in order:
            rows, batch = self._batches[pos]
            if do_permute:
                batch = _permute_on_device(batch, self.seed, epoch, int(pos))
            self._c_rows.inc(rows)
            yield rows, batch

    def stats(self) -> dict:
        return {
            "ready": self.ready,
            "spilled": self.spilled,
            "resident_batches": len(self._batches),
            "resident_rows": self._resident_rows,
            "resident_bytes": self._resident_bytes,
            "budget_bytes": self.budget_bytes,
            "epochs_served": self._epochs_served,
            "permute": self.permute,
        }
