"""PyTorch delivery: stream a table scan into the CUDA card.

The port of ``lakesoul_tpu/data/jax_iter.py``.  Merged RecordBatches from
the host data plane are re-batched to a fixed size, collated to numpy, and
copied to the device **double-buffered**, so host decode/merge overlaps the
training step.

Pipeline:  scan units → [runtime pipeline: read + merge → collate (into
           pinned memory) → prefetch(bounded queue)] → [foreground: async
           H2D copies on a side stream, ``device_prefetch`` batches ahead]
           → training loop

The host half is the reference's, unchanged: ``LoaderStats``,
``LoaderCheckpoint``, the fused rebatch + collate (``_Rebatcher``,
``_Window``, ``_BufferRing``) and the host pipeline on the shared runtime
(:mod:`lakesoul_tpu_torch.runtime`), with its backpressure, cancellation,
exception propagation and ``lakesoul_runtime_*`` series.  A batch on the
host is a pytree of numpy arrays, so a user's ``transform`` and
``collate_fn`` run unchanged.

The device half replaces ``jax.device_put``:

- On the card, the collate writes into **pinned** host buffers (PyTorch's
  caching host allocator, or the reuse ring's pinned slots), and a leaf a
  ``transform`` made in pageable memory takes one memcpy into a pinned
  buffer, still on the pipeline's thread.  The consumer's thread then only
  dispatches ``to(device, non_blocking=True)`` on a side stream and records
  one event per batch.  Before a batch is yielded, the current stream waits
  on that event and every leaf is ``record_stream``-ed on it: without the
  wait the step reads a half-copied batch, without ``record_stream`` the
  caching allocator could hand the batch's memory to the next copy while
  the step still reads it.  A pinned buffer is released (back to the
  allocator, or for reuse by the ring) only after its copy's event has
  completed.  Nothing on this path synchronizes the device.
- On the CPU (``device="cpu"``, the tests) a leaf becomes
  ``torch.from_numpy`` of the collate buffer, which aliases it; the reuse
  ring therefore stays disarmed there, as the reference disarms it where
  ``device_put`` aliases.
- int64 and float64 stay int64 and float64 (jax demotes them with x64
  off).  A string (object) leaf cannot go to a device and raises
  :class:`ConfigError` naming its column.

Replay: ``cache="device"`` pins the delivered batches of the first
complete epoch in device memory (:mod:`lakesoul_tpu_torch.tensorplane.replay`)
and serves later epochs from there, with no decode, merge, collate or H2D
copy.  On the card a cached batch is the side-stream copy's output after
the consumer's stream waited on it, and every copy of the epoch has
completed by the time the cache seals (the epoch's last events are
synchronized); a replayed leaf is ``record_stream``-ed on the consumer's
current stream, and nothing on the replay path synchronizes or reads back.
The consumer always gets fresh containers, never the dict the cache holds.

Sharding: ``LakeSoulScan.shard()/auto_shard()`` (or ``multihost=True``)
splits scan units across processes.  ``sharding=`` (a jax placement) has no
meaning here and raises.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

import numpy as np
import pyarrow as pa
import torch

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.obs.stages import stage_histogram
from lakesoul_tpu_torch.runtime import pipeline as rt_pipeline
from lakesoul_tpu_torch.tensorplane.replay import (
    DeviceReplayCache,
    _map_leaves,
    fresh_containers,
)


class LoaderStats:
    """Thread-safe loader-throughput telemetry (the Deep Lake fetch/decode/
    collate visibility role): rows/sec, batches/sec, producer-queue depth,
    consumer stall time, per-epoch totals.

    ``snapshot()`` is what training loops read between steps; the same
    counters feed the process registry (``lakesoul_loader_*``), so a
    gateway's ``/metrics`` shows loader throughput next to everything else.
    Elapsed time counts only time spent inside epochs — an iterator parked
    between epochs does not dilute rows/sec."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows = 0
        self.batches = 0
        self.epochs = 0
        self.stall_s = 0.0
        self.queue_depth = 0
        self.epoch_rows: list[int] = []
        self._active_s = 0.0
        self._epoch_start: float | None = None
        self._cur_epoch_rows = 0
        self._reported_depth = 0  # this loader's share of the depth gauge
        # hot path: fetch each registry metric ONCE (the obs contract), not
        # per delivered batch — delivery then pays only the metric's own lock
        reg = registry()
        self._m_rows = reg.counter("lakesoul_loader_rows_total")
        self._m_batches = reg.counter("lakesoul_loader_batches_total")
        self._m_stall = reg.counter("lakesoul_loader_stall_seconds_total")
        self._m_epochs = reg.counter("lakesoul_loader_epochs_total")
        self._m_depth = reg.gauge("lakesoul_loader_queue_depth")

    def epoch_begin(self) -> None:
        with self._lock:
            self._epoch_start = time.perf_counter()
            self._cur_epoch_rows = 0

    def epoch_end(self, completed: bool) -> None:
        with self._lock:
            if self._epoch_start is not None:
                self._active_s += time.perf_counter() - self._epoch_start
                self._epoch_start = None
            if completed:
                self.epochs += 1
                self.epoch_rows.append(self._cur_epoch_rows)
                del self.epoch_rows[:-64]  # bound the history
            # settle this loader's contribution to the shared depth gauge:
            # a parked/finished loader must not pin a stale depth
            settle = self._reported_depth
            self._reported_depth = 0
        if settle:
            self._m_depth.dec(settle)
        if completed:
            self._m_epochs.inc()

    def delivered(self, rows: int, stall_s: float, queue_depth: int) -> None:
        with self._lock:
            self.rows += rows
            self.batches += 1
            self._cur_epoch_rows += rows
            self.stall_s += stall_s
            self.queue_depth = queue_depth
            # DELTA update on the shared gauge: concurrent loaders (train +
            # eval) then aggregate on /metrics instead of clobbering each
            # other's last write
            delta = queue_depth - self._reported_depth
            self._reported_depth = queue_depth
        self._m_rows.inc(rows)
        self._m_batches.inc()
        self._m_stall.inc(stall_s)
        if delta:
            self._m_depth.inc(delta)

    def snapshot(self) -> dict:
        with self._lock:
            elapsed = self._active_s
            if self._epoch_start is not None:
                elapsed += time.perf_counter() - self._epoch_start
            return {
                "rows": self.rows,
                "batches": self.batches,
                "epochs": self.epochs,
                "epoch_rows": list(self.epoch_rows),
                "elapsed_s": elapsed,
                "rows_per_sec": (self.rows / elapsed) if elapsed > 0 else 0.0,
                "batches_per_sec": (self.batches / elapsed) if elapsed > 0 else 0.0,
                "stall_s": self.stall_s,
                "queue_depth": self.queue_depth,
            }


class LoaderCheckpoint:
    """Mid-epoch input-stream position (tf.data-checkpoint role).

    The trainer persists this NEXT TO its model checkpoint: after resuming,
    a loader built with the restored object continues exactly after the
    last delivered batch — no replayed or skipped rows.  Position is the
    delivered-row count over the scan's deterministic unit order, guarded by
    a digest of the table version (a commit in between makes the position
    meaningless, so resume refuses it).

    ::

        ckpt = LoaderCheckpoint()
        for batch in scan.to_jax_iter(checkpoint=ckpt):
            step(batch)
            save(model_state, ckpt.to_json())   # atomically, per N steps
        # after a crash:
        ckpt = LoaderCheckpoint.from_json(saved)
        for batch in scan.to_jax_iter(checkpoint=ckpt):  # resumes mid-epoch
            ...
    """

    def __init__(self, rows_delivered: int = 0, plan_digest: str | None = None):
        self.rows_delivered = rows_delivered
        self.plan_digest = plan_digest

    def to_json(self) -> str:
        import json

        return json.dumps(
            {"rows_delivered": self.rows_delivered, "plan_digest": self.plan_digest}
        )

    @classmethod
    def from_json(cls, s: str) -> "LoaderCheckpoint":
        import json

        d = json.loads(s)
        return cls(d["rows_delivered"], d.get("plan_digest"))


def _is_stringlike(t: pa.DataType) -> bool:
    """String/binary columns (incl. dictionary-encoded ones, which Parquet
    readers commonly produce) keep the documented stay-as-object contract."""
    if pa.types.is_dictionary(t):
        return _is_stringlike(t.value_type)
    return (
        pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or pa.types.is_binary(t)
        or pa.types.is_large_binary(t)
    )


def _default_collate(
    batch: pa.RecordBatch | pa.Table,
    tensor_shapes: "dict[str, tuple[int, ...]] | None" = None,
) -> dict[str, np.ndarray]:
    """Arrow → dict of numpy arrays (zero-copy where possible).  Fixed-width
    columns map directly; ``fixed_size_list`` tensor columns (token rows,
    image pixels) collate to real fixed-width arrays — 2-D by default, or
    the full declared logical shape when the loader resolved one from the
    table's tensor declarations (``tensor_shapes``, computed ONCE per
    loader from the projected schema instead of re-probing Arrow types per
    batch); strings stay as object arrays (caller should tokenize/encode
    upstream for TPU consumption).  Anything that only lowers to
    dtype=object (variable lists, structs, maps) fails LOUDLY: the old
    object-array fallback survived until ``jax.device_put`` rejected the
    batch deep inside the pipeline, with no hint of which column was
    responsible."""
    from lakesoul_tpu_torch.errors import ConfigError

    out: dict[str, np.ndarray] = {}
    table = pa.table(batch) if isinstance(batch, pa.RecordBatch) else batch
    for name in table.column_names:
        col = table.column(name)
        if pa.types.is_fixed_size_list(col.type):
            arr = col.combine_chunks()  # lakelint: ignore[hot-path-materialize] fallback for windows the zero-copy view path declined (nulls/odd layouts); the fused path never reaches here
            width = col.type.list_size
            flat = arr.flatten().to_numpy(zero_copy_only=False)
            if flat.dtype != object and len(flat) == len(arr) * width:
                shape = (tensor_shapes or {}).get(name) or (width,)
                out[name] = flat.reshape((len(arr),) + tuple(shape))
                continue
        try:
            arr = col.to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
            raise ConfigError(
                f"column {name!r} has Arrow type {col.type} which only "
                "collates to dtype=object — object arrays cannot be "
                "device_put; flatten/encode the column upstream or pass a "
                "collate_fn that handles it"
            ) from e
        if arr.dtype == object and not _is_stringlike(col.type):
            raise ConfigError(
                f"column {name!r} has Arrow type {col.type} which only "
                "collates to dtype=object — object arrays cannot be "
                "device_put; flatten/encode the column upstream or pass a "
                "collate_fn that handles it"
            )
        out[name] = arr
    return out


def _np_column_views(
    batch: pa.RecordBatch,
    tensor_shapes: "dict[str, tuple[int, ...]] | None" = None,
) -> dict[str, np.ndarray] | None:
    """Zero-copy per-column numpy views of one record batch, or None when any
    column cannot be viewed without conversion (nulls, strings/objects,
    bit-packed bools, variable nesting) — the window then falls back to the
    arrow-table collate path, which handles those exactly as before.
    Declared tensor columns view straight to their logical shape
    (``(rows, *shape)``): the declaration was resolved once per loader, so
    the hot path never re-discovers ``fixed_size_list`` per batch."""
    views: dict[str, np.ndarray] = {}
    for i, name in enumerate(batch.schema.names):
        col = batch.column(i)
        t = col.type
        try:
            if pa.types.is_fixed_size_list(t):
                if col.null_count:
                    return None
                flat = col.flatten().to_numpy(zero_copy_only=True)
                shape = (tensor_shapes or {}).get(name) or (t.list_size,)
                views[name] = flat.reshape((len(col),) + tuple(shape))
            else:
                if col.null_count:
                    return None
                views[name] = col.to_numpy(zero_copy_only=True)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, ValueError):
            return None
    return views


class _Window:
    """One fixed-size row window over the pending batches, materialization
    deferred: the window holds zero-copy (batch, views, start, length) parts
    and either collates STRAIGHT from the numpy views into one output buffer
    per column (fast path — no intermediate table ever exists) or assembles
    a table from batch slices for the fallback/custom-collate path."""

    __slots__ = ("parts", "nrows", "fast", "tensor_shapes")

    def __init__(self, parts, nrows: int, tensor_shapes=None):
        self.parts = parts  # [(record_batch, views_or_None, start, length)]
        self.nrows = nrows
        self.fast = all(v is not None for _, v, _, _ in parts)
        self.tensor_shapes = tensor_shapes  # declared shapes for fallbacks

    def __len__(self) -> int:
        return self.nrows

    def to_table(self) -> pa.Table:
        # zero-copy: slices share the source batch buffers; the table's
        # chunked columns are exactly what the old concat-based rebatcher
        # handed to collate
        return pa.Table.from_batches(
            [b.slice(s, ln) for b, _, s, ln in self.parts]
        )

    def collate(self, buffers: "dict[str, np.ndarray] | None",
                alloc: "Callable[[tuple, np.dtype], np.ndarray] | None" = None) -> dict[str, np.ndarray]:
        """Fused rebatch+collate: one ``out[pos:pos+len] = view[s:s+len]``
        memcpy per (column, part) into per-column output buffers —
        ``buffers`` (a reuse-ring slot) or freshly allocated once.  A window
        that is a single slice of one batch (the common case: the scan
        already emits ``batch_size``-row batches, so windows align) doesn't
        even copy — the numpy views pass straight through, sliced.

        ``alloc(shape, dtype)`` makes each output buffer.  The loader passes
        a pinned allocator when it delivers to the card: Arrow's views are
        read-only pageable memory, which cannot be copied asynchronously, so
        a single-part window then takes its one memcpy into pinned memory
        instead of passing the views through."""
        if buffers is None and alloc is None and len(self.parts) == 1:
            b, views, s, ln = self.parts[0]
            if s == 0 and ln == len(b):
                return dict(views)
            return {name: v[s : s + ln] for name, v in views.items()}
        first_views = self.parts[0][1]
        out: dict[str, np.ndarray] = {}
        for name, proto in first_views.items():
            shape = (self.nrows,) + proto.shape[1:]
            buf = None if buffers is None else buffers.get(name)
            if buf is None or buf.shape != shape or buf.dtype != proto.dtype:
                buf = (alloc or np.empty)(shape, proto.dtype)
                if buffers is not None:
                    buffers[name] = buf
            pos = 0
            for _, views, s, ln in self.parts:
                v = views[name]
                if v.dtype != proto.dtype:
                    # batches disagree on dtype (schema drift): numpy would
                    # cast silently — take the exact table path instead
                    return _default_collate(self.to_table(), self.tensor_shapes)
                buf[pos : pos + ln] = v[s : s + ln]
                pos += ln
            out[name] = buf
        return out


class _Slot(dict):
    """One ring slot's buffers by column, plus ``event``: the CUDA event
    recorded after the last copy out of them to the card (None when there
    was none, or on the host)."""

    __slots__ = ("event",)

    def __init__(self):
        super().__init__()
        self.event = None


class _BufferRing:
    """Round-robin pool of collate output buffer sets (opt-in via
    ``LAKESOUL_COLLATE_REUSE=1``): with ``size`` ≥ the number of windows that
    can be live at once (prefetch queue + device-copy pipeline + in-flight),
    steady-state collate allocates NOTHING — each window overwrites the
    buffers of a window the consumer has already retired.  Only safe when
    the consumer copies batches out before ``size`` further batches are
    drawn; the default path allocates fresh buffers per window.  On the
    card the slots are pinned and a slot is handed out again only after the
    H2D copy out of it has completed: :meth:`next_slot` waits on the copy's
    event (recorded by the delivery), not on the return from the copy call,
    which is only its dispatch."""

    def __init__(self, size: int):
        self._slots: list[_Slot] = [_Slot() for _ in range(max(1, size))]
        self._next = 0

    def next_slot(self) -> _Slot:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        return slot


class _Rebatcher:
    """Accumulate arrow batches and emit fixed-size row windows — chunk-aware:
    pending batches are never concatenated (the old ``pa.concat_tables`` per
    pop rebuilt a table of everything buffered, per window); a window is a
    list of zero-copy slice descriptors resolved at collate time."""

    def __init__(self, batch_size: int, *, capture_views: bool = True,
                 tensor_shapes: "dict[str, tuple[int, ...]] | None" = None):
        self.batch_size = batch_size
        # a custom collate_fn consumes tables, never views — skip the
        # per-batch view capture entirely on that path
        self._capture_views = capture_views
        self._tensor_shapes = tensor_shapes
        self._pending: list[tuple[pa.RecordBatch, dict | None]] = []
        self._offset = 0  # consumed rows of the FIRST pending batch
        self._rows = 0

    def push(self, batch: pa.RecordBatch | pa.Table) -> "list[_Window]":
        if isinstance(batch, pa.Table):
            incoming = batch.to_batches()
        else:
            incoming = [batch]
        for b in incoming:
            if len(b) == 0:
                continue
            views = (
                _np_column_views(b, self._tensor_shapes)
                if self._capture_views else None
            )
            self._pending.append((b, views))
            self._rows += len(b)
        out = []
        while self._rows >= self.batch_size:
            out.append(self._pop(self.batch_size))
        return out

    def _pop(self, n: int) -> _Window:
        parts = []
        need = n
        while need:
            b, views = self._pending[0]
            avail = len(b) - self._offset
            take = min(avail, need)
            parts.append((b, views, self._offset, take))
            need -= take
            if take == avail:
                self._pending.pop(0)
                self._offset = 0
            else:
                self._offset += take
        self._rows -= n
        return _Window(parts, n, self._tensor_shapes)

    def tail(self) -> _Window | None:
        if self._rows == 0:
            return None
        out = self._pop(self._rows)
        return out


def _pinned_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` over pinned host memory from PyTorch's caching host
    allocator (pinning costs far more than a pageable allocation, so it is
    never asked of CUDA per batch).  The array keeps its tensor alive
    through ``.base``."""
    dt = np.dtype(dtype)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    raw = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
    return raw.numpy()[:nbytes].view(dt).reshape(shape)


def _is_pinned(arr: np.ndarray) -> bool:
    """True when ``arr`` is a contiguous view of a pinned tensor's memory
    (what :func:`_pinned_empty` and the ring's slots hand out)."""
    if not arr.flags.c_contiguous:
        return False
    owner = arr
    while isinstance(owner, np.ndarray):
        owner = owner.base
    return isinstance(owner, torch.Tensor) and owner.is_pinned()


def _numeric_leaf(x, name: str):
    """A leaf as a tensor or a numeric numpy array; a string or object leaf
    raises, naming its column (the reference's ``device_put`` rejects it
    too)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind in "OUSVMm":
        raise ConfigError(
            f"column {name!r} has dtype {arr.dtype}, which cannot be copied to a"
            " device: encode it upstream, drop it with a transform, or pass"
            " device_put=False"
        )
    return arr


def _cpu_leaf(x, name: str) -> torch.Tensor:
    """Delivery to the CPU: the tensor aliases the collate buffer."""
    x = _numeric_leaf(x, name)
    if isinstance(x, torch.Tensor):
        return x
    try:
        return torch.from_numpy(x)
    except ValueError:  # negative strides: torch cannot view them
        return torch.from_numpy(np.ascontiguousarray(x))


def _pinned_leaf(x, name: str):
    """A leaf ready for an async H2D copy: pinned memory passes through,
    anything else takes one memcpy into a pinned buffer."""
    x = _numeric_leaf(x, name)
    if isinstance(x, torch.Tensor):
        return x if x.device.type != "cpu" or x.is_pinned() else x.pin_memory()
    if _is_pinned(x):
        return x
    buf = _pinned_empty(x.shape, x.dtype)
    np.copyto(buf, x)
    return buf


class TorchBatchIterator:
    """Iterator of fixed-size batches on the device.

    Args:
        scan: a LakeSoulScan (its batch_size sets the emitted batch size).
        collate_fn: arrow table → pytree of numpy arrays.  Default: dict of
            per-column arrays.
        transform: optional numpy-level pytree transform (e.g. tokenize,
            reshape features) applied on the host thread.
        device_put: move batches to ``device`` (default True; False yields
            host numpy pytrees — useful for tests and CPU pipelines).
        device: where batches go: ``None`` means the CUDA card and raises
            without one; ``"cpu"`` yields tensors that alias the host
            buffers.  Ignored with ``device_put=False``.
        sharding: the reference's jax placement; it has no meaning in the
            port and raises.
        prefetch: queue depth for the host pipeline (decode ahead).
        device_prefetch: how many batches to keep in flight to the device
            ahead of the consumer (double buffering = 2).
        drop_remainder: drop the final short batch (static-shape default True).
        io_threads: decode scan units on this many threads (multi-core hosts;
            see LakeSoulScan.to_batches).
        checkpoint: a :class:`LoaderCheckpoint` to resume from and advance.
        cache: ``"device"`` pins delivered batches in device memory on the
            first complete epoch (a
            :class:`~lakesoul_tpu_torch.tensorplane.replay.DeviceReplayCache`);
            re-iterating then replays them with no storage, host or link
            traffic.  Budgeted (``replay_budget_bytes`` /
            ``LAKESOUL_REPLAY_BUDGET_BYTES``): past the budget the cache
            records a typed, metered spill and later epochs replay the
            resident prefix then re-stream only the tail.  An epoch
            abandoned early leaves the cache unfilled (partial replay would
            silently drop data).
        replay_budget_bytes: device-memory budget for ``cache='device'``
            (default: the env var, else unbounded).
        replay_permute: re-permute the resident epoch on the device each
            replay (seeded; batch order + on-device row permutation) —
            only honoured while fully resident, a spilled cache replays
            in stream order.
        replay_seed: seed pinning the permutation schedule.
        consumer: attribution tag for this loader's ``queue`` stall series
            (``lakesoul_scan_stage_seconds{stage=queue,consumer=...}``).
            Default ``"local"``.
        follow: the continuous source over the commit log is not ported yet
            and raises.
        multihost: shard the scan by this process's position on the data
            axis (``torch.distributed``'s rank and world size, overridable
            via ``LAKESOUL_FLEET_PROCESS_INDEX``/``_COUNT``) before the
            pipeline resolves it.  A scan already ``shard()``-ed the same
            way passes through; a conflicting shard raises.
    """

    def __init__(
        self,
        scan,
        *,
        collate_fn: Callable[[pa.Table], Any] | None = None,
        transform: Callable[[Any], Any] | None = None,
        device_put: bool = True,
        device: "str | torch.device | None" = None,
        sharding=None,
        prefetch: int = 4,
        device_prefetch: int = 2,
        drop_remainder: bool = True,
        io_threads: int | None = None,
        checkpoint: "LoaderCheckpoint | None" = None,
        cache: str | None = None,
        replay_budget_bytes: int | None = None,
        replay_permute: bool = False,
        replay_seed: int = 0,
        consumer: str | None = None,
        follow=None,
        multihost: bool = False,
    ):
        if sharding is not None:
            raise ConfigError(
                "sharding= is a jax placement and has no meaning in the PyTorch"
                " port; shard the scan (shard()/auto_shard()/multihost=True)"
            )
        if cache not in (None, "device"):
            raise ConfigError(f"unknown cache mode {cache!r}; expected 'device'")
        if cache != "device" and (
            replay_budget_bytes is not None or replay_permute or replay_seed
        ):
            # a replay knob without the replay cache must not silently train
            # un-permuted / un-budgeted
            raise ConfigError(
                "replay_budget_bytes/replay_permute/replay_seed require"
                " cache='device'"
            )
        if follow is not None and follow is not False:
            if checkpoint is not None:
                raise ConfigError(
                    "follow and checkpoint are mutually exclusive: the"
                    " follower carries its own exactly-once position"
                    " (follow_state_json)"
                )
            if cache == "device":
                raise ConfigError(
                    "cache='device' cannot cache an unbounded follow stream"
                )
            from lakesoul_tpu_torch.data.batch_source import batch_source_for

            batch_source_for(scan, follow=follow)  # raises: not ported yet
        if cache == "device" and checkpoint is not None:
            # a replayed epoch never touches the input stream, so a loader
            # checkpoint could not represent its position
            raise ConfigError("cache='device' and checkpoint are mutually exclusive")
        if cache == "device" and not device_put:
            raise ConfigError("cache='device' requires device_put=True")
        if multihost:
            # shard BEFORE anything else resolves the scan: the plan digest,
            # replay cache and checkpoint must see the local host's shard
            from lakesoul_tpu_torch.fleet.multihost import shard_scan

            scan = shard_scan(scan)
        self._replay: DeviceReplayCache | None = None
        # exactly ONE active generator may fill the shared cache: two
        # interleaved iterations of the same loader would both offer into
        # it, sealing a doubled epoch or tripping offer()-after-seal
        # mid-stream — the first streaming generator claims the fill, later
        # concurrent ones stream plain
        self._fill_claimed = False
        if cache == "device":
            self._replay = DeviceReplayCache(
                budget_bytes=replay_budget_bytes,
                permute=replay_permute,
                seed=replay_seed,
            )
        self._device = resolve_device(device) if device_put else None
        # the collate writes pinned memory only for a copy to the card
        self._pin = self._device is not None and self._device.type == "cuda"
        self._stats = LoaderStats()
        self._scan = scan
        self._collate = collate_fn or _default_collate
        # declared tensor shapes, resolved ONCE from the projected schema
        # (tensorplane/columns.py): the collate layer reshapes straight to
        # (batch, *shape) instead of re-probing Arrow types per batch
        try:
            from lakesoul_tpu_torch.tensorplane.columns import tensor_specs

            self._tensor_shapes = {
                name: spec.shape
                for name, spec in tensor_specs(scan.projected_schema()).items()
            } or None
        except Exception:  # scans without resolvable schemas keep the
            self._tensor_shapes = None  # per-type collate contract
        # opt-in collate-buffer reuse ring (see _BufferRing contract), sized
        # to cover every window that can be live at once.  It arms where the
        # delivery copies: for a host consumer (device_put=False, which
        # copies batches out before the ring wraps) and on the card (its
        # pinned slots are reused once their copy's event has completed).
        # On the CPU a delivered tensor aliases its collate buffer, so the
        # ring stays down there, as the reference keeps it down where
        # device_put aliases — a batch the replay cache holds must own its
        # bytes.  On the card a cached batch is the copy's device tensors,
        # which own theirs, so the pinned slots may be reused under
        # cache='device' too.
        self._ring: _BufferRing | None = None
        if (
            collate_fn is None
            and os.environ.get("LAKESOUL_COLLATE_REUSE") == "1"
            and (not device_put or self._pin)
        ):
            self._ring = _BufferRing(
                max(1, prefetch) + max(1, device_prefetch) + 2
            )
        # the collate's allocator: pinned on the card, unless a transform
        # makes new arrays anyway (its output is pinned after it runs)
        self._alloc = (
            _pinned_empty
            if self._pin and (transform is None or self._ring is not None)
            else None
        )
        self._copy_stream = torch.cuda.Stream(self._device) if self._pin else None
        # stage-attribution handles, fetched once (the obs hot-path
        # contract); the queue series carries this loader's consumer tag so
        # multi-client stall is attributable per client
        self._h_rebatch = stage_histogram("rebatch")
        self._h_collate = stage_histogram("collate")
        self._h_queue = stage_histogram("queue", consumer=consumer or "local")
        self._h_device_put = stage_histogram("device_put")
        self._transform = transform
        self._device_put = device_put
        self._prefetch = max(1, prefetch)
        self._device_prefetch = max(1, device_prefetch)
        self._drop_remainder = drop_remainder
        self._io_threads = io_threads
        self._checkpoint = checkpoint
        self._rows_out = 0  # consumer-delivered rows
        if checkpoint is not None:
            digest = self._plan_digest()
            if checkpoint.plan_digest is None:
                checkpoint.plan_digest = digest
            elif checkpoint.plan_digest != digest:
                raise ConfigError(
                    "loader checkpoint was taken against a different table"
                    " version/scan — the saved position is meaningless"
                )

    def _plan_digest(self) -> str:
        import hashlib

        return hashlib.md5(repr(self._scan._cache_key()).encode()).hexdigest()

    def stats(self) -> dict:
        """Loader telemetry snapshot: rows/batches (+ per-sec over in-epoch
        wall time), epochs, per-epoch row totals, consumer stall seconds,
        and current producer-queue depth — plus the replay cache's
        residency stats under ``"replay"`` in cache='device' mode.  Cheap
        enough to read every step."""
        snap = self._stats.snapshot()
        if self._replay is not None:
            snap["replay"] = self._replay.stats()
        return snap

    @property
    def _device_cached(self):
        """The resident (rows, batch) list while a fully-resident cache is
        serving, else None."""
        if self._replay is not None and self._replay.ready \
                and not self._replay.spilled:
            return self._replay._batches
        return None

    # ------------------------------------------------------------- pipeline
    def _epoch_windows(self, extra_skip: int = 0) -> "Iterator[_Window]":
        """Fixed-size row windows over one epoch's scan (the pipeline
        source).  Resume: the scan's unit order is deterministic, so the
        checkpoint's delivered-row count is a complete position; the scan
        skips whole units via metadata row counts without decoding them and
        decode-discards only the residual prefix of one unit.
        ``extra_skip`` is the spilled-replay tail resume: the resident
        prefix rows the cache already serves from device memory."""
        skip = (self._checkpoint.rows_delivered if self._checkpoint else 0) + extra_skip
        rb = _Rebatcher(
            self._scan._batch_size,
            capture_views=self._collate is _default_collate,
            tensor_shapes=self._tensor_shapes,
        )
        h = self._h_rebatch
        # the batch-source seam: in-process decode or a scan-plane fleet
        # (scan.via_scanplane) — everything downstream (rebatch, collate,
        # prefetch, the copy to the card, stats) is identical either way
        from lakesoul_tpu_torch.data.batch_source import batch_source_for

        for arrow_batch in batch_source_for(self._scan).iter_batches(
            num_threads=self._io_threads, skip_rows=skip
        ):
            t0 = time.perf_counter()
            windows = rb.push(arrow_batch)
            h.observe(time.perf_counter() - t0)
            yield from windows
        if not self._drop_remainder:
            tail = rb.tail()
            if tail is not None:
                yield tail

    def _host_pipeline(self, extra_skip: int = 0):
        """One epoch's host pipeline on the shared runtime: scan windows →
        collate/transform → bounded prefetch pump.  Items are
        ``(rows, host batch, ring slot or None)``."""
        return (
            rt_pipeline("loader")
            .source(self._epoch_windows(extra_skip))
            .map(self._host_batch, name="collate")
            .prefetch(self._prefetch, name="prefetch")
            .run()
        )

    def _host_batch(self, window):
        t0 = time.perf_counter()
        slot = None
        if window.fast and self._collate is _default_collate:
            # fused zero-copy path: views → output buffers, no
            # intermediate table, no per-column combine_chunks
            slot = self._ring.next_slot() if self._ring is not None else None
            batch = window.collate(slot, self._alloc)
        elif self._collate is _default_collate:
            batch = _default_collate(window.to_table(), self._tensor_shapes)
        else:
            batch = self._collate(window.to_table())
        if self._transform is not None:
            batch = self._transform(batch)
        if self._pin:
            batch = _map_leaves(_pinned_leaf, batch)
        self._h_collate.observe(time.perf_counter() - t0)
        return len(window), batch, slot

    def __iter__(self):
        if self._replay is not None and self._replay.ready:
            # steady state: replay the device-resident epoch — no storage,
            # no host pipeline, no link traffic; a spilled cache replays its
            # resident prefix then re-streams ONLY the tail (the offers
            # stopped at the first budget rejection, so the prefix is
            # contiguous and `resident_rows` is an exact resume position)
            self._stats.epoch_begin()
            completed = False
            try:
                for rows, b in self._replay.replay():
                    self._stats.delivered(rows, 0.0, 0)
                    self._rows_out += rows
                    yield self._replayed(b)
                if self._replay.spilled:
                    completed = yield from self._deliver_stream(
                        extra_skip=self._replay.resident_rows
                    )
                else:
                    completed = True
            finally:
                self._stats.epoch_end(completed)
            return
        self._stats.epoch_begin()
        completed = False
        filling = self._replay is not None and not self._fill_claimed
        if filling:
            self._fill_claimed = True
        try:
            offer = self._replay.offer if filling else None
            completed = yield from self._deliver_stream(offer=offer)
            if completed and filling:
                # only a COMPLETE epoch becomes the resident cache: an
                # abandoned iteration (consumer break → GeneratorExit)
                # never reaches here
                self._replay.seal()
        finally:
            if filling:
                if not self._replay.ready:
                    self._replay.abandon()
                self._fill_claimed = False
            self._stats.epoch_end(completed)

    def _replayed(self, batch):
        """A cached batch for the consumer: fresh containers, and on the
        card each leaf tied to the consumer's current stream (bookkeeping
        for the caching allocator, no sync)."""
        if self._pin:
            current = torch.cuda.current_stream(self._device)
            _map_leaves(lambda t, _: t.record_stream(current) if t.is_cuda else None, batch)
        return fresh_containers(batch)

    def _put_cuda(self, host_batch, slot, inflight: deque):
        """Dispatch the batch's H2D copies on the side stream and record one
        event after them.  The host batch stays referenced in ``inflight``
        until that event has completed, so no pinned buffer goes back to
        the allocator while the copy may still read it; a ring slot keeps
        the event and is not refilled before it completes."""
        dev = self._device
        with torch.cuda.stream(self._copy_stream):
            out = _map_leaves(
                lambda x, _: (x if isinstance(x, torch.Tensor) else torch.from_numpy(x)).to(
                    dev, non_blocking=True
                ),
                host_batch,
            )
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        if slot is not None:
            slot.event = ev
        inflight.append((ev, host_batch))
        while inflight and inflight[0][0].query():
            inflight.popleft()
        return out, ev

    def _ready_cuda(self, item):
        """Make a dispatched batch safe for the consumer's stream: wait on
        its copy (on the device, not the host) and tie each leaf's memory to
        that stream, so the caching allocator does not reuse it while the
        step still reads it."""
        out, ev = item
        current = torch.cuda.current_stream(self._device)
        current.wait_event(ev)
        _map_leaves(lambda t, _: t.record_stream(current) if t.is_cuda else None, out)
        return out

    def _deliver_stream(self, extra_skip: int = 0, offer=None):
        """One streaming epoch: host pipeline → (device copy double buffer)
        → consumer.  Returns True when the pipeline ran to exhaustion AND
        every batch reached the consumer.  ``offer`` is the replay cache's
        pin hook, called with each batch as the consumer gets it (on the
        card: after its stream waited on the copy); a pinned batch is
        handed to the consumer as fresh containers so in-place mutation
        cannot poison the cached epoch."""
        pipe = self._host_pipeline(extra_skip)
        produced_all = False  # the pipeline ran to exhaustion

        def host_iter():
            nonlocal produced_all
            try:
                while True:
                    waited = time.perf_counter()
                    try:
                        item = next(pipe)
                    except StopIteration:
                        produced_all = True
                        return
                    stall = time.perf_counter() - waited
                    # telemetry at the host hand-off: this is the loader's
                    # produced throughput and how long the consumer starved
                    self._h_queue.observe(stall)
                    self._stats.delivered(item[0], stall, pipe.queue_depth())
                    yield item
            finally:
                # quiesce, don't just signal: close() cancels the pipeline
                # and joins its pump
                pipe.close()

        def delivered(rows: int) -> None:
            # position advances when a batch reaches the CONSUMER: a trainer
            # saving (model, checkpoint) after step k resumes exactly at k+1
            self._rows_out += rows
            if self._checkpoint is not None:
                self._checkpoint.rows_delivered += rows

        if not self._device_put:
            for rows, host_batch, _ in host_iter():
                delivered(rows)  # BEFORE yield: a post-step save includes it
                yield host_batch
            return produced_all

        inflight: deque = deque()  # (copy event, host batch) not yet complete
        if self._pin:
            put = lambda b, slot: self._put_cuda(b, slot, inflight)  # noqa: E731
            ready = self._ready_cuda
        else:
            put = lambda b, slot: _map_leaves(_cpu_leaf, b)  # noqa: E731
            ready = lambda out: out  # noqa: E731
        h_put = self._h_device_put

        def emit(r, b):
            delivered(r)
            b = ready(b)
            if offer is not None and offer(r, b):
                return fresh_containers(b)  # the cache keeps the pristine one
            return b

        try:
            # double buffering: keep device_prefetch copies in flight so the
            # H2D copy of batch k+1 overlaps the step on batch k
            buf: deque = deque()
            for rows, host_batch, slot in host_iter():
                t0 = time.perf_counter()  # dispatch cost only
                buf.append((rows, put(host_batch, slot)))
                h_put.observe(time.perf_counter() - t0)
                if len(buf) > self._device_prefetch:
                    yield emit(*buf.popleft())
            while buf:
                yield emit(*buf.popleft())
        finally:
            # the epoch's last copies may still read pinned memory that the
            # next epoch's collate would be handed again
            for ev, _ in inflight:
                ev.synchronize()
        # a consumer break during the tail flush raises GeneratorExit above
        # and never reaches here: the epoch is NOT complete
        return produced_all


def to_torch_iter(scan, **kwargs) -> TorchBatchIterator:
    """``scan.to_torch_iter(**kwargs)``: see :class:`TorchBatchIterator`."""
    return TorchBatchIterator(scan, **kwargs)
