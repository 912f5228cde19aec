"""Bounded-memory streaming merge-on-read.

The reference never materializes a bucket: it merges k sorted file *streams*
incrementally with a loser tree (physical_plan/merge/sorted/
sorted_stream_merger.rs:317, v2/loser_tree_merger.rs).  This module gives the
vectorized merge the same property without abandoning the TPU-first
formulation (io/merge.py): each file is opened as a stream of sorted record
batches, and the merge advances in **watermark windows**:

    watermark = min over non-exhausted streams of (last buffered PK tuple)
    rows strictly below the watermark are complete — no stream can produce
    another row for those PK groups — so the window is sliced off every
    buffer, merged with the existing vectorized kernel, and emitted.

Memory is bounded by ``n_files × stream_batch_rows`` plus one merge window,
never by bucket size.  Within a window the slices are concatenated in file
order (= version order), so "last wins" / merge-operator semantics are
byte-identical to the materialized path — property-tested against it in
tests/test_streaming_merge.py.

The writer-side counterpart of the reference's sort spill
(physical_plan/spill.rs) is the writer's byte-budget auto-flush: sorted runs
land on disk as ordinary staged files and *this* merger re-combines them at
read/compaction time, bounded, instead of an ad-hoc spill file format.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from lakesoul_tpu_torch.io.merge import merge_sorted_tables, uniform_table
from lakesoul_tpu_torch.obs.stages import stage_histogram
from lakesoul_tpu_torch.runtime import pipeline as rt_pipeline

# rows per load step per stream; the byte budget divides down from this
DEFAULT_STREAM_BATCH_ROWS = 65_536
MIN_STREAM_BATCH_ROWS = 4_096


def _prefetch_iter(it):
    """One-slot background prefetch over an iterator (runtime pipeline):
    while the merge works on batch k, batch k+1 decodes on the pump thread —
    the IO/decode overlap the synchronous scanner gives up.  Memory bound:
    ONE extra batch in flight.  Eager: the pump primes before the first
    pull, so a merger's k file streams all decode their first batch
    concurrently."""
    return rt_pipeline("mor_stream").source(it).prefetch(1, name="decode_ahead").run()


def _key_tuple(table: pa.Table, primary_keys: list[str], row: int) -> tuple:
    """Comparable PK tuple for one row.  Nulls sort last (matching the
    writer's pyarrow sort default) via a (is_null, value) wrap."""
    out = []
    for k in primary_keys:
        v = table.column(k)[row].as_py()
        out.append((v is None, v))
    return tuple(out)


def _prefix_below(table: pa.Table, primary_keys: list[str], watermark: tuple) -> int:
    """Length of the sorted table's prefix whose PK tuple is strictly below
    the watermark (vectorized lexicographic compare; single numeric PKs use
    binary search instead — sortedness of each stream's buffer is already a
    precondition of the whole watermark scheme, so O(log n) replaces the
    O(n) compare per stream per window)."""
    n = len(table)
    if n == 0:
        return 0
    if len(primary_keys) == 1:
        w_null, w_val = watermark[0]
        if not w_null:
            col = table.column(primary_keys[0])
            t = col.type
            if col.null_count == 0 and (
                pa.types.is_integer(t) or pa.types.is_floating(t)
            ):
                total = 0
                for chunk in col.chunks:
                    keys = np.asarray(chunk)  # zero-copy primitive view
                    total += int(np.searchsorted(keys, w_val, side="left"))
                return total
    lt = eq = None
    for k, (w_null, w_val) in zip(primary_keys, watermark):
        col = table.column(k)
        if w_null:
            # nulls sort last: value < null for any non-null value
            c_lt = col.is_valid()
            c_eq = pc.fill_null(col.is_null(), True)
        else:
            c_lt = pc.fill_null(pc.less(col, pa.scalar(w_val, type=col.type)), False)
            c_eq = pc.fill_null(pc.equal(col, pa.scalar(w_val, type=col.type)), False)
        if lt is None:
            lt, eq = c_lt, c_eq  # first key seeds the lexicographic fold
        else:
            lt = pc.or_(lt, pc.and_(eq, c_lt))
            eq = pc.and_(eq, c_eq)
    count = pc.sum(lt).as_py() or 0
    return int(count)


class _SortedFileStream:
    """One file of a PK cell as a stream of sorted, schema-uniformed batches."""

    def __init__(
        self,
        path: str,
        *,
        file_schema: pa.Schema | None,
        columns: list[str] | None,
        arrow_filter,
        defaults: dict | None,
        storage_options: dict | None,
        batch_rows: int,
        zone_predicates=None,
    ):
        from lakesoul_tpu_torch.io.formats import format_for
        from lakesoul_tpu_torch.io.reader import timed_decode_iter

        self._file_schema = file_schema
        self._defaults = defaults
        self._batches = _prefetch_iter(
            timed_decode_iter(iter(format_for(path).iter_batches(
                path,
                columns=columns,
                arrow_filter=arrow_filter,
                batch_size=batch_rows,
                storage_options=storage_options,
                zone_predicates=zone_predicates,
            )))
        )
        self.buffer: pa.Table = (
            file_schema.empty_table() if file_schema is not None else pa.table({})
        )
        self.exhausted = False
        self._primed = file_schema is not None

    def load(self) -> bool:
        """Pull one more batch into the buffer; False once the file is done."""
        if self.exhausted:
            return False
        try:
            batch = next(self._batches)
        except StopIteration:
            self.exhausted = True
            return False
        t = pa.table(pa.Table.from_batches([batch]) if isinstance(batch, pa.RecordBatch) else batch)
        if self._file_schema is not None:
            fill0 = time.perf_counter()
            t = uniform_table(t, self._file_schema, self._defaults)
            stage_histogram("fill").observe(time.perf_counter() - fill0)
        elif not self._primed:
            # no declared schema: adopt the first batch's schema
            self._file_schema = t.schema
            self.buffer = t.schema.empty_table()
            self._primed = True
        self.buffer = pa.concat_tables([self.buffer, t]) if len(self.buffer) else t  # lakelint: ignore[hot-path-materialize] chunk-list append, zero-copy: the buffer shares the decoded batches' buffers
        return True

    def last_key(self, primary_keys: list[str]) -> tuple:
        return _key_tuple(self.buffer, primary_keys, len(self.buffer) - 1)

    def split_below(self, primary_keys: list[str], watermark: tuple) -> pa.Table:
        """Slice off and return the prefix strictly below the watermark."""
        cut = _prefix_below(self.buffer, primary_keys, watermark)
        emit = self.buffer.slice(0, cut)
        # copy the (small) remainder: a zero-copy suffix slice would pin its
        # whole parent batches — decoded row groups — in memory
        self.buffer = self.buffer.slice(cut).combine_chunks()  # lakelint: ignore[hot-path-materialize] bounded remainder copy: a zero-copy suffix slice would pin whole decoded row groups in memory
        return emit

    def take_all(self) -> pa.Table:
        out, self.buffer = self.buffer, self.buffer.schema.empty_table()
        return out

    def close(self) -> None:
        self._batches.close()


def iter_merged_windows(
    files: list[str],
    primary_keys: list[str],
    *,
    file_schema: pa.Schema | None = None,
    columns: list[str] | None = None,
    arrow_filter=None,
    merge_operators: dict[str, str] | None = None,
    defaults: dict | None = None,
    storage_options: dict | None = None,
    stream_batch_rows: int = DEFAULT_STREAM_BATCH_ROWS,
    zone_predicates=None,
) -> Iterator[pa.Table]:
    """Merge k sorted file runs into a stream of merged windows.

    ``files`` must be ordered oldest → newest (commit order); each file's PK
    cell is sorted by the writer (io/writer.py flush).  A window never splits
    a PK group, so every merge-operator reduction sees its whole group."""
    if not primary_keys:
        raise ValueError("iter_merged_windows requires primary keys")
    streams = [
        _SortedFileStream(
            p,
            file_schema=file_schema,
            columns=columns,
            arrow_filter=arrow_filter,
            defaults=defaults,
            storage_options=storage_options,
            batch_rows=stream_batch_rows,
            zone_predicates=zone_predicates,
        )
        for p in files
    ]
    try:
        yield from _merge_loop(
            streams, primary_keys, file_schema, merge_operators, defaults
        )
    finally:
        # abandoned or finished: stop every prefetch thread
        for s in streams:
            s.close()


def _merge_loop(streams, primary_keys, file_schema, merge_operators, defaults):
    while True:
        for s in streams:
            # loop, not a single load: a pushed-down filter can produce empty
            # batches, and a non-exhausted stream with an empty buffer would
            # silently drop out of the watermark min — emitting rows its
            # future keys should have fenced (stale versions would leak)
            while len(s.buffer) == 0 and not s.exhausted:
                s.load()
        producers = [s for s in streams if not s.exhausted]
        if not producers:
            # drain: no stream can produce more, everything left is complete
            tables = [s.take_all() for s in streams if len(s.buffer)]
            if tables:
                yield merge_sorted_tables(
                    tables,
                    primary_keys,
                    merge_operators=merge_operators,
                    target_schema=file_schema,
                    defaults=defaults,
                )
            return

        # every producer has a non-empty buffer here (the load loop above)
        watermark = min(s.last_key(primary_keys) for s in producers)
        pieces = [s.split_below(primary_keys, watermark) for s in streams]
        tables = [p for p in pieces if len(p)]
        if not tables:
            # stall: every buffered row is ≥ the watermark (a PK group spans
            # the binding stream's whole buffer) — grow the binding stream(s)
            # until their last key moves past the group or the file ends
            for s in producers:
                if len(s.buffer) and s.last_key(primary_keys) == watermark:
                    s.load()
            continue
        yield merge_sorted_tables(
            tables,
            primary_keys,
            merge_operators=merge_operators,
            target_schema=file_schema,
            defaults=defaults,
        )
