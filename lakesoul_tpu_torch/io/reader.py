"""Scan-unit reader with merge-on-read.

Reads one scan unit — the files of a single (range-partition, hash-bucket)
cell — applying filter pushdown, LSM merge on primary keys, merge operators,
CDC delete filtering, schema evolution fill, and partition-column
reconstruction.  Capability parity with LakeSoulReader::start →
build_physical_plan (reader.rs:148-246, session.rs:794-1036), minus the
DataFusion plumbing: the plan here *is* the code path.

Two execution modes share one plan:

- ``read_scan_unit`` materializes the unit (to_arrow, threaded decode).
- ``iter_scan_unit_batches`` **streams** it with bounded memory: PK units go
  through the watermark-window merger (io/streaming_merge.py — the role of
  the reference's sorted_stream_merger.rs:317), non-PK units stream file by
  file; neither ever holds a whole bucket.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Iterator

import pyarrow as pa
import pyarrow.dataset as pads

logger = logging.getLogger(__name__)

from lakesoul_tpu_torch.io.config import DEFAULT_MEMORY_BUDGET
from lakesoul_tpu_torch.io.filters import Filter, filter_column_names, zone_conjuncts
from lakesoul_tpu_torch.io.formats import format_for
from lakesoul_tpu_torch.io.merge import apply_cdc_filter, merge_sorted_tables, uniform_table
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.obs.stages import stage_histogram
from lakesoul_tpu_torch.runtime import pipeline as rt_pipeline


def timed_decode_iter(it: Iterator) -> Iterator:
    """Wrap a format reader's batch iterator so every pull is attributed to
    the ``decode`` scan stage (runs on whatever thread actually decodes —
    the prefetch pump when the iterator sits behind one)."""
    h = stage_histogram("decode")
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        h.observe(time.perf_counter() - t0)
        yield item


def _unit_observe(mode: str, rows: int, started: float) -> None:
    """Scan-unit telemetry: per-unit wall time and produced rows, split by
    execution mode (materialize vs bounded-memory stream)."""
    registry().histogram("lakesoul_io_scan_unit_seconds", mode=mode).observe(
        time.perf_counter() - started
    )
    registry().counter("lakesoul_io_scan_rows_total", mode=mode).inc(rows)


def _read_one_file(
    path: str,
    *,
    columns: list[str] | None,
    arrow_filter,
    storage_options: dict | None,
    zone_predicates=None,
) -> pa.Table:
    return format_for(path).read_table(
        path, columns=columns, arrow_filter=arrow_filter,
        storage_options=storage_options, zone_predicates=zone_predicates,
    )


@dataclass
class _UnitPlan:
    """Resolved read plan for one scan unit (projection closure, file schema,
    pushdown-safe file filter, exact post-merge filter, zone conjuncts for
    stats-based chunk skipping)."""

    read_columns: list[str] | None
    file_schema: pa.Schema | None
    file_filter: object | None
    post_filter: object | None
    zone_predicates: list = None


def _plan_unit(
    primary_keys: list[str],
    *,
    schema: pa.Schema | None,
    partition_values: dict[str, str],
    filter: Filter | None,
    cdc_column: str | None,
    columns: list[str] | None,
) -> _UnitPlan:
    arrow_filter = filter.to_arrow() if filter is not None else None

    refs = filter_column_names(filter)  # None = unknowable (substrait bytes)

    # columns that must be read even if projected away later: PKs for the
    # merge, the CDC column for delete filtering (session.rs merged_projection),
    # and any column the filter references (ALL columns when unknowable)
    read_columns = None
    if columns is not None and refs is not None:
        need = list(columns)
        extra = list(primary_keys)
        if cdc_column:
            extra.append(cdc_column)
        extra.extend(refs)
        for k in extra:
            if k not in need:
                need.append(k)
        read_columns = [c for c in need if c not in partition_values]

    # file-level schema: table schema minus directory-encoded partition cols
    file_schema = None
    if schema is not None:
        file_schema = pa.schema([f for f in schema if f.name not in partition_values])
        if read_columns is not None:
            file_schema = pa.schema([f for f in file_schema if f.name in read_columns])

    # Pushdown safety: pre-merge filtering may only remove *whole PK groups*,
    # otherwise it could drop the newest version of a row and resurrect a
    # stale one through the merge.  So for PK tables the filter is pushed into
    # the file scan only when it references PK columns exclusively; it is
    # always re-applied after the merge.  Partition columns aren't stored in
    # files, so filters referencing them can never push down.
    file_filter = None
    post_filter = arrow_filter
    if arrow_filter is not None:
        if refs is None:
            # opaque (substrait) predicate: only safe pre-merge when there is
            # no merge and no directory-encoded column it could reference
            file_filter = (
                arrow_filter if not primary_keys and not partition_values else None
            )
        elif refs & set(partition_values):
            file_filter = None
        elif primary_keys and not refs <= set(primary_keys):
            file_filter = None
        else:
            # pushdown is per-file best-effort (schema evolution can force a
            # file to skip it), so the exact filter is always re-applied
            # post-merge
            file_filter = arrow_filter
    zone = zone_conjuncts(filter) if file_filter is not None else []
    return _UnitPlan(read_columns, file_schema, file_filter, post_filter, zone)


def _postprocess(
    merged: pa.Table,
    *,
    schema: pa.Schema | None,
    partition_values: dict[str, str],
    cdc_column: str | None,
    drop_cdc_deletes: bool,
    post_filter,
    columns: list[str] | None,
) -> pa.Table:
    """Post-merge tail shared by both execution modes: partition-column fill,
    CDC delete filter, exact filter re-application, final projection."""
    # fill directory-encoded partition columns back in (all of them — the
    # post-merge filter may reference partition columns that the final
    # projection drops)
    if partition_values and schema is not None:
        fill0 = time.perf_counter()
        n = len(merged)
        arrays, names = [], []
        for fld in schema:
            if fld.name in merged.column_names:
                arrays.append(merged.column(fld.name))
                names.append(fld.name)
            elif fld.name in partition_values:
                val = partition_values[fld.name]
                scalar = None if val == "__NULL__" else val
                arr = pa.array([scalar] * n, type=pa.string()).cast(fld.type)
                arrays.append(arr)
                names.append(fld.name)
        merged = pa.table(dict(zip(names, arrays)))
        stage_histogram("fill").observe(time.perf_counter() - fill0)

    if cdc_column and drop_cdc_deletes:
        merged = apply_cdc_filter(merged, cdc_column)

    # apply (or re-apply) the filter post-merge for exact semantics
    if post_filter is not None and len(merged) > 0:
        merged = pads.dataset(merged).to_table(filter=post_filter)

    if columns is not None:
        keep = [c for c in columns if c in merged.column_names]
        merged = merged.select(keep)
    return merged


def read_scan_unit(
    files: list[str],
    primary_keys: list[str],
    *,
    schema: pa.Schema | None = None,
    partition_values: dict[str, str] | None = None,
    filter: Filter | None = None,
    merge_operators: dict[str, str] | None = None,
    cdc_column: str | None = None,
    drop_cdc_deletes: bool = True,
    columns: list[str] | None = None,
    defaults: dict | None = None,
    storage_options: dict | None = None,
) -> pa.Table:
    """Read + merge one scan unit into a single Arrow table.

    ``schema`` is the full table schema (incl. range-partition columns);
    ``partition_values`` fills the directory-encoded columns back in
    (reference: stream/default_column.rs)."""
    partition_values = partition_values or {}
    started = time.perf_counter()
    plan = _plan_unit(
        primary_keys,
        schema=schema,
        partition_values=partition_values,
        filter=filter,
        cdc_column=cdc_column,
        columns=columns,
    )

    def _fetch_decode(path: str) -> pa.Table:
        t0 = time.perf_counter()
        t = _read_one_file(
            path,
            columns=plan.read_columns,
            arrow_filter=plan.file_filter,
            storage_options=storage_options,
            zone_predicates=plan.zone_predicates,
        )
        stage_histogram("decode").observe(time.perf_counter() - t0)
        if plan.file_schema is not None:
            t0 = time.perf_counter()
            t = uniform_table(t, plan.file_schema, defaults)
            stage_histogram("fill").observe(time.perf_counter() - t0)
        return t

    if len(files) > 1:
        # fetch+decode the unit's files in parallel on the runtime pool —
        # the merge consumes them in FILE order (= version order), so MOR
        # semantics are byte-identical to the serial loop.  Falls back to
        # inline execution on a pool worker (nested parallelism).
        tables = list(
            rt_pipeline("scan_unit")
            .source(files)
            .map_parallel(_fetch_decode, name="decode")
            .run()
        )
    else:
        tables = [_fetch_decode(p) for p in files]

    if primary_keys and len(tables) >= 1:
        merged = merge_sorted_tables(
            tables,
            primary_keys,
            merge_operators=merge_operators,
            target_schema=plan.file_schema,
            defaults=defaults,
        )
    else:
        merged = pa.concat_tables(tables) if tables else pa.table({})  # lakelint: ignore[hot-path-materialize] chunk-list concat, zero-copy: no buffer is copied, downstream slices share the decoded chunks

    out = _postprocess(
        merged,
        schema=schema,
        partition_values=partition_values,
        cdc_column=cdc_column,
        drop_cdc_deletes=drop_cdc_deletes,
        post_filter=plan.post_filter,
        columns=columns,
    )
    _unit_observe("materialize", len(out), started)
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(
            "scan unit materialized: files=%d rows=%d merge=%s in %.1fms",
            len(files),
            len(out),
            bool(primary_keys),
            (time.perf_counter() - started) * 1e3,
        )
    return out


def _stream_batch_rows(
    file_schema: pa.Schema | None,
    n_files: int,
    memory_budget_bytes: int,
    *,
    fast_merge: bool = True,
) -> int:
    """Per-stream load size so that n_files buffered stream batches plus one
    merge window stay within the budget."""
    from lakesoul_tpu_torch.io.streaming_merge import (
        DEFAULT_STREAM_BATCH_ROWS,
        MIN_STREAM_BATCH_ROWS,
    )

    width = 64  # fallback row-width guess
    if file_schema is not None:
        width = 0
        for f in file_schema:
            try:
                width += (f.type.bit_width + 7) // 8
            except ValueError:
                width += 32  # var-width (string/binary) estimate
        width = max(width, 8)
    # budget splits across: per-stream buffers (n_files), the concat window
    # (~n_files worth, zero-copy chunk refs into the buffers) and the merge
    # scratch.  On the native fast path the scratch is one gather output
    # (the run chunks are gathered directly — no combine_chunks, no
    # argsort), so a window costs ~1x itself; the argsort fallback still
    # pays combine + sort indices (~2x), so it keeps the old divisor.
    divisor = 3 if fast_merge else 4
    rows = memory_budget_bytes // max(1, divisor * n_files * width)
    return max(MIN_STREAM_BATCH_ROWS, min(DEFAULT_STREAM_BATCH_ROWS, int(rows)))


def _pk_native_capable(
    file_schema: pa.Schema | None, primary_keys: list[str]
) -> bool:
    """Whether the native loser-tree fast path can take these PKs (the
    window-budget sizing must assume the argsort fallback otherwise).
    Mirrors the runtime eligibility in io/merge.py conservatively: single
    int64/string keys merge directly, fixed-width ints/bools/dates/
    timestamps/times go through the memcomparable encoding; floats (NaN
    declines at runtime), decimals and var-width composites do not."""
    if file_schema is None:
        return False
    for k in primary_keys:
        idx = file_schema.get_field_index(k)
        if idx < 0:
            return False
        t = file_schema.field(idx).type
        if len(primary_keys) == 1 and (
            pa.types.is_string(t)
            or pa.types.is_large_string(t)
            or pa.types.is_binary(t)
            or pa.types.is_large_binary(t)
        ):
            continue
        if (
            pa.types.is_boolean(t)
            or pa.types.is_integer(t)
            or pa.types.is_date(t)
            or pa.types.is_timestamp(t)
            or pa.types.is_time(t)
        ):
            continue
        return False
    return True


# decoded-size multiplier over on-disk bytes when deciding whether a unit
# fits the budget (lz4 numeric data ≈ 1-1.5x; strings compress harder)
_DECODE_EXPANSION = 3


def iter_scan_unit_batches(
    files: list[str],
    primary_keys: list[str],
    *,
    batch_size: int = 8192,
    memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET,
    file_sizes: list[int] | None = None,
    schema: pa.Schema | None = None,
    partition_values: dict[str, str] | None = None,
    filter: Filter | None = None,
    merge_operators: dict[str, str] | None = None,
    cdc_column: str | None = None,
    drop_cdc_deletes: bool = True,
    columns: list[str] | None = None,
    defaults: dict | None = None,
    storage_options: dict | None = None,
) -> Iterator[pa.RecordBatch]:
    """Stream one scan unit as RecordBatches with bounded memory.

    Hybrid execution: when ``file_sizes`` (known from commit metadata) prove
    the whole unit fits comfortably inside ``memory_budget_bytes``, the unit
    is materialized — pyarrow's multi-threaded decode is much faster than a
    synchronous stream and the budget holds by construction.  Otherwise PK
    units merge incrementally through watermark windows
    (io/streaming_merge.py) and non-PK units stream file by file, so peak
    memory is governed by the budget, not bucket size — the property the
    reference gets from its loser-tree stream merger
    (sorted_stream_merger.rs:317) and memory pool (mem/pool.rs)."""
    partition_values = partition_values or {}
    if file_sizes and len(file_sizes) == len(files):
        est = sum(file_sizes) * _DECODE_EXPANSION
        if est <= memory_budget_bytes:
            table = read_scan_unit(
                files,
                primary_keys,
                schema=schema,
                partition_values=partition_values,
                filter=filter,
                merge_operators=merge_operators,
                cdc_column=cdc_column,
                drop_cdc_deletes=drop_cdc_deletes,
                columns=columns,
                defaults=defaults,
                storage_options=storage_options,
            )
            yield from table.to_batches(max_chunksize=batch_size)
            return
    plan = _plan_unit(
        primary_keys,
        schema=schema,
        partition_values=partition_values,
        filter=filter,
        cdc_column=cdc_column,
        columns=columns,
    )

    def post(t: pa.Table) -> pa.Table:
        return _postprocess(
            t,
            schema=schema,
            partition_values=partition_values,
            cdc_column=cdc_column,
            drop_cdc_deletes=drop_cdc_deletes,
            post_filter=plan.post_filter,
            columns=columns,
        )

    if not primary_keys:
        # merge operators are PK-group reductions; without PKs they are a
        # no-op and files simply concatenate
        rows = _stream_batch_rows(plan.file_schema, 1, memory_budget_bytes)
        started = time.perf_counter()
        out_rows = 0

        def raw_batches():
            for path in files:
                fmt = format_for(path)
                yield from timed_decode_iter(iter(fmt.iter_batches(
                    path,
                    columns=plan.read_columns,
                    arrow_filter=plan.file_filter,
                    batch_size=rows,
                    storage_options=storage_options,
                    zone_predicates=plan.zone_predicates,
                )))

        # degeneracy: with no partition fill, no CDC filter, no residual
        # filter and no projection, postprocess is the identity — a batch
        # whose schema already matches the plan's then flows straight from
        # the decoder to the consumer (a pyarrow.dataset-grade plan; the
        # merge/fill stages never run and report ~0 in the breakdown)
        post_identity = (
            not partition_values
            and not (cdc_column and drop_cdc_deletes)
            and plan.post_filter is None
            and columns is None
        )

        # one-batch decode-ahead: batch k+1 fetches/decodes while k
        # postprocesses and emits (memory bound: ONE extra batch)
        it = rt_pipeline("scan_stream").source(raw_batches()).prefetch(
            1, name="decode_ahead"
        ).run()
        try:
            for batch in it:
                if post_identity and (
                    plan.file_schema is None
                    or batch.schema.equals(plan.file_schema)
                ):
                    n = len(batch)
                    if n == 0:
                        continue
                    out_rows += n
                    if n <= batch_size:
                        yield batch
                    else:  # same row partitioning to_batches(max_chunksize) produced
                        for lo in range(0, n, batch_size):
                            yield batch.slice(lo, min(batch_size, n - lo))
                    continue
                t = pa.Table.from_batches([batch])
                if plan.file_schema is not None:
                    fill0 = time.perf_counter()
                    t = uniform_table(t, plan.file_schema, defaults)
                    stage_histogram("fill").observe(time.perf_counter() - fill0)
                t = post(t)
                if len(t):
                    out_rows += len(t)
                    yield from t.to_batches(max_chunksize=batch_size)
        finally:
            it.close()
        _unit_observe("stream", out_rows, started)
        return

    from lakesoul_tpu_torch import native
    from lakesoul_tpu_torch.io.streaming_merge import iter_merged_windows

    # the 3x window budget assumes the native gather fast path; merge
    # operators force the argsort path, a missing native library forces the
    # pyarrow one, and PK shapes the loser tree declines (floats/decimals/
    # var-width composites) fall back at runtime — all of those need the
    # old conservative 4x headroom
    rows = _stream_batch_rows(
        plan.file_schema, len(files), memory_budget_bytes,
        fast_merge=(
            not merge_operators
            and native.available()
            and _pk_native_capable(plan.file_schema, primary_keys)
        ),
    )
    started = time.perf_counter()
    out_rows = windows = 0
    for window in iter_merged_windows(
        files,
        primary_keys,
        file_schema=plan.file_schema,
        columns=plan.read_columns,
        arrow_filter=plan.file_filter,
        merge_operators=merge_operators,
        defaults=defaults,
        storage_options=storage_options,
        stream_batch_rows=rows,
        zone_predicates=plan.zone_predicates,
    ):
        t = post(window)
        windows += 1
        if len(t):
            out_rows += len(t)
            yield from t.to_batches(max_chunksize=batch_size)
    _unit_observe("stream", out_rows, started)
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(
            "scan unit streamed: files=%d windows=%d rows=%d window_rows=%d in %.1fms",
            len(files),
            windows,
            out_rows,
            rows,
            (time.perf_counter() - started) * 1e3,
        )


