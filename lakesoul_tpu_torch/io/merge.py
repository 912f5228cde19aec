"""Merge-on-read: LSM-style k-way merge of sorted file runs on primary keys.

Design note (TPU-first, intentionally different from the reference): the
reference merges with a streaming loser-tree over k sorted streams
(merge/sorted/v2/loser_tree_merger.rs) because its consumers are row engines.
Our consumer is a batch-oriented accelerator pipeline, so the merge is
expressed as **vectorized array ops** instead of a per-row compare loop:

    concat file runs (file order = version order)
      → stable multi-key argsort (ties keep file order)
      → group-boundary detection by vectorized neighbor compare
      → per-column segment reduction (UseLast = gather at group tails;
        SumAll = reduceat; UseLastNotNull = segmented max-scan of valid row
        indices; ...)

This is O(n log n) numpy/Arrow kernel work with no Python-per-row cost, and
the same formulation maps directly to a future on-chip Pallas segmented-scan
kernel.  Capability parity targets: merge semantics of
merge/sorted/sorted_stream_merger.rs + merge_operator.rs:22-165 (UseLast,
UseLastNotNull, SumAll, SumLast, JoinedLastBy*, JoinedAllBy*), CDC delete
semantics, and schema evolution via null-fill/cast (file_format.rs:211
CanCastSchemaBuilder, stream/default_column.rs).
"""

from __future__ import annotations

import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from lakesoul_tpu_torch.errors import IOError_
from lakesoul_tpu_torch.obs.stages import stage_histogram

MERGE_OPERATORS = {
    "UseLast",
    "UseLastNotNull",
    "SumAll",
    "SumLast",
    "JoinedLastByComma",
    "JoinedLastBySemicolon",
    "JoinedAllByComma",
    "JoinedAllBySemicolon",
}

CDC_DELETE = "delete"


def uniform_table(table: pa.Table, target_schema: pa.Schema, defaults: dict | None = None) -> pa.Table:
    """Schema evolution: reorder/cast columns to the target schema, filling
    missing columns with defaults (or nulls).

    Identity fast path: a table already carrying the target schema (the
    steady state — schema evolution is the exception, not the rule) is
    returned UNTOUCHED, so the fill stage degenerates to one schema compare
    per batch on compacted/unevolved scans."""
    if table.schema.equals(target_schema):
        return table
    defaults = defaults or {}
    n = len(table)
    cols = []
    for fld in target_schema:
        if fld.name in table.column_names:
            c = table.column(fld.name)
            if c.type != fld.type:
                c = pc.cast(c, fld.type)
            cols.append(c)
        elif fld.name in defaults:
            cols.append(pa.array([defaults[fld.name]] * n, type=fld.type))
        else:
            cols.append(pa.nulls(n, type=fld.type))
    return pa.table(cols, schema=target_schema)


def _group_boundaries(sorted_keys: list[np.ndarray | pa.Array], n: int) -> np.ndarray:
    """Boolean array: True where row i starts a new PK group (row 0 = True)."""
    starts = np.zeros(n, dtype=bool)
    if n == 0:
        return starts
    starts[0] = True
    for k in sorted_keys:
        if isinstance(k, np.ndarray):
            neq = k[1:] != k[:-1]
        else:  # arrow array (strings etc.)
            neq = np.asarray(pc.not_equal(k.slice(1), k.slice(0, len(k) - 1)))
            neq = np.where(np.isnan(neq.astype(float)), True, neq).astype(bool) if neq.dtype != bool else neq
        starts[1:] |= neq
    return starts


def _key_column(arr: pa.ChunkedArray | pa.Array):
    """Key column as a zero-copy-ish comparable array for boundary detection."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_date(t)
        or pa.types.is_time(t)
        or pa.types.is_timestamp(t)
    ):
        return np.asarray(arr)
    return arr  # strings/binary: compare with arrow kernels


def _segmented_last_valid(valid: np.ndarray, group_id: np.ndarray, n: int) -> np.ndarray:
    """For each row (in sorted order), the index of the last valid row seen so
    far within its group, or -1.  One maximum.accumulate over an offset
    encoding keeps it fully vectorized."""
    idx = np.where(valid, np.arange(n, dtype=np.int64), -1)
    offset = group_id.astype(np.int64) * np.int64(n + 1)
    running = np.maximum.accumulate(idx + offset) - offset
    return running  # -1 where no valid row yet in this group


def merge_sorted_tables(
    tables: list[pa.Table],
    primary_keys: list[str],
    *,
    merge_operators: dict[str, str] | None = None,
    target_schema: pa.Schema | None = None,
    defaults: dict | None = None,
) -> pa.Table:
    """Merge file runs (ordered oldest → newest) into one deduplicated table.

    Rows are grouped by primary key; within a group the *later* (newer) row
    wins for UseLast semantics.  Input tables need not be pre-sorted — the
    merge does one stable multi-key sort (ties preserve input order, which
    encodes file version order)."""
    from lakesoul_tpu_torch.obs import registry

    started = time.perf_counter()
    acc = {"fill": 0.0}
    out = _merge_sorted_tables(
        tables,
        primary_keys,
        merge_operators=merge_operators,
        target_schema=target_schema,
        defaults=defaults,
        _stage_acc=acc,
    )
    total = time.perf_counter() - started
    registry().histogram("lakesoul_io_merge_seconds").observe(total)
    registry().counter("lakesoul_io_merge_rows_total").inc(len(out))
    # stage attribution: the schema-uniform (cast/null-fill) leg counts as
    # "fill", everything else — sort/loser-tree/gather — as "merge", so the
    # two stages stay additive in the scan breakdown
    if acc["fill"]:
        stage_histogram("fill").observe(acc["fill"])
    stage_histogram("merge").observe(max(0.0, total - acc["fill"]))
    return out


def _merge_sorted_tables(
    tables: list[pa.Table],
    primary_keys: list[str],
    *,
    merge_operators: dict[str, str] | None = None,
    target_schema: pa.Schema | None = None,
    defaults: dict | None = None,
    _stage_acc: dict | None = None,
) -> pa.Table:
    merge_operators = merge_operators or {}
    for colname, op in merge_operators.items():
        if op not in MERGE_OPERATORS:
            raise IOError_(f"unknown merge operator {op!r} for column {colname!r}")
        if colname in primary_keys:
            raise IOError_(f"merge operator on primary key column {colname!r}")

    if target_schema is None:
        target_schema = tables[0].schema
    fill0 = time.perf_counter()
    uniformed = [uniform_table(t, target_schema, defaults) for t in tables]
    if _stage_acc is not None:
        _stage_acc["fill"] = time.perf_counter() - fill0
    # chunk-list concat only (zero-copy): the fast paths below gather
    # straight from the concatenated runs' chunks, so the combine_chunks
    # copy — once the single largest merge-apply cost per window — is
    # deferred until the argsort fallback actually needs contiguity
    big = pa.concat_tables(uniformed)
    n = len(big)
    if n == 0:
        return big
    if not primary_keys:
        return big

    # fast path: null-free PKs over already-sorted runs (the writer sorts
    # every PK cell) → native loser-tree merge, no argsort.  Single int64 or
    # string keys merge directly; composite fixed-width keys merge through a
    # memcomparable byte encoding.
    if not merge_operators:
        fast = None
        if len(primary_keys) == 1:
            fast = _native_merge_fast_path(big, uniformed, primary_keys[0])
        if fast is None:
            # covers composite keys AND single fixed-width keys the direct
            # helper declines (int32/float/date/... → memcomparable bytes)
            fast = _native_merge_composite_fast_path(big, uniformed, primary_keys)
        if fast is not None:
            return fast

    big = big.combine_chunks()
    # sort by PK columns with an explicit row-order tiebreaker: pyarrow's sort
    # is not documented stable, and ties must keep concat order (= file
    # version order) for "last wins" semantics
    order = pa.array(np.arange(n, dtype=np.int64))
    big_with_order = big.append_column("__row_order", order)
    sort_idx = np.asarray(
        pc.sort_indices(
            big_with_order,
            sort_keys=[(k, "ascending") for k in primary_keys] + [("__row_order", "ascending")],
        )
    ).astype(np.int64)

    sorted_keys = [_key_column(big.column(k).take(pa.array(sort_idx))) for k in primary_keys]
    starts = _group_boundaries(sorted_keys, n)
    group_id = np.cumsum(starts) - 1
    num_groups = int(group_id[-1]) + 1
    group_start_pos = np.nonzero(starts)[0]
    group_end_pos = np.append(group_start_pos[1:], n) - 1

    # rows chosen by plain UseLast: the newest row of each group
    last_row_idx = sort_idx[group_end_pos]
    base = big.take(pa.array(last_row_idx))

    if not merge_operators:
        return base

    # source-file id per original row (for SumLast / JoinedLast sub-grouping)
    file_lengths = np.array([len(t) for t in uniformed], dtype=np.int64)
    file_offsets = np.cumsum(file_lengths)
    file_id_of_row = np.searchsorted(file_offsets, np.arange(n, dtype=np.int64), side="right")

    out_columns = {}
    for colname, op in merge_operators.items():
        if op == "UseLast":
            continue  # base already has it
        column = big.column(colname).combine_chunks()
        if op == "UseLastNotNull":
            # gather+fill in ONE pass from the UNSORTED column: the winning
            # source row per group is sort_idx[last_valid], no-winner groups
            # get index -1 (→ null) — composing the indices replaces the
            # full-column take + group-tail take + if_else null-fill trio
            valid = np.asarray(column.is_valid())[sort_idx]
            last_valid = _segmented_last_valid(valid, group_id, n)[group_end_pos]
            has_value = last_valid >= 0
            src_idx = np.where(
                has_value, sort_idx[np.where(has_value, last_valid, 0)], -1
            )
            out_columns[colname] = _gather_fill(column, src_idx)
            continue
        col_sorted = column.take(pa.array(sort_idx))
        if op in ("SumAll", "SumLast"):
            npvals = np.asarray(col_sorted.fill_null(0))
            valid = np.asarray(col_sorted.is_valid())
            if op == "SumLast":
                # only rows from the newest file present in each group count
                sorted_file_id = file_id_of_row[sort_idx]
                last_file = sorted_file_id[group_end_pos]  # per group
                keep = sorted_file_id == last_file[group_id]
                npvals = np.where(keep, npvals, 0)
                valid = valid & keep
            sums = np.add.reduceat(npvals, group_start_pos)
            any_valid = np.bitwise_or.reduceat(valid, group_start_pos)
            arr = pa.array(sums).cast(column.type)
            if not any_valid.all():
                arr = pc.if_else(pa.array(any_valid), arr, pa.nulls(num_groups, column.type))
            out_columns[colname] = arr
        elif op.startswith("Joined"):
            sep = "," if op.endswith("Comma") else ";"
            last_only = "Last" in op
            keep = np.asarray(col_sorted.is_valid())
            if last_only:
                # only rows from the newest file present in each group join
                sorted_file_id = file_id_of_row[sort_idx]
                last_file = sorted_file_id[group_end_pos]
                keep = keep & (sorted_file_id == last_file[group_id])
            if pa.types.is_string(column.type) or pa.types.is_large_string(column.type):
                # vectorized: gather kept strings in order, wrap them in a
                # per-group ListArray, and join each list with ONE kernel
                # call (no per-row Python)
                kept = col_sorted.take(pa.array(np.nonzero(keep)[0]))
                counts = np.add.reduceat(keep.astype(np.int64), group_start_pos)
                offsets = np.concatenate([[0], np.cumsum(counts)])
                lists = pa.ListArray.from_arrays(
                    pa.array(offsets, type=pa.int32()), pc.cast(kept, pa.string())
                )
                joined_arr = pc.binary_join(lists, sep)
                empty = pa.array(counts == 0)
                out_columns[colname] = pc.if_else(
                    empty, pa.nulls(num_groups, pa.string()), joined_arr
                )
            else:
                # non-string joins keep python str() semantics ("1.0" not "1")
                pyvals = col_sorted.to_pylist()
                joined: list[str | None] = []
                for g in range(num_groups):
                    s, e = group_start_pos[g], group_end_pos[g] + 1
                    vals = [
                        pyvals[i] for i in range(s, e) if keep[i] and pyvals[i] is not None
                    ]
                    joined.append(sep.join(map(str, vals)) if vals else None)
                out_columns[colname] = pa.array(joined, type=pa.string())
        else:  # pragma: no cover
            raise IOError_(f"unhandled merge operator {op}")

    if out_columns:
        arrays = []
        for fld in base.schema:
            arrays.append(out_columns.get(fld.name, base.column(fld.name)))
        base = pa.table(arrays, schema=base.schema)
    return base


# byte width → same-width unsigned view for the native gather (bit patterns
# only; the Arrow type on the rebuilt array restores the semantics)
_WIDTH_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _native_gather_array(arr: pa.Array, idx: np.ndarray) -> pa.Array | None:
    """One column's gather+fill through the native kernels
    (``ls_gather_fixed`` + ``ls_gather_valid_bits``): rows at ``idx``,
    negative index → null.  Returns None when the layout isn't a
    fixed-width primitive (caller falls back to pyarrow)."""
    from lakesoul_tpu_torch import native

    if not native.available():
        return None
    t = arr.type
    width = _fixed_width_of(t)
    if width is None:
        return None
    dt = _WIDTH_DTYPE[width]
    bufs = arr.buffers()
    if len(bufs) != 2 or bufs[1] is None:
        return None
    src = np.frombuffer(bufs[1], dtype=dt, count=arr.offset + len(arr))[arr.offset:]
    n = len(idx)
    out = native.gather_fixed(src, idx)
    has_fill = bool(n) and bool(idx.min() < 0)
    if arr.null_count or has_fill:
        if arr.null_count:
            if bufs[0] is None:
                return None
            vsrc = np.frombuffer(bufs[0], dtype=np.uint8)
            vbits, nulls = native.gather_valid_bits(vsrc, arr.offset, idx)
        else:
            vbits, nulls = native.gather_valid_bits(None, 0, idx)
        return pa.Array.from_buffers(
            t, n, [pa.py_buffer(vbits), pa.py_buffer(out)], null_count=nulls
        )
    return pa.Array.from_buffers(t, n, [None, pa.py_buffer(out)], null_count=0)


def _single_chunk(col) -> pa.Array | None:
    if isinstance(col, pa.Array):
        return col
    if col.num_chunks == 1:
        return col.chunk(0)
    if col.num_chunks == 0:
        return None
    combined = col.combine_chunks()
    return combined if isinstance(combined, pa.Array) else combined.chunk(0)


def _gather_fill(col, idx: np.ndarray):
    """Gather rows at ``idx`` with negative → null: native single pass where
    the layout allows, else the pyarrow take + if_else null-fill pair."""
    arr = _single_chunk(col)
    if arr is not None:
        out = _native_gather_array(arr, idx)
        if out is not None:
            return out
    has_fill = bool(len(idx)) and bool(idx.min() < 0)
    if not has_fill:
        return col.take(pa.array(idx))
    vals = col.take(pa.array(np.where(idx < 0, 0, idx)))
    return pc.if_else(pa.array(idx >= 0), vals, pa.nulls(len(idx), col.type))


def _fixed_width_of(t: pa.DataType) -> int | None:
    """Byte width for the native gather, or None for ineligible layouts."""
    if pa.types.is_dictionary(t):
        return None
    try:
        bit_width = t.bit_width
    except ValueError:
        return None  # var-width (string/binary) or nested
    if bit_width % 8 or pa.types.is_boolean(t) or pa.types.is_nested(t):
        return None
    width = bit_width // 8
    return width if width in _WIDTH_DTYPE else None


def take_indices(table: pa.Table, indices: np.ndarray) -> pa.Table:
    """Merge-apply gather+fill over a whole table (the native entry point
    the loser-tree fast paths feed): rows at ``indices``, negative index →
    null cells.  All null-free fixed-width columns — CHUNKED included, so
    the caller never pays a combine_chunks copy — gather in ONE
    ``ls_gather_multi_chunked`` call; columns with nulls go through the
    per-column gather+fill; anything else falls back to pyarrow ``take``.
    Byte-equivalent to ``table.take(pa.array(indices))`` for non-negative
    indices (asserted in tests/test_native.py)."""
    from lakesoul_tpu_torch import native

    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n_out = len(indices)
    if len(table) == 0 or n_out == 0:
        return table.slice(0, 0)

    arrays: list = [None] * table.num_columns
    # (col_idx, width, [(chunk_len, data_buffer, chunk_offset)])
    multi: list[tuple[int, int, list[tuple[int, object, int]]]] = []
    # fill rows present: the multi-chunk resolution below maps a -1 through
    # searchsorted into a bogus (chunk, local) pair, so every column must go
    # through the per-column gather+fill path, which honors negative → null
    use_native = native.available() and not bool(indices.min() < 0)
    for i, fld in enumerate(table.schema):
        col = table.column(i)
        chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
        width = _fixed_width_of(fld.type) if use_native else None
        if width is not None and col.null_count == 0:
            metas = []
            for c in chunks:
                if len(c) == 0:
                    continue
                bufs = c.buffers()
                if len(bufs) != 2 or bufs[1] is None:
                    metas = None
                    break
                metas.append((len(c), bufs[1], c.offset))
            if metas is not None:
                multi.append((i, width, metas))
                continue
        arrays[i] = _gather_fill(col, indices)

    if multi:
        # columns almost always share one chunk layout (the runs); resolve
        # each group's global row ids to (chunk, local) ONCE with a
        # vectorized searchsorted, then gather every column in one C call
        groups: dict[tuple, list[tuple[int, int, list]]] = {}
        for entry in multi:
            sig = tuple(m[0] for m in entry[2])
            groups.setdefault(sig, []).append(entry)
        outs = []
        for sig, cols in groups.items():
            if len(sig) == 1:
                chunk_of = np.zeros(n_out, dtype=np.int32)
                local = indices
            else:
                bounds = np.cumsum(np.array(sig, dtype=np.int64))
                chunk_of = np.searchsorted(
                    bounds, indices, side="right"
                ).astype(np.int32)
                starts = np.concatenate([[0], bounds[:-1]])
                local = indices - starts[chunk_of]
            addrs: list[int] = []
            counts = np.empty(len(cols), dtype=np.int32)
            widths = np.empty(len(cols), dtype=np.int64)
            out_addrs = np.empty(len(cols), dtype=np.uint64)
            for j, (i, width, metas) in enumerate(cols):
                for _len, buf, off in metas:
                    addrs.append(buf.address + off * width)
                counts[j] = len(metas)
                widths[j] = width
                out = np.empty(n_out, dtype=_WIDTH_DTYPE[width])
                outs.append((i, width, out))
                out_addrs[j] = out.ctypes.data
            native.gather_multi_chunked(
                np.array(addrs, dtype=np.uint64),
                counts, widths, chunk_of,
                np.ascontiguousarray(local, dtype=np.int64), out_addrs,
            )
        for i, _width, out in outs:
            arrays[i] = pa.Array.from_buffers(
                table.schema.field(i).type, n_out,
                [None, pa.py_buffer(out)], null_count=0,
            )
    return pa.table(arrays, schema=table.schema)


def _native_merge_fast_path(big: pa.Table, uniformed: list[pa.Table], pk: str):
    """C++ loser-tree merge (native/src/lakesoul_native.cc ls_merge_i64 /
    ls_merge_bytes) when the key column is a null-free int64 or
    string/binary and each input run is sorted.  Returns None when
    preconditions don't hold (caller falls back to the argsort path)."""
    from lakesoul_tpu_torch import native

    if not native.available():
        return None
    col = big.column(pk)
    if col.null_count:
        return None
    lengths = np.array([len(t) for t in uniformed], dtype=np.int64)
    run_offsets = np.concatenate([[0], np.cumsum(lengths)])

    t = col.type
    if pa.types.is_signed_integer(t) and t.bit_width == 64:
        keys = np.asarray(col).astype(np.int64, copy=False)
        # INT64_MAX is the C++ merge's run-exhausted sentinel
        if len(keys) and keys.max() == np.iinfo(np.int64).max:
            return None
        # already-merged degeneracy: globally strictly-increasing keys mean
        # every key is unique and already in merge order (the compacted /
        # single-sorted-run steady state) — the answer IS the input, no
        # loser tree, no gather
        if len(keys) < 2 or np.all(keys[1:] > keys[:-1]):
            return big
        for a, b in zip(run_offsets[:-1], run_offsets[1:]):
            if b - a > 1 and not np.all(keys[a + 1 : b] >= keys[a : b - 1]):
                return None  # run not sorted; vectorized path handles it
        order, tail, _groups = native.merge_sorted_runs_i64(keys, run_offsets)
        return take_indices(big, order[tail])

    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t) or pa.types.is_large_binary(t):
        chunk = col.combine_chunks()
        if isinstance(chunk, pa.ChunkedArray):
            if chunk.num_chunks != 1:
                return None
            chunk = chunk.chunk(0)
        n = len(chunk)
        if n < 2:
            return big  # 0/1 rows: trivially merged
        inc = pc.min(pc.greater(chunk.slice(1), chunk.slice(0, n - 1))).as_py()
        if inc:  # strictly increasing: unique + merge-ordered already
            return big
        for a, b in zip(run_offsets[:-1], run_offsets[1:]):
            if b - a > 1:
                lo = chunk.slice(a, b - a - 1)
                hi = chunk.slice(a + 1, b - a - 1)
                ok = pc.min(pc.greater_equal(hi, lo)).as_py()
                if not ok:
                    return None
        data, offsets = _arrow_bytes_layout(chunk)
        if data is None:
            return None
        order, tail, _groups = native.merge_sorted_runs_bytes(data, offsets, run_offsets)
        return take_indices(big, order[tail])

    return None


def _native_merge_composite_fast_path(
    big: pa.Table, uniformed: list[pa.Table], pks: list[str]
):
    """Composite PKs through the byte loser tree: encode each key tuple as a
    fixed-width MEMCOMPARABLE byte string (big-endian, sign-bit flipped for
    signed ints, IEEE-754 order-flip for floats) so bytewise lexicographic
    order equals tuple order, then run ls_merge_bytes.  Covers fixed-width
    key columns (ints/floats/dates/timestamps/bools); anything else falls
    back to the argsort path."""
    from lakesoul_tpu_torch import native

    if not native.available():
        return None
    n = len(big)
    if n == 0:
        return None
    parts = []
    for k in pks:
        col = big.column(k)
        if col.null_count:
            return None
        enc = _memcomparable_fixed(col)
        if enc is None:
            return None
        parts.append(enc)
    encoded = np.concatenate(parts, axis=1)  # [n, total_width] uint8
    width = encoded.shape[1]

    lengths = np.array([len(t) for t in uniformed], dtype=np.int64)
    run_offsets = np.concatenate([[0], np.cumsum(lengths)])
    if _strictly_increasing_bytes(encoded):
        return big  # unique + merge-ordered already (compacted steady state)
    if not _runs_sorted_bytes(encoded, run_offsets):
        return None
    data = np.ascontiguousarray(encoded).reshape(-1)
    offsets = (np.arange(n + 1, dtype=np.int64) * width)
    order, tail, _groups = native.merge_sorted_runs_bytes(data, offsets, run_offsets)
    return take_indices(big, order[tail])


def _memcomparable_fixed(col: pa.ChunkedArray) -> np.ndarray | None:
    """[n, w] uint8 whose bytewise order equals the column's value order, or
    None for unsupported types."""
    t = col.type
    if pa.types.is_boolean(t):
        return np.asarray(col).astype(np.uint8)[:, None]
    if pa.types.is_integer(t):
        vals = np.asarray(col)
        w = t.bit_width // 8
        udt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[w]
        u = vals.astype(udt, copy=True)
        if pa.types.is_signed_integer(t):
            u ^= udt(1) << udt(t.bit_width - 1)  # flip sign bit → unsigned order
        return u[:, None].view(np.uint8).reshape(len(u), w)[:, ::-1]  # big-endian
    if pa.types.is_floating(t):
        vals = np.asarray(col)
        if np.isnan(vals).any():
            # arrow sorts every NaN last regardless of sign; the bit encoding
            # would order negative NaN first — fall back
            return None
        # -0.0 and +0.0 are EQUAL keys but have different bit patterns:
        # canonicalize so the byte order agrees with value equality
        vals = np.where(vals == 0.0, 0.0, vals)
        w = t.bit_width // 8
        udt = {2: np.uint16, 4: np.uint32, 8: np.uint64}[w]
        u = vals.view(udt).copy()
        # IEEE-754 total order: positives flip the sign bit, negatives flip all
        neg = (u >> udt(t.bit_width - 1)) != 0
        u[neg] = ~u[neg]
        u[~neg] ^= udt(1) << udt(t.bit_width - 1)
        return u[:, None].view(np.uint8).reshape(len(u), w)[:, ::-1]
    if pa.types.is_date(t) or pa.types.is_timestamp(t) or pa.types.is_time(t):
        # go through an arrow cast: np.asarray of time32/time64 yields
        # datetime.time OBJECTS whose astype(int64) raises
        try:
            vals = np.asarray(col.cast(pa.int64()))
        except (pa.lib.ArrowInvalid, pa.lib.ArrowNotImplementedError):
            return None
        u = vals.astype(np.uint64) ^ (np.uint64(1) << np.uint64(63))
        return u[:, None].view(np.uint8).reshape(len(u), 8)[:, ::-1]
    return None


def _strictly_increasing_bytes(encoded: np.ndarray) -> bool:
    """Consecutive encoded rows strictly increasing bytewise (vectorized):
    the whole concat is already unique and in merge order."""
    if len(encoded) < 2:
        return True
    a = encoded[:-1]
    b = encoded[1:]
    neq = a != b
    any_neq = neq.any(axis=1)
    if not any_neq.all():
        return False  # an equal neighbor pair: duplicate keys
    first = np.argmax(neq, axis=1)
    rows = np.arange(len(a))
    return bool(np.all(b[rows, first] > a[rows, first]))


def _runs_sorted_bytes(encoded: np.ndarray, run_offsets: np.ndarray) -> bool:
    """Each run's encoded rows nondecreasing bytewise (vectorized)."""
    a = encoded[:-1]
    b = encoded[1:]
    neq = a != b
    any_neq = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    rows = np.arange(len(a))
    decreasing = any_neq & (b[rows, first] < a[rows, first])
    if not decreasing.any():
        return True
    # a decrease is only a violation INSIDE a run (run boundaries may drop)
    bad = np.nonzero(decreasing)[0] + 1  # index of the smaller row
    boundary = set(int(x) for x in run_offsets[1:-1])
    return all(int(i) in boundary for i in bad)


def _arrow_bytes_layout(chunk: pa.Array):
    """(data uint8, offsets int64) view of a string/binary array, or
    (None, None) when the buffers aren't directly addressable."""
    bufs = chunk.buffers()
    if len(bufs) < 3 or bufs[1] is None or bufs[2] is None:
        return None, None
    n = len(chunk)
    width = 8 if pa.types.is_large_string(chunk.type) or pa.types.is_large_binary(chunk.type) else 4
    dtype = np.int64 if width == 8 else np.int32
    offsets = np.frombuffer(
        bufs[1], dtype=dtype, count=n + 1, offset=chunk.offset * width
    ).astype(np.int64, copy=False)
    data = np.frombuffer(bufs[2], dtype=np.uint8)
    return data, offsets


def apply_cdc_filter(table: pa.Table, cdc_column: str) -> pa.Table:
    """Drop rows whose CDC row-kind marks a delete (after merge, a key whose
    newest row is a delete disappears from the read)."""
    if cdc_column not in table.column_names:
        return table
    mask = pc.not_equal(table.column(cdc_column), pa.scalar(CDC_DELETE))
    mask = pc.fill_null(mask, True)
    return table.filter(mask)
