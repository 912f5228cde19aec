"""Range+hash partitioned Parquet writer.

Capability parity with the reference writer stack (create_writer decision
tree, writer/mod.rs:83-151): rows are split by range-partition values and
Spark-Murmur3 hash buckets, PK-table cells are sorted by primary key before
writing, parquet files are zstd(1) without dictionary encoding
(writer/mod.rs:215-240), file names carry the ``part-<token>_NNNN.parquet``
bucket suffix the scan planner depends on, and ``flush()`` returns the
FlushOutput list the commit protocol consumes (writer/mod.rs:372-430).

Design note: instead of the reference's async exchange
(RepartitionByRangeAndHashExec + channels), the split is one vectorized
hash + argsort per incoming batch — the grouping itself is array work, which
keeps the Python layer thin and lets the C++ core / Pallas take it over
without changing the algorithm.
"""

from __future__ import annotations

import logging
import secrets
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from lakesoul_tpu_torch.errors import IOError_
from lakesoul_tpu_torch.io.config import IOConfig
from lakesoul_tpu_torch.io.formats import format_by_name
from lakesoul_tpu_torch.io.object_store import delete_file, ensure_dir
from lakesoul_tpu_torch.meta.entity import NO_PARTITION_DESC
from lakesoul_tpu_torch.utils import spark_hash


@dataclass
class FlushOutput:
    """One staged file, ready to be committed (reference: FlushOutput list
    returned by SyncSendableMutableLakeSoulWriter::flush_and_close)."""

    partition_desc: str
    path: str
    size: int
    row_count: int
    file_exist_cols: str = ""
    bucket_id: int = -1


def _file_token() -> str:
    return secrets.token_hex(8)


class TableWriter:
    """Buffering writer for one table path.

    write_batch() splits rows into (range-partition, hash-bucket) cells;
    flush() sorts PK cells, writes one parquet file per cell, and returns
    FlushOutputs for the metadata commit.  abort() deletes staged files
    (reference: abort_and_close, writer/mod.rs:432)."""

    def __init__(self, config: IOConfig, table_path: str):
        config.validate_for_write()
        self.config = config
        self.table_path = table_path.rstrip("/")
        self._cells: dict[tuple[str, int], list[pa.Table]] = {}
        self._staged: list[FlushOutput] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._closed = False
        # declared tensor columns (tensorplane/columns.py): the spec is read
        # from the schema ONCE here, and every incoming batch is verified
        # against it — wrong element dtype / width / nulls die at the table
        # boundary with a typed TensorColumnError naming the column, so the
        # on-disk fixed-width buffers are ALWAYS dense and 2-D-ready
        from lakesoul_tpu_torch.tensorplane.columns import tensor_specs

        self._tensor_specs = tensor_specs(config.schema)

    # ------------------------------------------------------------------ write
    def write_batch(self, batch: pa.RecordBatch | pa.Table) -> None:
        if self._closed:
            raise IOError_("writer is closed")
        table = pa.table(batch) if isinstance(batch, pa.RecordBatch) else batch
        if self._tensor_specs:
            # BEFORE the uniform cast: declared tensor columns are strict —
            # exact fixed_size_list width/dtype, no nulls at either level —
            # so a malformed batch raises the typed error naming the
            # column, not a bare ArrowInvalid out of pc.cast
            from lakesoul_tpu_torch.tensorplane.columns import validate_tensor_batch

            validate_tensor_batch(table, self._tensor_specs)
        # align to declared schema (cast, fill missing nullable columns)
        from lakesoul_tpu_torch.io.merge import uniform_table

        table = uniform_table(table, self.config.schema, self.config.default_column_values)
        if len(table) == 0:
            return
        for (desc, bucket), piece in self._split(table).items():
            self._cells.setdefault((desc, bucket), []).append(piece)
        self._buffered_rows += len(table)
        self._buffered_bytes += table.nbytes
        # bounded memory: spill buffered cells to staged sorted files once the
        # row or byte budget is hit (role of the reference's memory pool +
        # sort spill, mem/pool.rs + physical_plan/spill.rs — the staged files
        # ARE the sorted spill runs; the streaming merger re-combines them at
        # read/compaction time, and extra files per cell simply deepen the
        # merge stack until compaction)
        if (
            self._buffered_rows >= self.config.max_file_rows
            or self._buffered_bytes >= self.config.memory_budget_bytes
        ):
            self.flush()

    def _split(self, table: pa.Table) -> dict[tuple[str, int], pa.Table]:
        cfg = self.config
        n = len(table)
        # hash buckets from PK columns (Spark-Murmur3 seed 42, chained)
        if cfg.primary_keys and cfg.hash_bucket_num > 1:
            hashes = spark_hash.hash_columns(
                [table.column(k) for k in cfg.primary_keys], num_rows=n
            )
            buckets = spark_hash.bucket_ids(hashes, cfg.hash_bucket_num)
        elif cfg.primary_keys:
            buckets = np.zeros(n, dtype=np.int64)
        else:
            buckets = np.full(n, -1, dtype=np.int64)

        # range partition descs from partition-column values
        if cfg.range_partitions:
            descs = self._partition_descs(table, n)
            desc_codes, desc_uniques = _factorize(descs)
        else:
            desc_codes = np.zeros(n, dtype=np.int64)
            desc_uniques = [NO_PARTITION_DESC]

        out: dict[tuple[str, int], pa.Table] = {}
        combined = desc_codes * np.int64(max(cfg.hash_bucket_num, 1) + 1) + (buckets + 1)
        for code in np.unique(combined):
            mask = combined == code
            desc = desc_uniques[int(code) // (max(cfg.hash_bucket_num, 1) + 1)]
            bucket = int(code) % (max(cfg.hash_bucket_num, 1) + 1) - 1
            idx = np.nonzero(mask)[0]
            out[(desc, bucket)] = table.take(pa.array(idx))
        return out

    def _partition_descs(self, table: pa.Table, n: int) -> np.ndarray:
        parts = []
        for c in self.config.range_partitions:
            vals = table.column(c).cast(pa.string()).fill_null("__NULL__")
            parts.append(np.asarray(vals, dtype=object))
        descs = np.empty(n, dtype=object)
        for i in range(n):
            descs[i] = ",".join(
                f"{c}={parts[j][i]}" for j, c in enumerate(self.config.range_partitions)
            )
        return descs

    # ------------------------------------------------------------------ flush
    def flush(self) -> list[FlushOutput]:
        """Write every buffered cell to its parquet file and return the staged
        file list.  The writer can keep receiving batches afterwards (each
        flush stages a new set of files)."""
        outputs: list[FlushOutput] = []
        cfg = self.config
        started = time.perf_counter()
        for (desc, bucket), pieces in sorted(self._cells.items()):
            cell = pa.concat_tables(pieces).combine_chunks()
            if cfg.primary_keys:
                order = pa.array(np.arange(len(cell), dtype=np.int64))
                sort_idx = pc.sort_indices(
                    cell.append_column("__row_order", order),
                    sort_keys=[(k, "ascending") for k in cfg.primary_keys]
                    + [("__row_order", "ascending")],
                )
                cell = cell.take(sort_idx)
            # partition columns are directory-encoded, not stored in the file
            file_table = cell.select(
                [f.name for f in cfg.schema if f.name not in cfg.range_partitions]
            )
            fmt = format_by_name(cfg.file_format)
            path = self._target_path(desc, bucket, fmt)
            size = fmt.write_table(file_table, path, config=cfg)
            out = FlushOutput(
                partition_desc=desc,
                path=path,
                size=size,
                row_count=len(file_table),
                file_exist_cols=",".join(file_table.column_names),
                bucket_id=bucket,
            )
            outputs.append(out)
            self._staged.append(out)
        self._cells.clear()
        self._buffered_rows = 0
        self._buffered_bytes = 0
        if outputs and logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "flush staged %d files rows=%d bytes=%d in %.1fms",
                len(outputs),
                sum(o.row_count for o in outputs),
                sum(o.size for o in outputs),
                (time.perf_counter() - started) * 1e3,
            )
        return outputs

    def _target_path(self, desc: str, bucket: int, fmt) -> str:
        dir_path = self.table_path
        if desc != NO_PARTITION_DESC:
            dir_path = f"{dir_path}/{desc.replace(',', '/')}"
        ensure_dir(dir_path, self.config.object_store_options)
        suffix = max(bucket, 0)
        return f"{dir_path}/part-{_file_token()}_{suffix:04d}{fmt.extensions[0]}"

    # ------------------------------------------------------------------ take
    def take_staged(self) -> list[FlushOutput]:
        """Hand ownership of every staged-but-untaken output to the caller
        (for committing).  Taken files are no longer deleted by abort() —
        once committed they are live table data.  Callers that commit must
        use this (or close()) rather than flush()'s return value: write_batch
        may auto-flush on the row budget, staging files between flushes."""
        out = list(self._staged)
        self._staged.clear()
        return out

    # ------------------------------------------------------------------ close
    def close(self) -> list[FlushOutput]:
        """Flush pending data and close; returns all untaken staged outputs."""
        self.flush()
        self._closed = True
        return self.take_staged()

    def abort(self) -> None:
        """Discard buffers and delete every staged file not yet taken for
        commit."""
        self._cells.clear()
        if self._staged:
            logger.info("abort: deleting %d staged files", len(self._staged))
        for out in self._staged:
            delete_file(out.path, self.config.object_store_options, missing_ok=True)
        self._staged.clear()
        self._closed = True


def _factorize(values: np.ndarray) -> tuple[np.ndarray, list]:
    uniques, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int64), list(uniques)
