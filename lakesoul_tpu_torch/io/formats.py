"""Physical file-format registry.

The reference dispatches Parquet vs Vortex per file extension behind a
``PhysicalFormat`` trait + ``LakeSoulFormatRegistry``
(rust/lakesoul-io/src/file_format.rs:46-150, file_format/vortex.rs).  Same
seam here: every read/write goes through a format object resolved from the
path, so formats can mix freely inside one partition.  The second format is
**Arrow IPC / Feather v2** — Vortex has no Python implementation, and IPC is
the TPU-first substitute: zero-copy mmap decode straight into the delivery
pipeline (PARITY.md records the substitution).

Formats must preserve two invariants the rest of the stack depends on:
row order within a file (= PK sort order for PK cells) and exact schema
round-tripping.
"""

from __future__ import annotations

from typing import Iterator

import pyarrow as pa
import pyarrow.dataset as pads

from lakesoul_tpu_torch.errors import IOError_
from lakesoul_tpu_torch.io.object_store import filesystem_for


def _is_local(fs) -> bool:
    import fsspec.implementations.local

    return isinstance(fs, fsspec.implementations.local.LocalFileSystem)


class PhysicalFormat:
    """One storage format: how to scan, stream, and write a single file."""

    name: str = ""
    extensions: tuple[str, ...] = ()
    # pyarrow.dataset format object (or name) used for scans
    _ds_format: object = None

    # ------------------------------------------------------------------ read
    def read_table(
        self,
        path: str,
        *,
        columns: list[str] | None = None,
        arrow_filter=None,
        storage_options: dict | None = None,
        zone_predicates=None,
    ) -> pa.Table:
        """Materialize one file with projection + best-effort filter pushdown.

        ``zone_predicates`` are (col, op, value) conjuncts each NECESSARY for
        a row to match — formats with chunk statistics (LSF) skip chunks they
        refute; parquet ignores them (its row-group pruning rides
        ``arrow_filter``).

        Schema evolution: a file written before add_columns may be missing
        projected columns — they are dropped here and null-filled by the
        caller (uniform_table); a filter referencing a missing column is
        skipped and re-applied exactly post-merge."""
        fs, p = filesystem_for(path, storage_options)
        ds = self._dataset(fs, p)
        try:
            return ds.to_table(columns=columns, filter=arrow_filter)
        except (pa.lib.ArrowInvalid, KeyError):
            avail = set(ds.schema.names)
            cols = [c for c in columns if c in avail] if columns is not None else None
            try:
                return ds.to_table(columns=cols, filter=arrow_filter)
            except (pa.lib.ArrowInvalid, KeyError):
                return ds.to_table(columns=cols)

    def iter_batches(
        self,
        path: str,
        *,
        columns: list[str] | None = None,
        arrow_filter=None,
        batch_size: int = 65_536,
        storage_options: dict | None = None,
        zone_predicates=None,
    ) -> Iterator[pa.RecordBatch]:
        """Stream one file without materializing it (streaming MOR path)."""
        fs, p = filesystem_for(path, storage_options)
        ds = self._dataset(fs, p)
        avail = set(ds.schema.names)
        cols = columns
        flt = arrow_filter
        if cols is not None and not set(cols) <= avail:
            cols = [c for c in cols if c in avail]
        # fully synchronous scan: no readahead, no scan threads.  With
        # use_threads the scanner races ahead and materializes the whole
        # fragment regardless of readahead; even readahead=2 queues several
        # row groups per stream.  This path exists to bound memory; overlap
        # lives across file streams / scan units (io_threads), not inside one.
        opts = dict(
            batch_size=batch_size,
            batch_readahead=0,
            fragment_readahead=0,
            use_threads=False,
        )
        scan_opts = self._stream_scan_options()
        if scan_opts is not None:
            opts["fragment_scan_options"] = scan_opts
        if flt is not None:
            try:
                scanner = ds.scanner(columns=cols, filter=flt, **opts)
                yield from scanner.to_batches()
                return
            except (pa.lib.ArrowInvalid, KeyError):
                pass  # filter references a column this file predates
        scanner = ds.scanner(columns=cols, **opts)
        yield from scanner.to_batches()

    def _dataset(self, fs, p) -> pads.Dataset:
        return pads.dataset(p, format=self._ds_format, filesystem=fs)

    def _stream_scan_options(self):
        """Per-format scan options for the bounded-memory streaming path."""
        return None

    # ----------------------------------------------------------------- write
    def write_table(self, table: pa.Table, path: str, *, config=None) -> int:
        """Write one file; returns its size in bytes."""
        raise NotImplementedError

    def read_schema(self, path: str, storage_options: dict | None = None) -> pa.Schema:
        fs, p = filesystem_for(path, storage_options)
        return self._dataset(fs, p).schema

    def count_rows(self, path: str, storage_options: dict | None = None) -> int:
        """Row count WITHOUT decoding data (count-only scans — the role of
        the reference's EmptyScanCountExec shortcut, session.rs:1036)."""
        fs, p = filesystem_for(path, storage_options)
        return self._dataset(fs, p).count_rows()


class ParquetFormat(PhysicalFormat):
    """Parquet via pyarrow: row-group filter pushdown on scan, mmap decode for
    local files (role of the reference's LakeSoulParquetFormat,
    file_format.rs:150)."""

    name = "parquet"
    extensions = (".parquet",)
    _ds_format = "parquet"

    def _stream_scan_options(self):
        # pre_buffer coalesces + caches the raw column chunks of a whole
        # fragment (~file size of extra RSS) — good for one-shot materialize,
        # fatal for the bounded-memory stream.  Trade: more, smaller reads on
        # remote stores, which the block cache absorbs.
        return pads.ParquetFragmentScanOptions(pre_buffer=False)

    def read_table(self, path, *, columns=None, arrow_filter=None,
                   storage_options=None, zone_predicates=None):
        if arrow_filter is not None:
            return super().read_table(
                path, columns=columns, arrow_filter=arrow_filter,
                storage_options=storage_options,
            )
        import pyarrow.parquet as pq

        fs, p = filesystem_for(path, storage_options)
        local = _is_local(fs)
        # partitioning=None: these are SINGLE data files addressed by the
        # scan plan — pq.read_table's default hive inference would derive a
        # dictionary-typed partition field from reference-layout paths
        # (.../date=2024-01-01/part-*.parquet) and collide with the file's
        # own physical column; partition values come from partition_desc
        # metadata, never from path sniffing
        try:
            if local:
                # local files: memory-map instead of read-into-buffer (~1.5x)
                return pq.read_table(
                    p, columns=columns, memory_map=True, partitioning=None
                )
            return pq.read_table(p, columns=columns, filesystem=fs, partitioning=None)
        except (pa.lib.ArrowInvalid, KeyError):
            avail = set(
                pq.read_schema(p, filesystem=None if local else fs, memory_map=local).names
            )
            cols = [c for c in columns if c in avail] if columns is not None else None
            if local:
                return pq.read_table(p, columns=cols, memory_map=True, partitioning=None)
            return pq.read_table(p, columns=cols, filesystem=fs, partitioning=None)

    def count_rows(self, path, storage_options=None):
        import pyarrow.parquet as pq

        fs, p = filesystem_for(path, storage_options)
        local = _is_local(fs)
        # footer-only read: no column data touched
        meta = pq.read_metadata(p, filesystem=None if local else fs, memory_map=local)
        return meta.num_rows

    def write_table(self, table, path, *, config=None):
        import pyarrow.parquet as pq

        compression = getattr(config, "compression", "lz4") if config else "lz4"
        level = getattr(config, "compression_level", None) if config else None
        row_group = getattr(config, "max_row_group_size", 250_000) if config else 250_000
        opts = dict(storage_options_of(config))
        fs, p = filesystem_for(path, opts, write=True)
        pq.write_table(
            table,
            p,
            filesystem=fs,
            compression=compression,
            # level only applies to leveled codecs (zstd/gzip/brotli)
            compression_level=level if compression in ("zstd", "gzip", "brotli") else None,
            use_dictionary=False,
            row_group_size=row_group,
        )
        return fs.size(p)


class ArrowIpcFormat(PhysicalFormat):
    """Arrow IPC file (Feather v2): the second physical format.  Decode is a
    zero-copy mmap for local/cached files — the cheapest possible path into
    the host→HBM pipeline (the role Vortex's fast decode plays in the
    reference, file_format/vortex.rs)."""

    name = "arrow"
    extensions = (".arrow", ".feather", ".ipc")
    _ds_format = "feather"

    def write_table(self, table, path, *, config=None):
        compression = getattr(config, "compression", "lz4") if config else "lz4"
        if compression == "lz4":
            compression = "lz4_frame"
        if compression not in ("lz4_frame", "zstd"):
            compression = "lz4_frame"  # ipc supports lz4/zstd only
        opts = dict(storage_options_of(config))
        fs, p = filesystem_for(path, opts, write=True)
        ipc_opts = pa.ipc.IpcWriteOptions(compression=compression)
        with fs.open(p, "wb") as f:
            with pa.ipc.new_file(f, table.schema, options=ipc_opts) as writer:
                writer.write_table(table)
        return fs.size(p)


class LsfFormat(PhysicalFormat):
    """LSF: the native columnar format (io/lsf.py) — lightweight encodings +
    zero-copy mmap decode, the third registered format (the Vortex role,
    file_format/vortex.rs).  All IO bypasses pyarrow.dataset: the footer
    carries everything."""

    name = "lsf"
    extensions = (".lsf",)

    def _open(self, path, storage_options):
        from lakesoul_tpu_torch.io.lsf import LsfFile

        return LsfFile(path, storage_options)

    def read_table(self, path, *, columns=None, arrow_filter=None,
                   storage_options=None, zone_predicates=None):
        # close the mapping as soon as decode finishes: decoded arrays keep
        # their own reference to the mapped region, but the fd (and on
        # Windows the file-replacement block) is released here, not at GC
        with self._open(path, storage_options) as f:
            return f.read(columns, arrow_filter, zone_predicates=zone_predicates)

    def iter_batches(self, path, *, columns=None, arrow_filter=None,
                     batch_size=65_536, storage_options=None, zone_predicates=None):
        with self._open(path, storage_options) as f:
            yield from f.iter_batches(
                columns, arrow_filter, batch_size, zone_predicates=zone_predicates
            )

    def read_schema(self, path, storage_options=None):
        from lakesoul_tpu_torch.io.lsf import LsfFile

        with LsfFile(path, storage_options, footer_only=True) as f:
            return f.schema

    def count_rows(self, path, storage_options=None):
        # footer-only: local mmap or two ranged GETs, no column data decoded
        from lakesoul_tpu_torch.io.lsf import LsfFile

        with LsfFile(path, storage_options, footer_only=True) as f:
            return f.n_rows

    def write_table(self, table, path, *, config=None):
        from lakesoul_tpu_torch.io.lsf import write_lsf_table

        return write_lsf_table(table, path, config=config)


def storage_options_of(config) -> dict:
    return getattr(config, "object_store_options", None) or {}


_REGISTRY: dict[str, PhysicalFormat] = {}
_BY_NAME: dict[str, PhysicalFormat] = {}
DEFAULT_FORMAT_NAME = "parquet"


def register_format(fmt: PhysicalFormat) -> None:
    _BY_NAME[fmt.name] = fmt
    for ext in fmt.extensions:
        _REGISTRY[ext] = fmt


register_format(ParquetFormat())
register_format(ArrowIpcFormat())
register_format(LsfFormat())


def format_for(path: str) -> PhysicalFormat:
    """Resolve the format from the file extension (reference:
    file_format.rs:46 format-by-extension dispatch); unknown extensions
    default to parquet like the reference's fallback."""
    name = path.rsplit("/", 1)[-1]
    dot = name.rfind(".")
    if dot != -1:
        fmt = _REGISTRY.get(name[dot:].lower())
        if fmt is not None:
            return fmt
    return _BY_NAME[DEFAULT_FORMAT_NAME]


def format_by_name(name: str) -> PhysicalFormat:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise IOError_(
            f"unknown file format {name!r}; registered: {sorted(_BY_NAME)}"
        ) from None
