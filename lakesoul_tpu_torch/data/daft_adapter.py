"""Daft adapter (the port of ``lakesoul_tpu/data/daft_adapter.py``; parity
with LakeSoul's python/src/lakesoul/daft/__init__.py:31,44).

Partition-wise on both sides:

- ``read_lakesoul`` hands daft a LAZY iterator of per-scan-unit Arrow
  tables (the reference's `_iter_lakesoul_tables` shape): each
  (range-partition, hash-bucket) unit decodes and MOR-merges independently,
  so daft starts consuming before the scan finishes and nothing requires
  the whole table in memory at once.
- ``write_lakesoul`` streams ``DataFrame.to_arrow_iter()`` partitions
  through the TableWriter (range+hash split per batch, bounded buffering,
  abort-on-error) and the driver commits every staged file in ONE ACID
  commit — the reference's writer-stream + `_commit_write_result` shape.

daft is an optional dependency; tests/test_torch_adapters.py pins the daft
API surface used here (``from_arrow`` accepting a table OR an iterable of
tables, ``to_arrow_iter`` yielding tables/batches, ``to_arrow`` fallback)
with a wire-faithful stub.
"""

from __future__ import annotations


def read_lakesoul(scan):
    """LakeSoulScan → daft.DataFrame (lazy, one Arrow table per scan unit)."""
    try:
        import daft
    except ImportError as e:  # pragma: no cover - daft is an optional dependency
        raise ImportError("daft is required for read_lakesoul") from e

    units = [
        (u.data_files, u.primary_keys, scan._unit_kwargs(u))
        for u in scan.scan_plan()
    ]
    if not units:
        return daft.from_arrow(scan.to_arrow())  # empty: table carries schema

    def unit_tables():
        from lakesoul_tpu_torch.io.reader import read_scan_unit

        for files, pks, kwargs in units:
            yield read_scan_unit(files, pks, **kwargs)

    return daft.from_arrow(unit_tables())


def write_lakesoul(df, table):
    """daft.DataFrame → table: stream partitions through the writer, commit
    once.  Returns the committed DataFileOps."""
    try:
        import daft  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError("daft is required for write_lakesoul") from e

    to_arrow_iter = getattr(df, "to_arrow_iter", None)
    if to_arrow_iter is not None:
        return table.write_arrow(iter(to_arrow_iter()))
    return table.write_arrow(df.to_arrow())
