"""Ray Data adapter (the port of ``lakesoul_tpu/data/ray_adapter.py``; parity
with LakeSoul's python/src/lakesoul/ray/read_lakesoul.py:60,80 and
write_lakesoul.py:23,99): one read task per scan unit, or per scan-plane
range for ``via_scanplane`` scans; distributed writes stage files on
workers and the driver commits once.  Both halves are host code: the rows
travel as Arrow tables, never through a device.

Ray contract used here (stable public API): ``ray.data.from_items(items)``
treats a MAPPING item as a row (its keys become columns) and wraps any
other item as ``{"item": <obj>}``; ``map_batches(fn, batch_size=1,
batch_format="pandas")`` hands ``fn`` a pandas DataFrame of rows and accepts
a pyarrow Table (of any length) as the return value; ``take_all()`` returns
rows as dicts.  Each scan unit therefore travels as ``{"unit": <dict>}`` —
one object column — never as a bare dict whose keys would explode into
columns.  tests/test_torch_adapters.py pins this contract with the
reference's wire-faithful stub, so the adapter is tested without ray
installed.
"""

from __future__ import annotations


def read_lakesoul(scan):
    """LakeSoulScan → ray.data.Dataset: one read task per scan unit
    (in-process scans) or per scan-plane range (``scan.via_scanplane``
    scans, where tasks pull from the fleet's gateway instead of decoding —
    the same batch-source seam every adapter rides)."""
    try:
        import ray
    except ImportError as e:  # pragma: no cover - ray is an optional dependency
        raise ImportError("ray is required for read_lakesoul") from e

    from lakesoul_tpu_torch.data.batch_source import batch_source_for

    source = batch_source_for(scan)
    if getattr(source, "remote", False):
        payload = source.task_payload()
        items = [
            {"unit": {"scanplane": payload, "seq_index": i}}
            for i in range(source.num_task_ranges())
        ]

        def load_remote(df):
            unit = dict(df["unit"].iloc[0])
            from lakesoul_tpu_torch.scanplane.client import read_task_range

            return read_task_range(unit["scanplane"], unit["seq_index"])

        return ray.data.from_items(items).map_batches(
            load_remote, batch_size=1, batch_format="pandas"
        )

    units = [
        {
            "unit": {
                "data_files": u.data_files,
                "primary_keys": u.primary_keys,
                **scan._unit_kwargs(u),
            }
        }
        for u in scan.scan_plan()
    ]

    def load_batch(df):
        # batch_size=1 → exactly one scan-unit dict per call, in the single
        # "unit" object column built above
        unit = dict(df["unit"].iloc[0])
        files = unit.pop("data_files")
        pks = unit.pop("primary_keys")
        from lakesoul_tpu_torch.io.reader import read_scan_unit

        return read_scan_unit(files, pks, **unit)

    return ray.data.from_items(units).map_batches(
        load_batch, batch_size=1, batch_format="pandas"
    )


def write_lakesoul(dataset, table) -> None:
    """ray.data.Dataset → table: workers stage files via TableWriter, the
    driver commits every staged file in ONE ACID commit (reference: Datasink
    distributed write + driver-side single commit, write_lakesoul.py:99)."""
    try:
        import ray  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError("ray is required for write_lakesoul") from e

    import pandas as pd

    cfg = table.io_config()
    table_path = table.info.table_path

    def stage(batch):
        # emit one plain-typed row per staged file: worker→driver transport
        # must stay arrow-serializable (no dataclass objects in columns)
        import pyarrow as pa

        from lakesoul_tpu_torch.io.writer import TableWriter

        w = TableWriter(cfg, table_path)
        w.write_batch(pa.Table.from_pandas(batch, preserve_index=False))
        outs = w.close()
        return pd.DataFrame(
            {
                "partition_desc": [o.partition_desc for o in outs],
                "path": [o.path for o in outs],
                "size": [o.size for o in outs],
                "file_exist_cols": [o.file_exist_cols for o in outs],
            }
        )

    from lakesoul_tpu_torch.meta import CommitOp, DataFileOp

    staged = dataset.map_batches(stage, batch_format="pandas").take_all()
    files_by_partition: dict[str, list[DataFileOp]] = {}
    for row in staged:
        files_by_partition.setdefault(row["partition_desc"], []).append(
            DataFileOp(
                path=row["path"],
                file_op="add",
                size=row["size"],
                file_exist_cols=row["file_exist_cols"],
            )
        )
    op = CommitOp.MERGE if table.info.primary_keys else CommitOp.APPEND
    table.catalog.client.commit_data_files(
        table.info,
        files_by_partition,
        op,
        storage_options=cfg.object_store_options,
    )
