"""Exactly-once streaming ingest: the subset of
``lakesoul_tpu/streaming/cdc.py`` that the Flight gateway's DoPut needs.

Role parity with the reference's Flink sink stack (LakeSoulMultiTablesSink →
NativeParquetWriter → LakeSoulSinkGlobalCommitter.java:128): files are staged
per *checkpoint epoch*, and the epoch commit uses **deterministic commit ids**
(UUIDv5 of table/partition/checkpoint) so a replay after failure is an
idempotent no-op.  The ids are the reference's, so a checkpoint committed
through either package's gateway is a replay for the other's."""

from __future__ import annotations

import uuid

import pyarrow as pa

from lakesoul_tpu_torch.io.writer import TableWriter
from lakesoul_tpu_torch.meta import DataFileOp
from lakesoul_tpu_torch.meta.entity import CommitOp

_CHECKPOINT_NS = uuid.UUID("6ba7b811-9dad-11d1-80b4-00c04fd430c8")


def checkpoint_commit_id(table_id: str, partition_desc: str, checkpoint_id: int | str) -> str:
    """Deterministic commit id for (table, partition, checkpoint epoch)."""
    return str(uuid.uuid5(_CHECKPOINT_NS, f"{table_id}/{partition_desc}/{checkpoint_id}"))


class CheckpointedWriter:
    """Stage batches, commit atomically per checkpoint epoch.

    ::

        w = CheckpointedWriter(table)
        w.write(batch); w.write(batch)
        w.checkpoint(7)        # commits everything staged since the last one
        w.checkpoint(7)        # replay → no-op (same deterministic ids)
    """

    def __init__(self, table, *, commit_op: CommitOp | None = None):
        self.table = table
        self.commit_op = commit_op or (
            CommitOp.MERGE if table.info.primary_keys else CommitOp.APPEND
        )
        self._writer: TableWriter | None = None

    def _ensure_writer(self) -> TableWriter:
        if self._writer is None:
            self._writer = TableWriter(self.table.io_config(), self.table.info.table_path)
        return self._writer

    def write(self, batch: pa.RecordBatch | pa.Table) -> None:
        self._ensure_writer().write_batch(batch)

    def _staged_files_by_partition(self) -> dict[str, list[DataFileOp]]:
        """Flush and group this epoch's staged files per partition.
        take_staged, not flush()'s return: write_batch may have auto-flushed
        earlier files of this epoch on the row budget."""
        if self._writer is None:
            return {}
        self._writer.flush()
        files_by_partition: dict[str, list[DataFileOp]] = {}
        for out in self._writer.take_staged():
            files_by_partition.setdefault(out.partition_desc, []).append(
                DataFileOp(path=out.path, file_op="add", size=out.size,
                           file_exist_cols=out.file_exist_cols)
            )
        return files_by_partition

    def checkpoint(self, checkpoint_id: int | str) -> int:
        """Flush staged data and commit with checkpoint-derived commit ids,
        under the shared :class:`RetryPolicy` (a retry after a half-landed
        attempt is the same idempotent replay a crashed process gets).
        Returns the number of partitions committed (0 on replay/no data)."""
        from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

        files_by_partition = self._staged_files_by_partition()
        if not files_by_partition:
            return 0
        commit_ids = {
            desc: checkpoint_commit_id(self.table.info.table_id, desc, checkpoint_id)
            for desc in files_by_partition
        }

        def attempt():
            return self.table.catalog.client.commit_data_files(
                self.table.info,
                files_by_partition,
                self.commit_op,
                commit_id_by_partition=commit_ids,
                storage_options=self.table.io_config().object_store_options,
            )

        committed = RetryPolicy.from_env().run(attempt, op="cdc.checkpoint")
        return len(committed)

    def abort(self) -> None:
        if self._writer is not None:
            self._writer.abort()
            self._writer = None
