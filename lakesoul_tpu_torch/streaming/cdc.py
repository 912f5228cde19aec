"""Exactly-once streaming / CDC ingest (the port's copy of
``lakesoul_tpu/streaming/cdc.py``).

Role parity with the reference's Flink sink stack (LakeSoulMultiTablesSink →
NativeParquetWriter → LakeSoulSinkGlobalCommitter.java:128): files are staged
per *checkpoint epoch*, and the epoch commit uses **deterministic commit ids**
(UUIDv5 of table/partition/checkpoint) so a replay after failure is an
idempotent no-op — the same mechanism the Flink committer gets from its
checkpointed commit_id UUIDs (:95 filterRecoveredCommittables), without the
Flink runtime.  The ids are the reference's, so a checkpoint committed
through either package is a replay for the other's.

CDC rows carry a row-kind column (``rowKinds``: insert/update/delete) like
LakeSoulRecordConvert; deletes materialize at read time through the normal
merge + CDC filter path."""

from __future__ import annotations

import uuid
from typing import Iterable

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.io.writer import TableWriter
from lakesoul_tpu_torch.meta.entity import CommitOp
from lakesoul_tpu_torch.meta import DataFileOp

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
        """Flush staged data and commit with checkpoint-derived commit ids.
        Returns the number of partitions committed (0 on replay/no data).

        The commit runs under the shared
        :class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy`: a transient
        store/meta fault retries on the seeded schedule, and because the
        commit ids derive from the checkpoint id, a retry after a
        half-landed attempt is the same idempotent replay a crashed
        process gets — a continuously-ingesting writer (the freshness
        chaos harness's writer role) survives injected flaky faults
        without double-committing an epoch."""
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

    def checkpoint_replace(self, checkpoint_id: int | str) -> int:
        """REPLACE-mode checkpoint: swap the table's ENTIRE content for this
        epoch's staged files without ever dropping the table.

        Partitions that received data get an UPDATE commit (whole-snapshot
        replace with read-version conflict detection); pre-existing
        partitions that did not are emptied with a DELETE commit.  The
        table_id never changes and every commit id derives from the
        checkpoint id, so replaying the same id after a success is an
        idempotent no-op (re-staged duplicate files are dropped as replay
        orphans) — unlike a drop+recreate, a client disconnect mid-stream
        leaves the old data fully intact, and a crash between the two commit
        waves is healed by the replay.  Returns partitions committed."""
        files_by_partition = self._staged_files_by_partition()
        from lakesoul_tpu_torch.errors import CommitConflictError
        from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

        client = self.table.catalog.client
        info = self.table.info
        opts = self.table.io_config().object_store_options

        # a concurrent writer advancing a partition between our head read
        # and the commit raises CommitConflictError; each attempt re-reads
        # fresh heads and re-applies the whole replace
        def attempt() -> int:
            heads = {
                h.partition_desc: h
                for h in client._select_partitions(info, None)
            }
            committed = 0
            if files_by_partition:
                committed += len(client.commit_data_files(
                    info,
                    files_by_partition,
                    CommitOp.UPDATE,
                    commit_id_by_partition={
                        desc: checkpoint_commit_id(info.table_id, desc, checkpoint_id)
                        for desc in files_by_partition
                    },
                    read_partition_info=[
                        heads[d] for d in files_by_partition if d in heads
                    ],
                    storage_options=opts,
                ))
            stale = [
                d for d, h in heads.items()
                if d not in files_by_partition and h.snapshot
            ]
            if stale:
                committed += len(client.commit_data_files(
                    info,
                    {d: [] for d in stale},
                    CommitOp.DELETE,
                    commit_id_by_partition={
                        d: checkpoint_commit_id(
                            info.table_id, d, f"{checkpoint_id}:truncate"
                        )
                        for d in stale
                    },
                    # conflict detection on the DELETE wave too: a
                    # concurrent writer advancing one of these
                    # partitions between our head read and this commit
                    # must raise CommitConflictError (and re-run the
                    # replace against fresh heads) instead of being
                    # silently wiped by the truncate
                    read_partition_info=[heads[d] for d in stale],
                    storage_options=opts,
                ))
            return committed

        return RetryPolicy.from_env(
            max_attempts=5,
            base_delay_s=0.01,
            max_delay_s=0.25,
            classify=lambda e: isinstance(e, CommitConflictError),
        ).run(attempt, op="cdc.checkpoint_replace")

    def adopt_staged(self, other: "CheckpointedWriter | None") -> None:
        """Take over another checkpointed writer's staged-but-uncommitted
        files (schema-evolution handoff: the old writer is retired, this one
        commits its files at the next checkpoint).  The donor is closed and
        must not be written to again."""
        if other is None or other._writer is None:
            return
        donor = other._writer
        donor.flush()
        self._ensure_writer()._staged.extend(donor.take_staged())
        donor._closed = True
        other._writer = None

    def abort(self) -> None:
        if self._writer is not None:
            self._writer.abort()
            self._writer = None

    def close(self) -> None:
        if self._writer is not None:
            self._writer._closed = True
            self._writer = None


class CdcIngestor:
    """Apply CDC change events to a CDC-enabled PK table.

    Events are (op, row_dict) with op ∈ {insert, update, delete} — the shape
    a Debezium-style source produces (reference: entry/JdbcCDC.java →
    LakeSoulRecordConvert).  Deletes only need the primary key columns."""

    def __init__(self, table, *, buffer_rows: int = 10_000):
        info = table.info
        if not info.cdc_column:
            raise ConfigError(
                f"table {info.table_name} is not CDC-enabled (create with cdc=True)"
            )
        if not info.primary_keys:
            raise ConfigError("CDC ingest requires a primary-key table")
        self.table = table
        self.cdc_column = info.cdc_column
        self.buffer_rows = buffer_rows
        self._writer = CheckpointedWriter(table)
        self._pending: list[dict] = []

    def apply(self, op: str, row: dict) -> None:
        if op not in ("insert", "update", "delete"):
            raise ConfigError(f"unknown CDC op {op!r}")
        event = dict(row)
        event[self.cdc_column] = op
        self._pending.append(event)
        if len(self._pending) >= self.buffer_rows:
            self._flush_buffer()

    def apply_many(self, events: Iterable[tuple[str, dict]]) -> None:
        for op, row in events:
            self.apply(op, row)

    def _flush_buffer(self) -> None:
        if not self._pending:
            return
        schema = self.table.schema
        cols = {}
        for fld in schema:
            cols[fld.name] = pa.array(
                [r.get(fld.name) for r in self._pending], type=fld.type
            )
        self._writer.write(pa.table(cols, schema=schema))
        self._pending.clear()

    def checkpoint(self, checkpoint_id: int | str) -> int:
        """Flush buffered events and commit exactly-once for this epoch."""
        self._flush_buffer()
        return self._writer.checkpoint(checkpoint_id)
