"""User-facing catalog API: LakeSoulCatalog / LakeSoulTable / LakeSoulScan.

Python surface parity with the reference's ``python/src/lakesoul/catalog.py``
(LakeSoulCatalog:39, LakeSoulTable:277, LakeSoulScan:596): catalog-backed
table lifecycle, Arrow write + ACID commit, lazy immutable scans with
select/filter/shard, and delivery into PyTorch: ``to_torch_iter`` (fixed-size
batches on the CUDA card, through pinned buffers and a side stream) beside
the reference's ``to_torch`` dataset adapter.

The port's copy of ``lakesoul_tpu/catalog.py``.  The table vector index
(``build_vector_index``, ``vector_search``, ``scan().vector_search``) runs on
the card unless ``device="cpu"`` is passed.  ``via_scanplane`` sources a
scan's batches from a scan-plane gateway.  ``follow`` is the freshness
follower (``freshness/follower.py``): an unbounded, retry-hardened stream over
the table's commit log with an exactly-once resumable position.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Iterator

import numpy as np
import pyarrow as pa

from lakesoul_tpu_torch.errors import CommitConflictError, ConfigError, MetadataError
from lakesoul_tpu_torch.io.config import IOConfig
from lakesoul_tpu_torch.io.filters import Filter, extract_pk_equalities
from lakesoul_tpu_torch.io.reader import iter_scan_unit_batches, read_scan_unit
from lakesoul_tpu_torch.io.writer import TableWriter
from lakesoul_tpu_torch.meta import (
    CommitOp,
    DataFileOp,
    MetaDataClient,
    ScanPlanPartition,
)
from lakesoul_tpu_torch.runtime import pipeline as rt_pipeline
from lakesoul_tpu_torch.meta.entity import (
    CDC_DEFAULT_COLUMN,
    PROP_CDC_CHANGE_COLUMN,
    PROP_HASH_BUCKET_NUM,
    TableInfo,
)
from lakesoul_tpu_torch.utils import spark_hash

# how many times a compaction commit that lost its race to a writer's appends
# may catch up (LakeSoulTable.compact) before it is a conflict
COMPACT_CATCH_UP = 8


class LakeSoulCatalog:
    """Warehouse-rooted catalog over a metadata store."""

    def __init__(
        self,
        warehouse: str,
        *,
        db_path: str | None = None,
        client: MetaDataClient | None = None,
        storage_options: dict | None = None,
    ):
        self.warehouse = str(warehouse).rstrip("/")
        if client is None:
            if db_path is None:
                from lakesoul_tpu_torch.io.object_store import ensure_dir

                ensure_dir(self.warehouse, storage_options)
                db_path = f"{self.warehouse}/.lakesoul_meta.db"
            client = MetaDataClient(db_path=db_path)
        self.client = client
        self.storage_options = storage_options or {}
        self._recover_on_open()
        # scan.cache() storage: LRU of decoded tables, keyed by scan
        # parameters + partition-version digest (commits invalidate naturally).
        # BYTE-bounded, not count-bounded: four 2M-row tables are GBs — the
        # pressure valve must see sizes
        self._scan_cache: dict = {}
        self._scan_cache_max_bytes = 512 << 20
        self._scan_cache_bytes = 0

    def _recover_on_open(self) -> None:
        """Crash-safe open: commits a killed process left between the two
        metadata phases are rolled forward/back before the catalog serves
        its first plan (MetaDataClient.recover_incomplete_commits).  Only
        commits older than ``LAKESOUL_RECOVER_MIN_AGE_MS`` (default 1 h)
        are swept, so live writers sharing the store are never raced; a
        failing recovery must never fail the open itself."""
        import logging
        import os

        raw = os.environ.get("LAKESOUL_RECOVER_MIN_AGE_MS", "").strip()
        try:
            min_age_ms = int(raw) if raw else 3_600_000
        except ValueError:
            min_age_ms = 3_600_000
        try:
            self.client.recover_incomplete_commits(
                min_age_ms=min_age_ms, storage_options=self.storage_options
            )
        except Exception:
            logging.getLogger(__name__).exception(
                "commit recovery on catalog open failed; continuing"
            )

    def _scan_cache_get(self, key):
        hit = self._scan_cache.pop(key, None)
        if hit is not None:
            self._scan_cache[key] = hit  # LRU refresh
        return hit

    def _scan_cache_put(self, key, table) -> None:
        size = table.nbytes
        if size > self._scan_cache_max_bytes:
            return  # larger than the whole budget: caching it evicts everything
        prev = self._scan_cache.pop(key, None)
        if prev is not None:
            self._scan_cache_bytes -= prev.nbytes
        self._scan_cache[key] = table
        self._scan_cache_bytes += size
        while self._scan_cache_bytes > self._scan_cache_max_bytes and self._scan_cache:
            oldest = next(iter(self._scan_cache))  # insertion order = LRU order
            self._scan_cache_bytes -= self._scan_cache.pop(oldest).nbytes

    # ------------------------------------------------------------------- DDL
    def create_table(
        self,
        name: str,
        schema: pa.Schema,
        *,
        primary_keys: list[str] | None = None,
        range_partitions: list[str] | None = None,
        hash_bucket_num: int | None = None,
        cdc: bool = False,
        cdc_column: str | None = None,
        properties: dict | None = None,
        merge_operators: dict[str, str] | None = None,
        namespace: str = "default",
        table_path: str | None = None,
    ) -> "LakeSoulTable":
        props = dict(properties or {})
        if hash_bucket_num is not None:
            props[PROP_HASH_BUCKET_NUM] = str(hash_bucket_num)
        for colname, op in (merge_operators or {}).items():
            # persisted in table properties → every surface (table API, SQL
            # WITH(...), Flight) reads back the same per-column operators
            props[IOConfig.PROP_MERGE_OP_PREFIX + colname] = op
        if cdc or cdc_column:
            cdc_column = cdc_column or CDC_DEFAULT_COLUMN
            props[PROP_CDC_CHANGE_COLUMN] = cdc_column
            if cdc_column not in schema.names:
                schema = schema.append(pa.field(cdc_column, pa.string()))
        info = self.client.create_table(
            name,
            table_path or f"{self.warehouse}/{namespace}/{name}",
            schema,
            primary_keys=primary_keys,
            range_partitions=range_partitions,
            properties=props,
            namespace=namespace,
        )
        return LakeSoulTable(self, info)

    def table(self, name: str, namespace: str = "default") -> "LakeSoulTable":
        return LakeSoulTable(self, self.client.get_table_info_by_name(name, namespace))

    def table_by_path(self, path: str) -> "LakeSoulTable":
        return LakeSoulTable(self, self.client.get_table_info_by_path(path))

    def drop_table(self, name: str, namespace: str = "default") -> None:
        self.client.drop_table(name, namespace)

    def table_exists(self, name: str, namespace: str = "default") -> bool:
        return self.client.table_exists(name, namespace)

    def list_tables(self, namespace: str = "default") -> list[str]:
        return self.client.list_tables(namespace)

    def create_namespace(self, name: str) -> None:
        self.client.create_namespace(name)

    def drop_namespace(self, name: str) -> None:
        self.client.drop_namespace(name)

    def list_namespaces(self) -> list[str]:
        return self.client.list_namespaces()

    def scan(self, name: str, namespace: str = "default") -> "LakeSoulScan":
        return self.table(name, namespace).scan()


class LakeSoulTable:
    """Handle to one table: writes, upserts, compaction, scans."""

    def __init__(self, catalog: LakeSoulCatalog, info: TableInfo):
        self.catalog = catalog
        self._info = info

    # refresh metadata (another writer may have altered schema/properties)
    def refresh(self) -> "LakeSoulTable":
        self._info = self.catalog.client.get_table_info_by_name(
            self._info.table_name, self._info.table_namespace
        )
        return self

    @property
    def info(self) -> TableInfo:
        return self._info

    @property
    def name(self) -> str:
        return self._info.table_name

    @property
    def schema(self) -> pa.Schema:
        return self._info.arrow_schema

    @property
    def primary_keys(self) -> list[str]:
        return self._info.primary_keys

    def io_config(self, **overrides) -> IOConfig:
        cfg = IOConfig.for_table(self._info)
        cfg.object_store_options = dict(self.catalog.storage_options)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    def set_properties(self, props: dict[str, str]) -> "LakeSoulTable":
        """Merge properties into the table (ALTER TABLE SET TBLPROPERTIES
        role): per-table IO knobs, TTLs, and mergeOperator.* entries become
        effective for subsequent reads/writes.  A value of None removes the
        key.  Structural properties (hashBucketNum, the CDC column) are
        immutable — existing files were written under them."""
        immutable = {PROP_HASH_BUCKET_NUM, PROP_CDC_CHANGE_COLUMN}
        bad = immutable & set(props)
        if bad:
            raise MetadataError(
                f"properties {sorted(bad)} are structural and cannot change"
            )

        def merge(current: dict) -> dict:
            merged = dict(current or {})
            for k, v in props.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = str(v)
            return merged

        # the merge runs inside the store's locked transaction: merging
        # against a cached self._info snapshot and writing the result back
        # blind would drop a concurrent peer's property update
        self.catalog.client.store.merge_table_properties(
            self._info.table_id, merge
        )
        return self.refresh()

    # ---------------------------------------------------------------- writes
    def write_arrow(
        self,
        data: pa.Table | pa.RecordBatch | Iterable[pa.RecordBatch],
        *,
        op: CommitOp | str | None = None,
        commit_id_by_partition: dict[str, str] | None = None,
    ) -> list[DataFileOp]:
        """Write Arrow data and commit atomically.  PK tables default to a
        MergeCommit (upsert semantics on read), plain tables to AppendCommit —
        matching LakeSoulTable.write_arrow (catalog.py:401)."""
        if op is None:
            op = CommitOp.MERGE if self._info.primary_keys else CommitOp.APPEND
        elif isinstance(op, str):
            op = CommitOp(op)
        writer = TableWriter(self.io_config(), self._info.table_path)
        try:
            if isinstance(data, (pa.Table, pa.RecordBatch)):
                writer.write_batch(data)
            else:
                for b in data:
                    writer.write_batch(b)
            outputs = writer.close()
        except Exception:
            writer.abort()
            raise
        files_by_partition: dict[str, list[DataFileOp]] = {}
        for out in outputs:
            files_by_partition.setdefault(out.partition_desc, []).append(
                DataFileOp(
                    path=out.path,
                    file_op="add",
                    size=out.size,
                    file_exist_cols=out.file_exist_cols,
                )
            )
        try:
            self.catalog.client.commit_data_files(
                self._info,
                files_by_partition,
                op,
                commit_id_by_partition=commit_id_by_partition,
                storage_options=self.catalog.storage_options,
            )
        except CommitConflictError:
            # conflict = the partition-version insert never landed, so the
            # staged files are provably invisible → safe to delete (close()
            # already took ownership from the writer, so delete explicitly)
            from lakesoul_tpu_torch.io.object_store import delete_file

            for out in outputs:
                delete_file(out.path, self.catalog.storage_options, missing_ok=True)
            raise
        except Exception:
            # any other failure may have happened AFTER the snapshot became
            # visible (e.g. in mark_committed) — deleting files a snapshot
            # references would corrupt the table; leave them for the cleaner
            raise
        return [f for ops in files_by_partition.values() for f in ops]

    def upsert(self, data) -> list[DataFileOp]:
        if not self._info.primary_keys:
            raise MetadataError("upsert requires a primary-key table")
        return self.write_arrow(data, op=CommitOp.MERGE)

    def delete_partitions(self, partitions: dict[str, str] | None = None) -> None:
        """Drop data (DeleteCommit clears the partition snapshot)."""
        from lakesoul_tpu_torch.meta.entity import MetaInfo, PartitionInfo

        heads = self.catalog.client._select_partitions(self._info, partitions)
        if not heads:
            return
        self.catalog.client.commit_data(
            MetaInfo(
                table_info=self._info,
                list_partition=[
                    PartitionInfo(self._info.table_id, h.partition_desc) for h in heads
                ],
            ),
            CommitOp.DELETE,
        )

    # ------------------------------------------------------------- row DML
    def _commit_partition_rewrite(self, head, outputs, old_files, commit_op,
                                  *, lease=None) -> None:
        """Shared tail of every partition-rewrite operation (compaction and
        row DML): build the file ops, commit against the read head, delete
        staged files on a provably-invisible conflict, queue replaced files
        for the cleaner.  ``lease`` fences the commit on a coordination
        lease (leased compaction services); a fenced commit is just as
        provably invisible as a conflicted one, so its staged files are
        cleaned up the same way."""
        from lakesoul_tpu_torch.errors import LeaseFencedError

        try:
            self._commit_staged(head, outputs, commit_op, lease=lease)
        except (CommitConflictError, LeaseFencedError):
            self._delete_staged(outputs)
            raise
        self._discard_replaced(head, old_files)

    def _commit_staged(self, head, outputs, commit_op, *, lease=None) -> None:
        """Commit the staged ``outputs`` against the read ``head``; raises
        the conflict (or the fence) with the outputs left on disk."""
        files_by_partition: dict[str, list[DataFileOp]] = {head.partition_desc: []}
        for out in outputs:
            files_by_partition.setdefault(out.partition_desc, []).append(
                DataFileOp(path=out.path, file_op="add", size=out.size,
                           file_exist_cols=out.file_exist_cols)
            )
        self.catalog.client.commit_data_files(
            self._info,
            files_by_partition,
            commit_op,
            read_partition_info=[head],
            lease=lease,
            # a failed commit's staged outputs are deleted or committed
            # again under new rows, so its phase-1 rows must die (see
            # commit_data_files)
            staged_deleted_on_conflict=True,
        )

    def _delete_staged(self, outputs) -> None:
        from lakesoul_tpu_torch.io.object_store import delete_file

        for out in outputs:
            delete_file(out.path, self.catalog.storage_options, missing_ok=True)

    def _discard_replaced(self, head, old_files) -> None:
        for f in old_files:
            self.catalog.client.store.insert_discard_file(
                f, self._info.table_path, head.partition_desc)

    @staticmethod
    def _partition_constraints(flt: Filter, range_cols: list[str]) -> dict[str, str]:
        """AND-of-equality constraints on partition columns (conservative:
        anything under OR/NOT is ignored) → prune partitions before reading."""
        out: dict[str, str] = {}

        def walk(f: Filter):
            if f.op == "and":
                for a in f.args:
                    walk(a)
            elif f.op == "eq" and f.col in range_cols:
                out[f.col] = str(f.value)

        walk(flt)
        return out

    def _match_mask(self, table: pa.Table, flt: Filter) -> np.ndarray:
        """Boolean row mask for the predicate with SQL three-valued logic:
        NULL-predicate rows are NOT matched (kept by DELETE, skipped by
        UPDATE)."""
        import pyarrow.dataset as pads

        idx = pa.array(np.arange(len(table), dtype=np.int64))
        with_idx = table.append_column("__idx", idx)
        matched = np.asarray(
            pads.dataset(with_idx).to_table(filter=flt.to_arrow()).column("__idx")
        )
        mask = np.zeros(len(table), dtype=bool)
        mask[matched] = True
        return mask

    def _rewrite_where(self, flt: Filter | None, mutate, *, mask_fn=None) -> int:
        """Shared engine for row-level UPDATE/DELETE (reference:
        lakesoul-datafusion update/delete planning): per matching partition,
        rewrite the merged data with ``mutate(table, mask)`` applied and
        commit an UpdateCommit (snapshot replace, conflict checked against
        the read head).  Returns affected row count.

        ``mask_fn(table) -> bool ndarray`` replaces the Filter-derived match
        mask for predicates the pushdown AST cannot express (function
        calls, subqueries — the SQL layer's general evaluator); with no
        Filter, every partition is scanned."""
        client = self.catalog.client
        total_affected = 0
        constraints = (
            self._partition_constraints(flt, self._info.range_partition_columns)
            if flt is not None else {}
        )
        heads = client._select_partitions(self._info, constraints or None)
        for head in heads:
            units = client.get_scan_plan_partitions(
                self._info.table_name, namespace=self._info.table_namespace,
                snapshot=[head],
            )
            tables = []
            for unit in units:
                t = read_scan_unit(
                    unit.data_files,
                    unit.primary_keys,
                    schema=self.schema,
                    partition_values=unit.partition_values,
                    merge_operators=self.io_config().merge_operators,
                    cdc_column=self._info.cdc_column,
                    drop_cdc_deletes=True,
                    storage_options=self.catalog.storage_options,
                )
                if len(t):
                    tables.append(t)
            if not tables:
                continue
            merged = pa.concat_tables(tables)
            mask = (
                mask_fn(merged) if mask_fn is not None
                else self._match_mask(merged, flt)
            )
            affected = int(mask.sum())
            if affected == 0:
                continue
            new_table = mutate(merged, mask)
            writer = TableWriter(self.io_config(), self._info.table_path)
            if len(new_table):
                writer.write_batch(new_table)
            outputs = writer.close()
            old_files = [f for unit in units for f in unit.data_files]
            self._commit_partition_rewrite(head, outputs, old_files, CommitOp.UPDATE)
            total_affected += affected
        return total_affected

    def delete_where(self, flt: Filter | None, *, mask_fn=None) -> int:
        """Row-level delete: rewrite matching partitions without the matching
        rows.  Returns the number of rows deleted."""

        def mutate(table, mask):
            return table.filter(pa.array(~mask))

        return self._rewrite_where(flt, mutate, mask_fn=mask_fn)

    def update_where(self, flt: Filter | None, assignments: dict, *,
                     mask_fn=None, expr_assignments: dict | None = None) -> int:
        """Row-level update: SET column=value on rows matching the filter.
        ``assignments`` maps columns to plain Python literals;
        ``expr_assignments`` maps columns to callables ``fn(table) ->
        Array`` evaluated over the merged partition (the SQL layer's
        SET-expression path).  Returns the number of rows updated."""
        import pyarrow.compute as pc

        expr_assignments = expr_assignments or {}
        schema = self.schema
        for col_name in (*assignments, *expr_assignments):
            if col_name not in schema.names:
                raise MetadataError(f"unknown column {col_name!r} in UPDATE")
            if col_name in self._info.primary_keys:
                raise MetadataError("cannot UPDATE a primary-key column")
            if col_name in self._info.range_partition_columns:
                # moving rows between partitions would replace the target
                # partition's snapshot outside the conflict check
                raise MetadataError("cannot UPDATE a range-partition column")

        def mutate(table, mask):
            import numpy as np

            mask_arr = pa.array(mask)
            # SET expressions evaluate over the MATCHED rows only (standard
            # SQL): a non-matching row must not be able to abort the
            # statement (e.g. SET v = 10 / k WHERE k <> 0)
            matched = table.take(pa.array(np.nonzero(mask)[0]))
            arrays = []
            for fld in schema:
                col = table.column(fld.name)
                if fld.name in assignments:
                    val = pa.scalar(assignments[fld.name], type=fld.type)
                    col = pc.if_else(mask_arr, val, col)
                elif fld.name in expr_assignments:
                    try:
                        new = pc.cast(
                            expr_assignments[fld.name](matched),
                            options=pc.CastOptions(
                                target_type=fld.type, allow_float_truncate=True
                            ),
                        )
                    except (pa.lib.ArrowInvalid,
                            pa.lib.ArrowNotImplementedError) as e:
                        raise MetadataError(
                            f"UPDATE SET {fld.name}: CAST failed: {e}"
                        )
                    if isinstance(new, pa.ChunkedArray):
                        new = new.combine_chunks()
                    col = pc.replace_with_mask(
                        col.combine_chunks() if isinstance(col, pa.ChunkedArray)
                        else col,
                        mask_arr, new,
                    )
                arrays.append(col)
            return pa.table(arrays, schema=schema)

        return self._rewrite_where(flt, mutate, mask_fn=mask_fn)

    # ----------------------------------------------------------- maintenance
    def rollback(
        self,
        *,
        to_version: int | None = None,
        to_timestamp_ms: int | None = None,
        partitions: dict[str, str] | None = None,
    ) -> int:
        """Roll partitions back to an earlier state by committing a NEW
        version carrying the old snapshot (history is preserved — parity with
        Spark LakeSoulTable.rollback, tables/LakeSoulTable.scala:341-551).
        Returns the number of partitions rolled back."""
        if (to_version is None) == (to_timestamp_ms is None):
            raise ConfigError("rollback needs exactly one of to_version / to_timestamp_ms")
        client = self.catalog.client
        store = client.store
        heads = client._select_partitions(self._info, partitions)
        from lakesoul_tpu_torch.meta.entity import MetaInfo, PartitionInfo

        # all partitions in ONE commit: a mid-loop conflict must not leave the
        # table half rolled back
        list_partition: list[PartitionInfo] = []
        read_info: list[PartitionInfo] = []
        for head in heads:
            if to_version is not None:
                target = store.get_partition_info_at_version(
                    self._info.table_id, head.partition_desc, to_version
                )
            else:
                target = store.get_partition_at_timestamp(
                    self._info.table_id, head.partition_desc, to_timestamp_ms
                )
            if target is None or target.version == head.version:
                continue
            list_partition.append(
                PartitionInfo(
                    table_id=self._info.table_id,
                    partition_desc=head.partition_desc,
                    snapshot=list(target.snapshot),
                )
            )
            read_info.append(head)
        if not list_partition:
            return 0
        client.commit_data(
            MetaInfo(
                table_info=self._info,
                list_partition=list_partition,
                read_partition_info=read_info,
            ),
            CommitOp.UPDATE,  # snapshot REPLACE with conflict detection
        )
        return len(list_partition)

    def add_columns(self, fields: list[pa.Field] | pa.Field) -> "LakeSoulTable":
        """Schema evolution: append nullable columns.  Existing files stay
        untouched; reads fill the new columns with nulls (reference: Flink
        auto DDL sync + CanCastSchemaBuilder semantics)."""
        if isinstance(fields, pa.Field):
            fields = [fields]
        schema = self.schema
        for f in fields:
            if f.name in schema.names:
                raise MetadataError(f"column {f.name!r} already exists")
            if not f.nullable:
                raise MetadataError(f"added column {f.name!r} must be nullable")
            schema = schema.append(f)
        self.catalog.client.update_table_schema(self._info.table_id, schema)
        return self.refresh()

    # ------------------------------------------------------------ compaction
    def compact(self, partitions: dict[str, str] | None = None, *, lease=None) -> int:
        """Merge each (partition, bucket)'s file stack into sorted files and
        commit with CompactionCommit; replaced files go to the discard list
        for the cleaner.  Mirrors Spark CompactionCommand + CompactBucketIO.
        The writer rolls a file at ``max_file_rows``, so a bucket of r rows
        comes out in at most ceil(r / ``max_file_rows``) + 1 files, not
        always one.  ``lease`` (from a leased compaction service) fences the
        commit and stamps its fencing token into the version row's
        expression.

        The commit needs the head it read (a CompactionCommit head is read
        without a merge), so a writer that commits more often than one pass
        takes would starve it.  A commit that lost its race to appends and
        merges only (the new head's snapshot extends the one compacted)
        catches up instead, up to ``COMPACT_CATCH_UP`` times: the buckets
        those commits touched are merged again from the staged output plus
        just their new files — the staged output first, so newer rows still
        win — and the commit is retried against the new head.  A rewrite or
        delete in between is a conflict.  Returns the number of partitions
        compacted."""
        from lakesoul_tpu_torch.errors import LeaseFencedError
        from lakesoul_tpu_torch.obs import registry

        client = self.catalog.client
        heads = client._select_partitions(self._info, partitions)
        count = 0
        for head in heads:
            units = client.get_scan_plan_partitions(
                self._info.table_name,
                namespace=self._info.table_namespace,
                snapshot=[head],
            )
            if not units or all(len(u.data_files) <= 1 and not u.primary_keys for u in units):
                continue
            outputs = self._merge_units(units)
            old_files = [f for u in units for f in u.data_files]
            rounds = 0
            while True:
                try:
                    self._commit_staged(head, outputs, CommitOp.COMPACTION, lease=lease)
                    break
                except LeaseFencedError:
                    self._delete_staged(outputs)
                    raise
                except CommitConflictError:
                    if rounds == COMPACT_CATCH_UP:
                        self._delete_staged(outputs)
                        raise
                    rounds += 1
                    head, outputs, added = self._catch_up(head, outputs)
                    old_files += added
                    registry().counter("lakesoul_compaction_catch_ups_total").inc()
            self._discard_replaced(head, old_files)
            count += 1
        return count

    def _merge_units(self, units) -> list:
        """Merge each scan unit's files into staged sorted files (streamed:
        a bucket deeper than the byte budget compacts with flat memory; the
        writer's own budget rolls oversized cells into several files)."""
        cfg = self.io_config()
        writer = TableWriter(cfg, self._info.table_path)
        for unit in units:
            for batch in iter_scan_unit_batches(
                unit.data_files,
                unit.primary_keys,
                batch_size=cfg.batch_size,
                memory_budget_bytes=cfg.memory_budget_bytes,
                file_sizes=unit.file_sizes,
                schema=self.schema,
                partition_values=unit.partition_values,
                merge_operators=cfg.merge_operators,
                cdc_column=None,  # keep CDC rows through compaction
            ):
                if len(batch):
                    writer.write_batch(batch)
        return writer.close()

    def _catch_up(self, head, outputs) -> tuple:
        """One catch-up round of :meth:`compact` after a lost commit race:
        returns (the new head, the staged outputs for it, the data files the
        new commits added).  Raises the conflict again, deleting the staged
        outputs, when the head moved by anything but appends and merges."""
        client = self.catalog.client
        cur = client.store.get_latest_partition_info(self._info.table_id, head.partition_desc)
        n = len(head.snapshot)
        if cur is None or len(cur.snapshot) <= n or list(cur.snapshot[:n]) != list(head.snapshot):
            self._delete_staged(outputs)
            raise CommitConflictError(
                f"compaction of {head.partition_desc}: the partition was rewritten since"
                f" version {head.version}, not only appended to"
            )
        tail = cur.clone()
        tail.snapshot = list(cur.snapshot[n:])
        tail.commit_op = CommitOp.MERGE  # read the new commits as a merge
        tail_units = client.get_scan_plan_partitions(
            self._info.table_name, namespace=self._info.table_namespace, snapshot=[tail])

        def bucket(b):
            return None if b is None or b < 0 else b

        staged: dict = {}
        for out in outputs:
            staged.setdefault(bucket(out.bucket_id), []).append(out)
        remerge, added, superseded = [], [], []
        for unit in tail_units:
            mine = staged.pop(bucket(unit.bucket_id), [])
            remerge.append(ScanPlanPartition(
                data_files=[o.path for o in mine] + list(unit.data_files),
                primary_keys=list(self.primary_keys),
                bucket_id=unit.bucket_id,
                partition_desc=unit.partition_desc,
                partition_values=unit.partition_values,
                file_sizes=[o.size for o in mine] + list(unit.file_sizes),
            ))
            added += unit.data_files
            superseded += mine
        try:
            merged = self._merge_units(remerge)
        except BaseException:
            self._delete_staged(outputs)
            raise
        self._delete_staged(superseded)  # staged, never committed: nobody else reads them
        kept = [o for outs in staged.values() for o in outs]
        return cur, kept + merged, added

    # ---------------------------------------------------------- vector index
    def build_vector_index(self, column: str, *, device=None, **config_kwargs) -> int:
        """Train+persist per-(partition, bucket) ANN shards for a vector
        column (reference: LakeSoulTable.build_vector_index, catalog.py:496),
        on ``device`` (``None`` = the CUDA card).  Returns the number of
        vectors indexed."""
        from lakesoul_tpu_torch.vector.builder import build_table_vector_index

        return build_table_vector_index(self, column, device=device, **config_kwargs)

    def vector_search(
        self,
        column: str,
        query,
        *,
        top_k: int = 10,
        nprobe: int = 8,
        partitions: dict[str, str] | None = None,
        device=None,
        index=None,
    ):
        """ANN search → (pk ids, distances), nearest first, on ``device``
        (``None`` = the CUDA card); ``index`` (a ``TableVectorIndex``) keeps
        the opened shards across searches."""
        from lakesoul_tpu_torch.vector.builder import search_table_vector_index

        return search_table_vector_index(
            self, column, query, top_k=top_k, nprobe=nprobe, partitions=partitions,
            device=device, index=index,
        )

    # ------------------------------------------------------------------ scan
    def scan(self) -> "LakeSoulScan":
        return LakeSoulScan(self)

    def to_arrow(self) -> pa.Table:
        return self.scan().to_arrow()


class LakeSoulScan:
    """Lazy immutable scan builder (reference: LakeSoulScan, catalog.py:596).

    Chainable: ``table.scan().select(...).filter(...).shard(r, w).to_torch_iter()``.
    """

    def __init__(self, table: LakeSoulTable):
        self._table = table
        self._columns: list[str] | None = None
        self._filter: Filter | None = None
        self._partitions: dict[str, str] = {}
        self._rank: int | None = None
        self._world: int | None = None
        self._batch_size = 8192
        self._snapshot_ts: int | None = None
        self._incremental: tuple[int, int | None] | None = None
        self._keep_cdc_deletes = False
        self._vector_search: tuple | None = None
        self._cache = False
        self._limit: int | None = None
        # batch-source seam (data/batch_source.py): None = decode in this
        # process; a factory (scan → source) = remote delivery, e.g. a
        # scan-plane fleet via via_scanplane()
        self._batch_source_factory = None

    def _replace(self, **kw) -> "LakeSoulScan":
        s = copy.copy(self)
        for k, v in kw.items():
            setattr(s, k, v)
        return s

    # --------------------------------------------------------------- builder
    def select(self, columns: list[str]) -> "LakeSoulScan":
        return self._replace(_columns=list(columns))

    def filter(self, flt: "Filter | str") -> "LakeSoulScan":
        """Add a pushdown predicate: a Filter node, or a WHERE-style string
        (``scan.filter("f > 100 AND id IN (1, 2)")``) parsed by the SQL
        predicate grammar."""
        if isinstance(flt, str):
            from lakesoul_tpu_torch.sql.parser import parse_predicate

            flt = parse_predicate(flt)
        elif not isinstance(flt, Filter):
            raise ConfigError(
                f"filter() takes a Filter or a predicate string, got {type(flt).__name__}"
            )
        new = flt if self._filter is None else (self._filter & flt)
        return self._replace(_filter=new)

    def partitions(self, parts: dict[str, str]) -> "LakeSoulScan":
        return self._replace(_partitions={**self._partitions, **{k: str(v) for k, v in parts.items()}})

    def shard(self, rank: int, world_size: int) -> "LakeSoulScan":
        """Explicit distributed shard: scan units are assigned round-robin
        ``i % world_size == rank`` (reference: arrow/dataset.py:366-397)."""
        if not 0 <= rank < world_size:
            raise ConfigError(f"invalid shard rank={rank} world={world_size}")
        return self._replace(_rank=rank, _world=world_size)

    def auto_shard(self) -> "LakeSoulScan":
        """Shard by this process's position on the data axis — the
        analogue of the reference's torch.distributed auto-detection
        (arrow/dataset.py:353).  The axis resolves through the fleet plane
        (the ``torch.distributed`` rank and world size, with the
        ``LAKESOUL_FLEET_PROCESS_INDEX``/``_COUNT`` emulation override), so
        every consumer shards identically."""
        from lakesoul_tpu_torch.fleet.multihost import process_axis

        index, count = process_axis()
        if count > 1:
            return self.shard(index, count)
        return self

    def batch_size(self, n: int) -> "LakeSoulScan":
        return self._replace(_batch_size=int(n))

    def limit(self, n: int) -> "LakeSoulScan":
        """Stop after ``n`` rows (arbitrary subset, like SQL LIMIT without
        ORDER BY): batch iteration ends early, skipping unread units."""
        if n < 0:
            raise ConfigError(f"limit must be non-negative, got {n}")
        return self._replace(_limit=int(n))

    def snapshot_at(self, timestamp_ms: int) -> "LakeSoulScan":
        return self._replace(_snapshot_ts=int(timestamp_ms))

    def incremental(self, start_ts_ms: int, end_ts_ms: int | None = None) -> "LakeSoulScan":
        return self._replace(_incremental=(int(start_ts_ms), end_ts_ms))

    def with_cdc_deletes(self) -> "LakeSoulScan":
        """Keep CDC delete rows (needed by incremental CDC consumers)."""
        return self._replace(_keep_cdc_deletes=True)

    def cache(self) -> "LakeSoulScan":
        """Cache this scan's decoded Arrow table in memory (tf.data
        ``cache()`` role): epochs 2+ of a training loop skip decode+merge
        entirely.  The cache key includes the partition version digest, so
        any commit to the table invalidates it automatically."""
        return self._replace(_cache=True)

    def via_scanplane(self, target, **client_kwargs) -> "LakeSoulScan":
        """Source this scan's batches from a scan-plane gateway instead of
        decoding in-process: ``target`` is a gateway location
        (``grpc://host:port``) or an existing
        :class:`~lakesoul_tpu_torch.scanplane.client.ScanPlaneClient`.
        Chainable like every builder method; every consumer downstream —
        ``to_batches`` / ``to_arrow`` / ``to_torch_iter`` / ``to_torch`` —
        then streams from the fleet with byte-identical results (the copy to
        the card, collate and loader stats stay client-side)."""
        from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient

        client = (
            target
            if isinstance(target, ScanPlaneClient)
            else ScanPlaneClient(target, **client_kwargs)
        )
        return self._replace(_batch_source_factory=client.source)

    def _cache_key(self) -> tuple:
        info = self._table.info
        heads = self._table.catalog.client.store.get_all_latest_partition_info(
            info.table_id
        )
        version_digest = tuple(sorted((h.partition_desc, h.version) for h in heads))
        import hashlib

        schema_digest = hashlib.md5(info.table_schema_arrow_ipc).hexdigest()
        return (
            info.table_id,
            schema_digest,  # add_columns invalidates even without a commit
            version_digest,
            tuple(self._columns) if self._columns is not None else None,
            self._filter.to_json() if self._filter is not None else None,
            tuple(sorted(self._partitions.items())),
            self._rank,
            self._world,
            self._snapshot_ts,
            self._incremental,
            self._keep_cdc_deletes,
            # _limit intentionally absent: limited reads recurse through the
            # unlimited scan, so the cache holds (and shares) the full result
        )

    def vector_search(self, column: str, query, *, top_k: int = 10, nprobe: int = 8,
                      device=None, index=None) -> "LakeSoulScan":
        """ANN-filtered scan: search the table's index shards and inject a
        ``pk IN (matched ids)`` filter, so the scan returns the matching rows
        through the normal MOR path (reference:
        inject_vector_search_filter, reader.rs:250-344).

        Lazy like every other builder method: the search executes at read
        time, so partition filters chained before OR after this call narrow
        which shards are searched."""
        return self._replace(
            _vector_search=(column, query, int(top_k), int(nprobe), device, index))

    def _resolve_vector_search(self) -> "LakeSoulScan":
        if self._vector_search is None:
            return self
        if self._snapshot_ts is not None or self._incremental is not None:
            raise ConfigError(
                "vector_search cannot be combined with snapshot/incremental scans:"
                " index shards always reflect the latest table state"
            )
        column, query, top_k, nprobe, device, index = self._vector_search
        ids, _ = self._table.vector_search(
            column, query, top_k=top_k, nprobe=nprobe,
            partitions=self._partitions or None, device=device, index=index,
        )
        pk = self._table.info.primary_keys[0]
        resolved = self._replace(_vector_search=None)
        return resolved.filter(Filter(op="in", col=pk, value=[int(i) for i in ids]))

    # ------------------------------------------------------------------ plan
    def scan_plan(self) -> list[ScanPlanPartition]:
        if self._vector_search is not None:
            return self._resolve_vector_search().scan_plan()
        return self._restrict_units(self._plan_units())

    def _plan_units(self) -> list[ScanPlanPartition]:
        """Scan units after partition selection, before bucket pruning and
        rank sharding (metadata only)."""
        client = self._table.catalog.client
        info = self._table.info
        if self._incremental is not None:
            units = client.incremental_scan_plan(
                info.table_name, self._incremental[0], self._incremental[1],
                namespace=info.table_namespace,
            )
            return self._filter_partitions(units)
        if self._snapshot_ts is not None:
            snapshot = client.get_snapshot_at_timestamp(
                info.table_name, self._snapshot_ts, namespace=info.table_namespace
            )
            return client.get_scan_plan_partitions(
                info.table_name, self._partitions, namespace=info.table_namespace,
                snapshot=snapshot,
            )
        return client.get_scan_plan_partitions(
            info.table_name, self._partitions, namespace=info.table_namespace
        )

    def explain(self) -> dict:
        """What this scan WILL do, from metadata alone — no data is read and
        a pending vector search is not executed.  The observability role of
        the reference's EXPLAIN over its TableProvider (DataFusion shows
        pushed filters and file groups); here the plan also quantifies
        partition/bucket pruning and merge work."""
        from lakesoul_tpu_torch.io.filters import zone_conjuncts

        info = self._table.info
        out: dict[str, Any] = {
            "table": info.table_name,
            "columns": list(self._columns) if self._columns is not None else None,
            "filter": self._filter._to_dict() if self._filter is not None else None,
            "zone_predicates": [
                {"col": c, "op": op, "value": v}
                for c, op, v in zone_conjuncts(self._filter)
            ],
            "partitions": dict(self._partitions) or None,
            "snapshot_ts": self._snapshot_ts,
            "incremental": self._incremental,
            "limit": self._limit,
            "shard": (
                {"rank": self._rank, "world": self._world}
                if self._rank is not None
                else None
            ),
        }
        if self._vector_search is not None:
            col, _, top_k, nprobe, _, _ = self._vector_search
            out["vector_search"] = {"column": col, "top_k": top_k, "nprobe": nprobe}
            out["note"] = "vector search resolves at read time to a pk IN filter"
            return out
        base = self._plan_units()
        pruned = self._prune_buckets(base)
        final = (
            pruned
            if self._rank is None
            else [u for i, u in enumerate(pruned) if i % self._world == self._rank]
        )
        files = [f for u in final for f in u.data_files]
        sizes = [s for u in final for s in (u.file_sizes or [])]
        by_ext: dict[str, int] = {}
        for f in files:
            by_ext[f.rsplit(".", 1)[-1]] = by_ext.get(f.rsplit(".", 1)[-1], 0) + 1
        # prune accounting: units are (partition × bucket) entries; on
        # multi-partition tables len(base)-len(pruned) overstates *bucket*
        # pruning, so report units_pruned plus the distinct
        # bucket ids that vanished entirely
        kept_buckets = {u.bucket_id for u in pruned}
        out.update(
            units=len(final),
            units_before_bucket_prune=len(base),
            units_pruned=len(base) - len(pruned),
            buckets_pruned=len(
                {u.bucket_id for u in base if u.bucket_id not in kept_buckets}
            ),
            merge_units=sum(1 for u in final if u.primary_keys),
            files=len(files),
            bytes_known=sum(sizes) if sizes else None,
            file_formats=by_ext,
        )
        return out

    def _filter_partitions(self, units: list[ScanPlanPartition]) -> list[ScanPlanPartition]:
        if not self._partitions:
            return units
        return [
            u
            for u in units
            if all(u.partition_values.get(k) == v for k, v in self._partitions.items())
        ]

    def _restrict_units(
        self, units: list[ScanPlanPartition], *, stable_shard: bool = False
    ) -> list[ScanPlanPartition]:
        """Shared unit restriction: bucket pruning + DP rank sharding.

        Batch scans shard round-robin by plan index (every rank computes the
        same full plan, so indices agree).  Streaming follow() must use
        ``stable_shard``: each rank polls with independent cursors and
        timing, so assignment has to key on stable unit identity, not
        enumeration order — otherwise a commit can be skipped by every rank
        or delivered twice."""
        units = self._prune_buckets(units)
        if self._rank is None:
            return units
        if not stable_shard:
            return [u for i, u in enumerate(units) if i % self._world == self._rank]
        import zlib

        def owner(u: ScanPlanPartition) -> int:
            ident = f"{u.partition_desc}/{u.bucket_id}"
            if u.bucket_id < 0 and u.data_files:
                ident += "/" + u.data_files[0].rsplit("/", 1)[-1]
            return zlib.crc32(ident.encode()) % self._world

        return [u for u in units if owner(u) == self._rank]

    def _prune_buckets(self, units: list[ScanPlanPartition]) -> list[ScanPlanPartition]:
        """Hash-bucket pruning: a PK-equality filter can only match rows in
        the buckets its values hash to (reader.rs:164-225)."""
        info = self._table.info
        pks = info.primary_keys
        if self._filter is None or len(pks) != 1:
            return units
        equalities = extract_pk_equalities(self._filter, pks)
        if not equalities:
            return units
        schema = info.arrow_schema
        dtype = schema.field(pks[0]).type
        n = info.hash_bucket_num
        live = {spark_hash.bucket_id_for_scalar(v, n, dtype) for _, v in equalities}
        return [u for u in units if u.bucket_id < 0 or u.bucket_id in live]

    # -------------------------------------------------------------- delivery
    def _unit_kwargs(self, unit: ScanPlanPartition) -> dict[str, Any]:
        info = self._table.info
        cfg = self._table.io_config()
        return dict(
            schema=info.arrow_schema,
            partition_values=unit.partition_values,
            filter=self._filter,
            merge_operators=cfg.merge_operators,
            cdc_column=info.cdc_column,
            drop_cdc_deletes=not self._keep_cdc_deletes,
            columns=self._columns,
            storage_options=self._table.catalog.storage_options,
        )

    def projected_schema(self) -> pa.Schema:
        """The Arrow schema this scan's batches carry (projection applied)
        — THE one definition, shared by local delivery and the scan
        plane's spool writer + gateway stream so they can never drift."""
        base = self._table.info.arrow_schema
        if self._columns is not None:
            return pa.schema([base.field(c) for c in self._columns])
        return base

    def _projected_empty_table(self) -> pa.Table:
        return self.projected_schema().empty_table()

    def to_arrow(self, *, parallel: bool | None = None) -> pa.Table:
        """Materialize the scan.  ``parallel=None`` (auto) decodes scan
        units concurrently on the shared runtime pool when there is more
        than one; unit order is preserved, so the result is byte-identical
        to ``parallel=False``."""
        if self._limit is not None or self._batch_source_factory is not None:
            batches = list(self.to_batches())
            if batches:
                return pa.Table.from_batches(batches)
            return self._projected_empty_table()
        if self._vector_search is not None:
            return self._resolve_vector_search().to_arrow(parallel=parallel)
        if self._cache:
            key = self._cache_key()
            hit = self._table.catalog._scan_cache_get(key)
            if hit is not None:
                return hit
            result = self._replace(_cache=False).to_arrow(parallel=parallel)
            self._table.catalog._scan_cache_put(key, result)
            return result
        units = self.scan_plan()

        def _read_unit(unit: ScanPlanPartition) -> pa.Table:
            return read_scan_unit(
                unit.data_files, unit.primary_keys, **self._unit_kwargs(unit)
            )

        if parallel is None:
            parallel = len(units) > 1
        if parallel and len(units) > 1:
            # ordered parallel fan-out over scan units (MOR merge of unit k
            # overlaps fetch+decode of units k+1..): deterministic unit
            # order in, deterministic table out
            decoded = rt_pipeline("scan").source(units).map_parallel(
                _read_unit, name="unit"
            ).run()
            tables = [t for t in decoded if len(t)]
        else:
            tables = [t for t in map(_read_unit, units) if len(t)]
        if not tables:
            return self._projected_empty_table()
        return pa.concat_tables(tables, promote_options="default").combine_chunks()

    def to_batches(
        self, num_threads: int | None = None, skip_rows: int = 0
    ) -> Iterator[pa.RecordBatch]:
        """Stream record batches.  ``num_threads > 1`` decodes scan units on a
        thread pool (unit order preserved, bounded in-flight window) — parquet
        decode and the numpy merge release the GIL, so multi-core hosts
        overlap unit decodes like the reference's per-bucket tokio readers.

        ``skip_rows`` resumes mid-stream (the LoaderCheckpoint path): whole
        scan units before the position are dropped via metadata/footer row
        counts — no decode — when the count is provably the delivered count
        (no filter/vector search/limit, unit needs no PK merge: the same
        conditions as the count_rows shortcut); the residual lands inside one
        unit and only that prefix is decoded and discarded."""
        if self._batch_source_factory is not None:
            # remote delivery (via_scanplane): the source owns limit/skip
            # semantics and yields the byte-identical stream
            yield from self._batch_source_factory(self).iter_batches(
                num_threads=num_threads, skip_rows=skip_rows
            )
            return
        if skip_rows:
            skip = skip_rows
            fast_ok = (
                self._filter is None
                and self._vector_search is None
                and not self._cache
                and self._limit is None
                # CDC: compacted files retain delete rows the decode drops,
                # so footer counts != delivered counts unless deletes are kept
                and (self._table.info.cdc_column is None or self._keep_cdc_deletes)
            )
            if fast_ok:
                from lakesoul_tpu_torch.io.formats import format_for

                opts = self._table.catalog.storage_options
                units = self.scan_plan()
                idx = 0
                while idx < len(units) and skip:
                    u = units[idx]
                    if u.primary_keys:
                        break  # merge can collapse rows: count != delivered
                    n = sum(format_for(f).count_rows(f, opts) for f in u.data_files)
                    if n > skip:
                        break
                    skip -= n
                    idx += 1
                inner = self._iter_unit_batches(units[idx:], num_threads)
            else:
                inner = self.to_batches(num_threads)
            try:
                for b in inner:
                    if skip >= len(b):
                        skip -= len(b)
                        continue
                    if skip:
                        b = b.slice(skip)
                        skip = 0
                    yield b
            finally:
                inner.close()  # stop producer threads on early exit
            return
        if self._limit is not None:
            inner = self._replace(_limit=None).to_batches(num_threads)
            remaining = self._limit
            try:
                # check BEFORE pulling: advancing the iterator decodes the
                # next unit, which must not happen once the limit is met
                while remaining > 0:
                    b = next(inner, None)
                    if b is None:
                        break
                    if len(b) > remaining:
                        yield b.slice(0, remaining)
                        remaining = 0
                        break
                    remaining -= len(b)
                    yield b
            finally:
                inner.close()  # stop producer threads on early exit
            return
        if self._vector_search is not None:
            yield from self._resolve_vector_search().to_batches(num_threads)
            return
        if self._cache:
            key = self._cache_key()
            hit = self._table.catalog._scan_cache_get(key)
            if hit is None:
                uncached = self._replace(_cache=False)
                batches = list(uncached.to_batches(num_threads))
                hit = (
                    pa.Table.from_batches(batches)
                    if batches
                    else uncached.to_arrow()
                )
                self._table.catalog._scan_cache_put(key, hit)
            yield from hit.to_batches(max_chunksize=self._batch_size)
            return
        yield from self._iter_unit_batches(self.scan_plan(), num_threads)

    def _iter_unit_batches(
        self, units: list[ScanPlanPartition], num_threads: int | None
    ) -> Iterator[pa.RecordBatch]:
        """Batch production over an explicit unit list (unit order preserved)."""
        if not num_threads or num_threads <= 1 or len(units) <= 1:
            budget = self._table.io_config().memory_budget_bytes
            for unit in units:
                yield from iter_scan_unit_batches(
                    unit.data_files,
                    unit.primary_keys,
                    batch_size=self._batch_size,
                    memory_budget_bytes=budget,
                    file_sizes=unit.file_sizes,
                    **self._unit_kwargs(unit),
                )
            return
        # work items: merge units stay whole (the merge needs all streams of
        # a bucket), plain units split per file; every item STREAMS its
        # batches through the runtime pipeline's bounded per-slot queues, so
        # the in-flight window holds a few batches per unit — never a
        # materialized unit.  The byte budget splits across the concurrent
        # units.  Slot order = item order, so the batch stream is
        # byte-identical to the serial path.
        items: list[tuple[ScanPlanPartition, list[str], list[int] | None]] = []
        cfg = self._table.io_config()
        for u in units:
            if u.primary_keys or cfg.merge_operators:
                items.append((u, u.data_files, u.file_sizes))
            elif u.file_sizes and len(u.file_sizes) == len(u.data_files):
                items.extend(
                    (u, [f], [s]) for f, s in zip(u.data_files, u.file_sizes)
                )
            else:
                items.extend((u, [f], None) for f in u.data_files)

        unit_budget = max(8 << 20, cfg.memory_budget_bytes // (num_threads + 1))

        def stream_item(item):
            unit, files, sizes = item
            return iter_scan_unit_batches(
                files,
                unit.primary_keys,
                batch_size=self._batch_size,
                memory_budget_bytes=unit_budget,
                file_sizes=sizes,
                **self._unit_kwargs(unit),
            )

        it = (
            rt_pipeline("scan")
            .source(items)
            .flat_map_parallel(
                stream_item, workers=num_threads, buffer=4, name="unit_stream"
            )
            .run()
        )
        try:
            yield from it
        finally:
            it.close()  # abandoned generator: stop producers promptly

    def count_rows(self) -> int:
        """Row count; metadata-only when no decode is needed (reference:
        EmptyScanCountExec shortcut, session.rs:1036).  The shortcut applies
        when there is no filter/vector search and no unit needs a PK merge —
        merge can collapse duplicate keys, so merged units must be counted
        the slow way (a single PK file may itself hold duplicates)."""
        if (
            self._filter is None
            and self._vector_search is None
            and not self._cache
            # CDC: compacted files retain delete rows the decode drops
            and (self._table.info.cdc_column is None or self._keep_cdc_deletes)
        ):
            units = self.scan_plan()
            if all(not u.primary_keys for u in units):
                from lakesoul_tpu_torch.io.formats import format_for

                opts = self._table.catalog.storage_options
                n = sum(
                    format_for(f).count_rows(f, opts)
                    for u in units
                    for f in u.data_files
                )
                return n if self._limit is None else min(n, self._limit)
        return sum(len(b) for b in self.to_batches())

    def follow(
        self,
        start_timestamp_ms: int | None = None,
        *,
        poll_interval: float = 1.0,
        stop_event=None,
        settle_ms=None,  # deprecated no-op, kept for API compat (see note)
        cursors: dict | None = None,
        state=None,
        slo=None,
        retry_policy=None,
    ) -> Iterator[pa.RecordBatch]:
        """Unbounded incremental source: yield batches for every commit after
        ``start_timestamp_ms`` (default: now), then keep polling for new
        commits — the role of the reference's unbounded Flink source
        (LakeSoulSource + dynamic split enumerator).  Stops when
        ``stop_event`` (threading.Event) is set; the idle wait rides
        ``stop_event.wait(poll_interval)``, so shutdown latency is bounded
        by ONE poll tick.

        The loop is the freshness follower
        (:class:`lakesoul_tpu_torch.freshness.follower.FreshFollower`): polls and
        unit decodes run under the shared
        :class:`~lakesoul_tpu_torch.runtime.resilience.RetryPolicy` (transient
        store/meta faults retry on the seeded schedule instead of killing
        the stream; permanent failures raise typed), and an attached
        ``slo`` (:class:`~lakesoul_tpu_torch.freshness.slo.SloMonitor`) observes
        each delivered commit's commit-to-visible latency.

        Resume, two grains:

        - ``cursors`` (a dict the stream mutates in place; serialize with
          ``meta.client.follow_cursors_to_json``): commit-grained — a
          restarted consumer continues after the last *enumerated* commit
          (the pending-splits checkpointing of the reference's Flink
          source).
        - ``state`` (a :class:`~lakesoul_tpu_torch.freshness.follower.
          FollowerState` or its JSON): row-exact — replays the recorded
          undelivered units, so a killed consumer resumes with no
          duplicated and no lost row.

        .. deprecated::
            ``settle_ms`` has been a no-op since follow moved to version
            cursors (a commit is either visible with a new version number
            or it is not); the parameter is retained so existing callers
            keep working.
        """
        if settle_ms is not None:
            import warnings

            warnings.warn(
                "LakeSoulScan.follow(settle_ms=...) is deprecated and has"
                " no effect: version cursors made the settle window"
                " obsolete",
                DeprecationWarning,
                stacklevel=2,
            )
        from lakesoul_tpu_torch.freshness.follower import FollowerState, FreshFollower

        if isinstance(state, str):
            state = FollowerState.from_json(state)
        follower = FreshFollower(
            self,
            start_timestamp_ms=start_timestamp_ms,
            state=state,
            cursors=cursors,
            poll_interval=poll_interval,
            stop_event=stop_event,
            retry_policy=retry_policy,
            slo=slo,
        )
        yield from follower.iter_batches()

    # torch delivery
    def to_torch_iter(self, **kwargs):
        """Double-buffered iterator of fixed-size batches on the card — see
        lakesoul_tpu_torch.data.torch_iter.TorchBatchIterator."""
        from lakesoul_tpu_torch.data.torch_iter import TorchBatchIterator

        return TorchBatchIterator(self, **kwargs)

    def to_torch(self):
        from lakesoul_tpu_torch.data.torch_adapter import TorchIterableDataset

        return TorchIterableDataset(self)

    def to_huggingface(self, **kwargs):
        from lakesoul_tpu_torch.data.hf_adapter import to_hf_dataset

        return to_hf_dataset(self, **kwargs)

    def to_pandas(self):
        return self.to_arrow().to_pandas()
