"""Metadata client: table lifecycle, the optimistic commit protocol, and
scan-plan construction.

Behavior-equivalent to the reference's ``MetaDataClient``
(rust/lakesoul-metadata/src/metadata_client.rs) and the Python scan planner
(python/src/lakesoul/metadata/native_client.py:354-431), including the
conflict-resolution branch the reference left TODO
(metadata_client.rs:585-588): on a version conflict this client re-reads the
current partition head and retries the commit.
"""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass, field

import pyarrow as pa

from lakesoul_tpu_torch.errors import (
    CommitConflictError,
    MetadataError,
    TableNotFoundError,
)
from lakesoul_tpu_torch.meta.entity import (
    NO_PARTITION_DESC,
    CommitOp,
    DataCommitInfo,
    DataFileOp,
    MetaInfo,
    Namespace,
    PartitionInfo,
    TableInfo,
    encode_partitions_field,
    now_millis,
    schema_to_ipc,
    schema_to_json,
)
from lakesoul_tpu_torch.meta.store import (
    DESCS_VERIFIED_KEY,
    MetadataStore,
    SqliteMetadataStore,
)

logger = logging.getLogger(__name__)

_BUCKET_ID_PATTERN = re.compile(r".*_(\d+)(?:\..*)?$")

MAX_COMMIT_RETRIES = 10


def _commit_retry_policy():
    """Seeded-jitter backoff for optimistic-commit conflicts (replaces the
    old unseeded ``random.uniform`` sleeps — chaos runs now reproduce).
    Only :class:`CommitConflictError` retries; everything else surfaces."""
    from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

    return RetryPolicy.from_env(
        max_attempts=MAX_COMMIT_RETRIES,
        base_delay_s=0.01,
        max_delay_s=0.5,
        classify=lambda e: isinstance(e, CommitConflictError),
    )


def extract_hash_bucket_id(file_path: str) -> int | None:
    """Bucket id from the trailing ``_NNNN`` file-name suffix
    (reference: helpers/mod.rs:945, native_client.py:404)."""
    m = _BUCKET_ID_PATTERN.match(file_path.rsplit("/", 1)[-1])
    return int(m.group(1)) if m else None


def partition_desc_to_dict(desc: str) -> dict[str, str]:
    if not desc or desc == NO_PARTITION_DESC:
        return {}
    out = {}
    for kv in desc.split(","):
        k, _, v = kv.partition("=")
        out[k] = v
    return out


def dict_to_partition_desc(d: dict[str, str], range_cols: list[str]) -> str:
    if not d:
        return NO_PARTITION_DESC
    return ",".join(f"{c}={d[c]}" for c in range_cols)


def canonical_partition_desc(desc: str, range_cols: list[str]) -> str:
    """Re-order a ``k=v[,k=v...]`` desc into range-column order.  The store
    keeps ONE canonical desc per partition so planner fast paths (point
    lookup, desc-prefix index ranges) can hit the primary-key index; descs
    whose keys don't match the table's range columns pass through untouched
    (caller-owned formats stay the caller's problem)."""
    if not desc or desc == NO_PARTITION_DESC or not range_cols:
        return desc
    d = partition_desc_to_dict(desc)
    if set(d) != set(range_cols):
        return desc
    return dict_to_partition_desc(d, range_cols)


@dataclass
class PartitionCursor:
    """Follow-stream position for one partition: the last consumed version
    and its snapshot (to diff out already-seen commit ids)."""

    version: int
    snapshot: set[str] = field(default_factory=set)


def follow_cursors_to_json(cursors: dict[str, "PartitionCursor"]) -> str:
    """Serialize a follow stream's position (the role of the reference's
    Flink pending-splits serializer, SimpleLakeSoulPendingSplitsSerializer):
    persist alongside the consumer's checkpoint, restore with
    follow_cursors_from_json, and resume exactly where the stream left off."""
    import json

    return json.dumps(
        {desc: {"version": c.version, "snapshot": sorted(c.snapshot)} for desc, c in cursors.items()}
    )


def follow_cursors_from_json(s: str) -> dict[str, "PartitionCursor"]:
    import json

    return {
        desc: PartitionCursor(version=d["version"], snapshot=set(d["snapshot"]))
        for desc, d in json.loads(s).items()
    }


@dataclass
class ScanPlanPartition:
    """One independently-readable scan unit: the files of a single
    (range-partition, hash-bucket) cell plus the PKs to merge on.  PKs are
    empty when no merge is needed (non-PK table, or the partition head is a
    CompactionCommit)."""

    data_files: list[str]
    primary_keys: list[str]
    bucket_id: int = -1
    partition_desc: str = NO_PARTITION_DESC
    partition_values: dict[str, str] = field(default_factory=dict)
    # on-disk bytes per data file (from DataFileOp.size); lets readers choose
    # materialize-vs-stream without extra object-store HEAD requests
    file_sizes: list[int] = field(default_factory=list)
    # wall-clock instant (now_millis timebase) the EARLIEST commit feeding
    # this unit became visible in partition_info — 0 when unknown (batch
    # plans don't carry it).  Streaming followers subtract it from delivery
    # time to measure commit-to-visible freshness (freshness/slo.py); the
    # earliest contributing commit makes the figure the WORST-case staleness
    # of the unit, which is what an SLO must bound.
    commit_timestamp_ms: int = 0

    @property
    def needs_merge(self) -> bool:
        return bool(self.primary_keys) and len(self.data_files) > 1


class MetaDataClient:
    """Backend-agnostic metadata client (default: SQLite store)."""

    def __init__(self, store: MetadataStore | None = None, db_path: str | None = None):
        if store is None:
            store = SqliteMetadataStore(db_path or ":memory:")
        self.store = store
        # table_id → (desc epoch at verification time, all-canonical)
        self._canonical_desc_cache: dict[str, tuple[str, bool]] = {}

    # ------------------------------------------------------------------ DDL
    def create_namespace(self, name: str, properties: str = "{}", comment: str = "") -> None:
        self.store.insert_namespace(Namespace(namespace=name, properties=properties, comment=comment))

    def create_table(
        self,
        table_name: str,
        table_path: str,
        schema: pa.Schema,
        *,
        primary_keys: list[str] | None = None,
        range_partitions: list[str] | None = None,
        properties: dict | None = None,
        namespace: str = "default",
        domain: str = "public",
    ) -> TableInfo:
        primary_keys = list(primary_keys or [])
        range_partitions = list(range_partitions or [])
        props = dict(properties or {})
        if primary_keys and "hashBucketNum" not in props:
            props["hashBucketNum"] = "4"  # reference default (catalog.py:214)
        for col in primary_keys + range_partitions:
            if col not in schema.names:
                raise MetadataError(f"partition/pk column {col!r} not in schema")
        info = TableInfo(
            table_id=TableInfo.new_table_id(),
            table_namespace=namespace,
            table_name=table_name,
            table_path=table_path,
            table_schema=schema_to_json(schema),
            table_schema_arrow_ipc=schema_to_ipc(schema),
            properties=props,
            partitions=encode_partitions_field(range_partitions, primary_keys),
            domain=domain,
        )
        self.store.insert_table_info(info)
        return info

    def drop_table(self, table_name: str, namespace: str = "default") -> TableInfo:
        info = self.get_table_info_by_name(table_name, namespace)
        self.store.delete_table(info.table_id)
        return info

    def get_table_info_by_name(self, table_name: str, namespace: str = "default") -> TableInfo:
        info = self.store.get_table_info_by_name(table_name, namespace)
        if info is None:
            raise TableNotFoundError(f"table {namespace}.{table_name} not found")
        return info

    def get_table_info_by_path(self, path: str) -> TableInfo:
        info = self.store.get_table_info_by_path(path)
        if info is None:
            raise TableNotFoundError(f"table at path {path} not found")
        return info

    def table_exists(self, table_name: str, namespace: str = "default") -> bool:
        return self.store.get_table_info_by_name(table_name, namespace) is not None

    def list_tables(self, namespace: str = "default") -> list[str]:
        return self.store.list_tables(namespace)

    def list_namespaces(self) -> list[str]:
        return self.store.list_namespaces()

    def drop_namespace(self, name: str) -> None:
        """Remove an empty namespace (reference: DBManager.deleteNamespace —
        refusing non-empty namespaces prevents orphaning tables)."""
        if name == "default":
            raise MetadataError("the default namespace cannot be dropped")
        if name not in self.store.list_namespaces():
            raise MetadataError(f"namespace {name!r} does not exist")
        if self.store.list_tables(name):
            raise MetadataError(f"namespace {name!r} is not empty")
        self.store.delete_namespace(name)

    def update_table_schema(self, table_id: str, schema: pa.Schema) -> None:
        self.store.update_table_schema(table_id, schema_to_json(schema), schema_to_ipc(schema))

    # --------------------------------------------------------------- commits
    def commit_data(
        self, meta_info: MetaInfo, commit_op: CommitOp, *, lease=None
    ) -> None:
        """Two-phase commit with optimistic retry.

        Phase 1 (insert_data_commit_info) is done by the writer beforehand;
        this is phase 2: advance each partition's version chain.  On PK
        conflict (another committer won the version) the current head is
        re-read and the commit retried — Append/Merge simply stack on the new
        head; Compaction/Update re-validate their read version and abort if
        the partition moved (the caller must re-run on fresh data).

        ``lease`` (a :class:`~lakesoul_tpu_torch.meta.store.Lease`) fences phase 2
        on the lease row inside the same store transaction: a holder whose
        TTL lapsed and whose lease was re-acquired by a peer gets
        :class:`LeaseFencedError` instead of committing zombie work.

        Callers building MetaInfo by hand must use canonical partition descs
        (range-column order; ``dict_to_partition_desc``) — phase 1 already
        inserted data commits under the same desc, and planner fast paths
        index on the canonical form.  ``commit_data_files`` does this for you."""
        if meta_info.table_info is None:
            raise MetadataError("table info missing")
        from lakesoul_tpu_torch.obs import registry, span
        from lakesoul_tpu_torch.runtime import faults

        started = time.perf_counter()
        table_name = meta_info.table_info.table_name
        retryable = commit_op not in (CommitOp.COMPACTION, CommitOp.UPDATE)

        def attempt():
            # kill-mid-commit chaos point: phase 1 (data-commit rows) is
            # durable, phase 2 (partition version advance) has not run yet
            faults.maybe_inject("meta.commit.phase2")
            try:
                with span("meta.commit", op=commit_op.value):
                    return self._commit_data_once(meta_info, commit_op, lease=lease)
            except CommitConflictError as e:
                registry().counter("lakesoul_meta_commit_conflicts_total").inc()
                if not retryable:
                    # the snapshot this job produced was computed from a stale
                    # read version; stacking it would lose concurrent writes
                    logger.warning(
                        "commit %s conflict on table=%s: %s (not retryable)",
                        commit_op.value, table_name, e,
                    )
                raise

        def on_retry(attempt_no, exc):
            logger.warning(
                "commit %s conflict on table=%s attempt=%d/%d; retrying",
                commit_op.value, table_name, attempt_no, MAX_COMMIT_RETRIES,
            )

        try:
            if not retryable:
                result = attempt()
            else:
                result = _commit_retry_policy().run(
                    attempt, op="meta.commit", on_retry=on_retry
                )
        except CommitConflictError as e:
            if not retryable:
                raise
            logger.error(
                "commit %s failed after %d retries on table=%s",
                commit_op.value, MAX_COMMIT_RETRIES, table_name,
            )
            raise CommitConflictError(
                f"commit failed after {MAX_COMMIT_RETRIES} retries"
            ) from e
        registry().histogram(
            "lakesoul_meta_commit_seconds", op=commit_op.value
        ).observe(time.perf_counter() - started)
        registry().counter(
            "lakesoul_meta_commits_total", op=commit_op.value
        ).inc()
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "commit %s table=%s partitions=%d in %.1fms",
                commit_op.value,
                table_name,
                len(meta_info.list_partition),
                (time.perf_counter() - started) * 1e3,
            )
        return result

    def _commit_data_once(
        self, meta_info: MetaInfo, commit_op: CommitOp, *, lease=None
    ) -> None:
        table_info = meta_info.table_info
        cur_map = {
            desc: self.store.get_latest_partition_info(table_info.table_id, desc)
            for desc in {p.partition_desc for p in meta_info.list_partition}
        }
        new_partition_list: list[PartitionInfo] = []

        if commit_op in (CommitOp.APPEND, CommitOp.MERGE):
            for p in meta_info.list_partition:
                cur = cur_map.get(p.partition_desc)
                if cur is not None:
                    # idempotence: a replayed commit id that already made it
                    # into the snapshot must not be appended twice (crash
                    # between phase 2 and mark_committed, or a racing replay)
                    fresh = [c for c in p.snapshot if c not in cur.snapshot]
                    if not fresh:
                        continue
                    nxt = cur.clone()
                    nxt.snapshot.extend(fresh)
                    nxt.version += 1
                else:
                    nxt = PartitionInfo(
                        table_id=table_info.table_id,
                        partition_desc=p.partition_desc,
                        version=0,
                        snapshot=list(p.snapshot),
                    )
                nxt.commit_op = commit_op
                nxt.expression = p.expression
                nxt.timestamp = now_millis()
                nxt.domain = table_info.domain
                new_partition_list.append(nxt)

        elif commit_op in (CommitOp.COMPACTION, CommitOp.UPDATE):
            read_map = {p.partition_desc: p for p in meta_info.read_partition_info}
            for p in meta_info.list_partition:
                cur = cur_map.get(p.partition_desc)
                if cur is not None:
                    nxt = cur.clone()
                else:
                    nxt = PartitionInfo(
                        table_id=table_info.table_id,
                        partition_desc=p.partition_desc,
                        version=-1,
                    )
                read_version = read_map.get(p.partition_desc)
                read_version = read_version.version if read_version else 0
                if cur is None or read_version == cur.version:
                    nxt.snapshot = list(p.snapshot)
                else:
                    # partition advanced since this job read it: implementing
                    # the branch left TODO in the reference
                    # (metadata_client.rs:585-588) — refuse to clobber newer
                    # commits; the caller re-reads and re-runs.
                    raise CommitConflictError(
                        f"{commit_op.value} read version {read_version} but current is"
                        f" {cur.version} for {p.partition_desc}"
                    )
                nxt.version += 1
                nxt.commit_op = commit_op
                nxt.expression = p.expression
                nxt.timestamp = now_millis()
                nxt.domain = table_info.domain
                new_partition_list.append(nxt)

        elif commit_op == CommitOp.DELETE:
            for p in meta_info.list_partition:
                cur = cur_map.get(p.partition_desc)
                if cur is None:
                    continue
                nxt = cur.clone()
                nxt.version += 1
                nxt.commit_op = commit_op
                nxt.expression = p.expression
                nxt.snapshot = []
                nxt.timestamp = now_millis()
                new_partition_list.append(nxt)
        else:
            raise MetadataError(f"unsupported commit op {commit_op}")

        range_cols = table_info.range_partition_columns
        self.store.transaction_insert_partition_info(
            new_partition_list,
            # attest canonicality so the store can CAS the verified flag
            # forward atomically with the epoch bump — a new canonical desc
            # then costs O(1) at plan time instead of a full desc re-scan
            descs_canonical=all(
                self._is_canonical_desc(p.partition_desc, range_cols)
                for p in new_partition_list
                if p.version >= 0
            ),
            lease_guard=lease.guard() if lease is not None else None,
        )

    def commit_data_files(
        self,
        table_info: TableInfo,
        files_by_partition: dict[str, list[DataFileOp]],
        commit_op: CommitOp,
        *,
        commit_id_by_partition: dict[str, str] | None = None,
        read_partition_info: list[PartitionInfo] | None = None,
        storage_options: dict | None = None,
        lease=None,
        staged_deleted_on_conflict: bool = False,
    ) -> list[DataCommitInfo]:
        """Convenience used by writers: phase 1 (insert data commits) + phase 2
        (advance partition versions) in one call.  ``commit_id_by_partition``
        makes streaming ingest idempotent: a commit id that is already present
        and committed is skipped (the Flink exactly-once pattern,
        LakeSoulSinkGlobalCommitter.java:95).  A skipped replay deletes the
        freshly re-staged duplicate files (they are unknown to the durable
        commit and would otherwise orphan on the object store forever).

        Partition-desc keys are canonicalized to range-column order on entry
        so the stored desc is unique per partition regardless of how the
        caller ordered the k=v pairs (planner fast paths index on it)."""
        range_cols = table_info.range_partition_columns
        new_commits: list[DataCommitInfo] = []
        partitions: list[PartitionInfo] = []
        done_ids: list[tuple[str, str]] = []  # (partition_desc, commit_id) to flag committed
        for raw_desc, file_ops in files_by_partition.items():
            desc = canonical_partition_desc(raw_desc, range_cols)
            cid = (commit_id_by_partition or {}).get(raw_desc) or DataCommitInfo.new_commit_id()
            state = self.store.commit_state(table_info.table_id, desc, cid)
            if state is True:
                # fully durable already: idempotent replay is a no-op — but the
                # replay re-staged fresh files under new names; drop any that
                # the durable commit does not reference
                self._delete_replay_orphans(
                    table_info.table_id, desc, cid, file_ops, storage_options
                )
                continue
            if state is None:
                new_commits.append(
                    DataCommitInfo(
                        table_id=table_info.table_id,
                        partition_desc=desc,
                        commit_id=cid,
                        file_ops=list(file_ops),
                        commit_op=commit_op,
                        committed=False,
                        timestamp=now_millis(),
                        domain=table_info.domain,
                    )
                )
            else:
                # state is False → the writer crashed between phase 1 and
                # phase 2: re-run phase 2 so the durable commit's files become
                # visible.  The replay's re-staged files are not the ones the
                # durable commit references — drop them like the state-True path
                self._delete_replay_orphans(
                    table_info.table_id, desc, cid, file_ops, storage_options
                )
            partitions.append(
                PartitionInfo(
                    table_id=table_info.table_id,
                    partition_desc=desc,
                    snapshot=[cid],
                    # leased commits stamp their fencing token into the
                    # version row: commit history then PROVES which holder
                    # produced each compaction (the chaos tests assert
                    # zero double-compaction from exactly this trail)
                    expression=f"fence={lease.fencing_token}" if lease else "",
                )
            )
            done_ids.append((desc, cid))
        if not partitions:
            return []
        if new_commits:
            self.store.insert_data_commit_info(new_commits)
        meta_info = MetaInfo(
            table_info=table_info,
            list_partition=partitions,
            read_partition_info=list(read_partition_info or []),
        )
        from lakesoul_tpu_torch.errors import LeaseFencedError

        try:
            self.commit_data(meta_info, commit_op, lease=lease)
        except (CommitConflictError, LeaseFencedError) as e:
            # a fenced commit — or a conflicted commit whose caller deletes
            # its staged files and re-runs from fresh state with a new
            # commit id — is dead for GOOD.  Without this, every lost race
            # leaves committed=0 phase-1 rows lingering until a recovery
            # sweep (the two-services-race chaos test caught exactly that
            # debris).  Only the rows THIS call inserted are deleted;
            # replayed durable ids are untouched.  Scoped to commits whose
            # staged files the CALLER provably deletes on this error:
            # compactions always do, and partition rewrites declare it via
            # ``staged_deleted_on_conflict``.  A conflicted UPDATE whose
            # staged files SURVIVE (cdc checkpoint_replace) keeps its rows
            # instead: its retries reuse the same staged files via the
            # replay path, and after exhausted retries the committed=0 rows
            # are what lets recover_incomplete_commits find and delete the
            # files rather than leaking them.
            dead = (
                isinstance(e, LeaseFencedError)
                or commit_op is CommitOp.COMPACTION
                or staged_deleted_on_conflict
            )
            if dead:
                for c in new_commits:
                    self.store.delete_data_commit_info(
                        c.table_id, c.partition_desc, [c.commit_id]
                    )
            raise
        for desc, cid in done_ids:
            self.store.mark_committed(table_info.table_id, desc, [cid])
        return new_commits

    def _delete_replay_orphans(
        self,
        table_id: str,
        partition_desc: str,
        commit_id: str,
        file_ops: list[DataFileOp],
        storage_options: dict | None,
    ) -> None:
        """Best-effort removal of files staged by an idempotent replay whose
        commit id was already durable (they were invisible to both
        abort() and the cleaner)."""
        from lakesoul_tpu_torch.io.object_store import delete_file

        durable = self.store.get_data_commit_info(table_id, partition_desc, [commit_id])
        known = {op.path for c in durable for op in c.file_ops}
        for op in file_ops:
            if op.path not in known:
                try:
                    delete_file(op.path, storage_options)
                except Exception:
                    pass  # cleanup is advisory; never fail a successful replay

    # --------------------------------------------------------- crash recovery
    def recover_incomplete_commits(
        self,
        *,
        table_id: str | None = None,
        min_age_ms: int = 0,
        storage_options: dict | None = None,
    ) -> dict:
        """Repair commits a killed writer left between the two phases.

        Phase 1 (data-commit rows) is atomic and durable; phase 2 (partition
        version advance) and the final ``committed`` flag flip each leave a
        distinct crash signature, and each is repaired to a consistent
        state — never a partial one:

        - snapshot references the commit but ``committed=0`` (killed between
          phase 2 and mark_committed): the data is already visible and
          complete — repair the flag (roll forward).
        - unreferenced Append/Merge whose staged files all still exist
          (killed between phases): phase 1 captured the complete file list,
          so re-run phase 2 and publish it (roll forward).
        - anything else — staged files missing, or a snapshot-replacing op
          (Compaction/Update/Delete) whose read-version validation went
          stale with the crash: delete the staged files and the commit row
          (roll back); the job re-runs from fresh state.

        ``min_age_ms`` keeps live in-flight writers out of the sweep (the
        catalog-open hook passes ``LAKESOUL_RECOVER_MIN_AGE_MS``, default
        1 h; the kill-mid-commit test passes 0).  Returns per-action counts,
        also published as ``lakesoul_meta_recovered_commits_total{action=}``.
        """
        from lakesoul_tpu_torch.io.object_store import delete_file
        from lakesoul_tpu_torch.io.object_store import exists as file_exists
        from lakesoul_tpu_torch.obs import registry

        counts = {"flag_repaired": 0, "rolled_forward": 0, "rolled_back": 0}
        lister = getattr(self.store, "list_uncommitted_commits", None)
        if lister is None:
            return counts  # a store without the sweep query has nothing to repair
        cutoff = now_millis() - max(0, int(min_age_ms))
        for c in lister(table_id=table_id, older_than_ms=cutoff):
            info = self.store.get_table_info_by_id(c.table_id)
            if info is None:
                # table dropped out from under the commit: only the row is left
                self.store.delete_data_commit_info(
                    c.table_id, c.partition_desc, [c.commit_id]
                )
                counts["rolled_back"] += 1
                continue
            referenced = any(
                c.commit_id in v.snapshot
                for v in self.store.get_partition_versions(
                    c.table_id, c.partition_desc
                )
            )
            if referenced:
                self.store.mark_committed(c.table_id, c.partition_desc, [c.commit_id])
                counts["flag_repaired"] += 1
                continue
            adds = [op for op in c.file_ops if op.file_op.value == "add"]
            forwardable = c.commit_op in (CommitOp.APPEND, CommitOp.MERGE) and all(
                file_exists(op.path, storage_options) for op in adds
            )
            if forwardable:
                meta_info = MetaInfo(
                    table_info=info,
                    list_partition=[
                        PartitionInfo(
                            table_id=c.table_id,
                            partition_desc=c.partition_desc,
                            snapshot=[c.commit_id],
                        )
                    ],
                )
                try:
                    self.commit_data(meta_info, c.commit_op)
                except CommitConflictError:
                    logger.warning(
                        "recovery of commit %s on %s keeps losing races;"
                        " leaving it for the next sweep",
                        c.commit_id, c.partition_desc,
                    )
                    continue
                self.store.mark_committed(c.table_id, c.partition_desc, [c.commit_id])
                counts["rolled_forward"] += 1
            else:
                for op in adds:
                    try:
                        delete_file(op.path, storage_options)
                    except Exception:
                        pass  # cleanup is advisory; the row delete is the repair
                self.store.delete_data_commit_info(
                    c.table_id, c.partition_desc, [c.commit_id]
                )
                counts["rolled_back"] += 1
        for action, n in counts.items():
            if n:
                logger.info("commit recovery: %s ×%d", action, n)
                registry().counter(
                    "lakesoul_meta_recovered_commits_total", action=action
                ).inc(n)
        return counts

    # ------------------------------------------------------------ scan plans
    _CANONICAL_FLAG = DESCS_VERIFIED_KEY

    @staticmethod
    def _is_canonical_desc(desc: str, range_cols: list[str]) -> bool:
        """Canonical = exactly the table's range columns, in order.  A desc
        with a key SUBSET (``a=1`` on an (a, b) table) must count as
        non-canonical too: it sorts below the ``a=1,`` prefix bound and would
        be dropped by the prefix range even though the full-scan filter
        matches it."""
        if not desc or desc == NO_PARTITION_DESC:
            return True
        keys = [kv.split("=", 1)[0] for kv in desc.split(",")]
        return keys == list(range_cols)

    def _descs_all_canonical(self, table_info: TableInfo) -> bool:
        """Whether every partition desc in the store is in canonical
        range-column order — the precondition for the indexed desc-prefix and
        point-lookup fast paths.  Verified by one
        index-only desc scan; the result is keyed to the store's desc EPOCH
        both in memory and in ``global_config`` (so other clients skip the
        scan too).  The epoch is bumped transactionally by every store-API
        writer that adds a new desc or rewrites one — including external
        hand-committers going through ``transaction_insert_partition_info``
        — so any desc-set change after verification forces a re-check, while
        the steady-state cost per scan plan is a single O(1) epoch lookup."""
        table_id = table_info.table_id
        epoch = self.store.get_desc_epoch(table_id)
        cached = self._canonical_desc_cache.get(table_id)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        if self.store.get_global_config(self._CANONICAL_FLAG + table_id) == epoch:
            self._canonical_desc_cache[table_id] = (epoch, True)
            return True
        range_cols = list(table_info.range_partition_columns)
        ok = all(
            self._is_canonical_desc(d, range_cols)
            for d in self.store.get_partition_descs(table_id)
        )
        self._canonical_desc_cache[table_id] = (epoch, ok)
        if ok:
            # CAS, not a blind set_global_config: the store re-checks the
            # epoch under the row lock, so a desc committed between our scan
            # and this write invalidates the flag instead of being masked by
            # it (the lakelint read-modify-write finding this replaced)
            self.store.set_descs_verified(table_id, epoch)
        return ok

    def canonicalize_partition_descs(self, table_name: str, namespace: str = "default") -> int:
        """Migration: rewrite legacy non-canonical descs (``b=2,a=1``) into
        canonical range-column order across partition_info/data_commit_info
        so the indexed prefix fast path is sound again.  Returns the number
        of descs rewritten.  Two kinds of desc are left in place (keeping the
        full-scan fallback active, so correctness never depends on this
        migration finishing clean): descs whose keys don't match the table's
        range columns (caller-owned formats), and descs whose canonical
        spelling ALREADY exists as a separate partition — that is two version
        chains for one logical partition, and merging them is ambiguous, so
        it is logged and skipped rather than guessed at."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        range_cols = list(table_info.range_partition_columns)
        n = 0
        for desc in self.store.get_partition_descs(table_info.table_id):
            new_desc = canonical_partition_desc(desc, range_cols)
            if new_desc == desc:
                continue
            try:
                self.store.rewrite_partition_desc(table_info.table_id, desc, new_desc)
                n += 1
            except MetadataError as e:
                logger.warning("canonicalize %s: skipping %r: %s", table_name, desc, e)
        self._canonical_desc_cache.pop(table_info.table_id, None)
        self._descs_all_canonical(table_info)  # re-verify; sets flag if clean
        return n

    def _select_partitions(
        self, table_info: TableInfo, partitions: dict[str, str] | None
    ) -> list[PartitionInfo]:
        partitions = partitions or {}
        if not partitions:
            return self.store.get_all_latest_partition_info(table_info.table_id)
        range_cols = table_info.range_partition_columns
        if set(partitions) == set(range_cols):
            # fully-specified filter: one indexed point lookup, O(1) in the
            # partition count — this is the shape behind the reference 3.0
            # "~50 ms plan over millions of partitions" claim.  The hit is
            # only trusted when the store is verified all-canonical: a legacy
            # spelling of the SAME logical partition ('b=1,a=1' beside
            # 'a=1,b=1') could otherwise hold data the point lookup would
            # silently drop.  A miss (or unverified store) falls through to
            # the full scan below.
            desc = dict_to_partition_desc(partitions, range_cols)
            p = self.store.get_latest_partition_info(table_info.table_id, desc)
            if p is not None and self._descs_all_canonical(table_info):
                return [p]
        wanted = [f"{k}={v}" for k, v in partitions.items()]
        n_lead = 0
        while n_lead < len(range_cols) and range_cols[n_lead] in partitions:
            n_lead += 1
        if n_lead == len(range_cols):
            # point lookup above missed: only a legacy non-canonical desc can
            # still match, and it won't start with the canonical prefix either
            n_lead = 0
        if n_lead and not self._descs_all_canonical(table_info):
            # the indexed prefix range only matches canonically-ordered descs;
            # a legacy/hand-committed desc like 'b=2,a=1' would silently
            # vanish from the scan.  Mirror the
            # point-lookup fallback above: full scan when the store may hold
            # non-canonical descs.
            n_lead = 0
        if n_lead:
            # leading range columns pinned: push an indexed desc-prefix range
            # into the store (trailing separator stops d1 matching d10)
            prefix = ",".join(f"{c}={partitions[c]}" for c in range_cols[:n_lead])
            prefix += "," if n_lead < len(range_cols) else ""
            candidates = self.store.get_all_latest_partition_info(
                table_info.table_id, desc_prefix=prefix
            )
        else:
            candidates = self.store.get_all_latest_partition_info(table_info.table_id)
        return [
            p
            for p in candidates
            if all(w in p.partition_desc.split(",") for w in wanted)
        ]

    def _files_for_partition(self, partition: PartitionInfo) -> list[DataFileOp]:
        """Resolve a partition version's snapshot into its live file list,
        honoring add/del file ops in commit order."""
        commits = self.store.get_data_commit_info(
            partition.table_id, partition.partition_desc, partition.snapshot
        )
        files: dict[str, DataFileOp] = {}
        for c in commits:
            for op in c.file_ops:
                if op.file_op.value == "del":
                    files.pop(op.path, None)
                else:
                    files[op.path] = op
        return list(files.values())

    def get_scan_plan_partitions(
        self,
        table_name: str,
        partitions: dict[str, str] | None = None,
        namespace: str = "default",
        *,
        snapshot: list[PartitionInfo] | None = None,
    ) -> list[ScanPlanPartition]:
        """Scan units grouped by (range partition, hash bucket); primary keys
        are dropped when the partition head is a CompactionCommit so the
        reader can skip the merge (native_client.py:404-428).  Pass
        ``snapshot`` to plan over time-travel/incremental partition versions
        instead of the latest."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        pk_cols = table_info.primary_keys
        partition_infos = (
            snapshot if snapshot is not None else self._select_partitions(table_info, partitions)
        )
        plan: list[ScanPlanPartition] = []
        for partition in partition_infos:
            file_ops = self._files_for_partition(partition)
            values = partition_desc_to_dict(partition.partition_desc)
            if not pk_cols:
                if not file_ops:
                    continue
                plan.append(
                    ScanPlanPartition(
                        data_files=[f.path for f in file_ops],
                        primary_keys=[],
                        partition_desc=partition.partition_desc,
                        partition_values=values,
                        file_sizes=[f.size for f in file_ops],
                    )
                )
                continue
            by_bucket: dict[int, list[tuple[str, int]]] = {}
            for f in file_ops:
                bucket = extract_hash_bucket_id(f.path)
                if bucket is None:
                    raise MetadataError(
                        f"cannot determine bucket id from file name {f.path}"
                    )
                by_bucket.setdefault(bucket, []).append((f.path, f.size))
            merge_pks = [] if partition.commit_op == CommitOp.COMPACTION else pk_cols
            for bucket_id, bucket_files in sorted(by_bucket.items()):
                plan.append(
                    ScanPlanPartition(
                        data_files=[p for p, _ in bucket_files],
                        primary_keys=merge_pks,
                        bucket_id=bucket_id,
                        partition_desc=partition.partition_desc,
                        partition_values=values,
                        file_sizes=[s for _, s in bucket_files],
                    )
                )
        return plan

    # -------------------------------------------- time travel & incremental
    def get_snapshot_at_timestamp(
        self, table_name: str, timestamp_ms: int, namespace: str = "default"
    ) -> list[PartitionInfo]:
        """Partition versions as of an instant (reference: time travel via
        SnapshotManagement / LakeSoulOptions READ_TYPE snapshot)."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        out = []
        for p in self.store.get_all_latest_partition_info(table_info.table_id):
            at = self.store.get_partition_at_timestamp(
                table_info.table_id, p.partition_desc, timestamp_ms
            )
            if at is not None:
                out.append(at)
        return out

    def get_incremental_partitions(
        self,
        table_name: str,
        start_timestamp_ms: int,
        end_timestamp_ms: int | None = None,
        namespace: str = "default",
    ) -> list[tuple[PartitionInfo, list[str]]]:
        """Incremental read: for each partition, the data-commit UUIDs added in
        versions with timestamp in (start, end]  (reference: READ_TYPE
        incremental, LakeSoulOptions.scala:128-134).  Returns (version-head,
        new_commit_ids) pairs."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        if end_timestamp_ms is None:
            end_timestamp_ms = now_millis()
        out: list[tuple[PartitionInfo, list[str]]] = []
        for head in self.store.get_all_latest_partition_info(table_info.table_id):
            versions = self.store.get_partition_versions(
                table_info.table_id, head.partition_desc
            )
            prev_snapshot: set[str] = set()
            new_commits: list[str] = []
            last_in_range: PartitionInfo | None = None
            for v in versions:
                added = [c for c in v.snapshot if c not in prev_snapshot]
                if start_timestamp_ms < v.timestamp <= end_timestamp_ms:
                    if v.commit_op == CommitOp.COMPACTION:
                        pass  # compaction rewrites data, adds nothing new
                    elif v.commit_op in (CommitOp.UPDATE,):
                        new_commits = list(v.snapshot)  # full rewrite
                    else:
                        new_commits.extend(added)
                    last_in_range = v
                prev_snapshot = set(v.snapshot)
            if last_in_range is not None and new_commits:
                out.append((last_in_range, new_commits))
        return out

    def incremental_scan_plan(
        self,
        table_name: str,
        start_timestamp_ms: int,
        end_timestamp_ms: int | None = None,
        namespace: str = "default",
    ) -> list[ScanPlanPartition]:
        """Scan units covering only data committed in the window."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        pk_cols = table_info.primary_keys
        plan: list[ScanPlanPartition] = []
        for head, commit_ids in self.get_incremental_partitions(
            table_name, start_timestamp_ms, end_timestamp_ms, namespace
        ):
            plan.extend(
                self._units_from_commits(
                    table_info, head.partition_desc, commit_ids, pk_cols
                )
            )
        return plan

    # ------------------------------------------------- streaming follow plans
    def init_follow_cursors(
        self, table_name: str, start_timestamp_ms: int, namespace: str = "default"
    ) -> dict[str, "PartitionCursor"]:
        """Per-partition version cursors positioned at ``start_timestamp_ms``
        (partitions created later are picked up from version 0)."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        cursors: dict[str, PartitionCursor] = {}
        for head in self.store.get_all_latest_partition_info(table_info.table_id):
            at = self.store.get_partition_at_timestamp(
                table_info.table_id, head.partition_desc, start_timestamp_ms
            )
            if at is not None:
                cursors[head.partition_desc] = PartitionCursor(
                    at.version, set(at.snapshot)
                )
        return cursors

    def poll_scan_plan(
        self,
        table_name: str,
        cursors: dict[str, "PartitionCursor"],
        namespace: str = "default",
    ) -> list[ScanPlanPartition]:
        """Scan units for commits past the cursors; advances ``cursors`` in
        place.  Cost is O(new commits): an unchanged partition is skipped on
        the head-version check alone, with zero extra store queries — the
        reference Flink enumerator's incremental split discovery, without
        re-diffing version history every poll."""
        table_info = self.get_table_info_by_name(table_name, namespace)
        pk_cols = table_info.primary_keys
        plan: list[ScanPlanPartition] = []
        for head in self.store.get_all_latest_partition_info(table_info.table_id):
            desc = head.partition_desc
            cur = cursors.get(desc)
            if cur is not None and head.version <= cur.version:
                continue  # nothing new for this partition
            start_v = cur.version + 1 if cur is not None else 0
            versions = self.store.get_partition_versions(
                table_info.table_id, desc, start_version=start_v
            )
            prev_snapshot = set(cur.snapshot) if cur is not None else set()
            new_commits: list[str] = []
            commit_ts: dict[str, int] = {}
            for v in versions:
                if v.commit_op == CommitOp.COMPACTION:
                    pass  # rewrites data, adds nothing new
                elif v.commit_op == CommitOp.UPDATE:
                    new_commits = list(v.snapshot)  # full rewrite
                    commit_ts = {c: v.timestamp for c in new_commits}
                else:
                    fresh = [c for c in v.snapshot if c not in prev_snapshot]
                    new_commits.extend(fresh)
                    # the version row's timestamp IS the visibility instant:
                    # the commit became readable when this row landed
                    for c in fresh:
                        commit_ts[c] = v.timestamp
                prev_snapshot = set(v.snapshot)
            if versions:
                cursors[desc] = PartitionCursor(versions[-1].version, prev_snapshot)
            else:
                cursors[desc] = PartitionCursor(head.version, set(head.snapshot))
            if not new_commits:
                continue
            plan.extend(
                self._units_from_commits(
                    table_info, desc, new_commits, pk_cols,
                    commit_timestamps=commit_ts,
                )
            )
        return plan

    def _units_from_commits(
        self,
        table_info: TableInfo,
        partition_desc: str,
        commit_ids: list[str],
        pk_cols: list[str],
        *,
        commit_timestamps: dict[str, int] | None = None,
    ) -> list[ScanPlanPartition]:
        """Scan units covering exactly the files added by the given commits.
        ``commit_timestamps`` (commit id → visibility instant from the
        partition_info version row) stamps each unit with the EARLIEST
        contributing commit's timestamp for freshness accounting."""
        commits = self.store.get_data_commit_info(
            table_info.table_id, partition_desc, commit_ids
        )
        values = partition_desc_to_dict(partition_desc)
        files = [
            (op, c.commit_id)
            for c in commits
            for op in c.file_ops
            if op.file_op.value == "add"
        ]
        if not files:
            return []
        ts = commit_timestamps or {}

        def unit_ts(commit_ids_of_unit) -> int:
            known = [ts[c] for c in commit_ids_of_unit if c in ts]
            return min(known) if known else 0

        if not pk_cols:
            return [
                ScanPlanPartition(
                    data_files=[f.path for f, _ in files],
                    primary_keys=[],
                    partition_desc=partition_desc,
                    partition_values=values,
                    file_sizes=[f.size for f, _ in files],
                    commit_timestamp_ms=unit_ts([cid for _, cid in files]),
                )
            ]
        by_bucket: dict[int, list[tuple[str, int, str]]] = {}
        for f, cid in files:
            bucket = extract_hash_bucket_id(f.path)
            if bucket is None:
                raise MetadataError(
                    f"cannot determine bucket id from file name {f.path}"
                )
            by_bucket.setdefault(bucket, []).append((f.path, f.size, cid))
        return [
            ScanPlanPartition(
                data_files=[p for p, _, _ in bucket_files],
                primary_keys=pk_cols,
                bucket_id=bucket_id,
                partition_desc=partition_desc,
                partition_values=values,
                file_sizes=[s for _, s, _ in bucket_files],
                commit_timestamp_ms=unit_ts([cid for _, _, cid in bucket_files]),
            )
            for bucket_id, bucket_files in sorted(by_bucket.items())
        ]

    # ----------------------------------------------------------------- misc
    def meta_cleanup(self) -> None:
        self.store.clean_all_for_test()
