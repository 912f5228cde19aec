"""Cleaner: expire old snapshots and delete discarded/orphaned data files
(the port's copy of ``lakesoul_tpu/compaction/cleaner.py``).

Role parity with the reference's Spark cleaner
(lakesoul-spark/…/clean/CleanExpiredData.scala): per table it
1. drops partition versions older than the retention window — but never the
   current head, and never versions newer than the latest CompactionCommit
   at-or-before the cutoff (time travel inside the window keeps working);
2. deletes data files that no surviving snapshot references;
3. deletes files queued in ``discard_compressed_file_info`` (compaction
   leftovers) past their grace period."""

from __future__ import annotations

import logging

from lakesoul_tpu_torch.io.object_store import delete_file
from lakesoul_tpu_torch.meta.entity import now_millis

logger = logging.getLogger(__name__)


class Cleaner:
    def __init__(self, catalog, *, retention_ms: int = 7 * 24 * 3600 * 1000,
                 discard_grace_ms: int = 3600 * 1000, deleter=None):
        """``deleter`` routes object deletes somewhere other than the store
        directly (a callable with :func:`delete_file`'s signature); the
        default talks to the object store like the reference's Spark
        cleaner does."""
        self.catalog = catalog
        self.retention_ms = retention_ms
        self.discard_grace_ms = discard_grace_ms
        self._delete = deleter or delete_file

    def _version_retention_for(self, info) -> int:
        """``lakesoul.version.retention`` (days) beats the cleaner default;
        absent/invalid values fall back (logged in TableInfo parsing terms:
        accessor returns None)."""
        days = info.version_retention_days
        if days is None and "lakesoul.version.retention" in (info.properties or {}):
            logger.warning(
                "table %s has invalid lakesoul.version.retention=%r; using default",
                info.table_name, info.properties.get("lakesoul.version.retention"),
            )
        if days is None:
            return self.retention_ms
        return int(days * 24 * 3600 * 1000)

    def expire_partitions(self, table_name: str, namespace: str = "default",
                          *, now_ms: int | None = None) -> int:
        """``partition.ttl`` (days) = partition DATA lifetime, matching the
        reference's semantics: a partition whose NEWEST commit is older than
        the ttl is deleted outright (DeleteCommit + live files removed).
        Returns the number of partitions expired."""
        now_ms = now_ms or now_millis()
        client = self.catalog.client
        info = client.get_table_info_by_name(table_name, namespace)
        days = info.partition_ttl_days
        if days is None:
            if "partition.ttl" in (info.properties or {}):
                logger.warning(
                    "table %s has invalid partition.ttl=%r; skipping expiry",
                    info.table_name, info.properties.get("partition.ttl"),
                )
            return 0
        cutoff = now_ms - int(days * 24 * 3600 * 1000)
        from lakesoul_tpu_torch.meta.entity import CommitOp, MetaInfo, PartitionInfo

        expired = 0
        for head in client.store.get_all_latest_partition_info(info.table_id):
            if head.timestamp > cutoff or not head.snapshot:
                continue
            live = client._files_for_partition(head)
            client.commit_data(
                MetaInfo(
                    table_info=info,
                    list_partition=[PartitionInfo(info.table_id, head.partition_desc)],
                ),
                CommitOp.DELETE,
            )
            for f in live:
                self._delete(f.path, self.catalog.storage_options, missing_ok=True)
            logger.info(
                "expired partition %s of %s (%d files)",
                head.partition_desc, table_name, len(live),
            )
            expired += 1
        return expired

    def clean_table(self, table_name: str, namespace: str = "default",
                    *, now_ms: int | None = None) -> dict:
        """Returns {"versions_dropped": n, "files_deleted": n}."""
        now_ms = now_ms or now_millis()
        client = self.catalog.client
        info = client.get_table_info_by_name(table_name, namespace)
        cutoff = now_ms - self._version_retention_for(info)
        store = client.store
        versions_dropped = 0
        files_deleted = 0

        for head in store.get_all_latest_partition_info(info.table_id):
            versions = store.get_partition_versions(info.table_id, head.partition_desc)
            # newest version at-or-before the cutoff that we can anchor on:
            # everything strictly older is reconstructible from it only if it
            # is a CompactionCommit; otherwise keep the chain
            keep_from = 0
            for v in versions:
                if v.timestamp <= cutoff and v.commit_op.value == "CompactionCommit":
                    keep_from = v.version
            if keep_from == 0:
                continue
            # commits still referenced by surviving versions
            surviving = {c for v in versions if v.version >= keep_from for c in v.snapshot}
            dropped = store.delete_partition_versions_before(
                info.table_id, head.partition_desc, keep_from
            )
            versions_dropped += len(dropped)
            dead_commits = {
                c for v in dropped for c in v.snapshot if c not in surviving
            }
            for cid in dead_commits:
                try:
                    commits = store.get_data_commit_info(
                        info.table_id, head.partition_desc, [cid]
                    )
                except Exception:
                    continue
                for commit in commits:
                    for op in commit.file_ops:
                        self._delete(op.path, self.catalog.storage_options, missing_ok=True)
                        files_deleted += 1
                store.delete_data_commit_info(info.table_id, head.partition_desc, [cid])
        return {"versions_dropped": versions_dropped, "files_deleted": files_deleted}

    def clean_discarded_files(self, *, now_ms: int | None = None) -> int:
        """Delete compaction-replaced files past the grace period
        (reference: discard_compressed_file_info consumption)."""
        now_ms = now_ms or now_millis()
        store = self.catalog.client.store
        rows = store.list_discard_files(older_than_ms=now_ms - self.discard_grace_ms)
        deleted = []
        for file_path, _table_path, _desc in rows:
            self._delete(file_path, self.catalog.storage_options, missing_ok=True)
            deleted.append(file_path)
        store.delete_discard_files(deleted)
        return len(deleted)

    def clean_all(self, *, now_ms: int | None = None) -> dict:
        out = {
            "versions_dropped": 0,
            "files_deleted": 0,
            "discarded_deleted": 0,
            "partitions_expired": 0,
        }
        for ns in self.catalog.list_namespaces():
            for name in self.catalog.list_tables(ns):
                out["partitions_expired"] += self.expire_partitions(name, ns, now_ms=now_ms)
                r = self.clean_table(name, ns, now_ms=now_ms)
                out["versions_dropped"] += r["versions_dropped"]
                out["files_deleted"] += r["files_deleted"]
        out["discarded_deleted"] = self.clean_discarded_files(now_ms=now_ms)
        return out
