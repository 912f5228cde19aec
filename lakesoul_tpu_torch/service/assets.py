"""Data-assets statistics (the port's copy of
``lakesoul_tpu/service/assets.py``).

Role parity with the reference's data-assets job
(lakesoul-flink/…/entry/assets/CountDataAssets.java, referenced from SURVEY
§5 metrics): walk the catalog's metadata and report per-table / per-namespace
asset counts — tables, partitions, live data files, bytes, and commit
activity — from the metadata store alone (no object-store listing; the
commit log is the source of truth for what is live)."""

from __future__ import annotations

from dataclasses import dataclass, field

import pyarrow as pa


@dataclass
class TableAssets:
    namespace: str
    table_name: str
    table_path: str
    domain: str
    partitions: int = 0
    live_files: int = 0
    live_bytes: int = 0
    total_commits: int = 0
    latest_commit_ts: int = 0
    hash_bucket_num: int = 1


@dataclass
class AssetsReport:
    tables: list[TableAssets] = field(default_factory=list)

    def to_arrow(self) -> pa.Table:
        cols = [
            "namespace", "table_name", "table_path", "domain", "partitions",
            "live_files", "live_bytes", "total_commits", "latest_commit_ts",
            "hash_bucket_num",
        ]
        return pa.table({c: [getattr(t, c) for t in self.tables] for c in cols})

    def by_namespace(self) -> pa.Table:
        agg: dict[str, dict] = {}
        for t in self.tables:
            a = agg.setdefault(
                t.namespace,
                {"tables": 0, "partitions": 0, "live_files": 0, "live_bytes": 0},
            )
            a["tables"] += 1
            a["partitions"] += t.partitions
            a["live_files"] += t.live_files
            a["live_bytes"] += t.live_bytes
        names = sorted(agg)
        return pa.table(
            {
                "namespace": names,
                **{
                    k: [agg[n][k] for n in names]
                    for k in ("tables", "partitions", "live_files", "live_bytes")
                },
            }
        )


def count_data_assets(catalog) -> AssetsReport:
    """One metadata sweep over every namespace/table."""
    client = catalog.client
    report = AssetsReport()
    for ns in catalog.list_namespaces():
        for name in catalog.list_tables(ns):
            info = client.get_table_info_by_name(name, ns)
            t = TableAssets(
                namespace=ns,
                table_name=name,
                table_path=info.table_path,
                domain=info.domain,
                hash_bucket_num=info.hash_bucket_num,
            )
            for head in client.store.get_all_latest_partition_info(info.table_id):
                t.partitions += 1
                t.total_commits += head.version + 1
                t.latest_commit_ts = max(t.latest_commit_ts, head.timestamp)
                # the same add/del fold scan planning uses — one definition
                # of "live" (meta/client.py _files_for_partition)
                live = client._files_for_partition(head)
                t.live_files += len(live)
                t.live_bytes += sum(f.size for f in live)
            report.tables.append(t)
    return report
