from lakesoul_tpu_torch.meta.entity import (
    CommitOp,
    DataCommitInfo,
    DataFileOp,
    FileOp,
    MetaInfo,
    Namespace,
    PartitionInfo,
    TableInfo,
)
from lakesoul_tpu_torch.meta.client import MetaDataClient, ScanPlanPartition
from lakesoul_tpu_torch.meta.store import MetadataStore, SqliteMetadataStore

__all__ = [
    "CommitOp",
    "DataCommitInfo",
    "DataFileOp",
    "FileOp",
    "MetaInfo",
    "Namespace",
    "PartitionInfo",
    "TableInfo",
    "MetaDataClient",
    "ScanPlanPartition",
    "MetadataStore",
    "SqliteMetadataStore",
]
