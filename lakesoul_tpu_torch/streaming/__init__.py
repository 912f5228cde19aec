"""Exactly-once streaming ingest of the port: the checkpointed writer
(the Flight gateway's DoPut commits through it), the CDC ingestor with
REPLACE-mode checkpoints (:mod:`.cdc`) and whole-database sync
(:mod:`.db_sync`), copies of ``lakesoul_tpu/streaming/``."""

from lakesoul_tpu_torch.streaming.cdc import CdcIngestor, CheckpointedWriter
from lakesoul_tpu_torch.streaming.db_sync import DatabaseSyncer, DebeziumJsonConsumer

__all__ = [
    "CdcIngestor",
    "CheckpointedWriter",
    "DatabaseSyncer",
    "DebeziumJsonConsumer",
]
