"""Exactly-once streaming ingest of the port: the checkpointed writer the
Flight gateway's DoPut commits through (:mod:`.cdc`).  The reference's CDC
ingestor, REPLACE-mode checkpoints and database sync are not ported yet."""

from lakesoul_tpu_torch.streaming.cdc import CheckpointedWriter

__all__ = ["CheckpointedWriter"]
