"""Automatic compaction of the port: the in-process and leased compaction
services (:mod:`.service`, over :mod:`.events`) and the cleaner
(:mod:`.cleaner`), copies of ``lakesoul_tpu/compaction/``.
``python -m lakesoul_tpu_torch.compaction`` is the deployable leased
compactor."""

from lakesoul_tpu_torch.compaction.service import (
    CompactionService,
    LeasedCompactionService,
)
from lakesoul_tpu_torch.compaction.cleaner import Cleaner

__all__ = ["CompactionService", "LeasedCompactionService", "Cleaner"]
