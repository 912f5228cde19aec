"""Atomic publication of one file on a local filesystem (the subset of
``lakesoul_tpu/runtime/atomicio.py``'s ``publish_bytes_fs`` that the
index and plane manifests use).

Protocol: write ``<path>.tmp-<pid>-<random>`` in the same directory, flush,
fsync, then ``os.replace`` it onto ``path`` (atomic on POSIX).  A crash
leaves the old file or the new one, never a torn one; an overwritten
pointer (``LATEST``, ``PLANE``) is always readable.
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path


def publish_bytes(path: str | Path, data: bytes) -> None:
    """Replace ``path`` with ``data`` atomically."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
