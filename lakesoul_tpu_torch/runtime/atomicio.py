"""Atomic publication of one file (the subset of
``lakesoul_tpu/runtime/atomicio.py`` that the checkpointer, the index and
plane manifests and the fleet spool use).

Protocol on a local filesystem: write ``<path>.tmp-<pid>-<random>`` in the
same directory, flush, fsync, then rename it onto ``path`` (atomic on
POSIX).  A crash leaves the old file or the new one, never a torn one; an
overwritten pointer (``LATEST``, ``PLANE``) is always readable.  An object
store gets one direct PUT, which its own contract makes atomic
(:func:`publish_bytes_fs`).
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path


def _is_local(fs) -> bool:
    # unwrap retry/cache layers (ResilientFileSystem, CachedReadFileSystem
    # both keep the wrapped fs on an attribute) to classify the real store
    for _ in range(4):
        inner = getattr(fs, "target", None) or getattr(fs, "inner", None)
        if inner is None:
            break
        fs = inner
    proto = getattr(fs, "protocol", ())
    if isinstance(proto, str):
        proto = (proto,)
    return bool({"file", "local"} & set(proto))


def publish_bytes_fs(fs, path: str, data: bytes) -> None:
    """Publish ``data`` through an fsspec filesystem (possibly wrapped by
    the resilient retry layer).  Local filesystems get the full
    tmp→fsync→rename discipline; object stores get one direct PUT — a
    tmp + server-side rename there would double the requests without
    adding atomicity."""
    if _is_local(fs):
        publish_bytes(path, data)
        return
    with fs.open(path, "wb") as f:
        f.write(data)


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


def fsync_dir(path: str | Path) -> None:
    """fsync the directory ``path``, so a rename into it survives a host
    crash.  Best-effort: a filesystem that refuses directory fsync (some
    network mounts) does not fail the publication."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
