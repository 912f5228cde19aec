"""Plane-level manifest: the atomic record of a multi-shard build (the port
of ``lakesoul_tpu/annplane/manifest.py``), on a local path or an
object-store URI.

Same pointer-swap discipline as the per-shard ``ManifestStore``: every
progress state is written as a fresh immutable
``plane/plane-<gen>-<nshards>[c].json`` blob (CRC-wrapped), then the
``PLANE`` pointer is overwritten to name it — readers see the previous
complete record or the new one, never a torn write.  The builder writes one
record per persisted shard, so the newest record doubles as the resume
cursor: ``shards[-1].row_end`` is how many stream rows are durably indexed.
"""

from __future__ import annotations

import json

from lakesoul_tpu_torch.io.object_store import ensure_dir, filesystem_for
from lakesoul_tpu_torch.runtime.atomicio import publish_bytes_fs
from lakesoul_tpu_torch.vector.manifest import _crc_unwrap, _crc_wrap

POINTER = "PLANE"


class PlaneManifestStore:
    def __init__(self, root, storage_options: dict | None = None):
        self.root = str(root).rstrip("/")
        self.storage_options = storage_options or {}
        self.fs, self.root_path = filesystem_for(self.root, self.storage_options, write=True)

    def write(self, manifest: dict) -> None:
        """Persist one progress/completion record and swap the pointer."""
        ensure_dir(f"{self.root}/plane", self.storage_options)
        rel = (
            f"plane/plane-{manifest['generation']}-"
            f"{len(manifest.get('shards', ())):05d}"
            f"{'c' if manifest.get('complete') else ''}.json"
        )
        self._write_blob(rel, _crc_wrap(json.dumps(manifest).encode()))
        self._write_blob(POINTER, _crc_wrap(rel.encode()))

    def _write_blob(self, rel: str, data: bytes) -> None:
        # the PLANE pointer is overwritten per progress record; atomicio
        # keeps a crashed overwrite old-or-new instead of torn
        publish_bytes_fs(self.fs, f"{self.root_path}/{rel}", data)

    def _read_blob(self, rel: str) -> bytes:
        with self.fs.open(f"{self.root_path}/{rel}", "rb") as f:
            return f.read()

    def read(self) -> dict | None:
        """Newest durable record, or None when the plane was never written.
        A corrupt pointer or record raises: a CRC mismatch is damage, not
        absence, and silently restarting a 10M-row build would hide it."""
        try:
            blob = self._read_blob(POINTER)
        except FileNotFoundError:
            return None
        rel = _crc_unwrap(blob, POINTER).decode()
        return json.loads(_crc_unwrap(self._read_blob(rel), rel))

    def exists(self) -> bool:
        return self.fs.exists(f"{self.root_path}/{POINTER}")
