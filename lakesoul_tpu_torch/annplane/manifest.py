"""Plane-level manifest: the atomic record of a multi-shard build (the port
of ``lakesoul_tpu/annplane/manifest.py``, on local paths).

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
from pathlib import Path

from lakesoul_tpu_torch.runtime.atomicio import publish_bytes
from lakesoul_tpu_torch.vector.manifest import _crc_unwrap, _crc_wrap

POINTER = "PLANE"


class PlaneManifestStore:
    def __init__(self, root: str | Path):
        self.root = Path(str(root).rstrip("/"))

    def write(self, manifest: dict) -> None:
        """Persist one progress/completion record and swap the pointer."""
        (self.root / "plane").mkdir(parents=True, exist_ok=True)
        rel = (
            f"plane/plane-{manifest['generation']}-"
            f"{len(manifest.get('shards', ())):05d}"
            f"{'c' if manifest.get('complete') else ''}.json"
        )
        publish_bytes(self.root / rel, _crc_wrap(json.dumps(manifest).encode()))
        publish_bytes(self.root / POINTER, _crc_wrap(rel.encode()))

    def read(self) -> dict | None:
        """Newest durable record, or None when the plane was never written.
        A corrupt pointer or record raises: a CRC mismatch is damage, not
        absence, and silently restarting a 10M-row build would hide it."""
        try:
            blob = (self.root / POINTER).read_bytes()
        except FileNotFoundError:
            return None
        rel = _crc_unwrap(blob, POINTER).decode()
        return json.loads(_crc_unwrap((self.root / rel).read_bytes(), rel))

    def exists(self) -> bool:
        return (self.root / POINTER).exists()
