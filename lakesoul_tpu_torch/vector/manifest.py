"""Read side of the versioned vector-index store (the port of
``lakesoul_tpu/vector/manifest.py``'s ``ManifestStore`` read path).

Reads a local index directory written by the JAX package's
``ManifestStore.write_index``: a ``LATEST`` pointer →
``manifests/manifest-<gen>.json`` → npz segment files, every blob
CRC32-checked.  It is the on-disk form of :meth:`IvfRabitqIndex.state`.
Object-store URIs are not read yet."""

from __future__ import annotations

import dataclasses
import io
import json
import zlib
from pathlib import Path

import numpy as np

from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex

LATEST = "LATEST"


def _crc_unwrap(blob: bytes, what: str) -> bytes:
    if len(blob) < 4:
        raise VectorIndexError(f"corrupt {what}: too short")
    crc, payload = int.from_bytes(blob[:4], "big"), blob[4:]
    if zlib.crc32(payload) != crc:
        raise VectorIndexError(f"corrupt {what}: CRC mismatch")
    return payload


class ManifestStore:
    """Read-only view of an index directory on the local filesystem."""

    def __init__(self, root: str | Path):
        root = str(root)
        if "://" in root and not root.startswith("file://"):
            raise VectorIndexError(f"only local index directories are read yet, not {root!r}")
        self.root = Path(root.removeprefix("file://"))

    def _read_blob(self, rel: str) -> bytes:
        return (self.root / rel).read_bytes()

    def exists(self) -> bool:
        return (self.root / LATEST).exists()

    def latest_generation(self) -> int:
        try:
            mpath = _crc_unwrap(self._read_blob(LATEST), LATEST).decode()
        except FileNotFoundError:
            return 0
        return int(mpath.rsplit("-", 1)[-1].split(".")[0])

    def read_manifest(self) -> dict:
        mpath = _crc_unwrap(self._read_blob(LATEST), LATEST).decode()
        return json.loads(_crc_unwrap(self._read_blob(mpath), mpath))

    def read_latest(self, *, device=None) -> IvfRabitqIndex:
        return IvfRabitqIndex.from_state(self.state(self.read_manifest()), device=device)

    def state(self, manifest: dict) -> dict:
        """A manifest and its segments as an :meth:`IvfRabitqIndex.state`."""
        config = VectorIndexConfig.parse(manifest["config"])
        clusters = [self._read_segment(p) for p in manifest["base_segments"]]
        if config.total_bits > 1 and any(
            c.get("scales") is None for c in clusters if len(c["ids"])
        ):
            # legacy shard: written when total_bits > 1 was accepted but only
            # 1-bit quantization existed (no scales persisted) — it is 1-bit
            config = dataclasses.replace(config, total_bits=1)
        deltas = [[] for _ in clusters]
        for entry in manifest["delta_segments"]:
            deltas[entry["cluster"]].append(self._read_segment(entry["path"]))
        return {
            "config": config.encode(),
            "keep_raw": manifest["keep_raw"],
            "centroids": (
                None if manifest["centroids"] is None
                else np.asarray(manifest["centroids"], dtype=np.float32)
            ),
            "clusters": clusters,
            "deltas": deltas,
        }

    def _read_segment(self, rel: str) -> dict:
        payload = _crc_unwrap(self._read_blob(rel), rel)
        with np.load(io.BytesIO(payload)) as z:
            return {f: z[f] for f in z.files}
