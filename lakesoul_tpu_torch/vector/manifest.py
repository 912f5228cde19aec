"""Versioned vector-index store on a filesystem or an object store (the
port of ``lakesoul_tpu/vector/manifest.py``'s ``ManifestStore``).

Layout as the JAX package's: a ``LATEST`` pointer →
``manifests/manifest-<gen>.json`` → npz segment files
(``segments/cluster_<c>.gen<gen>[.delta_<i>].seg``, fields codes / norms /
factors / ids / code_dot_c / raw, and scales for ex-codes), every blob
CRC32-wrapped, so either package reads what the other writes.  It is the
on-disk form of :meth:`IvfRabitqIndex.state`.  The root may be a local path
or any URI ``io/object_store.py`` resolves (``storage_options`` as the
table's); every blob is published atomically (``runtime/atomicio.py``).
``indexed_files`` records which table data files a shard covers, so an
incremental build inserts only the new ones."""

from __future__ import annotations

import dataclasses
import io
import json
import zlib

import numpy as np

from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.io.object_store import ensure_dir, filesystem_for
from lakesoul_tpu_torch.runtime.atomicio import publish_bytes_fs
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex

LATEST = "LATEST"
SEGMENT_FIELDS = ("codes", "norms", "factors", "ids", "code_dot_c", "raw", "scales")


def _crc_wrap(payload: bytes) -> bytes:
    return zlib.crc32(payload).to_bytes(4, "big") + payload


def _crc_unwrap(blob: bytes, what: str) -> bytes:
    if len(blob) < 4:
        raise VectorIndexError(f"corrupt {what}: too short")
    crc, payload = int.from_bytes(blob[:4], "big"), blob[4:]
    if zlib.crc32(payload) != crc:
        raise VectorIndexError(f"corrupt {what}: CRC mismatch")
    return payload


class ManifestStore:
    """An index directory: a local path or an object-store URI."""

    def __init__(self, root, storage_options: dict | None = None):
        self.root = str(root).rstrip("/")
        self.storage_options = storage_options or {}
        self.fs, self.root_path = filesystem_for(self.root, self.storage_options, write=True)

    # ------------------------------------------------------------------ write
    def write_index(self, index: IvfRabitqIndex, *,
                    indexed_files: list[str] | None = None) -> int:
        """Persist ``index`` as the next generation and swap ``LATEST`` to
        it; returns the generation.  ``indexed_files`` records which table
        data files this shard covers, enabling incremental refresh (only
        new files are inserted)."""
        ensure_dir(f"{self.root}/manifests", self.storage_options)
        ensure_dir(f"{self.root}/segments", self.storage_options)
        generation = self.latest_generation() + 1
        state = index.state()
        base = []
        for c, seg in enumerate(state["clusters"]):
            name = f"segments/cluster_{c}.gen{generation}.seg"
            self._write_segment(name, seg)
            base.append(name)
        delta = []
        for c, segs in enumerate(state["deltas"]):
            for i, seg in enumerate(segs):
                name = f"segments/cluster_{c}.gen{generation}.delta_{i}.seg"
                self._write_segment(name, seg)
                delta.append({"cluster": c, "path": name})
        manifest = {
            "generation": generation,
            "config": state["config"],
            "keep_raw": state["keep_raw"],
            "num_vectors": index.num_vectors,
            "centroids": None if state["centroids"] is None else state["centroids"].tolist(),
            "base_segments": base,
            "delta_segments": delta,
            "indexed_files": sorted(indexed_files or []),
        }
        mpath = f"manifests/manifest-{generation}.json"
        self._write_blob(mpath, _crc_wrap(json.dumps(manifest).encode()))
        self._write_blob(LATEST, _crc_wrap(mpath.encode()))
        return generation

    def _write_segment(self, name: str, seg: dict) -> None:
        buf = io.BytesIO()
        np.savez(buf, **{f: seg[f] for f in SEGMENT_FIELDS if seg.get(f) is not None})
        self._write_blob(name, _crc_wrap(buf.getvalue()))

    def _write_blob(self, rel: str, data: bytes) -> None:
        # LATEST is overwritten by every write_index: a torn overwrite would
        # make the whole store unreadable, so every blob is published whole
        publish_bytes_fs(self.fs, f"{self.root_path}/{rel}", data)

    # ------------------------------------------------------------------- read
    def _read_blob(self, rel: str) -> bytes:
        with self.fs.open(f"{self.root_path}/{rel}", "rb") as f:
            return f.read()

    def exists(self) -> bool:
        return self.fs.exists(f"{self.root_path}/{LATEST}")

    def latest_generation(self) -> int:
        try:
            mpath = _crc_unwrap(self._read_blob(LATEST), LATEST).decode()
        except FileNotFoundError:
            return 0
        return int(mpath.rsplit("-", 1)[-1].split(".")[0])

    def read_manifest(self) -> dict:
        mpath = _crc_unwrap(self._read_blob(LATEST), LATEST).decode()
        return json.loads(_crc_unwrap(self._read_blob(mpath), mpath))

    def read_manifest_at(self, generation: int) -> dict:
        """A PINNED generation's manifest, bypassing ``LATEST``: manifests
        are immutable once written, so a reader holding a generation number
        (the ANN plane's per-shard records) is immune to a concurrent
        rebuild swapping ``LATEST`` underneath it."""
        mpath = f"manifests/manifest-{generation}.json"
        return json.loads(_crc_unwrap(self._read_blob(mpath), mpath))

    def read_at(self, generation: int, *, device=None) -> IvfRabitqIndex:
        return IvfRabitqIndex.from_state(self.state(self.read_manifest_at(generation)),
                                         device=device)

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
