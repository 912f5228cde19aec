"""Memory-bounded multi-shard plane build over a vector stream (the port of
``lakesoul_tpu/annplane/build.py``).

The builder consumes an ordered stream of ``(vectors [n, dim], ids [n])``
batches — numpy arrays or tensors — and cuts it into shards of exactly
``config.rows_per_shard()`` rows.  Only ONE shard's working set is ever
held; each shard trains, inserts and merges through
:class:`IvfRabitqIndex` on the builder's device, persists through the
per-shard ``ManifestStore``, and then a plane-level progress record lands
atomically (manifest.py).

:func:`iter_table_vectors` streams a table's vector column through the
bounded scan path (``io/reader.py``'s ``iter_scan_unit_batches`` under the
table's memory budget), and :func:`build_table_ann_plane` builds (or
resumes) a table's plane from it.  The roots and the per-shard stores take
local paths or object-store URIs (``storage_options`` as the table's).

Resume contract: the stream must be deterministic.  A restarted builder
reads the newest plane record, verifies the config digest, SKIPS exactly
the rows covered by completed shards, and continues with the next shard
index — shard-exact, no partial shard is ever visible.  A plane written by
either package resumes in the other: the digest, the layout and the shard
sample draw are the same."""

from __future__ import annotations

import time

import numpy as np
import torch

from lakesoul_tpu_torch.annplane.config import AnnPlaneConfig
from lakesoul_tpu_torch.annplane.manifest import PlaneManifestStore
from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex
from lakesoul_tpu_torch.vector.manifest import ManifestStore

INSERT_CHUNK_ROWS = 262_144


def shard_root(root: str, shard: int) -> str:
    return f"{str(root).rstrip('/')}/shard_{shard:05d}"


class ShardedAnnBuilder:
    def __init__(self, root: str, config: AnnPlaneConfig, *, device=None,
                 storage_options: dict | None = None):
        self.root = str(root).rstrip("/")
        self.config = config
        self.device = resolve_device(device)
        self.storage_options = storage_options or {}
        self.store = PlaneManifestStore(self.root, self.storage_options)
        reg = registry()
        self._c_rows = reg.counter("lakesoul_ann_build_rows_total")
        self._g_shards = reg.gauge("lakesoul_ann_plane_shards")
        self._h_shard = reg.histogram("lakesoul_ann_shard_build_seconds")

    # ------------------------------------------------------------------ build
    def build(self, batches, *, resume: bool = True) -> dict:
        """Stream ``batches`` into shards; returns the complete plane
        manifest.  ``resume=False`` forces a fresh generation regardless of
        prior progress."""
        digest = self.config.digest()
        shards: list[dict] = []
        generation = 1
        prior = self.store.read() if resume else None
        if prior is not None:
            if prior.get("config_digest") == digest:
                if prior.get("complete"):
                    return prior  # nothing to do: the plane is durable
                shards = list(prior.get("shards", ()))
                generation = prior["generation"]
            else:
                # layout changed (dim/bits/budget/...): row ranges no longer
                # line up — rebuild everything under a bumped generation so
                # a torn old plane can never be half-read as the new one
                generation = prior["generation"] + 1
        elif not resume:
            stale = self.store.read()
            if stale is not None:
                generation = stale["generation"] + 1

        rows_per_shard = self.config.rows_per_shard()
        resume_row = shards[-1]["row_end"] if shards else 0
        dim = self.config.index.dim

        buf_v: list[torch.Tensor] = []
        buf_i: list[np.ndarray] = []
        buffered = 0
        cursor = 0  # absolute stream row position

        def flush_shard() -> None:
            nonlocal buffered
            vectors = torch.cat(buf_v) if len(buf_v) > 1 else buf_v[0]
            ids = np.concatenate(buf_i) if len(buf_i) > 1 else buf_i[0]
            buf_v.clear()
            buf_i.clear()
            buffered = 0
            start = time.perf_counter()
            entry = self._build_shard(len(shards), vectors, ids)
            self._h_shard.observe(time.perf_counter() - start)
            entry["row_start"] = shards[-1]["row_end"] if shards else 0
            entry["row_end"] = entry["row_start"] + len(ids)
            shards.append(entry)
            self._c_rows.inc(len(ids))
            self._g_shards.set(len(shards))
            self.store.write(self._manifest(generation, digest, shards, False))

        for vectors, ids in batches:
            ids = np.asarray(ids, dtype=np.uint64)
            if vectors.ndim != 2 or vectors.shape[1] != dim:
                raise VectorIndexError(f"expected [n, {dim}] vectors, got {tuple(vectors.shape)}")
            if len(ids) != len(vectors):
                raise VectorIndexError("ids/vectors length mismatch")
            n = len(ids)
            if cursor + n <= resume_row:  # fully covered by durable shards
                cursor += n
                continue
            if cursor < resume_row:  # batch straddles the resume point
                off = resume_row - cursor
                vectors, ids = vectors[off:], ids[off:]
                cursor = resume_row
                n = len(ids)
            cursor += n
            vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
            while len(ids):
                take = min(rows_per_shard - buffered, len(ids))
                buf_v.append(vectors[:take])
                buf_i.append(ids[:take])
                buffered += take
                vectors, ids = vectors[take:], ids[take:]
                if buffered == rows_per_shard:
                    flush_shard()

        if buffered:
            flush_shard()
        if not shards:
            raise VectorIndexError("no vectors to build an ANN plane from")
        manifest = self._manifest(generation, digest, shards, True)
        self.store.write(manifest)
        return manifest

    def _manifest(self, generation, digest, shards, complete) -> dict:
        return {
            "generation": generation,
            "config_digest": digest,
            "index_config": self.config.index.encode(),
            "keep_raw": self.config.keep_raw,
            "shard_budget_bytes": self.config.budget_bytes,
            "rows_per_shard": self.config.rows_per_shard(),
            "total_rows": shards[-1]["row_end"] if shards else 0,
            "complete": bool(complete),
            "shards": list(shards),
        }

    # ------------------------------------------------------------ shard build
    def _build_shard(self, shard: int, vectors: torch.Tensor, ids: np.ndarray) -> dict:
        cfg = self.config.index
        sample_rows = self.config.train_sample_rows
        kw = dict(keep_raw=self.config.keep_raw, kmeans_iters=self.config.kmeans_iters,
                  device=self.device)
        if len(vectors) <= sample_rows:
            index = IvfRabitqIndex.train(vectors, ids, cfg, **kw)
        else:
            # k-means wants a sample, not the shard: train centroids on a
            # seeded unbiased subsample (the reference's numpy draw), then
            # drop the sample rows and insert EVERY row in bounded chunks
            rng = np.random.default_rng(cfg.seed + shard)
            sel = rng.choice(len(vectors), sample_rows, replace=False)
            index = IvfRabitqIndex.train(
                vectors[torch.from_numpy(sel).to(self.device)], ids[sel], cfg, **kw
            )
            empty = torch.zeros((0, cfg.dim), dtype=torch.float32, device=self.device)
            index.clusters = [
                index._make_cluster(empty, np.zeros(0, np.uint64), c) for c in index.centroids
            ]
            for lo in range(0, len(vectors), INSERT_CHUNK_ROWS):
                index.insert_batch(
                    vectors[lo : lo + INSERT_CHUNK_ROWS], ids[lo : lo + INSERT_CHUNK_ROWS]
                )
            index.merge_deltas()
        store = ManifestStore(shard_root(self.root, shard), self.storage_options)
        gen = store.write_index(index)
        return {"shard": shard, "num_vectors": int(index.num_vectors), "generation": gen}


# ----------------------------------------------------------------- table feed
def iter_table_vectors(
    table,
    column: str,
    id_column: str,
    *,
    batch_size: int = 65_536,
    memory_budget_bytes: int | None = None,
    partitions: dict[str, str] | None = None,
):
    """Stream ``(vectors, ids)`` (host numpy) from a table column through
    the bounded scan path (``iter_scan_unit_batches``) — unit order follows
    the scan plan, so the stream is deterministic and resume-safe."""
    import pyarrow as pa

    from lakesoul_tpu_torch.io.reader import iter_scan_unit_batches
    from lakesoul_tpu_torch.vector.builder import extract_vectors

    info = table.info
    io_cfg = table.io_config()
    budget = (
        io_cfg.memory_budget_bytes if memory_budget_bytes is None
        else memory_budget_bytes
    )
    field = info.arrow_schema.field(column)
    dim = field.type.list_size if hasattr(field.type, "list_size") else None
    scan = table.scan()
    if partitions:
        scan = scan.partitions(partitions)
    for unit in scan.scan_plan():
        for batch in iter_scan_unit_batches(
            unit.data_files,
            unit.primary_keys,
            batch_size=batch_size,
            memory_budget_bytes=budget,
            file_sizes=getattr(unit, "file_sizes", None),
            schema=info.arrow_schema,
            partition_values=unit.partition_values,
            columns=[column, id_column],
            storage_options=table.catalog.storage_options,
        ):
            t = pa.Table.from_batches([batch])
            if len(t) == 0:
                continue
            if dim is None:
                first = t.column(column).combine_chunks()
                dim = len(first[0])
            yield extract_vectors(t, column, id_column, dim)


def build_table_ann_plane(
    table,
    column: str,
    *,
    root: str | None = None,
    config: AnnPlaneConfig | None = None,
    id_column: str | None = None,
    resume: bool = True,
    device=None,
    **cfg_kw,
) -> dict:
    """Build (or resume) the plane of a table's vector column on ``device``
    (``None`` = the CUDA card).  The plane lives beside the table at
    ``{table_path}/_ann_plane/{column}`` unless ``root`` overrides it."""
    import pyarrow as pa

    from lakesoul_tpu_torch.vector.config import VectorIndexConfig

    info = table.info
    if id_column is None:
        if len(info.primary_keys) != 1:
            raise VectorIndexError(
                "ann plane needs id_column= or a single-PK table; table has"
                f" PK {info.primary_keys}"
            )
        id_column = info.primary_keys[0]
    if config is None:
        t = info.arrow_schema.field(column).type
        if pa.types.is_fixed_size_list(t):
            dim = t.list_size
        elif "dim" in cfg_kw:
            dim = cfg_kw.pop("dim")
        else:
            raise VectorIndexError("dim required for non-fixed-size-list columns")
        budget = cfg_kw.pop("shard_budget_bytes", None)
        keep_raw = cfg_kw.pop("keep_raw", True)
        config = AnnPlaneConfig(
            index=VectorIndexConfig(column=column, dim=dim, **cfg_kw),
            shard_budget_bytes=budget,
            keep_raw=keep_raw,
        )
    if root is None:
        root = f"{info.table_path}/_ann_plane/{column}"
    builder = ShardedAnnBuilder(
        root, config, device=device, storage_options=table.catalog.storage_options
    )
    return builder.build(
        iter_table_vectors(table, column, id_column), resume=resume
    )
