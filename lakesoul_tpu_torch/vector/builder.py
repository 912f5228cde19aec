"""Per-bucket vector-index shard builder + table-level build/search (the port
of ``lakesoul_tpu/vector/builder.py``).

One index shard per (range partition, hash bucket) at
``{table_path}/_vector_index/{column}/{partition_desc}/{bucket}/``, vector
row ids are the table's primary keys (u64), search unions per-shard
candidates and re-ranks by exact distance.  The shards are read and written
through :class:`~lakesoul_tpu_torch.vector.manifest.ManifestStore` in the
JAX package's layout, so an index built by either package opens in the
other.

Training, inserts and searches run on ``device`` (``None`` = the CUDA card,
``"cpu"`` = the plain PyTorch path): a search reaches ``packed_dot``'s
product mode through :meth:`IvfRabitqIndex.search`.  The reader streams on
the host under the table's memory budget, as the reference's does.

A search reads every shard it touches from its store, as the reference's
does; a caller that searches many times passes a :class:`TableVectorIndex`,
which holds the opened shards on its device until released."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from lakesoul_tpu_torch.device import resolve_device
from lakesoul_tpu_torch.errors import VectorIndexError
from lakesoul_tpu_torch.io.reader import iter_scan_unit_batches, read_scan_unit
from lakesoul_tpu_torch.vector.config import VectorIndexConfig
from lakesoul_tpu_torch.vector.index import IvfRabitqIndex, SearchParams
from lakesoul_tpu_torch.vector.manifest import ManifestStore

# k-means needs a sample, not the corpus: shards up to this many rows train
# on everything in one pass; larger shards reservoir-sample for training and
# take a second streaming pass to insert
DEFAULT_TRAIN_SAMPLE_ROWS = 200_000


def _shard_root(table_path: str, column: str, partition_desc: str, bucket_id: int) -> str:
    part = partition_desc if partition_desc else "-5"
    return f"{table_path}/_vector_index/{column}/{part}/{max(bucket_id, 0)}"


def extract_vectors(
    table: pa.Table, column: str, id_column: str, dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """FixedSizeList<f32>/List<f32> column + integer PK column → (vectors, ids)
    (reference: extract_vector_batch, vector/reader.rs:25)."""
    col = table.column(column).combine_chunks()
    if col.null_count:
        # a null row contributes no child values (variable lists) or garbage
        # slots (fixed), so col.values would silently misalign against ids —
        # fail typed instead of returning a corrupted index
        raise VectorIndexError(
            f"vector column {column!r} contains {col.null_count} null row(s);"
            " null vectors cannot be indexed — filter or fill them first"
        )
    t = col.type
    if pa.types.is_fixed_size_list(t):
        if t.list_size != dim:
            raise VectorIndexError(f"vector column dim {t.list_size} != config dim {dim}")
        values = np.asarray(col.values, dtype=np.float32).reshape(-1, dim)
    elif pa.types.is_list(t) or pa.types.is_large_list(t):
        values = np.asarray(col.values, dtype=np.float32).reshape(len(col), -1)
        if values.shape[1] != dim:
            raise VectorIndexError(f"vector column dim {values.shape[1]} != config dim {dim}")
    else:
        raise VectorIndexError(f"column {column} is not a vector (list<float>) column")
    ids = np.asarray(table.column(id_column).cast(pa.uint64()), dtype=np.uint64)
    return values, ids


class VectorShardIndexBuilder:
    """Build/refresh the index shard of one scan unit."""

    def __init__(
        self,
        table_path: str,
        config: VectorIndexConfig,
        id_column: str,
        *,
        storage_options: dict | None = None,
        batch_size: int = 65_536,
        memory_budget_bytes: int | None = None,
        train_sample_rows: int | None = None,
        device=None,
    ):
        self.table_path = table_path
        self.config = config
        self.id_column = id_column
        self.storage_options = storage_options or {}
        self.batch_size = batch_size
        from lakesoul_tpu_torch.io.config import DEFAULT_MEMORY_BUDGET

        self.memory_budget_bytes = (
            memory_budget_bytes if memory_budget_bytes is not None else DEFAULT_MEMORY_BUDGET
        )
        # read at call time, so a caller (or a test) may lower the module's
        # default before building
        self.train_sample_rows = (
            DEFAULT_TRAIN_SAMPLE_ROWS if train_sample_rows is None else train_sample_rows
        )
        self.device = resolve_device(device)

    def build(self, unit, schema: pa.Schema, *, keep_raw: bool = True,
              incremental: bool = False) -> int:
        """Scan the unit's files (merged), train a shard index, persist it.

        ``incremental=True`` and an existing shard: only files not yet covered
        by the manifest are read and inserted as delta segments (reference:
        insert_batch → delta segments; note updated PKs keep their stale
        entry too until a full rebuild — exact re-rank resolves ordering, the
        same contract the reference has).  Returns vectors (newly) indexed."""
        store = ManifestStore(
            _shard_root(self.table_path, self.config.column, unit.partition_desc, unit.bucket_id),
            self.storage_options,
        )
        if incremental and store.exists():
            manifest = store.read_manifest()
            # a compaction/rollback rewrote the file set: indexed files no
            # longer exist, so the "new" files are rewrites of already-indexed
            # rows — delta-inserting them would duplicate every id.  Rebuild.
            current = set(unit.data_files)
            already = set(manifest.get("indexed_files", []))
            if manifest.get("config") == self.config.encode() and already <= current:
                new_files = [f for f in unit.data_files if f not in already]
                if not new_files:
                    return 0
                table = read_scan_unit(
                    new_files,
                    [],  # raw appended rows; dedup resolved at re-rank/rebuild
                    schema=schema,
                    partition_values=unit.partition_values,
                    columns=[self.config.column, self.id_column],
                    storage_options=self.storage_options,
                )
                if len(table) == 0:
                    return 0
                vectors, ids = extract_vectors(
                    table, self.config.column, self.id_column, self.config.dim
                )
                index = store.read_latest(device=self.device)
                index.insert_batch(vectors, ids)
                store.write_index(index, indexed_files=sorted(already | set(new_files)))
                return len(ids)
        # full (re)build with bounded memory.  Pass 1 streams the unit,
        # buffering everything up to train_sample_rows and RESERVOIR-sampling
        # beyond it (an unbiased training sample — first-N would bias
        # centroids toward PK-ordered drift).  Small shards finish in that
        # single pass; oversized shards train on the reservoir and take a
        # second streaming pass to insert every vector.
        cap = self.train_sample_rows
        rng = np.random.default_rng(0xC0FFEE)
        reservoir_v: np.ndarray | None = None
        reservoir_i: np.ndarray | None = None
        buffered: list[tuple[np.ndarray, np.ndarray]] = []  # exact rows (small path)
        seen = 0
        for vectors, ids in self._stream_vectors(unit, schema):
            if seen < cap and seen + len(ids) <= cap:
                buffered.append((vectors, ids))
                seen += len(ids)
                continue
            if reservoir_v is None:
                # crossing the cap: seed the reservoir from the exact buffer
                parts_v = [v for v, _ in buffered] or [
                    np.zeros((0, self.config.dim), np.float32)
                ]
                parts_i = [i for _, i in buffered] or [np.zeros(0, np.uint64)]
                reservoir_v = np.concatenate(parts_v)
                reservoir_i = np.concatenate(parts_i)
                buffered = []
                if len(reservoir_v) < cap:  # top up from the current batch
                    take = cap - len(reservoir_v)
                    reservoir_v = np.concatenate([reservoir_v, vectors[:take]])
                    reservoir_i = np.concatenate([reservoir_i, ids[:take]])
                    vectors, ids = vectors[take:], ids[take:]
                    seen = cap
            # algorithm-R style vectorized replacement for the remainder
            m = len(ids)
            if m:
                positions = seen + np.arange(m)
                accept = rng.random(m) < cap / (positions + 1)
                idx = np.nonzero(accept)[0]
                slots = rng.integers(0, cap, len(idx))
                reservoir_v[slots] = vectors[idx]
                reservoir_i[slots] = ids[idx]
                seen += m

        kw = dict(keep_raw=keep_raw, device=self.device)
        if reservoir_v is None:
            # single pass: the whole shard fit in the sample window
            if not buffered:
                return 0
            vectors = np.concatenate([v for v, _ in buffered])
            ids = np.concatenate([i for _, i in buffered])
            index = IvfRabitqIndex.train(vectors, ids, self.config, **kw)
            store.write_index(index, indexed_files=unit.data_files)
            return len(ids)

        # oversized shard: train on the unbiased sample, then pass 2 inserts
        # EVERY vector (the reservoir was for centroids only)
        index = IvfRabitqIndex.train(
            reservoir_v, reservoir_i[: len(reservoir_v)], self.config, **kw
        )
        empty = index._tensor(np.zeros((0, self.config.dim), np.float32))
        index.clusters = [
            index._make_cluster(empty, np.zeros(0, np.uint64), c) for c in index.centroids
        ]  # drop the sample rows: pass 2 re-inserts them with everything else
        total = 0
        for vectors, ids in self._stream_vectors(unit, schema):
            index.insert_batch(vectors, ids)
            total += len(ids)
        index.merge_deltas()
        store.write_index(index, indexed_files=unit.data_files)
        return total

    def _stream_vectors(self, unit, schema: pa.Schema):
        for batch in iter_scan_unit_batches(
            unit.data_files,
            unit.primary_keys,
            batch_size=self.batch_size,
            memory_budget_bytes=self.memory_budget_bytes,
            file_sizes=getattr(unit, "file_sizes", None),
            schema=schema,
            partition_values=unit.partition_values,
            columns=[self.config.column, self.id_column],
            storage_options=self.storage_options,
        ):
            t = pa.Table.from_batches([batch])
            if len(t) == 0:
                continue
            yield extract_vectors(t, self.config.column, self.id_column, self.config.dim)


def build_table_vector_index(table, column: str, *, config: VectorIndexConfig | None = None,
                             incremental: bool = False, device=None, **cfg_kw) -> int:
    """Build one shard per scan unit of the table (reference:
    build_table_vector_index, vector_index.py:215).  With ``incremental=True``
    existing shards only ingest files committed since their last build.
    Returns total (newly) indexed vectors."""
    info = table.info
    if not info.primary_keys:
        raise VectorIndexError("vector index requires a primary-key table")
    if len(info.primary_keys) != 1:
        raise VectorIndexError(
            "vector index requires a single integer primary key (row ids are the"
            f" PK); table has composite PK {info.primary_keys}"
        )
    if config is None:
        field = info.arrow_schema.field(column)
        t = field.type
        if pa.types.is_fixed_size_list(t):
            dim = t.list_size
        elif "dim" in cfg_kw:
            dim = cfg_kw.pop("dim")
        else:
            raise VectorIndexError("dim required for non-fixed-size-list columns")
        config = VectorIndexConfig(column=column, dim=dim, **cfg_kw)
    io_cfg = table.io_config()
    builder = VectorShardIndexBuilder(
        info.table_path, config, info.primary_keys[0],
        storage_options=table.catalog.storage_options,
        batch_size=io_cfg.batch_size,
        memory_budget_bytes=io_cfg.memory_budget_bytes,
        device=device,
    )
    total = 0
    for unit in table.scan().scan_plan():
        total += builder.build(unit, info.arrow_schema, incremental=incremental)

    # record the index config on the table for readers — merged inside the
    # store's locked transaction, so a peer indexing a DIFFERENT column
    # concurrently cannot have its config entry clobbered by this write
    def record(props: dict) -> dict:
        props = dict(props)
        configs = [c for c in props.get("vector_index_columns", "").split(";") if c]
        configs = [c for c in configs if not c.startswith(column + ":")]
        configs.append(config.encode())
        props["vector_index_columns"] = ";".join(configs)
        return props

    table.catalog.client.store.merge_table_properties(info.table_id, record)
    table.refresh()
    return total


class TableVectorIndex:
    """The opened shards of table vector indexes on one device, for a caller
    that searches many times: pass it as ``index=`` to
    :func:`search_table_vector_index` (or ``vector_search``).  Each shard is
    read once per generation — ``LATEST`` is re-read on every search, so a
    rebuild is seen — and held until :meth:`release`.  Without one, every
    search reads its shards anew, as the reference's does."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._shards: dict[str, tuple[int, IvfRabitqIndex]] = {}

    def shard(self, store: ManifestStore) -> IvfRabitqIndex:
        generation = store.latest_generation()
        held = self._shards.get(store.root)
        if held is None or held[0] != generation:
            held = (generation, store.read_latest(device=self.device))
            self._shards[store.root] = held
        return held[1]

    def release(self) -> None:
        """Drop every opened shard (and its device memory)."""
        self._shards.clear()

    def __enter__(self) -> "TableVectorIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def search_table_vector_index(
    table,
    column: str,
    query: np.ndarray,
    *,
    top_k: int = 10,
    nprobe: int = 8,
    partitions: dict[str, str] | None = None,
    device=None,
    index: TableVectorIndex | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Search every shard matching the (filtered) scan, union candidates and
    re-rank globally (reference: search_matching_shards vector/search.rs:55 +
    rerank_by_distance vector_index.py:263), on ``device`` (``None`` = the
    CUDA card), or on ``index``'s device with the shards it holds open (then
    ``device`` is not given).  Returns (pk ids, distances)."""
    if index is None:
        index = TableVectorIndex(device)
    elif device is not None:
        raise VectorIndexError("pass device= or index=, not both: the index has its device")
    info = table.info
    configs = VectorIndexConfig.parse_multiple(
        info.properties.get("vector_index_columns", "")
    )
    config = next((c for c in configs if c.column == column), None)
    if config is None:
        raise VectorIndexError(f"no vector index built for column {column}")
    params = SearchParams(top_k=top_k, nprobe=nprobe)
    scan = table.scan()
    if partitions:
        scan = scan.partitions(partitions)
    all_ids, all_dists = [], []
    for unit in scan.scan_plan():
        root = _shard_root(info.table_path, column, unit.partition_desc, unit.bucket_id)
        store = ManifestStore(root, table.catalog.storage_options)
        if not store.exists():
            continue
        ids, dists = index.shard(store).search(np.asarray(query, np.float32), params)
        all_ids.append(ids)
        all_dists.append(dists)
    if not all_ids:
        return np.zeros(0, np.uint64), np.zeros(0, np.float32)
    ids = np.concatenate(all_ids)
    dists = np.concatenate(all_dists)
    order = np.argsort(dists)[:top_k]
    return ids[order], dists[order]
