"""IO configuration.

One config drives both the reader and writer stacks, like the reference's
``LakeSoulIOConfig`` (rust/lakesoul-io/src/config/mod.rs:40) and its builder.
Free-form ``options`` mirror config/options.rs (OPTION_KEY_*).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError

# option keys (reference: config/options.rs:6-45)
OPTION_SKIP_MERGE_ON_READ = "skip_merge_on_read"
OPTION_COMPRESSION = "compression"
OPTION_COMPRESSION_LEVEL = "compression_level"
OPTION_MAX_ROW_GROUP_SIZE = "max_row_group_size"
OPTION_VECTOR_SEARCH_COLUMN = "vector_search_column"
OPTION_VECTOR_SEARCH_QUERY = "vector_search_query"
OPTION_VECTOR_SEARCH_TOP_K = "vector_search_top_k"
OPTION_VECTOR_SEARCH_NPROBE = "vector_search_nprobe"

DEFAULT_BATCH_SIZE = 8192
DEFAULT_MAX_ROW_GROUP_SIZE = 250_000
# single source for IOConfig + direct readers.  Sized for TPU-VM hosts
# (tens of GB of host RAM): units within the budget take the fast
# materialized decode; anything larger streams with bounded memory.
DEFAULT_MEMORY_BUDGET = 2 << 30


@dataclass
class IOConfig:
    """Reader+writer configuration for one table.

    ``schema`` is the full table schema *including* range-partition columns;
    like the reference, partition columns are directory-encoded and filled
    back on read (stream/default_column.rs), not stored in data files."""

    schema: pa.Schema | None = None
    files: list[str] = field(default_factory=list)
    primary_keys: list[str] = field(default_factory=list)
    range_partitions: list[str] = field(default_factory=list)
    hash_bucket_num: int = 1
    hash_bucket_id: int = -1
    cdc_column: str | None = None
    # per-column merge operators: {"col": "SumAll", ...}; default UseLast
    merge_operators: dict[str, str] = field(default_factory=dict)
    batch_size: int = DEFAULT_BATCH_SIZE
    prefetch_size: int = 2
    # parquet write options.  TPU-first default: lz4 decodes ~3x faster than
    # the reference's zstd(1) (writer/mod.rs:215-240) at ~14% larger files —
    # the right trade when the pipeline feeds HBM from a 1-2 core host.
    # Reference-written zstd files read fine; set compression="zstd",
    # compression_level=1 for byte-role parity on write.
    compression: str = "lz4"
    compression_level: int | None = None
    max_row_group_size: int = DEFAULT_MAX_ROW_GROUP_SIZE
    # target max rows per staged file before rolling to a new one
    max_file_rows: int = 5_000_000
    # physical file format for new files ("parquet" | "arrow"); readers
    # dispatch per file extension, so mixed-format tables read fine
    # (reference: file_format.rs:46-150 format registry)
    file_format: str = "parquet"
    # byte budget for buffered/streamed data: the writer auto-flushes sorted
    # runs past it (role of mem/pool.rs + sort spill, physical_plan/spill.rs)
    # and the streaming MOR reader sizes its merge windows from it
    memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET
    # free-form option map + object-store options (endpoint, keys, ...)
    options: dict[str, str] = field(default_factory=dict)
    object_store_options: dict[str, str] = field(default_factory=dict)
    # schema-evolution default fills: {"col": value}
    default_column_values: dict[str, object] = field(default_factory=dict)

    def validate_for_write(self) -> None:
        if self.schema is None:
            raise ConfigError("writer requires a schema")
        names = set(self.schema.names)
        for c in self.primary_keys + self.range_partitions:
            if c not in names:
                raise ConfigError(f"column {c!r} not in schema")
        if self.primary_keys and self.hash_bucket_num < 1:
            raise ConfigError("primary-key table needs hash_bucket_num >= 1")
        if set(self.primary_keys) & set(self.range_partitions):
            raise ConfigError("a column cannot be both primary key and range partition")
        if self.cdc_column and self.cdc_column not in names:
            raise ConfigError(f"cdc column {self.cdc_column!r} not in schema")

    @property
    def data_schema(self) -> pa.Schema:
        """Schema actually stored in data files: table schema minus
        range-partition columns (directory-encoded)."""
        if self.schema is None:
            raise ConfigError("schema not set")
        keep = [f for f in self.schema if f.name not in self.range_partitions]
        return pa.schema(keep, metadata=self.schema.metadata)

    # table-property keys that tune per-table IO (reference: table-level
    # knobs live in table_info.properties JSON — hash bucket num, CDC column,
    # TTLs, per-column merge operators)
    PROP_COMPRESSION = "lakesoul.compression"
    PROP_COMPRESSION_LEVEL = "lakesoul.compression_level"
    PROP_FILE_FORMAT = "lakesoul.file_format"
    PROP_MEMORY_BUDGET = "lakesoul.memory_budget_bytes"
    PROP_MAX_ROW_GROUP = "lakesoul.max_row_group_size"
    PROP_MERGE_OP_PREFIX = "mergeOperator."

    @classmethod
    def for_table(cls, table_info, **overrides) -> "IOConfig":
        """Build a config from a TableInfo.  Per-table IO knobs and
        per-column merge operators come from ``table_info.properties``
        (``lakesoul.compression``, ``lakesoul.file_format``,
        ``lakesoul.memory_budget_bytes``, ``mergeOperator.<col>`` …), so
        every surface — table API, SQL WITH(...), Flight — configures them
        the same way."""
        cfg = cls(
            schema=table_info.arrow_schema,
            primary_keys=table_info.primary_keys,
            range_partitions=table_info.range_partition_columns,
            hash_bucket_num=table_info.hash_bucket_num,
            cdc_column=table_info.cdc_column,
        )
        props = dict(table_info.properties or {})
        if cls.PROP_COMPRESSION in props:
            cfg.compression = str(props[cls.PROP_COMPRESSION])
        if cls.PROP_COMPRESSION_LEVEL in props:
            cfg.compression_level = int(props[cls.PROP_COMPRESSION_LEVEL])
        if cls.PROP_FILE_FORMAT in props:
            cfg.file_format = str(props[cls.PROP_FILE_FORMAT])
        if cls.PROP_MEMORY_BUDGET in props:
            cfg.memory_budget_bytes = int(props[cls.PROP_MEMORY_BUDGET])
        if cls.PROP_MAX_ROW_GROUP in props:
            cfg.max_row_group_size = int(props[cls.PROP_MAX_ROW_GROUP])
        for key, value in props.items():
            if key.startswith(cls.PROP_MERGE_OP_PREFIX):
                cfg.merge_operators[key[len(cls.PROP_MERGE_OP_PREFIX):]] = str(value)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
