"""Shared entity model.

Python-native equivalent of the reference's protobuf entity model
(rust/proto/src/entity.proto:13-186) — the same logical messages used across
every layer: TableInfo, PartitionInfo, DataCommitInfo, DataFileOp, MetaInfo.
Arrow schemas travel as IPC bytes (full fidelity, like
``table_schema_arrow_ipc`` in entity.proto:21-44) with a JSON mirror for
debuggability.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
import uuid
from dataclasses import dataclass, field

import pyarrow as pa

# partition-string encoding shared with the reference:
#   "<range_col1>,<range_col2>;<pk1>,<pk2>"  (transfusion.rs:367)
RANGE_HASH_SPLITTER = ";"
PARTITION_SPLITTER = ","
# partition_desc encoding: "k=v,k=v"; the no-partition sentinel used throughout
# the reference metadata layer:
NO_PARTITION_DESC = "-5"

# table property keys (reference: DBConfig / catalog.py)
PROP_HASH_BUCKET_NUM = "hashBucketNum"
PROP_CDC_CHANGE_COLUMN = "lakesoul_cdc_change_column"
CDC_DEFAULT_COLUMN = "rowKinds"


class CommitOp(str, enum.Enum):
    """Commit operations (entity.proto CommitOp)."""

    APPEND = "AppendCommit"
    COMPACTION = "CompactionCommit"
    UPDATE = "UpdateCommit"
    MERGE = "MergeCommit"
    DELETE = "DeleteCommit"

    @classmethod
    def from_str(cls, s: str) -> "CommitOp":
        return cls(s)


class FileOp(str, enum.Enum):
    """File operations inside a commit (entity.proto FileOp {add, del})."""

    ADD = "add"
    DEL = "del"


@dataclass(frozen=True)
class DataFileOp:
    path: str
    file_op: FileOp = FileOp.ADD
    size: int = 0
    file_exist_cols: str = ""

    def __post_init__(self):
        if not isinstance(self.file_op, FileOp):
            object.__setattr__(self, "file_op", FileOp(self.file_op))

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "file_op": self.file_op.value,
            "size": self.size,
            "file_exist_cols": self.file_exist_cols,
        }

    @classmethod
    def from_json(cls, d: dict) -> "DataFileOp":
        return cls(d["path"], FileOp(d["file_op"]), d.get("size", 0), d.get("file_exist_cols", ""))


@dataclass
class DataCommitInfo:
    """One atomic batch of file operations (entity.proto:94-133)."""

    table_id: str
    partition_desc: str
    commit_id: str
    file_ops: list[DataFileOp] = field(default_factory=list)
    commit_op: CommitOp = CommitOp.APPEND
    committed: bool = False
    timestamp: int = 0  # epoch millis
    domain: str = "public"

    @staticmethod
    def new_commit_id() -> str:
        return str(uuid.uuid4())


@dataclass
class PartitionInfo:
    """One version in a partition's version chain (entity.proto:46-65).

    ``snapshot`` is the ordered list of data-commit UUIDs whose files make up
    the partition at this version; Append/Merge extends it, Compaction/Update
    replaces it, Delete clears it (metadata_client.rs:467-634)."""

    table_id: str
    partition_desc: str
    version: int = -1
    commit_op: CommitOp = CommitOp.APPEND
    timestamp: int = 0
    snapshot: list[str] = field(default_factory=list)
    expression: str = ""
    domain: str = "public"

    def clone(self) -> "PartitionInfo":
        return dataclasses.replace(self, snapshot=list(self.snapshot))


@dataclass
class TableInfo:
    """Table metadata (entity.proto:21-44)."""

    table_id: str
    table_namespace: str = "default"
    table_name: str = ""
    table_path: str = ""
    table_schema: str = ""  # Spark DataType JSON (the reference wire format)
    table_schema_arrow_ipc: bytes = b""  # full-fidelity Arrow IPC schema
    properties: dict = field(default_factory=dict)
    partitions: str = ";"  # "range_cols;hash_cols"
    domain: str = "public"

    @staticmethod
    def new_table_id() -> str:
        return "table_" + uuid.uuid4().hex

    @property
    def arrow_schema(self) -> pa.Schema:
        """Arrow schema: full-fidelity IPC when present, else the JSON
        ``table_schema`` column — which for reference-written metadata is
        Spark's DataType JSON (``{"type":"struct","fields":[...]}``,
        entity.proto:24 / transfusion.rs) and for legacy rows of this repo
        is the old debug mirror.  Parsing the Spark encoding is what lets
        a table the reference's writer registered load here without the
        IPC column ever having been populated."""
        if self.table_schema_arrow_ipc:
            return pa.ipc.read_schema(pa.BufferReader(self.table_schema_arrow_ipc))
        if self.table_schema:
            return schema_from_json(self.table_schema)
        raise ValueError(f"table {self.table_name} has no arrow schema")

    @property
    def range_partition_columns(self) -> list[str]:
        part = self.partitions.split(RANGE_HASH_SPLITTER)[0]
        return [c for c in part.split(PARTITION_SPLITTER) if c]

    @property
    def primary_keys(self) -> list[str]:
        parts = self.partitions.split(RANGE_HASH_SPLITTER)
        if len(parts) < 2:
            return []
        return [c for c in parts[1].split(PARTITION_SPLITTER) if c]

    @property
    def hash_bucket_num(self) -> int:
        raw = self.properties.get(PROP_HASH_BUCKET_NUM, "1")
        try:
            n = int(raw)
        except (TypeError, ValueError):
            raise ValueError(f"invalid hashBucketNum table property: {raw!r}")
        if n < 1:
            raise ValueError(f"invalid hashBucketNum table property: {raw!r}")
        return n

    @property
    def cdc_column(self) -> str | None:
        return self.properties.get(PROP_CDC_CHANGE_COLUMN)

    def _ttl_days(self, key: str) -> float | None:
        """Parse a days-valued TTL property; None when absent or invalid
        (consumers log and fall back — a bad property must never crash a
        maintenance sweep)."""
        raw = self.properties.get(key)
        if raw is None:
            return None
        try:
            days = float(raw)
        except (TypeError, ValueError):
            return None
        if not (days >= 0) or days != days or days == float("inf"):
            return None  # negative / NaN / inf: a typo'd sign must not wipe history
        return days

    @property
    def partition_ttl_days(self) -> float | None:
        """``partition.ttl``: the LIFETIME of partition data, matching the
        reference's semantics — partitions whose newest commit is older than
        this are deleted outright by the cleaner."""
        return self._ttl_days("partition.ttl")

    @property
    def version_retention_days(self) -> float | None:
        """``lakesoul.version.retention``: how long superseded snapshot
        versions stay time-travelable (overrides the cleaner default)."""
        return self._ttl_days("lakesoul.version.retention")


@dataclass
class MetaInfo:
    """Commit envelope: partitions being written, the table, and (for
    Compaction/Update/Delete) the partition versions that were read."""

    table_info: TableInfo | None = None
    list_partition: list[PartitionInfo] = field(default_factory=list)
    read_partition_info: list[PartitionInfo] = field(default_factory=list)


@dataclass
class Namespace:
    namespace: str
    properties: str = "{}"
    comment: str = ""
    domain: str = "public"


def encode_partitions_field(range_cols: list[str], primary_keys: list[str]) -> str:
    return PARTITION_SPLITTER.join(range_cols) + RANGE_HASH_SPLITTER + PARTITION_SPLITTER.join(primary_keys)


def schema_to_ipc(schema: pa.Schema) -> bytes:
    return schema.serialize().to_pybytes()


# ---------------------------------------------------------------------------
# Spark-JSON schema encoding (the reference's table_schema wire format).
#
# The reference stores ``table_schema`` as Spark's DataType JSON —
# ``{"type":"struct","fields":[{"name","type","nullable","metadata"}]}``
# with type strings like "long"/"double"/"decimal(10,2)" and nested
# array/map/struct objects (spark/sql/types, consumed by transfusion.rs) —
# NOT as Arrow IPC.  Writing and parsing that encoding here is what makes
# the JSON column interoperable in both directions: reference-written
# metadata loads without the IPC column, and reference readers can parse
# ours.

_SPARK_TO_ARROW: dict[str, pa.DataType] = {
    "boolean": pa.bool_(),
    "byte": pa.int8(),
    "short": pa.int16(),
    "integer": pa.int32(),
    "long": pa.int64(),
    "float": pa.float32(),
    "double": pa.float64(),
    "string": pa.string(),
    "binary": pa.binary(),
    "date": pa.date32(),
    # Spark TimestampType is an instant (UTC-normalized); NTZ is wall time
    "timestamp": pa.timestamp("us", tz="UTC"),
    "timestamp_ntz": pa.timestamp("us"),
}

_ARROW_TO_SPARK: dict[pa.DataType, str] = {v: k for k, v in _SPARK_TO_ARROW.items()}
assert len(_ARROW_TO_SPARK) == len(_SPARK_TO_ARROW), "Spark type map must be 1:1"
_DECIMAL_RE = None  # lazily-compiled below (keeps import time flat)


def _spark_type_to_arrow(t) -> pa.DataType:
    if isinstance(t, str):
        hit = _SPARK_TO_ARROW.get(t)
        if hit is not None:
            return hit
        global _DECIMAL_RE
        if _DECIMAL_RE is None:
            import re

            _DECIMAL_RE = re.compile(r"decimal\((\d+),\s*(\d+)\)")
        m = _DECIMAL_RE.fullmatch(t)
        if m:
            return pa.decimal128(int(m.group(1)), int(m.group(2)))
        raise ValueError(f"unsupported Spark type string {t!r}")
    kind = t.get("type")
    if kind == "struct":
        return pa.struct(
            [
                pa.field(
                    f["name"],
                    _spark_type_to_arrow(f["type"]),
                    f.get("nullable", True),
                )
                for f in t.get("fields", [])
            ]
        )
    if kind == "array":
        element = pa.field("element", _spark_type_to_arrow(t["elementType"]),
                           t.get("containsNull", True))
        # fixed-length annotation (this repo's tensor columns): Spark has no
        # native fixed-size array, so the JSON carries the length next to
        # the standard ArrayType keys — readers that ignore it still see a
        # legal variable-length array of the right element type
        if "fixedLength" in t:
            return pa.list_(element, int(t["fixedLength"]))
        return pa.list_(element)
    if kind == "map":
        return pa.map_(
            _spark_type_to_arrow(t["keyType"]),
            pa.field("value", _spark_type_to_arrow(t["valueType"]),
                     t.get("valueContainsNull", True)),
        )
    raise ValueError(f"unsupported Spark type object {t!r}")


def _arrow_type_to_spark(t: pa.DataType):
    hit = _ARROW_TO_SPARK.get(t)
    if hit is not None:
        return hit
    if pa.types.is_decimal(t):
        return f"decimal({t.precision},{t.scale})"
    if pa.types.is_timestamp(t):
        return "timestamp" if t.tz else "timestamp_ntz"
    if pa.types.is_large_string(t):
        return "string"
    if pa.types.is_large_binary(t):
        return "binary"
    if pa.types.is_struct(t):
        return {
            "type": "struct",
            "fields": [
                {
                    "name": f.name,
                    "type": _arrow_type_to_spark(f.type),
                    "nullable": f.nullable,
                    "metadata": {},
                }
                for f in t
            ],
        }
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return {
            "type": "array",
            "elementType": _arrow_type_to_spark(t.value_type),
            "containsNull": t.value_field.nullable,
        }
    if pa.types.is_fixed_size_list(t):
        # tensor (fixed_size_list) columns get a REAL Spark spelling —
        # ArrayType plus a fixed-length annotation — instead of the old
        # IPC-only raw-name fallback: a Spark reader parses the standard
        # keys (a legal variable-length array), this repo's parser restores
        # the exact fixed_size_list, and the JSON mirror round-trips
        return {
            "type": "array",
            "elementType": _arrow_type_to_spark(t.value_type),
            "containsNull": t.value_field.nullable,
            "fixedLength": t.list_size,
        }
    if pa.types.is_map(t):
        return {
            "type": "map",
            "keyType": _arrow_type_to_spark(t.key_type),
            "valueType": _arrow_type_to_spark(t.item_type),
            "valueContainsNull": t.item_field.nullable,
        }
    # no Spark spelling at all (exotic types): record the Arrow name so the
    # JSON stays honest; the IPC column remains the full-fidelity source
    # for such tables
    return str(t)


# tensor-declaration field-metadata key (tensorplane/columns.py defines the
# authoritative constant; duplicated as a literal here so the base entity
# model never imports the tensor plane)
_TENSOR_META_KEY = b"lakesoul:tensor"


def spark_schema_to_arrow(spark: dict | str) -> pa.Schema:
    """Spark DataType JSON (struct) → Arrow schema.  Top-level fields whose
    Spark ``metadata`` map carries a ``lakesoul:tensor`` entry get it
    restored as Arrow field metadata, so a tensor declaration's logical
    shape survives the JSON mirror, not only the IPC column."""
    if isinstance(spark, str):
        spark = json.loads(spark)
    if spark.get("type") != "struct":
        raise ValueError("Spark schema JSON must be a struct at top level")
    struct = _spark_type_to_arrow(spark)
    fields = []
    meta_by_name = {
        f["name"]: f.get("metadata") or {} for f in spark.get("fields", [])
    }
    for field in struct:
        tensor = meta_by_name.get(field.name, {}).get("lakesoul:tensor")
        if tensor is not None:
            field = field.with_metadata(
                {_TENSOR_META_KEY: json.dumps(tensor).encode()}
            )
        fields.append(field)
    return pa.schema(fields)


def schema_from_json(s: str) -> pa.Schema:
    """Parse a ``table_schema`` JSON column: the reference's Spark encoding,
    or this repo's earlier debug mirror (``{"fields":[{"name","type"}]}``
    with Arrow type names) for legacy rows."""
    doc = json.loads(s)
    if doc.get("type") == "struct":
        return spark_schema_to_arrow(doc)
    fields = []
    for f in doc.get("fields", []):
        try:
            t = pa.type_for_alias(f["type"])
        except ValueError as e:
            raise ValueError(
                f"legacy mirror schema field {f['name']!r} has no parseable"
                f" type {f['type']!r} (and no IPC schema is present)"
            ) from e
        fields.append(pa.field(f["name"], t, f.get("nullable", True)))
    if not fields:
        raise ValueError("table_schema JSON has no fields")
    return pa.schema(fields)


def _field_spark_metadata(f: pa.Field) -> dict:
    """Spark-JSON ``metadata`` map for one field: tensor declarations ride
    it (``{"lakesoul:tensor": {"shape": [...]}}``) so the JSON mirror keeps
    the logical shape a multi-dim declaration would otherwise lose."""
    raw = (f.metadata or {}).get(_TENSOR_META_KEY)
    if raw is None:
        return {}
    try:
        return {"lakesoul:tensor": json.loads(raw)}
    except ValueError:
        return {}


def schema_to_json(schema: pa.Schema) -> str:
    return json.dumps(
        {
            "type": "struct",
            "fields": [
                {
                    "name": f.name,
                    "type": _arrow_type_to_spark(f.type),
                    "nullable": f.nullable,
                    "metadata": _field_spark_metadata(f),
                }
                for f in schema
            ],
        }
    )


def now_millis() -> int:
    return int(time.time() * 1000)
