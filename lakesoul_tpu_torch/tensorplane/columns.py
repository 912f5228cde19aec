"""First-class fixed-shape tensor columns for LSF tables.

A tensor column is a ``fixed_size_list<element: T not null>[prod(shape)]``
field whose *logical* shape rides in field metadata under
``lakesoul:tensor`` — the declaration the Delta-Tensor / Deep-Lake line of
work makes the differentiator for training-loop ingest: the storage layer
knows rows are ``(16, 16)`` float32 patches, so the writer can verify them
once at the table boundary and the collate layer can reshape straight to
``(batch, 16, 16)`` from a spec computed ONCE per loader, instead of
probing Arrow types per batch and flattening every epoch.

Fidelity: the catalog stores the Arrow schema as IPC bytes, which carry
field metadata verbatim, so declarations survive every metadata round
trip.  The Spark-JSON mirror (``meta/entity.py``) spells the same field's
type as ``{"type": "array", ..., "fixedLength": N}`` and carries the
logical shape in the field's Spark ``metadata`` map
(``{"lakesoul:tensor": {"shape": [...]}}``, restored to Arrow field
metadata on parse) so the JSON column stays fully interoperable instead
of degrading to a raw Arrow type string.

Element types are restricted to fixed-width numerics (what a TPU can eat);
the LSF ``fsl`` encoding stores the flat child values verbatim, so a
declared column decodes to a zero-copy 2-D-ready buffer.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError, TensorColumnError

# field-metadata key carrying the logical shape (JSON: {"shape": [...]})
TENSOR_META_KEY = b"lakesoul:tensor"

_ELEMENT_TYPES: dict[str, pa.DataType] = {
    "float16": pa.float16(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "int8": pa.int8(),
    "int16": pa.int16(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "uint8": pa.uint8(),
    "uint16": pa.uint16(),
    "uint32": pa.uint32(),
    "uint64": pa.uint64(),
}


@dataclass(frozen=True)
class TensorSpec:
    """One declared tensor column: logical shape + element dtype."""

    name: str
    shape: tuple[int, ...]
    dtype: pa.DataType

    @property
    def width(self) -> int:
        """Flattened row width (the fixed_size_list size)."""
        return math.prod(self.shape)


def _normalize_shape(shape) -> tuple[int, ...]:
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(d) for d in shape)
    if not shape or any(d < 1 for d in shape):
        raise ConfigError(f"tensor shape must be positive dims, got {shape}")
    return shape


def _element_type(dtype) -> pa.DataType:
    if isinstance(dtype, pa.DataType):
        t = dtype
    else:
        t = _ELEMENT_TYPES.get(str(dtype))
        if t is None:
            raise ConfigError(
                f"unsupported tensor element dtype {dtype!r}; expected one of"
                f" {sorted(_ELEMENT_TYPES)}"
            )
    if not (pa.types.is_integer(t) or pa.types.is_floating(t)):
        raise ConfigError(
            f"tensor element type must be fixed-width numeric, got {t}"
        )
    return t


def tensor_field(name: str, shape, dtype="float32") -> pa.Field:
    """Declare one tensor column: ``tensor_field("emb", (16, 16))`` →
    a non-nullable ``fixed_size_list<element: float not null>[256]`` field
    with the logical shape in ``lakesoul:tensor`` metadata."""
    shape = _normalize_shape(shape)
    elem = _element_type(dtype)
    t = pa.list_(pa.field("element", elem, nullable=False), math.prod(shape))
    meta = {TENSOR_META_KEY: json.dumps({"shape": list(shape)}).encode()}
    return pa.field(name, t, nullable=False, metadata=meta)


def tensor_shape_of(field: pa.Field) -> tuple[int, ...] | None:
    """The declared logical shape of ``field``, or None when it is not a
    declared tensor column.  A ``fixed_size_list`` without metadata still
    counts as a 1-D tensor of its list size — the pre-declaration collate
    contract — so legacy embedding columns keep collating to 2-D."""
    if not pa.types.is_fixed_size_list(field.type):
        return None
    meta = field.metadata or {}
    raw = meta.get(TENSOR_META_KEY)
    if raw is None:
        return (field.type.list_size,)
    try:
        shape = tuple(int(d) for d in json.loads(raw)["shape"])
    except (ValueError, KeyError, TypeError) as e:
        raise ConfigError(
            f"column {field.name!r} carries unparseable tensor metadata"
            f" {raw!r}"
        ) from e
    if math.prod(shape) != field.type.list_size:
        raise ConfigError(
            f"column {field.name!r}: declared tensor shape {shape} does not"
            f" flatten to the fixed_size_list width {field.type.list_size}"
        )
    return shape


def tensor_specs(schema: pa.Schema | None) -> dict[str, TensorSpec]:
    """Every *declared* tensor column of ``schema`` (metadata-carrying
    fields only — plain ``fixed_size_list`` columns are not validated, they
    predate declarations), keyed by column name.  Computed once per
    writer/loader; empty for schemas with no declarations."""
    if schema is None:
        return {}
    out: dict[str, TensorSpec] = {}
    for field in schema:
        if not pa.types.is_fixed_size_list(field.type):
            continue
        if not (field.metadata or {}).get(TENSOR_META_KEY):
            continue
        shape = tensor_shape_of(field)
        out[field.name] = TensorSpec(field.name, shape, field.type.value_type)
    return out


def validate_tensor_batch(
    table: pa.Table | pa.RecordBatch, specs: dict[str, TensorSpec]
) -> None:
    """Verify every declared tensor column of ``table`` against its spec;
    raises :class:`TensorColumnError` naming the first offending column.

    Checked per write batch (cheap: type identity + null counts, no data
    pass): the column must be present, a ``fixed_size_list`` of exactly the
    declared width and element dtype, and free of nulls at both the list
    and element level — a null row would silently misalign the flat child
    buffer against the row count in the zero-copy collate."""
    if not specs:
        return
    schema = table.schema
    for name, spec in specs.items():
        idx = schema.get_field_index(name)
        if idx < 0:
            raise TensorColumnError(
                f"tensor column {name!r} (shape {spec.shape},"
                f" {spec.dtype}) missing from the written batch"
            )
        col = table.column(idx)
        t = schema.field(idx).type
        if not pa.types.is_fixed_size_list(t):
            raise TensorColumnError(
                f"tensor column {name!r} must be fixed_size_list"
                f"[{spec.width}] of {spec.dtype}, got {t}"
            )
        if t.list_size != spec.width or t.value_type != spec.dtype:
            raise TensorColumnError(
                f"tensor column {name!r} declared shape {spec.shape}"
                f" ({spec.dtype}, width {spec.width}) but the batch carries"
                f" fixed_size_list[{t.list_size}] of {t.value_type}"
            )
        chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
        for chunk in chunks:
            if chunk.null_count:
                raise TensorColumnError(
                    f"tensor column {name!r} has {chunk.null_count} null"
                    " row(s) — tensor rows must be dense"
                )
            flat = chunk.flatten()
            if flat.null_count:
                raise TensorColumnError(
                    f"tensor column {name!r} has {flat.null_count} null"
                    " element(s) inside its rows — tensor elements must be"
                    " dense"
                )
