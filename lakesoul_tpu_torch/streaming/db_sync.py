"""Whole-database ingest: snapshot sync + Debezium-format CDC consumption
(the port's copy of ``lakesoul_tpu/streaming/db_sync.py``).

Role parity with the reference's Flink entry points
(lakesoul-flink/…/entry/JdbcCDC.java — Debezium CDC from MySQL/Oracle/PG
into per-table exactly-once sinks with automatic DDL sync — and
entry/SyncDatabase.java — batch whole-DB copy).  The TPU build has no Flink
or Debezium runtime, so the two halves are:

- :class:`DatabaseSyncer` — snapshot-sync every table of a DB-API source
  connection (schema introspection → auto CREATE TABLE with source primary
  keys → bulk copy).  Works against sqlite out of the box and any DB-API
  driver with ``information_schema``-style introspection via the hook
  methods.
- :class:`DebeziumJsonConsumer` — consume Debezium change-event dicts (the
  wire format every Debezium connector emits: ``payload.op`` c/r/u/d with
  ``before``/``after`` row images and ``source.table``), routing each event
  to a per-table :class:`~lakesoul_tpu_torch.streaming.cdc.CdcIngestor`.  Tables
  are auto-created on first sight and auto-evolved when events carry new
  columns (the role of LakeSoulSinkGlobalCommitter's DDL sync,
  LakeSoulSinkGlobalCommitter.java:176); ``checkpoint(epoch)`` commits every
  table exactly-once (deterministic commit ids, replay-safe).
"""

from __future__ import annotations

import logging
from typing import Iterable

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError

logger = logging.getLogger(__name__)

# declared-type → arrow mapping for DB-API sources (sqlite's loose typing
# resolves through affinity prefixes; richer engines hit exact names first)
_SQL_TYPE_MAP = [
    ("BIGINT", pa.int64()),
    ("INT", pa.int64()),
    ("SERIAL", pa.int64()),
    ("DOUBLE", pa.float64()),
    ("FLOAT", pa.float64()),
    ("REAL", pa.float64()),
    ("NUMERIC", pa.float64()),
    ("DECIMAL", pa.float64()),
    ("BOOL", pa.bool_()),
    ("CHAR", pa.string()),
    ("TEXT", pa.string()),
    ("CLOB", pa.string()),
    ("DATE", pa.string()),
    ("TIME", pa.string()),
    ("BLOB", pa.binary()),
    ("BYTEA", pa.binary()),
]


def _arrow_type_for(declared: str) -> pa.DataType:
    up = (declared or "").upper()
    for token, typ in _SQL_TYPE_MAP:
        if token in up:
            return typ
    return pa.string()  # safest fallback: everything casts to string


class DatabaseSyncer:
    """Snapshot-sync a whole source database into the lakehouse
    (reference: entry/SyncDatabase.java)."""

    def __init__(self, catalog, *, namespace: str = "default", hash_bucket_num: int = 4):
        self.catalog = catalog
        self.namespace = namespace
        self.hash_bucket_num = hash_bucket_num

    # ------------------------------------------------------- introspection
    def list_source_tables(self, conn) -> list[str]:
        cur = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"
            " AND name NOT LIKE 'sqlite_%'"
        )
        return [r[0] for r in cur.fetchall()]

    def source_schema(self, conn, table: str) -> tuple[pa.Schema, list[str]]:
        """→ (arrow schema, primary key columns) from table_info."""
        cur = conn.execute(f'PRAGMA table_info("{table}")')
        fields, pks = [], []
        for _cid, name, declared, _notnull, _default, pk in cur.fetchall():
            fields.append(pa.field(name, _arrow_type_for(declared)))
            if pk:
                pks.append((pk, name))
        pks.sort()
        return pa.schema(fields), [name for _, name in pks]

    # --------------------------------------------------------------- sync
    def sync_table(self, conn, table: str, *, batch_rows: int = 50_000) -> int:
        """Copy one source table (auto-creating the lakehouse table); returns
        rows copied."""
        schema, pks = self.source_schema(conn, table)
        if not self.catalog.table_exists(table, self.namespace):
            self.catalog.create_table(
                table,
                schema,
                primary_keys=pks,
                hash_bucket_num=self.hash_bucket_num if pks else 1,
                namespace=self.namespace,
            )
        dest = self.catalog.table(table, self.namespace)
        cols_sql = ", ".join(f'"{c}"' for c in schema.names)
        cur = conn.execute(f'SELECT {cols_sql} FROM "{table}"')
        total = 0
        while True:
            rows = cur.fetchmany(batch_rows)
            if not rows:
                break
            cols = {
                f.name: pa.array([r[i] for r in rows]).cast(f.type)
                for i, f in enumerate(schema)
            }
            batch = pa.table(cols, schema=schema)
            if pks:
                dest.upsert(batch)  # re-sync converges instead of duplicating
            else:
                dest.write_arrow(batch)
            total += len(rows)
        logger.info("synced table %s: %d rows", table, total)
        return total

    def sync(self, conn, *, tables: list[str] | None = None) -> dict[str, int]:
        """Whole-DB sync; returns {table: rows_copied}."""
        names = tables if tables is not None else self.list_source_tables(conn)
        return {name: self.sync_table(conn, name) for name in names}


class DebeziumJsonConsumer:
    """Route Debezium change events into per-table exactly-once CDC ingest
    (reference: entry/JdbcCDC.java → LakeSoulRecordConvert → multi-table
    sink).  Accepts both the enveloped form ({"payload": {...}}) and the
    flattened form Debezium emits with schemas disabled."""

    _OPS = {"c": "insert", "r": "insert", "u": "update", "d": "delete"}

    def __init__(self, catalog, *, namespace: str = "default",
                 hash_bucket_num: int = 4, primary_keys: dict[str, list[str]] | None = None):
        self.catalog = catalog
        self.namespace = namespace
        self.hash_bucket_num = hash_bucket_num
        # Debezium events don't carry PK metadata; the source's key columns
        # arrive out of band (reference: JdbcCDC gets them from JDBC metadata)
        self.primary_keys = dict(primary_keys or {})
        self._ingestors: dict[str, "object"] = {}
        # known column names per table: the per-event evolution check must
        # not cost a metadata-store query per event
        self._known_cols: dict[str, set[str]] = {}

    # -------------------------------------------------------------- events
    def consume(self, event: dict) -> None:
        payload = event.get("payload", event)
        op = payload.get("op")
        if op not in self._OPS:
            raise ConfigError(f"unknown Debezium op {op!r}")
        row = payload.get("after") if op != "d" else payload.get("before")
        if row is None:
            raise ConfigError(f"Debezium event missing row image for op {op!r}")
        source = payload.get("source", {})
        table = source.get("table")
        if not table:
            raise ConfigError("Debezium event missing source.table")
        self._ingestor_for(table, row)  # ensures table + ingestor exist
        self._evolve_if_needed(table, row)  # may swap in a rebuilt ingestor
        self._ingestors[table].apply(self._OPS[op], row)

    def consume_many(self, events: Iterable[dict]) -> int:
        n = 0
        for e in events:
            self.consume(e)
            n += 1
        return n

    def checkpoint(self, checkpoint_id: int | str) -> int:
        """Commit every table's staged changes exactly-once for this epoch;
        returns the number of partition commits."""
        total = 0
        for ing in self._ingestors.values():
            total += ing.checkpoint(checkpoint_id)
        return total

    # ------------------------------------------------------------- plumbing
    def _infer_schema(self, row: dict) -> pa.Schema:
        fields = []
        for k, v in row.items():
            if isinstance(v, bool):
                t = pa.bool_()
            elif isinstance(v, int):
                t = pa.int64()
            elif isinstance(v, float):
                t = pa.float64()
            elif isinstance(v, bytes):
                t = pa.binary()
            else:
                t = pa.string()
            fields.append(pa.field(k, t))
        return pa.schema(fields)

    def _ingestor_for(self, table: str, row: dict):
        ing = self._ingestors.get(table)
        if ing is not None:
            return ing
        from lakesoul_tpu_torch.streaming.cdc import CdcIngestor

        if not self.catalog.table_exists(table, self.namespace):
            pks = self.primary_keys.get(table)
            if not pks:
                raise ConfigError(
                    f"first event for unknown table {table!r}: pass its primary"
                    " keys via DebeziumJsonConsumer(primary_keys={...})"
                )
            self.catalog.create_table(
                table,
                self._infer_schema(row),
                primary_keys=pks,
                hash_bucket_num=self.hash_bucket_num,
                cdc=True,
                namespace=self.namespace,
            )
            logger.info("auto-created CDC table %s from first event", table)
        ing = CdcIngestor(self.catalog.table(table, self.namespace))
        self._ingestors[table] = ing
        return ing

    def _evolve_if_needed(self, table: str, row: dict) -> None:
        """Auto schema evolution: a new column in an event adds a nullable
        column to the table (committer DDL-sync role).  The fast path is a
        cached set check — no metadata query per event."""
        known = self._known_cols.get(table)
        if known is None:
            known = set(self.catalog.table(table, self.namespace).schema.names)
            self._known_cols[table] = known
        if all(k in known for k in row):
            return
        t = self.catalog.table(table, self.namespace)
        known = set(t.schema.names)  # authoritative re-check
        new = [k for k in row.keys() if k not in known]
        if not new:
            self._known_cols[table] = known
            return
        inferred = self._infer_schema(row)
        old = self._ingestors.get(table)
        if old is not None:
            # stage everything buffered under the OLD schema first — the old
            # writer must not see new-column rows (it would silently align
            # them down to the old schema)
            old._flush_buffer()
        t.add_columns([inferred.field(k) for k in new])
        logger.info("auto-evolved table %s: added columns %s", table, new)
        # rebuild the ingestor against the evolved schema, carrying any
        # staged-but-uncommitted files across so checkpoint() commits them
        from lakesoul_tpu_torch.streaming.cdc import CdcIngestor

        fresh = CdcIngestor(self.catalog.table(table, self.namespace))
        fresh._writer.adopt_staged(old._writer if old is not None else None)
        self._ingestors[table] = fresh
        self._known_cols[table] = known | set(new)
