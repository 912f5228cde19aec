"""Metadata stores.

The reference keeps all metadata in PostgreSQL with the schema in
``script/meta_init.sql`` and relies on the ``partition_info`` primary key
``(table_id, partition_desc, version)`` for optimistic concurrency: two
writers committing the same new version conflict on PK insert and one of them
retries (metadata_client.rs:467, meta_init.sql:95-99).

This module reproduces that design over a pluggable ``MetadataStore``:

- ``SqliteMetadataStore`` (default): file-backed SQLite with the same logical
  schema, WAL mode, ACID transactions, and PK-conflict semantics.  A SQLite
  file on a shared filesystem (or one per-host store fronted by the Flight
  gateway) plays PostgreSQL's role on a TPU pod slice where installing PG is
  not possible.
- A PostgreSQL store can implement the same interface (same SQL, psycopg)
  when psycopg2 is available; the client code is backend-agnostic.

The pg_notify-based compaction trigger (meta_init.sql:101-150) is reproduced
as a synchronous hook: after a partition_info insert where the version gap
since the last CompactionCommit reaches the trigger threshold, registered
listeners receive a ``CompactionEvent`` (see lakesoul_tpu/compaction).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sqlite3
import threading
from dataclasses import dataclass
from typing import Callable

from lakesoul_tpu_torch.errors import CommitConflictError, LeaseFencedError, MetadataError
from lakesoul_tpu_torch.meta.entity import (
    CommitOp,
    DataCommitInfo,
    DataFileOp,
    Namespace,
    PartitionInfo,
    TableInfo,
    now_millis,
)

COMPACTION_TRIGGER_VERSION_GAP = 10  # matches meta_init.sql trigger (version % gap)

# global_config keys maintained by the store / metadata client per table:
# DESC_EPOCH_KEY counts desc-set changes (new desc inserted, desc rewritten)
# and is bumped transactionally by every store-API writer;
# DESCS_VERIFIED_KEY records the epoch at which a client verified that all
# descs are canonically ordered (the desc-prefix fast-path precondition).
DESC_EPOCH_KEY = "desc_epoch:"
DESCS_VERIFIED_KEY = "descs_verified_canonical:"


@dataclass(frozen=True)
class CompactionEvent:
    """Equivalent of the `lakesoul_compaction_notify` pg_notify payload."""

    table_id: str
    table_path: str
    table_namespace: str
    partition_desc: str
    version: int


@dataclass(frozen=True)
class Lease:
    """One acquired lease row: who holds ``key``, until when (epoch millis
    on the store's shared timebase), and the **fencing token** — a counter
    that increments on every takeover, so a zombie holder presenting a
    stale token is rejected even if its process is still running.

    ``taken_over`` is set when this acquisition replaced an expired
    holder's row (the takeover path); it is not persisted."""

    key: str
    holder: str
    fencing_token: int
    expires_at_ms: int
    taken_over: bool = False

    def guard(self) -> tuple[str, str, int]:
        """The (key, holder, token) triple ``transaction_insert_partition_info``
        verifies atomically with the commit (``lease_guard=``)."""
        return (self.key, self.holder, self.fencing_token)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS namespace (
    namespace  TEXT PRIMARY KEY,
    properties TEXT DEFAULT '{}',
    comment    TEXT DEFAULT '',
    domain     TEXT DEFAULT 'public'
);
CREATE TABLE IF NOT EXISTS table_info (
    table_id        TEXT PRIMARY KEY,
    table_namespace TEXT DEFAULT 'default',
    table_name      TEXT,
    table_path      TEXT,
    table_schema    TEXT,
    table_schema_arrow_ipc BLOB,
    properties      TEXT DEFAULT '{}',
    partitions      TEXT,
    domain          TEXT DEFAULT 'public'
);
CREATE INDEX IF NOT EXISTS table_info_name_index ON table_info (table_namespace, table_name);
CREATE INDEX IF NOT EXISTS table_info_path_index ON table_info (table_path);
CREATE TABLE IF NOT EXISTS table_name_id (
    table_name      TEXT,
    table_id        TEXT,
    table_namespace TEXT DEFAULT 'default',
    domain          TEXT DEFAULT 'public',
    PRIMARY KEY (table_name, table_namespace)
);
CREATE TABLE IF NOT EXISTS table_path_id (
    table_path      TEXT PRIMARY KEY,
    table_id        TEXT,
    table_namespace TEXT DEFAULT 'default',
    domain          TEXT DEFAULT 'public'
);
CREATE TABLE IF NOT EXISTS data_commit_info (
    table_id       TEXT,
    partition_desc TEXT,
    commit_id      TEXT,
    file_ops       TEXT,
    commit_op      TEXT,
    committed      INTEGER DEFAULT 0,
    timestamp      INTEGER,
    domain         TEXT DEFAULT 'public',
    PRIMARY KEY (table_id, partition_desc, commit_id)
);
CREATE TABLE IF NOT EXISTS partition_info (
    table_id       TEXT,
    partition_desc TEXT,
    version        INTEGER,
    commit_op      TEXT,
    timestamp      INTEGER,
    snapshot       TEXT,
    expression     TEXT DEFAULT '',
    domain         TEXT DEFAULT 'public',
    PRIMARY KEY (table_id, partition_desc, version)
);
CREATE INDEX IF NOT EXISTS partition_info_timestamp ON partition_info (timestamp);
CREATE TABLE IF NOT EXISTS global_config (
    key   TEXT PRIMARY KEY,
    value TEXT
);
CREATE TABLE IF NOT EXISTS discard_compressed_file_info (
    file_path   TEXT PRIMARY KEY,
    table_path  TEXT,
    partition_desc TEXT,
    timestamp   INTEGER,
    t_date      TEXT
);
CREATE TABLE IF NOT EXISTS lease (
    lease_key      TEXT PRIMARY KEY,
    holder_id      TEXT,
    fencing_token  BIGINT DEFAULT 0,
    expires_at_ms  BIGINT,
    acquired_at_ms BIGINT
);
"""


class MetadataStore:
    """Abstract metadata backend. All methods are synchronous and thread-safe."""

    def transaction_insert_partition_info(
        self,
        partitions: list[PartitionInfo],
        *,
        descs_canonical: bool = False,
        lease_guard: tuple[str, str, int] | None = None,
    ) -> None:
        raise NotImplementedError

    # ... the concrete store defines the full DAO surface; kept on one class
    # rather than the reference's numbered DaoType dispatch (lib.rs:122) —
    # Python needs no prepared-statement indirection.


def desc_prefix_upper_bound(prefix: str) -> str | None:
    """Exclusive upper bound covering *every* string that starts with
    ``prefix``: the next prefix by codepoint increment with carry.  The
    previous ``prefix + '\\uffff'`` bound dropped descs whose next character
    is a supplementary-plane codepoint: those sort above U+FFFF
    in both Python str (codepoint) and SQLite UTF-8 byte order, which agree.
    Skips the unencodable surrogate block; returns None when no finite bound
    exists (prefix is all U+10FFFF — the range is then open above)."""
    chars = list(prefix)
    while chars:
        cp = ord(chars[-1])
        if cp >= 0x10FFFF:
            chars.pop()  # carry into the preceding position
            continue
        nxt = cp + 1
        if 0xD800 <= nxt <= 0xDFFF:
            nxt = 0xE000  # surrogates cannot appear in UTF-8 storage
        chars[-1] = chr(nxt)
        return "".join(chars)
    return None


def translate_sql(sql: str, paramstyle: str) -> str:
    """qmark → format placeholder translation plus the one dialect-specific
    construct the store uses (INSERT OR IGNORE → ON CONFLICT DO NOTHING)."""
    if paramstyle == "qmark":
        return sql
    stripped = sql.lstrip()
    if stripped.upper().startswith("INSERT OR IGNORE"):
        sql = "INSERT" + stripped[len("INSERT OR IGNORE"):] + " ON CONFLICT DO NOTHING"
    return sql.replace("?", "%s")


class SqlMetadataStore(MetadataStore):
    """Generic DB-API 2.0 implementation of the metadata store.  Subclasses
    provide connections (`_conn`), transactions (`transaction`), the
    paramstyle, and the DB-API module's integrity-error types; every DAO method
    below is shared."""

    PARAMSTYLE = "qmark"
    # appended to partition_desc in range predicates; SQLite's default BINARY
    # collation is already byte order, PG overrides with COLLATE "C"
    DESC_RANGE_COLLATION = ""
    INTEGRITY_ERRORS: tuple = (sqlite3.IntegrityError,)

    def _exec(self, conn, sql: str, params=()):
        sql = translate_sql(sql, self.PARAMSTYLE)
        if self.PARAMSTYLE == "qmark":
            return conn.execute(sql, params)
        cur = conn.cursor()
        cur.execute(sql, params)
        return cur

    def __init__(self):
        self._compaction_listeners: list[Callable[[CompactionEvent], None]] = []

    def _conn(self):
        raise NotImplementedError

    @contextlib.contextmanager
    def transaction(self):
        """THE write-transaction seam: every multi-statement store mutation
        that must land atomically enters through here (enforced by lakelint's
        ``txn-boundary`` rule), and the runtime interleaving detector
        (``analysis/txncheck.py``) wraps exactly this boundary to record
        per-transaction read/write sets.  Commit on success, rollback on
        error; subclasses override with backend-appropriate BEGIN semantics
        but keep the contract."""
        conn = self._conn()
        with conn:  # DB-API context manager: commit on success, rollback on error
            yield conn

    def _txn(self):
        """Deprecated spelling of :meth:`transaction` (dispatches through it
        so subclass overrides and txncheck instrumentation still apply)."""
        return self.transaction()

    # -- namespaces ----------------------------------------------------------
    def insert_namespace(self, ns: Namespace) -> None:
        try:
            with self.transaction() as conn:
                self._exec(conn, 
                    "INSERT INTO namespace(namespace, properties, comment, domain) VALUES (?,?,?,?)",
                    (ns.namespace, ns.properties, ns.comment, ns.domain),
                )
        except self.INTEGRITY_ERRORS as e:
            raise MetadataError(f"namespace {ns.namespace} already exists") from e

    def get_namespace(self, name: str) -> Namespace | None:
        row = self._exec(self._conn(), 
            "SELECT namespace, properties, comment, domain FROM namespace WHERE namespace=?",
            (name,),
        ).fetchone()
        return Namespace(*row) if row else None

    def list_namespaces(self) -> list[str]:
        return [r[0] for r in self._exec(self._conn(), "SELECT namespace FROM namespace")]

    def delete_namespace(self, name: str) -> None:
        with self.transaction() as conn:
            self._exec(conn, "DELETE FROM namespace WHERE namespace=?", (name,))

    # -- table info ----------------------------------------------------------
    def insert_table_info(self, info: TableInfo) -> None:
        """Insert table_info + name/path mappings in one transaction
        (reference: create_table → TableInfo/TableNameId/TablePathId DAOs)."""
        try:
            with self.transaction() as conn:
                self._exec(conn, 
                    "INSERT INTO table_info(table_id, table_namespace, table_name, table_path,"
                    " table_schema, table_schema_arrow_ipc, properties, partitions, domain)"
                    " VALUES (?,?,?,?,?,?,?,?,?)",
                    (
                        info.table_id,
                        info.table_namespace,
                        info.table_name,
                        info.table_path,
                        info.table_schema,
                        info.table_schema_arrow_ipc,
                        json.dumps(info.properties),
                        info.partitions,
                        info.domain,
                    ),
                )
                if info.table_name:
                    self._exec(conn, 
                        "INSERT INTO table_name_id(table_name, table_id, table_namespace, domain) VALUES (?,?,?,?)",
                        (info.table_name, info.table_id, info.table_namespace, info.domain),
                    )
                if info.table_path:
                    self._exec(conn, 
                        "INSERT INTO table_path_id(table_path, table_id, table_namespace, domain) VALUES (?,?,?,?)",
                        (info.table_path, info.table_id, info.table_namespace, info.domain),
                    )
        except self.INTEGRITY_ERRORS as e:
            raise MetadataError(
                f"table {info.table_namespace}.{info.table_name} already exists"
            ) from e

    def _row_to_table_info(self, row) -> TableInfo:
        return TableInfo(
            table_id=row[0],
            table_namespace=row[1],
            table_name=row[2],
            table_path=row[3],
            table_schema=row[4],
            table_schema_arrow_ipc=row[5] or b"",
            properties=json.loads(row[6] or "{}"),
            partitions=row[7],
            domain=row[8],
        )

    _TI_COLS = (
        "table_id, table_namespace, table_name, table_path, table_schema,"
        " table_schema_arrow_ipc, properties, partitions, domain"
    )

    def get_table_info_by_id(self, table_id: str) -> TableInfo | None:
        row = self._exec(self._conn(), 
            f"SELECT {self._TI_COLS} FROM table_info WHERE table_id=?", (table_id,)
        ).fetchone()
        return self._row_to_table_info(row) if row else None

    def get_table_info_by_name(self, name: str, namespace: str = "default") -> TableInfo | None:
        row = self._exec(self._conn(), 
            f"SELECT {self._TI_COLS} FROM table_info WHERE table_name=? AND table_namespace=?",
            (name, namespace),
        ).fetchone()
        return self._row_to_table_info(row) if row else None

    def get_table_info_by_path(self, path: str) -> TableInfo | None:
        row = self._exec(self._conn(), 
            f"SELECT {self._TI_COLS} FROM table_info WHERE table_path=?", (path,)
        ).fetchone()
        return self._row_to_table_info(row) if row else None

    def list_tables(self, namespace: str = "default") -> list[str]:
        return [
            r[0]
            for r in self._exec(self._conn(), 
                "SELECT table_name FROM table_info WHERE table_namespace=? AND table_name != ''",
                (namespace,),
            )
        ]

    def update_table_properties(self, table_id: str, properties: dict) -> None:
        with self.transaction() as conn:
            self._exec(conn,
                "UPDATE table_info SET properties=? WHERE table_id=?",
                (json.dumps(properties), table_id),
            )

    def merge_table_properties(self, table_id: str, updater) -> dict:
        """Atomic read-modify-write of ``table_info.properties``:
        ``updater(current: dict) -> dict`` runs inside ONE write transaction
        with the table row locked (``ROW_LOCK``), so two concurrent mergers
        queue instead of both reading the old map and losing one update.
        Callers that read properties, merge, and wrote back via
        :meth:`update_table_properties` carried exactly that lost-update
        race on a READ COMMITTED backend (the lakelint ``read-modify-write``
        findings this method retired).  Returns the merged map."""
        with self.transaction() as conn:
            row = self._exec(conn,
                f"SELECT properties FROM table_info WHERE table_id=?{self.ROW_LOCK}",
                (table_id,),
            ).fetchone()
            if row is None:
                raise MetadataError(f"no such table {table_id}")
            merged = updater(json.loads(row[0] or "{}"))
            self._exec(conn,
                "UPDATE table_info SET properties=? WHERE table_id=?",
                (json.dumps(merged), table_id),
            )
            return merged

    def update_table_schema(self, table_id: str, schema_json: str, schema_ipc: bytes) -> None:
        with self.transaction() as conn:
            self._exec(conn, 
                "UPDATE table_info SET table_schema=?, table_schema_arrow_ipc=? WHERE table_id=?",
                (schema_json, schema_ipc, table_id),
            )

    def delete_table(self, table_id: str) -> None:
        with self.transaction() as conn:
            self._exec(conn, "DELETE FROM table_name_id WHERE table_id=?", (table_id,))
            self._exec(conn, "DELETE FROM table_path_id WHERE table_id=?", (table_id,))
            self._exec(conn, "DELETE FROM partition_info WHERE table_id=?", (table_id,))  # lakelint: ignore[cas-guard] drop-table removes every version by design; no CAS applies
            self._exec(conn, "DELETE FROM data_commit_info WHERE table_id=?", (table_id,))  # lakelint: ignore[cas-guard] drop-table removes every commit row by design; no CAS applies
            self._exec(conn, "DELETE FROM table_info WHERE table_id=?", (table_id,))
            # per-table bookkeeping keys must not outlive the table
            self._exec(conn,
                "DELETE FROM global_config WHERE key IN (?, ?)",
                (DESC_EPOCH_KEY + table_id, DESCS_VERIFIED_KEY + table_id),
            )

    # -- data commit info ----------------------------------------------------
    def insert_data_commit_info(self, commits: list[DataCommitInfo]) -> int:
        with self.transaction() as conn:
            for c in commits:
                self._exec(conn, 
                    # OR IGNORE: concurrent replays of the same commit id are
                    # an idempotent no-op, not an IntegrityError crash
                    "INSERT OR IGNORE INTO data_commit_info(table_id, partition_desc, commit_id, file_ops,"
                    " commit_op, committed, timestamp, domain) VALUES (?,?,?,?,?,?,?,?)",
                    (
                        c.table_id,
                        c.partition_desc,
                        c.commit_id,
                        json.dumps([f.to_json() for f in c.file_ops]),
                        c.commit_op.value,
                        1 if c.committed else 0,
                        c.timestamp or now_millis(),
                        c.domain,
                    ),
                )
        return len(commits)

    def _row_to_commit(self, row) -> DataCommitInfo:
        return DataCommitInfo(
            table_id=row[0],
            partition_desc=row[1],
            commit_id=row[2],
            file_ops=[DataFileOp.from_json(d) for d in json.loads(row[3] or "[]")],
            commit_op=CommitOp(row[4]),
            committed=bool(row[5]),
            timestamp=row[6],
            domain=row[7],
        )

    def get_data_commit_info(
        self, table_id: str, partition_desc: str, commit_ids: list[str]
    ) -> list[DataCommitInfo]:
        """Fetch commits preserving the order of ``commit_ids`` (snapshot order
        defines merge order for MOR reads)."""
        if not commit_ids:
            return []
        qmarks = ",".join("?" for _ in commit_ids)
        rows = self._exec(self._conn(), 
            "SELECT table_id, partition_desc, commit_id, file_ops, commit_op, committed,"
            f" timestamp, domain FROM data_commit_info WHERE table_id=? AND partition_desc=?"
            f" AND commit_id IN ({qmarks})",
            (table_id, partition_desc, *commit_ids),
        ).fetchall()
        by_id = {r[2]: self._row_to_commit(r) for r in rows}
        missing = [cid for cid in commit_ids if cid not in by_id]
        if missing:
            raise MetadataError(
                f"snapshot refers to missing data commits {missing} in {table_id}/{partition_desc}"
            )
        return [by_id[cid] for cid in commit_ids]

    def mark_committed(self, table_id: str, partition_desc: str, commit_ids: list[str]) -> None:
        if not commit_ids:
            return
        qmarks = ",".join("?" for _ in commit_ids)
        with self.transaction() as conn:
            self._exec(conn, 
                f"UPDATE data_commit_info SET committed=1 WHERE table_id=? AND partition_desc=?"
                f" AND commit_id IN ({qmarks})",
                (table_id, partition_desc, *commit_ids),
            )

    def commit_exists(self, table_id: str, partition_desc: str, commit_id: str) -> bool:
        row = self._exec(self._conn(), 
            "SELECT 1 FROM data_commit_info WHERE table_id=? AND partition_desc=? AND commit_id=?",
            (table_id, partition_desc, commit_id),
        ).fetchone()
        return row is not None

    def commit_state(self, table_id: str, partition_desc: str, commit_id: str) -> bool | None:
        """None if the commit row doesn't exist, else its ``committed`` flag.
        Distinguishes a fully-durable commit from one that crashed between
        phase 1 (data commit insert) and phase 2 (partition version bump)."""
        row = self._exec(self._conn(), 
            "SELECT committed FROM data_commit_info WHERE table_id=? AND partition_desc=? AND commit_id=?",
            (table_id, partition_desc, commit_id),
        ).fetchone()
        return None if row is None else bool(row[0])

    def list_uncommitted_commits(
        self, table_id: str | None = None, older_than_ms: int | None = None
    ) -> list[DataCommitInfo]:
        """Data commits whose ``committed`` flag never flipped — the debris
        a writer killed between commit phases leaves behind.  Crash
        recovery (MetaDataClient.recover_incomplete_commits) rolls each
        forward or back; ``older_than_ms`` keeps live in-flight writers out
        of the sweep."""
        sql = (
            "SELECT table_id, partition_desc, commit_id, file_ops, commit_op,"
            " committed, timestamp, domain FROM data_commit_info WHERE committed=0"
        )
        params: list = []
        if table_id is not None:
            sql += " AND table_id=?"
            params.append(table_id)
        if older_than_ms is not None:
            sql += " AND timestamp<=?"
            params.append(older_than_ms)
        rows = self._exec(self._conn(), sql, tuple(params)).fetchall()
        return [self._row_to_commit(r) for r in rows]

    def delete_data_commit_info(self, table_id: str, partition_desc: str, commit_ids: list[str]) -> None:
        if not commit_ids:
            return
        qmarks = ",".join("?" for _ in commit_ids)
        with self.transaction() as conn:
            self._exec(conn, 
                f"DELETE FROM data_commit_info WHERE table_id=? AND partition_desc=? AND commit_id IN ({qmarks})",
                (table_id, partition_desc, *commit_ids),
            )

    # -- partition info ------------------------------------------------------
    def _row_to_partition(self, row) -> PartitionInfo:
        return PartitionInfo(
            table_id=row[0],
            partition_desc=row[1],
            version=row[2],
            commit_op=CommitOp(row[3]),
            timestamp=row[4],
            snapshot=json.loads(row[5] or "[]"),
            expression=row[6] or "",
            domain=row[7],
        )

    _PI_COLS = "table_id, partition_desc, version, commit_op, timestamp, snapshot, expression, domain"

    def transaction_insert_partition_info(
        self,
        partitions: list[PartitionInfo],
        *,
        descs_canonical: bool = False,
        lease_guard: tuple[str, str, int] | None = None,
    ) -> None:
        """Atomically insert new partition versions.  A PK conflict on
        (table_id, partition_desc, version) raises CommitConflictError —
        the optimistic-concurrency mechanism of the reference.

        ``descs_canonical=True`` is the caller's attestation that every desc
        in this batch is in canonical range-column order; a currently-valid
        verified-canonical flag is then moved forward to the new epoch in the
        same transaction (CAS), so client commits of new canonical
        partitions keep plan-time verification O(1).  Hand-committers that
        don't attest leave the flag behind the epoch, forcing the client's
        full re-verification — the safe direction.

        ``lease_guard=(key, holder, token)`` fences the commit on a lease
        (:meth:`acquire_lease`) *inside the same transaction*: if the lease
        row no longer matches — expired and re-acquired by a peer with a
        higher fencing token — the whole insert rolls back with
        :class:`LeaseFencedError`.  This is what makes a SIGKILLed-and-
        replaced compactor's late commit impossible, not merely unlikely."""
        live = [p for p in partitions if p.version >= 0]
        descs_by_table: dict[str, set[str]] = {}
        for p in live:  # sentinel Default rows (version<0) are skipped
            descs_by_table.setdefault(p.table_id, set()).add(p.partition_desc)
        try:
            with self.transaction() as conn:
                if lease_guard is not None:
                    self._verify_lease_guard(conn, lease_guard, now_millis())
                # one batched existence probe per table (not per partition):
                # which of this batch's descs are NEW to the desc set
                new_desc_tables: set[str] = set()
                for table_id, descs in descs_by_table.items():
                    dl = sorted(descs)
                    rows = self._exec(conn,
                        "SELECT DISTINCT partition_desc FROM partition_info"
                        f" WHERE table_id=? AND partition_desc IN ({','.join('?' * len(dl))})",
                        (table_id, *dl),
                    ).fetchall()
                    if descs - {r[0] for r in rows}:
                        new_desc_tables.add(table_id)
                for p in live:
                    self._exec(conn,
                        "INSERT INTO partition_info(table_id, partition_desc, version, commit_op,"
                        " timestamp, snapshot, expression, domain) VALUES (?,?,?,?,?,?,?,?)",
                        (
                            p.table_id,
                            p.partition_desc,
                            p.version,
                            p.commit_op.value,
                            p.timestamp or now_millis(),
                            json.dumps(p.snapshot),
                            p.expression,
                            p.domain,
                        ),
                    )
                for table_id in new_desc_tables:
                    # first version of a new desc changes the table's desc
                    # SET → bump the epoch in the same transaction, so
                    # clients' canonical-desc verification (keyed to the
                    # epoch) re-runs instead of trusting a stale result
                    old_epoch = self.get_global_config(
                        DESC_EPOCH_KEY + table_id, "0", conn=conn
                    )
                    self._bump_desc_epoch(conn, table_id)
                    if descs_canonical:
                        # CAS: only a flag valid at the pre-bump epoch moves
                        # forward; an invalid/absent flag stays invalid
                        self._exec(conn,
                            "UPDATE global_config SET value=? WHERE key=? AND value=?",
                            (
                                str(int(old_epoch) + 1),
                                DESCS_VERIFIED_KEY + table_id,
                                old_epoch,
                            ),
                        )
        except self.INTEGRITY_ERRORS as e:
            raise CommitConflictError(
                f"concurrent commit conflict on {[(p.partition_desc, p.version) for p in partitions]}"
            ) from e
        self._fire_compaction_triggers(partitions)

    def _fire_compaction_triggers(self, partitions: list[PartitionInfo]) -> None:
        """Python-side reproduction of the partition_insert() PG trigger
        (meta_init.sql:101-150): for non-compaction commits, if the version
        gap since the last CompactionCommit ≥ threshold, notify listeners."""
        if not self._compaction_listeners:
            return
        conn = self._conn()
        for p in partitions:
            if p.version < 0 or p.commit_op == CommitOp.COMPACTION:
                continue
            row = self._exec(conn, 
                "SELECT MAX(version) FROM partition_info WHERE table_id=? AND partition_desc=?"
                " AND commit_op=?",
                (p.table_id, p.partition_desc, CommitOp.COMPACTION.value),
            ).fetchone()
            last_compact = row[0] if row and row[0] is not None else -1
            if p.version - last_compact >= COMPACTION_TRIGGER_VERSION_GAP:
                ti = self.get_table_info_by_id(p.table_id)
                event = CompactionEvent(
                    table_id=p.table_id,
                    table_path=ti.table_path if ti else "",
                    table_namespace=ti.table_namespace if ti else "default",
                    partition_desc=p.partition_desc,
                    version=p.version,
                )
                for listener in self._compaction_listeners:
                    listener(event)

    def add_compaction_listener(self, fn: Callable[[CompactionEvent], None]) -> None:
        self._compaction_listeners.append(fn)

    def remove_compaction_listener(self, fn: Callable[[CompactionEvent], None]) -> None:
        self._compaction_listeners.remove(fn)

    def get_latest_partition_info(self, table_id: str, partition_desc: str) -> PartitionInfo | None:
        row = self._exec(self._conn(), 
            f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=?"
            " ORDER BY version DESC LIMIT 1",
            (table_id, partition_desc),
        ).fetchone()
        return self._row_to_partition(row) if row else None

    def get_partition_info_at_version(
        self, table_id: str, partition_desc: str, version: int
    ) -> PartitionInfo | None:
        row = self._exec(self._conn(), 
            f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=? AND version=?",
            (table_id, partition_desc, version),
        ).fetchone()
        return self._row_to_partition(row) if row else None

    def get_all_latest_partition_info(
        self, table_id: str, desc_prefix: str | None = None
    ) -> list[PartitionInfo]:
        """Latest version per partition_desc.  ``desc_prefix`` narrows the
        scan to descs starting with that string via an index range on the
        (table_id, partition_desc, version) primary key — the planner uses it
        to push a range-column prefix filter into the store instead of
        fetching every partition (reference pushes the same filter into PG,
        metadata_client.rs get_all_partition_info + partition filters)."""
        sql = f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND version =" \
            " (SELECT MAX(version) FROM partition_info p2 WHERE p2.table_id=partition_info.table_id" \
            "  AND p2.partition_desc=partition_info.partition_desc)"
        params: tuple = (table_id,)
        if desc_prefix is not None:
            # half-open range [prefix, next-prefix).  The bound math assumes
            # codepoint/byte ordering, which the default SQLite BINARY
            # collation gives but a PG cluster under a linguistic collation
            # (en_US.UTF-8 treats ',' as primary-ignorable) does NOT — so the
            # comparison names the byte collation explicitly where needed
            # (DESC_RANGE_COLLATION, '' on SQLite / ' COLLATE "C"' on PG).
            col = "partition_desc" + self.DESC_RANGE_COLLATION
            sql += f" AND {col} >= ?"
            params += (desc_prefix,)
            upper = desc_prefix_upper_bound(desc_prefix)
            if upper is not None:
                sql += f" AND {col} < ?"
                params += (upper,)
        rows = self._exec(self._conn(), sql, params).fetchall()
        return [self._row_to_partition(r) for r in rows]

    def get_partition_descs(self, table_id: str) -> list[str]:
        """All distinct partition descs for a table — an index-only scan the
        client uses to verify descs are canonically ordered before trusting
        the desc-prefix fast path."""
        rows = self._exec(self._conn(),
            "SELECT DISTINCT partition_desc FROM partition_info WHERE table_id=?",
            (table_id,),
        ).fetchall()
        return [r[0] for r in rows]

    def _bump_desc_epoch(self, conn, table_id: str) -> None:
        key = DESC_EPOCH_KEY + table_id
        self._exec(conn,
            "INSERT OR IGNORE INTO global_config(key, value) VALUES (?, '0')", (key,)
        )
        self._exec(conn,
            "UPDATE global_config SET value = CAST(CAST(value AS INTEGER) + 1 AS TEXT)"
            " WHERE key=?",
            (key,),
        )

    def get_desc_epoch(self, table_id: str) -> str:
        """Monotonic token for the table's desc SET (not its versions): any
        new desc or desc rewrite through the store API changes it.  O(1) —
        one global_config point lookup."""
        return self.get_global_config(DESC_EPOCH_KEY + table_id, "0") or "0"

    def rewrite_partition_desc(self, table_id: str, old_desc: str, new_desc: str) -> None:
        """Migration support: rename a partition desc across partition_info
        and data_commit_info in one transaction.  Used to canonicalize legacy
        descs (``b=2,a=1`` → ``a=1,b=2``) so the indexed prefix fast path is
        sound again; file paths are stored explicitly in file_ops and are
        unaffected."""
        if old_desc == new_desc:
            return
        with self.transaction() as conn:
            # refuse to merge two version chains: if the target desc already
            # has partition_info rows, the UPDATE would collide on the
            # (table_id, partition_desc, version) PK — and which chain wins
            # is not ours to guess
            row = self._exec(conn,
                "SELECT 1 FROM partition_info WHERE table_id=? AND partition_desc=? LIMIT 1",
                (table_id, new_desc),
            ).fetchone()
            if row is not None:
                raise MetadataError(
                    f"target desc {new_desc!r} already exists as its own partition"
                )
            self._exec(conn,  # lakelint: ignore[cas-guard] desc rename moves the WHOLE version chain by design; the in-txn probe above refuses chain merges
                "UPDATE partition_info SET partition_desc=? WHERE table_id=? AND partition_desc=?",
                (new_desc, table_id, old_desc),
            )
            self._exec(conn,  # lakelint: ignore[cas-guard] desc rename moves every commit row of the chain by design (same txn as the probe)
                "UPDATE data_commit_info SET partition_desc=? WHERE table_id=? AND partition_desc=?",
                (new_desc, table_id, old_desc),
            )
            self._bump_desc_epoch(conn, table_id)

    def get_partition_versions(
        self, table_id: str, partition_desc: str, start_version: int = 0, end_version: int | None = None
    ) -> list[PartitionInfo]:
        if end_version is None:
            rows = self._exec(self._conn(), 
                f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=?"
                " AND version >= ? ORDER BY version",
                (table_id, partition_desc, start_version),
            ).fetchall()
        else:
            rows = self._exec(self._conn(), 
                f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=?"
                " AND version >= ? AND version <= ? ORDER BY version",
                (table_id, partition_desc, start_version, end_version),
            ).fetchall()
        return [self._row_to_partition(r) for r in rows]

    def get_partition_at_timestamp(
        self, table_id: str, partition_desc: str, timestamp_ms: int
    ) -> PartitionInfo | None:
        """Time travel: the newest version with timestamp ≤ the given instant
        (reference: SnapshotManagement / for_path_snapshot)."""
        row = self._exec(self._conn(), 
            f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=?"
            " AND timestamp <= ? ORDER BY version DESC LIMIT 1",
            (table_id, partition_desc, timestamp_ms),
        ).fetchone()
        return self._row_to_partition(row) if row else None

    def delete_partition_versions_before(
        self, table_id: str, partition_desc: str, before_version: int
    ) -> list[PartitionInfo]:
        """Cleaner support: drop expired versions, returning them so the
        caller can delete orphaned data files."""
        with self.transaction() as conn:
            # SELECT and DELETE must share one transaction: a row inserted
            # between them would be deleted without being reported, orphaning
            # its data files forever
            rows = self._exec(conn, 
                f"SELECT {self._PI_COLS} FROM partition_info WHERE table_id=? AND partition_desc=? AND version < ?",
                (table_id, partition_desc, before_version),
            ).fetchall()
            self._exec(conn, 
                "DELETE FROM partition_info WHERE table_id=? AND partition_desc=? AND version < ?",
                (table_id, partition_desc, before_version),
            )
        return [self._row_to_partition(r) for r in rows]

    # -- leases --------------------------------------------------------------
    # Cross-process coordination rows (per-partition compaction jobs, or any
    # future singleton role).  Expiry is stored in epoch millis via
    # now_millis() — the store is the SHARED timebase between processes, so
    # wall clock is unavoidable here; NTP skew is absorbed by the TTL margin.
    # Holders track their LOCAL validity with time.monotonic() (see
    # compaction/service.py) and the fencing token — not the wall clock —
    # is what makes a zombie's commit rejectable (lease_guard below).

    def _lease_now_ms(self, now_ms: int | None) -> int:
        return now_millis() if now_ms is None else int(now_ms)

    def acquire_lease(
        self, key: str, holder: str, ttl_ms: int, *, now_ms: int | None = None
    ) -> Lease | None:
        """Take the lease if free, expired, or already ours.

        Returns the acquired :class:`Lease` (fencing token bumped on every
        takeover of an expired holder's row) or None when a live peer holds
        it.  ``now_ms`` is injectable for tests; atomic with respect to
        concurrent acquirers (single write transaction; a lost PK-insert
        race reads as "held by a peer")."""
        now = self._lease_now_ms(now_ms)
        try:
            with self.transaction() as conn:
                row = self._exec(conn,
                    "SELECT holder_id, fencing_token, expires_at_ms FROM lease WHERE lease_key=?",
                    (key,),
                ).fetchone()
                if row is None:
                    self._exec(conn,
                        "INSERT INTO lease(lease_key, holder_id, fencing_token,"
                        " expires_at_ms, acquired_at_ms) VALUES (?,?,?,?,?)",
                        (key, holder, 1, now + ttl_ms, now),
                    )
                    return Lease(key, holder, 1, now + ttl_ms)
                cur_holder, token, expires = row
                if cur_holder == holder and expires > now:
                    # re-entrant refresh by the current holder: same token.
                    # Compare-and-set so a READ COMMITTED backend (the PG
                    # path) can't refresh a row a peer already fenced past.
                    cur = self._exec(conn,
                        "UPDATE lease SET expires_at_ms=?"
                        " WHERE lease_key=? AND holder_id=? AND fencing_token=?",
                        (now + ttl_ms, key, holder, token),
                    )
                    if cur.rowcount == 0:
                        return None
                    return Lease(key, holder, token, now + ttl_ms)
                if expires > now:
                    return None  # a live peer holds it
                # expired: take over with a HIGHER fencing token — the old
                # holder may still be running, but its token is now stale.
                # The WHERE re-checks token+expiry so two racing takeovers
                # can't both win: the loser's UPDATE matches zero rows.
                cur = self._exec(conn,
                    "UPDATE lease SET holder_id=?, fencing_token=?,"
                    " expires_at_ms=?, acquired_at_ms=?"
                    " WHERE lease_key=? AND fencing_token=? AND expires_at_ms<=?",
                    (holder, token + 1, now + ttl_ms, now, key, token, now),
                )
                if cur.rowcount == 0:
                    return None  # a peer's takeover committed first
                return Lease(
                    key, holder, token + 1, now + ttl_ms,
                    # a cleanly-released tombstone (holder '') is a fresh
                    # acquisition, not a takeover of a dead peer
                    taken_over=cur_holder not in ("", holder),
                )
        except self.INTEGRITY_ERRORS:
            return None  # lost the insert race: a peer got there first

    def renew_lease(
        self, key: str, holder: str, fencing_token: int, ttl_ms: int,
        *, now_ms: int | None = None,
    ) -> Lease | None:
        """Extend a lease we still hold.  None when the lease is gone,
        held by someone else, carries a different token, or ALREADY EXPIRED
        — an expired lease must be re-acquired (possibly bumping the
        token), never silently revived: the renewal gap is exactly where a
        peer may have taken over."""
        now = self._lease_now_ms(now_ms)
        with self.transaction() as conn:
            # single compare-and-set: the full predicate rides in the WHERE
            # so a READ COMMITTED backend can't revive a lease a peer
            # re-acquired between a separate read and write
            cur = self._exec(conn,
                "UPDATE lease SET expires_at_ms=?"
                " WHERE lease_key=? AND holder_id=? AND fencing_token=?"
                " AND expires_at_ms>?",
                (now + ttl_ms, key, holder, fencing_token, now),
            )
            if cur.rowcount == 0:
                return None
            return Lease(key, holder, fencing_token, now + ttl_ms)

    def release_lease(self, key: str, holder: str, fencing_token: int) -> bool:
        """Drop the lease iff we still hold it under this token (a zombie's
        release must not free a peer's re-acquired lease).

        The row is TOMBSTONED (holder cleared, expiry zeroed), never
        deleted: deleting would restart fencing tokens at 1 on the next
        acquisition, and a hung ex-holder that rejoined under the same
        service id could then pass the commit guard with its stale token.
        Keeping the row keeps the token sequence monotonic per key for the
        table's lifetime."""
        with self.transaction() as conn:
            cur = self._exec(conn,
                "UPDATE lease SET holder_id='', expires_at_ms=0"
                " WHERE lease_key=? AND holder_id=? AND fencing_token=?",
                (key, holder, fencing_token),
            )
            return cur.rowcount > 0

    def get_lease(self, key: str) -> Lease | None:
        row = self._exec(self._conn(),
            "SELECT holder_id, fencing_token, expires_at_ms FROM lease WHERE lease_key=?",
            (key,),
        ).fetchone()
        if row is None or row[0] == "":  # absent or released tombstone
            return None
        return Lease(key, row[0], row[1], row[2])

    # appended to in-transaction reads whose value feeds a dependent write,
    # so backends with row-level concurrency (PG, READ COMMITTED) lock the
    # row until the txn ends — without it a peer's committed write can
    # interleave between the read and the write that depends on it.  SQLite's
    # fully-serialized transaction() needs (and supports) no FOR UPDATE, so
    # its spelling is a comment: a machine-visible marker that the read is
    # lock-intended, which the txncheck interleaving replayer keys on when
    # it decides whether a recorded read-then-write is splittable.
    ROW_LOCK = " /*row-lock*/"

    def _verify_lease_guard(self, conn, guard: tuple, now: int) -> None:
        key, holder, token = guard
        row = self._exec(conn,
            "SELECT holder_id, fencing_token, expires_at_ms FROM lease"
            f" WHERE lease_key=?{self.ROW_LOCK}",
            (key,),
        ).fetchone()
        if row is None or row[0] != holder or row[1] != token or row[2] <= now:
            raise LeaseFencedError(
                f"lease {key!r} no longer held by {holder!r} with token {token}"
                f" (current: {row!r}); abandoning the commit"
            )

    # -- compaction candidates ----------------------------------------------
    def get_compaction_candidates(
        self, version_gap: int = COMPACTION_TRIGGER_VERSION_GAP
    ) -> list[CompactionEvent]:
        """Partitions whose committed head has advanced ≥ ``version_gap``
        versions past their last CompactionCommit — the state the PG trigger
        derives its notify from (meta_init.sql:101-150), re-derivable by ANY
        process at ANY time.  This is what makes the polling consumer
        crash-safe: the 'watermark' is the last compaction version already
        in ``partition_info``, so a consumer killed mid-job loses nothing —
        the gap persists and the next poll (in any process) re-emits it."""
        rows = self._exec(self._conn(),
            "SELECT table_id, partition_desc, MAX(version),"
            " COALESCE(MAX(CASE WHEN commit_op=? THEN version END), -1)"
            " FROM partition_info GROUP BY table_id, partition_desc"
            " HAVING MAX(version) -"
            " COALESCE(MAX(CASE WHEN commit_op=? THEN version END), -1) >= ?",
            (CommitOp.COMPACTION.value, CommitOp.COMPACTION.value, version_gap),
        ).fetchall()
        if not rows:
            return []
        # one batched lookup for the candidate tables' path/namespace —
        # this runs on EVERY poll of every service, so no per-row queries
        ids = sorted({table_id for table_id, _, _, _ in rows})
        ph = ",".join("?" * len(ids))
        info = {
            r[0]: (r[1], r[2])
            for r in self._exec(self._conn(),
                "SELECT table_id, table_path, table_namespace"
                f" FROM table_info WHERE table_id IN ({ph})",
                tuple(ids),
            ).fetchall()
        }
        out: list[CompactionEvent] = []
        for table_id, desc, head, _last in rows:
            path, namespace = info.get(table_id, ("", "default"))
            out.append(
                CompactionEvent(
                    table_id=table_id,
                    table_path=path,
                    table_namespace=namespace,
                    partition_desc=desc,
                    version=head,
                )
            )
        return out

    # -- global config -------------------------------------------------------
    def get_global_config(self, key: str, default: str | None = None, *, conn=None) -> str | None:
        row = self._exec(conn or self._conn(),
            "SELECT value FROM global_config WHERE key=?", (key,)
        ).fetchone()
        return row[0] if row else default

    def set_global_config(self, key: str, value: str) -> None:
        with self.transaction() as conn:
            self._exec(conn,
                "INSERT INTO global_config(key, value) VALUES (?,?)"
                " ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (key, value),
            )

    def set_descs_verified(self, table_id: str, epoch: str) -> bool:
        """CAS write of the verified-canonical flag: the flag lands at
        ``epoch`` only while the table's desc epoch still IS ``epoch``,
        re-read under the row lock inside one transaction.  A blind
        ``set_global_config`` here would let this interleaving through on a
        READ COMMITTED backend: client verifies at epoch N → writer commits
        a new desc and bumps to N+1 → client's stale flag lands — and if the
        bump then moved the flag forward (descs_canonical attestation), the
        stale write would clobber a flag that is CURRENT.  Returns whether
        the flag was written.  (When the epoch row is still absent — epoch
        "0", nothing committed yet — there is no row to lock and a racing
        first bump can slip between; the flag then records epoch "0" which
        no longer matches, forcing re-verification: the safe direction.)"""
        with self.transaction() as conn:
            row = self._exec(conn,
                f"SELECT value FROM global_config WHERE key=?{self.ROW_LOCK}",
                (DESC_EPOCH_KEY + table_id,),
            ).fetchone()
            if (row[0] if row else "0") != epoch:
                return False
            self._exec(conn,
                "INSERT INTO global_config(key, value) VALUES (?,?)"
                " ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (DESCS_VERIFIED_KEY + table_id, epoch),
            )
            return True

    def update_global_config(self, key: str, updater) -> str:
        """Atomic read-modify-write: ``updater(old_value_or_None) -> new``
        runs inside ONE write transaction, so concurrent updates serialize
        instead of losing each other's changes.

        SQLite serializes whole transactions, but PG's READ COMMITTED lets a
        peer commit between this SELECT and the write — so the row is
        materialized first (FOR UPDATE cannot lock an absent row; a rollback
        removes it again) and the read takes the row lock.  Two concurrent
        updaters then queue on the lock instead of both reading the old
        value and losing one update."""
        with self.transaction() as conn:
            self._exec(conn,
                "INSERT OR IGNORE INTO global_config(key, value) VALUES (?, NULL)",
                (key,),
            )
            row = self._exec(
                conn, f"SELECT value FROM global_config WHERE key=?{self.ROW_LOCK}",
                (key,),
            ).fetchone()
            new = updater(row[0] if row else None)
            self._exec(conn,
                "UPDATE global_config SET value=? WHERE key=?", (new, key),
            )
            return new

    # -- discard (compaction garbage) ---------------------------------------
    def insert_discard_file(self, file_path: str, table_path: str, partition_desc: str) -> None:
        import datetime

        today = datetime.date.today().isoformat()
        with self.transaction() as conn:
            # portable upsert: delete+insert inside one transaction
            self._exec(conn,
                "DELETE FROM discard_compressed_file_info WHERE file_path=?",
                (file_path,),
            )
            self._exec(conn,
                "INSERT INTO discard_compressed_file_info(file_path, table_path,"
                " partition_desc, timestamp, t_date) VALUES (?,?,?,?,?)",
                (file_path, table_path, partition_desc, now_millis(), today),
            )

    def list_discard_files(self, older_than_ms: int | None = None) -> list[tuple[str, str, str]]:
        if older_than_ms is None:
            rows = self._exec(self._conn(), 
                "SELECT file_path, table_path, partition_desc FROM discard_compressed_file_info"
            ).fetchall()
        else:
            rows = self._exec(self._conn(), 
                "SELECT file_path, table_path, partition_desc FROM discard_compressed_file_info WHERE timestamp < ?",
                (older_than_ms,),
            ).fetchall()
        return rows

    def delete_discard_files(self, file_paths: list[str]) -> None:
        if not file_paths:
            return
        qmarks = ",".join("?" for _ in file_paths)
        with self.transaction() as conn:
            self._exec(conn, 
                f"DELETE FROM discard_compressed_file_info WHERE file_path IN ({qmarks})",
                tuple(file_paths),
            )

    # -- test support (reference: clean_meta_for_test) -----------------------
    def clean_all_for_test(self) -> None:
        with self.transaction() as conn:
            for t in (
                "table_info",
                "table_name_id",
                "table_path_id",
                "data_commit_info",
                "partition_info",
                "discard_compressed_file_info",
                "lease",
            ):
                self._exec(conn, f"DELETE FROM {t}")


class SqliteMetadataStore(SqlMetadataStore):
    def __init__(self, db_path: str | os.PathLike = ":memory:"):
        super().__init__()
        self.db_path = str(db_path)
        self._local = threading.local()
        # RLock: transaction() holds it across a whole write transaction
        # while the transaction body's own _exec calls re-enter it
        self._lock = threading.RLock()
        conn = self._conn()
        with conn:
            conn.executescript(_SCHEMA)
            self._exec(conn, 
                "INSERT OR IGNORE INTO namespace(namespace, properties, comment) VALUES ('default', '{}', '')"
            )

    # -- connection handling -------------------------------------------------
    def _conn(self) -> sqlite3.Connection:
        if self.db_path == ":memory:":
            # a single shared connection for in-memory DBs
            with self._lock:
                if not hasattr(self, "_mem_conn"):
                    self._mem_conn = sqlite3.connect(
                        ":memory:", check_same_thread=False
                    )
                    self._mem_conn.execute("PRAGMA foreign_keys=ON")
                return self._mem_conn
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path, timeout=30.0)
            self._exec(conn, "PRAGMA journal_mode=WAL")
            self._exec(conn, "PRAGMA synchronous=NORMAL")
            with conn:
                conn.executescript(_SCHEMA)
            self._local.conn = conn
        return conn

    class _EagerCursor:
        """Pre-fetched result rows with the cursor surface the DAO layer
        uses (fetchone/fetchall/iteration/rowcount).  ``rowcount`` must ride
        along: every lease CAS checks it, and an eager cursor without it
        made acquire/renew/release raise on shared :memory: stores — the
        CAS contract silently held only on the file-backed path."""

        __slots__ = ("_rows", "rowcount")

        def __init__(self, rows, rowcount=-1):
            self._rows = rows
            self.rowcount = rowcount

        def fetchall(self):
            return self._rows

        def fetchone(self):
            return self._rows[0] if self._rows else None

        def __iter__(self):
            return iter(self._rows)

    def _exec(self, conn, sql, params=()):
        if conn is getattr(self, "_mem_conn", None):
            # the shared :memory: connection: serialize EVERY statement with
            # the write-transaction lock and fetch eagerly inside it.  A
            # lazily-consumed cursor would race another thread's
            # commit/rollback on the same connection ("Cursor needed to be
            # reset because of commit/rollback and can no longer be fetched
            # from"), and a read interleaved with an open write transaction
            # would see its uncommitted rows.
            with self._lock:
                cur = super()._exec(conn, sql, params)
                try:
                    rows = cur.fetchall()
                except sqlite3.ProgrammingError:
                    rows = []  # statements with no result set
                return self._EagerCursor(rows, cur.rowcount)
        return super()._exec(conn, sql, params)

    @contextlib.contextmanager
    def transaction(self):
        """Write transaction.  In-memory stores share one connection across
        threads, so multi-statement transactions must be serialized by a lock
        to keep atomicity (file-backed stores get a connection per thread and
        rely on SQLite's own locking)."""
        conn = self._conn()
        if self.db_path == ":memory:":
            with self._lock:
                with conn:
                    yield conn
        else:
            # explicit BEGIN IMMEDIATE: legacy sqlite3 transaction control does
            # not open the implicit transaction for SELECTs, so a read+write
            # pair (e.g. delete_partition_versions_before) would not actually
            # share one transaction across processes without it
            with conn:
                if not conn.in_transaction:
                    # a "database is locked" timeout must propagate, not fall
                    # through to a transaction-less body
                    conn.execute("BEGIN IMMEDIATE")
                yield conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None



class PostgresMetadataStore(SqlMetadataStore):
    """PostgreSQL-backed store (the reference's deployment shape): same DAO
    surface over psycopg2 with per-thread connections.  Requires the psycopg2
    DB-API module (not bundled in TPU images — import-gated)."""

    PARAMSTYLE = "format"
    # a linguistic cluster collation (en_US.UTF-8) breaks the prefix-range
    # bound math; "C" is byte order and always present in PG
    DESC_RANGE_COLLATION = ' COLLATE "C"'
    # READ COMMITTED: in-transaction reads that feed dependent writes (the
    # commit-time fencing check, CAS helpers) must hold their row against a
    # concurrent committed UPDATE until the txn ends — a real row lock here,
    # where the base class's serialized sqlite spelling is just a marker
    ROW_LOCK = " FOR UPDATE"

    _PG_SCHEMA = re.sub(
        r"timestamp(\s+)INTEGER", r"timestamp\1BIGINT",
        _SCHEMA.replace("BLOB", "BYTEA"),
    )

    def __init__(self, dsn: str):
        try:
            import psycopg2
        except ImportError as e:  # pragma: no cover - psycopg2 not in image
            raise ImportError(
                "PostgresMetadataStore requires psycopg2 (pip install psycopg2-binary)"
            ) from e
        super().__init__()
        self._psycopg2 = psycopg2
        self.INTEGRITY_ERRORS = (psycopg2.IntegrityError,)
        self.dsn = dsn
        self._local = threading.local()
        conn = self._conn()
        with conn:
            cur = conn.cursor()
            for stmt in self._PG_SCHEMA.split(";"):
                if stmt.strip():
                    cur.execute(stmt)
            cur.execute(
                "INSERT INTO namespace(namespace, properties, comment)"
                " VALUES ('default', '{}', '') ON CONFLICT DO NOTHING"
            )

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None or conn.closed:
            conn = self._psycopg2.connect(self.dsn)
            # reads autocommit: otherwise every reader connection sits
            # "idle in transaction" forever, pinning xmin and blocking vacuum
            conn.autocommit = True
            self._local.conn = conn
        return conn

    @contextlib.contextmanager
    def transaction(self):
        conn = self._conn()
        conn.autocommit = False
        try:
            with conn:  # commit on success, rollback on error
                yield conn
        finally:
            conn.autocommit = True

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None and not conn.closed:
            conn.close()
