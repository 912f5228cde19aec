"""Arrow Flight SQL protocol on the gateway (the port's copy of
``lakesoul_tpu/service/flight_sql.py``).

The reference's multi-engine story is a real FlightSqlService any ADBC/JDBC
client can speak (rust/lakesoul-flight/src/flight_sql_service.rs:194,
src/bin/flight_sql_server.rs:22).  This module upgrades the plain-Flight
gateway to that protocol: protobuf commands wrapped in ``google.protobuf.Any``
ride the standard Flight RPCs —

- ``GetFlightInfo(CommandStatementQuery)`` → ``DoGet(TicketStatementQuery)``
  executes SELECTs (results cached under a one-shot statement handle);
- ``DoPut(CommandStatementUpdate)`` runs DML and returns ``DoPutUpdateResult``
  in the put metadata;
- ``DoPut(CommandStatementIngest)`` bulk-ingests an Arrow stream into a table
  (create-if-missing / append / replace), mapped onto the same exactly-once
  checkpoint path as the JSON dialect when a transaction id is supplied;
- ``CreatePreparedStatement`` / ``ClosePreparedStatement`` actions with
  parameter binding via ``DoPut(CommandPreparedStatementQuery)``;
- ``CommandGetCatalogs`` / ``DbSchemas`` / ``Tables`` / ``TableTypes`` /
  ``PrimaryKeys`` / ``SqlInfo`` metadata queries with the spec result schemas.

The JSON-ticket dialect of ``LakeSoulFlightServer`` remains the internal fast
path — any ticket/descriptor that doesn't parse as an Any-wrapped Flight SQL
message falls back to it.  Auth is unchanged (Basic/Bearer headers through the
shared middleware; ``authenticate_basic_token`` handshakes get the minted
bearer back in the response headers).

Transactions (reference: do_action_begin_transaction / end_transaction,
flight_sql_service.rs:1044-1082): ``BeginTransaction`` mints a server
transaction id; ingest streams carrying that id are STAGED (files written,
nothing committed); ``EndTransaction`` COMMIT publishes every staged table
through the exactly-once checkpoint path (commit ids derive from the
transaction id) and ROLLBACK deletes the staged files.  This is what ADBC
drivers with ``autocommit=False`` issue at connect time.  Like the
reference, only ingest participates: DML/queries inside an open transaction
execute per-statement (each is individually atomic through the commit
protocol).  An explicit ``transaction_id`` that was NOT minted by
BeginTransaction keeps its pre-existing meaning — per-statement ingest with
idempotent-replay dedup.

The messages, the ``type_url`` prefix, the result schemas and the commit ids
(``transaction_id.hex()``) are the reference's, so a client of either package
talks to a server of either package, and an ingest replayed to the other
package's server on the same warehouse is a no-op.  The server keeps the
gateway's ``device``: a ``CALL build_vector_index`` statement builds there
and the JSON fall-through's ``vector_search`` searches there (``None`` = the
CUDA card, ``"cpu"`` only when asked).
"""

from __future__ import annotations

import threading
import time
import uuid

import pyarrow as pa
import pyarrow.flight as flight
from google.protobuf import any_pb2

from lakesoul_tpu_torch.errors import LakeSoulError
from lakesoul_tpu_torch.service import _flight_sql_pb2 as pb
from lakesoul_tpu_torch.service.flight import LakeSoulFlightServer

_ANY_PREFIX = "type.googleapis.com/arrow.flight.protocol.sql."

# one-shot statement results: bounded, TTL-evicted
_STMT_TTL_S = 600.0
_STMT_CAP = 128


def _pack(msg) -> bytes:
    a = any_pb2.Any()
    a.Pack(msg)
    return a.SerializeToString()


def _unpack(raw: bytes):
    """Any bytes → (short type name, decoded message) or (None, None)."""
    try:
        a = any_pb2.Any.FromString(raw)
    except Exception:
        return None, None
    if not a.type_url.startswith(_ANY_PREFIX):
        return None, None
    name = a.type_url[len(_ANY_PREFIX):]
    cls = getattr(pb, name, None)
    if cls is None:
        raise flight.FlightServerError(f"unsupported Flight SQL message {name}")
    msg = cls()
    if not a.Unpack(msg):
        raise flight.FlightServerError(f"malformed {name} payload")
    return name, msg


def _render_sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, float):
        # the dialect's tokenizer has no scientific-notation number token:
        # repr(1e-07) would fail to parse — render as plain decimal, exact
        # to the float's shortest repr
        import decimal
        import math

        if not math.isfinite(v):
            raise flight.FlightServerError(
                f"cannot bind non-finite float parameter {v!r}: the dialect"
                " has no literal for it"
            )
        text = format(decimal.Decimal(repr(v)), "f")
        # keep the decimal point: an integral float (1e16) would otherwise
        # re-type as an int literal and fail int-range checks downstream
        return text if "." in text else text + ".0"
    if isinstance(v, bytes):
        # a quoted hex STRING would silently never equal a binary column —
        # reject instead of producing a wrong-answer literal
        raise flight.FlightServerError(
            "binary parameters are not supported: the dialect has no bytes"
            " literal (bind a string or use ingest)"
        )
    return "'" + str(v).replace("'", "''") + "'"


def count_placeholders(query: str) -> int:
    """Number of ``?`` parameter slots outside string literals — the same
    scan :func:`bind_parameters` performs, used to validate arity at
    CreatePreparedStatement time instead of failing at bind time."""
    n = 0
    in_str = False
    i = 0
    while i < len(query):
        ch = query[i]
        if in_str:
            if ch == "'":
                if i + 1 < len(query) and query[i + 1] == "'":
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
        elif ch == "?":
            n += 1
        i += 1
    return n


def bind_parameters(query: str, row: dict | None, values: list) -> str:
    """Substitute ``?`` placeholders (outside string literals) with rendered
    SQL literals — the binding model simple Flight SQL servers use; the
    dialect has no server-side parameterized plans.

    Contract: binding is LITERAL SUBSTITUTION over the dialect's quoting
    rules — single-quoted strings with ``''`` escapes are the only string
    syntax the tokenizer knows, and the scan here mirrors exactly that.  If
    the dialect ever grows another quoting form (dollar quotes, ``E''``),
    this scanner must learn it in the same commit or placeholders inside
    such strings would be substituted.  Arity is validated here and at
    prepare time (:func:`count_placeholders`); a mismatch is an error, not
    a silent partial bind."""
    del row  # positional binding only
    want = count_placeholders(query)
    if len(values) != want:
        raise flight.FlightServerError(
            f"statement has {want} parameter(s) but {len(values)} were bound"
        )
    out = []
    it = iter(values)
    in_str = False
    i = 0
    while i < len(query):
        ch = query[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                # '' escape stays inside the literal
                if i + 1 < len(query) and query[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            out.append(ch)
        elif ch == "?":
            # arity was validated above: the iterator cannot exhaust
            out.append(_render_sql_literal(next(it)))
        else:
            out.append(ch)
        i += 1
    return "".join(out)


_PREPARED_TTL_S = 3600.0
_PREPARED_CAP = 256

_TXN_TTL_S = 3600.0
_TXN_CAP = 64


class _Transaction:
    """Server-side transaction: per-table staged writers, published (or
    aborted) as one unit at EndTransaction."""

    __slots__ = ("writers", "replace", "failed", "closed", "expires", "lock")

    def __init__(self):
        self.writers: dict[tuple[str, str], object] = {}  # (ns, table) → CheckpointedWriter
        self.replace: set[tuple[str, str]] = set()
        self.failed = False  # a stream died mid-way: COMMIT must refuse
        # set under `lock` by EndTransaction/eviction: an ingest that looked
        # the txn up just before it ended must FAIL, not stage into a ghost
        self.closed = False
        self.expires = time.monotonic() + _TXN_TTL_S
        self.lock = threading.Lock()

    def abort(self) -> None:
        for w in self.writers.values():
            w.abort()
        self.writers.clear()


class _PreparedStatement:
    __slots__ = ("query", "dataset_schema", "params", "expires", "param_count")

    def __init__(self, query: str, dataset_schema: pa.Schema | None):
        self.query = query
        self.dataset_schema = dataset_schema
        self.params: list[list] = []  # bound rows (positional values)
        self.expires = time.monotonic() + _PREPARED_TTL_S
        self.param_count = count_placeholders(query)

    def touch(self) -> "_PreparedStatement":
        self.expires = time.monotonic() + _PREPARED_TTL_S
        return self


class LakeSoulFlightSqlServer(LakeSoulFlightServer):
    """The gateway with the standard Flight SQL protocol layered on top."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._stmt_lock = threading.Lock()
        self._stmt_results: dict[bytes, tuple[float, pa.Table]] = {}
        self._prepared: dict[bytes, _PreparedStatement] = {}
        self._transactions: dict[bytes, _Transaction] = {}
        # ids of ended/expired transactions: an ingest replaying one must be
        # REJECTED, not silently fall through to the autocommit path
        self._closed_txns: "dict[bytes, None]" = {}

    # --------------------------------------------------------- transactions
    def _pop_expired_locked(self) -> list[_Transaction]:
        """Remove TTL-expired transactions from the registry (caller holds
        ``_stmt_lock``) and return them — the caller aborts them AFTER
        releasing the lock, since abort takes each transaction's own lock
        and may wait for an in-flight stream."""
        now = time.monotonic()
        dead = [t for t, txn in self._transactions.items() if txn.expires < now]
        out = []
        for t in dead:
            self._mark_closed_locked(t)
            out.append(self._transactions.pop(t))
        return out

    def _mark_closed_locked(self, txn_id: bytes) -> None:
        while len(self._closed_txns) >= 1024:
            self._closed_txns.pop(next(iter(self._closed_txns)))
        self._closed_txns[txn_id] = None

    @staticmethod
    def _abort_all(expired: list[_Transaction]) -> None:
        for txn in expired:
            # expired staged files would orphan on the store forever.  The
            # closed flag is set BEFORE taking the lock (monotonic bool): a
            # wedged ingest stream may hold txn.lock for its whole duration,
            # and blocking here would hang every other client's
            # Begin/EndTransaction behind one dead stream — if the lock is
            # busy, the stream's own post-loop closed-check cleans up.
            txn.closed = True
            if txn.lock.acquire(timeout=0.5):
                try:
                    txn.abort()
                finally:
                    txn.lock.release()

    def _begin_transaction(self) -> list:
        txn_id = uuid.uuid4().bytes
        with self._stmt_lock:
            expired = self._pop_expired_locked()
            full = len(self._transactions) >= _TXN_CAP
            if not full:
                self._transactions[txn_id] = _Transaction()
        # aborts always happen OUTSIDE _stmt_lock: abort takes each txn.lock,
        # which an in-flight stream may hold for its whole duration
        self._abort_all(expired)
        if full:
            raise flight.FlightServerError(
                f"too many open transactions ({_TXN_CAP}); commit or"
                " roll back existing ones"
            )
        return [
            flight.Result(
                _pack(pb.ActionBeginTransactionResult(transaction_id=txn_id))
            )
        ]

    def _get_transaction(self, txn_id: bytes) -> _Transaction | None:
        """The OPEN transaction for this id; None when the id was never
        minted by BeginTransaction (→ per-statement idempotent-ingest path);
        error when it WAS minted but has since ended or expired."""
        with self._stmt_lock:
            expired = self._pop_expired_locked()
            txn = self._transactions.get(txn_id)
            if txn is not None:
                txn.expires = time.monotonic() + _TXN_TTL_S
            closed = txn is None and txn_id in self._closed_txns
        self._abort_all(expired)
        if closed:
            raise flight.FlightServerError(
                "transaction has already ended or expired"
            )
        return txn

    def _end_transaction(self, msg) -> list:
        with self._stmt_lock:
            txn = self._transactions.pop(msg.transaction_id, None)
            if txn is not None:
                self._mark_closed_locked(msg.transaction_id)
        if txn is None:
            raise flight.FlightServerError("unknown or expired transaction")
        with txn.lock:
            txn.closed = True
            if msg.action == pb.ActionEndTransactionRequest.END_TRANSACTION_ROLLBACK:
                txn.abort()
                return []
            if msg.action != pb.ActionEndTransactionRequest.END_TRANSACTION_COMMIT:
                txn.abort()
                raise flight.FlightServerError("invalid EndTransaction action")
            if txn.failed:
                txn.abort()
                raise flight.FlightServerError(
                    "transaction had a failed statement and cannot commit"
                )
            cid = msg.transaction_id.hex()
            done: set = set()
            try:
                for key, w in txn.writers.items():
                    # RBAC ran per-stream at ingest/stage time — each writer
                    # in txn.writers exists only because its ingest passed
                    # _check; EndTransaction merely publishes those already-
                    # authorized staged files under the transaction id
                    if key in txn.replace:
                        w.checkpoint_replace(cid)  # lakelint: ignore[rbac-gate-reachability] every staged writer passed _check at ingest time; commit publishes only authorized stages
                    else:
                        w.checkpoint(cid)  # lakelint: ignore[rbac-gate-reachability] every staged writer passed _check at ingest time; commit publishes only authorized stages
                    done.add(key)
            except Exception as e:  # noqa: BLE001 — ANY failure must clean up
                # per-table commits are individually atomic but there is no
                # cross-table transaction log: abort the NOT-yet-committed
                # writers (their staged files must not orphan) and report
                # exactly what did land so the client can reconcile.  A
                # failing abort (same store outage) must not stop the other
                # aborts or mask the original error's report.
                for key, w in txn.writers.items():
                    if key not in done:
                        try:
                            w.abort()
                        except Exception:  # noqa: BLE001
                            pass
                committed = ", ".join(f"{ns}.{t}" for ns, t in sorted(done)) or "none"
                raise flight.FlightServerError(
                    f"transaction commit failed on {e}; committed tables:"
                    f" {committed}; remaining tables rolled back"
                )
        return []

    # ------------------------------------------------------------- sql exec
    def _execute_sql(self, context, query: str, namespace: str = "default") -> pa.Table:
        from lakesoul_tpu_torch.sql import SqlSession
        from lakesoul_tpu_torch.sql.parser import SqlError, parse as parse_sql

        try:
            stmt = parse_sql(query)
        except SqlError as e:
            raise flight.FlightServerError(str(e))
        # RBAC covers EVERY table the statement touches — joins, derived
        # tables, EXISTS/IN/scalar subqueries — not just the primary FROM;
        # CALL clean() needs warehouse-wide (wildcard) access
        self._check_statement(context, namespace, stmt)
        try:
            return SqlSession(self.catalog, namespace, device=self.device).execute(query)
        except (LakeSoulError, SqlError) as e:
            raise flight.FlightServerError(str(e))

    def _cache_result(self, result: pa.Table) -> bytes:
        handle = uuid.uuid4().bytes
        now = time.monotonic()
        with self._stmt_lock:
            expired = [
                h for h, (exp, _) in self._stmt_results.items() if exp < now
            ]
            for h in expired:
                del self._stmt_results[h]
            while len(self._stmt_results) >= _STMT_CAP:
                self._stmt_results.pop(next(iter(self._stmt_results)))
            self._stmt_results[handle] = (now + _STMT_TTL_S, result)
        return handle

    def _take_result(self, handle: bytes) -> pa.Table:
        with self._stmt_lock:
            hit = self._stmt_results.pop(handle, None)
        if hit is None or hit[0] < time.monotonic():
            raise flight.FlightServerError("unknown or expired statement handle")
        return hit[1]

    def _result_info(self, descriptor, result: pa.Table) -> flight.FlightInfo:
        handle = self._cache_result(result)
        ticket = flight.Ticket(
            _pack(pb.TicketStatementQuery(statement_handle=handle))
        )
        endpoint = flight.FlightEndpoint(ticket, [])
        return flight.FlightInfo(
            result.schema, descriptor, [endpoint], result.num_rows, -1
        )

    # -------------------------------------------------------- metadata sets
    _TABLES_SCHEMA = pa.schema(
        [
            pa.field("catalog_name", pa.utf8()),
            pa.field("db_schema_name", pa.utf8()),
            pa.field("table_name", pa.utf8(), nullable=False),
            pa.field("table_type", pa.utf8(), nullable=False),
        ]
    )
    _PK_SCHEMA = pa.schema(
        [
            pa.field("catalog_name", pa.utf8()),
            pa.field("db_schema_name", pa.utf8()),
            pa.field("table_name", pa.utf8(), nullable=False),
            pa.field("column_name", pa.utf8(), nullable=False),
            pa.field("key_name", pa.utf8()),
            pa.field("key_sequence", pa.int32(), nullable=False),
        ]
    )

    @staticmethod
    def _like_match(pattern: str | None, value: str) -> bool:
        if not pattern:
            return True
        import re

        rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
        # re.escape escapes % and _ as themselves (no-op) in py3.12; handle
        # the escaped forms too for older semantics
        rx = rx.replace(r"\%", ".*").replace(r"\_", ".")
        return re.fullmatch(rx, value) is not None

    def _get_catalogs(self) -> pa.Table:
        return pa.table(
            {"catalog_name": pa.array(["lakesoul"], pa.utf8())},
            schema=pa.schema([pa.field("catalog_name", pa.utf8(), nullable=False)]),
        )

    def _get_db_schemas(self, msg) -> pa.Table:
        pattern = msg.db_schema_filter_pattern or None
        names = [
            ns for ns in self.catalog.list_namespaces() if self._like_match(pattern, ns)
        ]
        return pa.table(
            {
                "catalog_name": pa.array(["lakesoul"] * len(names), pa.utf8()),
                "db_schema_name": pa.array(names, pa.utf8()),
            },
            schema=pa.schema(
                [
                    pa.field("catalog_name", pa.utf8()),
                    pa.field("db_schema_name", pa.utf8(), nullable=False),
                ]
            ),
        )

    def _get_tables(self, msg) -> pa.Table:
        ns_pat = msg.db_schema_filter_pattern or None
        tb_pat = msg.table_name_filter_pattern or None
        rows = {"catalog_name": [], "db_schema_name": [], "table_name": [],
                "table_type": []}
        schemas: list[bytes] = []
        for ns in self.catalog.list_namespaces():
            if not self._like_match(ns_pat, ns):
                continue
            for name in self.catalog.list_tables(ns):
                if not self._like_match(tb_pat, name):
                    continue
                rows["catalog_name"].append("lakesoul")
                rows["db_schema_name"].append(ns)
                rows["table_name"].append(name)
                rows["table_type"].append("TABLE")
                if msg.include_schema:
                    schemas.append(
                        self.catalog.table(name, ns).schema.serialize().to_pybytes()
                    )
        schema = self._TABLES_SCHEMA
        arrays = [pa.array(rows[f.name], f.type) for f in schema]
        if msg.include_schema:
            schema = schema.append(
                pa.field("table_schema", pa.binary(), nullable=False)
            )
            arrays.append(pa.array(schemas, pa.binary()))
        return pa.Table.from_arrays(arrays, schema=schema)

    def _get_table_types(self) -> pa.Table:
        return pa.table(
            {"table_type": pa.array(["TABLE"], pa.utf8())},
            schema=pa.schema([pa.field("table_type", pa.utf8(), nullable=False)]),
        )

    def _get_primary_keys(self, msg) -> pa.Table:
        ns = msg.db_schema or "default"
        info = self.catalog.table(msg.table, ns).info
        rows = {
            "catalog_name": ["lakesoul"] * len(info.primary_keys),
            "db_schema_name": [ns] * len(info.primary_keys),
            "table_name": [msg.table] * len(info.primary_keys),
            "column_name": list(info.primary_keys),
            "key_name": [None] * len(info.primary_keys),
            "key_sequence": list(range(1, len(info.primary_keys) + 1)),
        }
        return pa.Table.from_arrays(
            [pa.array(rows[f.name], f.type) for f in self._PK_SCHEMA],
            schema=self._PK_SCHEMA,
        )

    # SqlInfo ids from the public spec (FLIGHT_SQL_SERVER_* block).  Python
    # ints ride the bigint branch of the union: id 8 is the int32
    # SqlSupportedTransaction ENUM per spec, not a bool — strict ADBC/JDBC
    # drivers read the union child by declared type
    _SQL_INFO = {
        0: "lakesoul_tpu",      # FLIGHT_SQL_SERVER_NAME
        1: "5.0",               # FLIGHT_SQL_SERVER_VERSION
        2: pa.__version__,      # FLIGHT_SQL_SERVER_ARROW_VERSION
        3: False,               # FLIGHT_SQL_SERVER_READ_ONLY
        8: 1,                   # FLIGHT_SQL_SERVER_TRANSACTION
                                #   = SQL_SUPPORTED_TRANSACTION_TRANSACTION
    }

    def _get_sql_info(self, msg) -> pa.Table:
        wanted = list(msg.info) or sorted(self._SQL_INFO)
        items = [(i, self._SQL_INFO[i]) for i in wanted if i in self._SQL_INFO]
        # spec value type: dense_union<string_value: utf8=0, bool_value: bool=1,
        # bigint_value: int64=2, int32_bitmask: int32=3, string_list:
        # list<utf8>=4, int32_to_int32_list_map: map<int32, list<int32>>=5>
        strings, bools, bigints = [], [], []
        type_ids, offsets = [], []
        for _, v in items:
            if isinstance(v, bool):
                type_ids.append(1)
                offsets.append(len(bools))
                bools.append(v)
            elif isinstance(v, int):
                type_ids.append(2)
                offsets.append(len(bigints))
                bigints.append(v)
            else:
                type_ids.append(0)
                offsets.append(len(strings))
                strings.append(str(v))
        children = [
            pa.array(strings, pa.utf8()),
            pa.array(bools, pa.bool_()),
            pa.array(bigints, pa.int64()),
            pa.array([], pa.int32()),
            pa.array([], pa.list_(pa.utf8())),
            pa.array([], pa.map_(pa.int32(), pa.list_(pa.int32()))),
        ]
        value = pa.UnionArray.from_dense(
            pa.array(type_ids, pa.int8()),
            pa.array(offsets, pa.int32()),
            children,
            [
                "string_value", "bool_value", "bigint_value", "int32_bitmask",
                "string_list", "int32_to_int32_list_map",
            ],
        )
        name = pa.array([i for i, _ in items], pa.uint32())
        return pa.Table.from_arrays(
            [name, value],
            schema=pa.schema(
                [pa.field("info_name", pa.uint32(), nullable=False),
                 pa.field("value", value.type, nullable=False)]
            ),
        )

    def _metadata_result(self, name: str, msg) -> pa.Table:
        if name == "CommandGetCatalogs":
            return self._get_catalogs()
        if name == "CommandGetDbSchemas":
            return self._get_db_schemas(msg)
        if name == "CommandGetTables":
            return self._get_tables(msg)
        if name == "CommandGetTableTypes":
            return self._get_table_types()
        if name == "CommandGetPrimaryKeys":
            return self._get_primary_keys(msg)
        if name == "CommandGetSqlInfo":
            return self._get_sql_info(msg)
        raise flight.FlightServerError(f"unsupported Flight SQL command {name}")

    def _get_prepared(self, handle: bytes) -> _PreparedStatement:
        now = time.monotonic()
        with self._stmt_lock:
            expired = [h for h, p in self._prepared.items() if p.expires < now]
            for h in expired:
                del self._prepared[h]
            ps = self._prepared.get(handle)
        if ps is None:
            raise flight.FlightServerError("unknown prepared statement handle")
        return ps.touch()

    # --------------------------------------------------------- RPC overrides
    def _descriptor_result(self, context, name, msg) -> pa.Table:
        """Execute whatever an Any-wrapped Flight SQL descriptor denotes."""
        if name == "CommandStatementQuery":
            return self._execute_sql(context, msg.query)
        if name == "CommandPreparedStatementQuery":
            ps = self._get_prepared(msg.prepared_statement_handle)
            query = ps.query
            if ps.params:
                if len(ps.params) != 1:
                    raise flight.FlightServerError(
                        "query execution binds exactly one parameter row"
                    )
                query = bind_parameters(query, None, ps.params[0])
            return self._execute_sql(context, query)
        return self._metadata_result(name, msg)

    def get_flight_info(self, context, descriptor):
        name, msg = (None, None)
        if descriptor.command:
            name, msg = _unpack(descriptor.command)
        if name is None:
            return super().get_flight_info(context, descriptor)
        with self._span(context, "flightsql.get_flight_info", command=name):
            return self._result_info(
                descriptor, self._descriptor_result(context, name, msg)
            )

    def get_schema(self, context, descriptor):
        name, msg = (None, None)
        if descriptor.command:
            name, msg = _unpack(descriptor.command)
        if name is None:
            info = super().get_flight_info(context, descriptor)
            return flight.SchemaResult(info.schema)
        # derive the schema WITHOUT caching a one-shot ticket: a GetSchema
        # burst must not evict other sessions' live statement handles
        result = self._descriptor_result(context, name, msg)
        return flight.SchemaResult(result.schema)

    def _do_get(self, context, ticket):
        # admission is taken once by the base do_get; this is the ungated body
        name, msg = _unpack(ticket.ticket)
        if name is None:
            return super()._do_get(context, ticket)
        with self._span(context, "flightsql.do_get", command=name):
            if name == "TicketStatementQuery":
                result = self._take_result(msg.statement_handle)
            elif name == "CommandStatementQuery":
                # liberal servers accept the command directly as a ticket
                result = self._execute_sql(context, msg.query)
            else:
                result = self._metadata_result(name, msg)
            self.metrics.add(
                total_get_streams=1, rows_out=result.num_rows
            )
            return flight.RecordBatchStream(result)

    def _do_put(self, context, descriptor, reader, writer):
        name, msg = (None, None)
        if descriptor.command:
            name, msg = _unpack(descriptor.command)
        if name is None:
            return super()._do_put(context, descriptor, reader, writer)
        with self._span(context, "flightsql.do_put", command=name):
            return self._do_put_sql(context, name, msg, reader, writer)

    def _do_put_sql(self, context, name, msg, reader, writer):
        if name == "CommandStatementUpdate":
            n = self._run_update(context, msg.query)
            self._write_update_result(writer, n)
            return
        if name == "CommandPreparedStatementQuery":
            ps = self._get_prepared(msg.prepared_statement_handle)
            ps.params = self._check_param_arity(ps, self._read_param_rows(reader))
            return
        if name == "CommandPreparedStatementUpdate":
            ps = self._get_prepared(msg.prepared_statement_handle)
            rows = self._check_param_arity(ps, self._read_param_rows(reader))
            total = 0
            if rows:
                for values in rows:
                    total += self._run_update(
                        context, bind_parameters(ps.query, None, values)
                    )
            else:
                total = self._run_update(context, ps.query)
            self._write_update_result(writer, total)
            return
        if name == "CommandStatementIngest":
            n = self._ingest(context, msg, reader)
            self._write_update_result(writer, n)
            return
        raise flight.FlightServerError(f"unsupported DoPut command {name}")

    @staticmethod
    def _write_update_result(writer, record_count: int) -> None:
        writer.write(
            pa.py_buffer(
                pb.DoPutUpdateResult(record_count=record_count).SerializeToString()
            )
        )

    @staticmethod
    def _check_param_arity(ps: _PreparedStatement, rows: list[list]) -> list[list]:
        """Reject a parameter bind whose width differs from the statement's
        placeholder count AT BIND TIME (the spec error point), instead of
        surfacing a confusing failure at execution."""
        for values in rows:
            if len(values) != ps.param_count:
                raise flight.FlightServerError(
                    f"statement has {ps.param_count} parameter(s) but"
                    f" {len(values)} were bound"
                )
        return rows

    @staticmethod
    def _read_param_rows(reader) -> list[list]:
        rows: list[list] = []
        for chunk in reader:
            batch = chunk.data
            if batch is None or not len(batch):
                continue
            cols = [c.to_pylist() for c in batch.columns]
            rows.extend([list(vals) for vals in zip(*cols)])
        return rows

    def _run_update(self, context, query: str) -> int:
        result = self._execute_sql(context, query)
        # the SQL layer reports DML row counts as a one-row result table
        if result.num_rows == 1 and result.num_columns >= 1:
            col = result.column(0)
            try:
                return int(col[0].as_py())
            except (TypeError, ValueError):
                return 0
        return 0

    def _ingest(self, context, msg, reader) -> int:
        opts = msg.table_definition_options
        ns = msg.schema or "default"
        name = msg.table
        # resolve the transaction BEFORE any side effect: an ingest
        # replaying a CLOSED transaction id must error without first
        # creating the target table
        txn = (
            self._get_transaction(bytes(msg.transaction_id))
            if msg.transaction_id else None
        )
        exists = name in self.catalog.list_tables(ns)
        replace = False
        if not exists:
            if opts.if_not_exist == pb.CommandStatementIngest.TableDefinitionOptions.TABLE_NOT_EXIST_OPTION_FAIL:
                raise flight.FlightServerError(f"table {ns}.{name} does not exist")
            pk = [c for c in (msg.options.get("primary_keys") or "").split(",") if c]
            # pre-create there is no table domain to check (creation is
            # open to any authenticated principal); the post-create _check
            # gates the ingest into what now exists, so a creation racing
            # into a foreign domain fails closed before any rows stage
            self.catalog.create_table(  # lakelint: ignore[rbac-gate-reachability] no domain exists pre-create; the _check on the next line gates the created table before any write
                name, reader.schema, namespace=ns, primary_keys=pk or None
            )
            try:
                self._check(context, ns, name)
            except flight.FlightUnauthorizedError:
                # roll the registration back: an unauthorized caller must
                # not squat the table name with an empty shell
                self.catalog.drop_table(name, ns)  # lakelint: ignore[rbac-gate-reachability] rollback of the caller's own just-created empty shell after the check DENIED — deleting it IS the enforcement
                raise
        else:
            self._check(context, ns, name)
            if opts.if_exists == pb.CommandStatementIngest.TableDefinitionOptions.TABLE_EXISTS_OPTION_FAIL:
                raise flight.FlightServerError(f"table {ns}.{name} already exists")
            # REPLACE keeps the table itself (same table_id, so primary
            # keys, range partitions, bucket count, CDC column and the
            # exactly-once replay dedup all survive): the stream is staged
            # as files first, then ONE UPDATE commit swaps the content in —
            # a disconnect mid-stream leaves the old data fully visible
            replace = (
                opts.if_exists
                == pb.CommandStatementIngest.TableDefinitionOptions.TABLE_EXISTS_OPTION_REPLACE
            )
        table = self.catalog.table(name, ns)
        from lakesoul_tpu_torch.streaming import CheckpointedWriter

        if txn is not None:
            # open server transaction: stage only — EndTransaction COMMIT
            # publishes, ROLLBACK deletes the staged files.  Table CREATION
            # (above) is non-transactional, like implicit-commit DDL in
            # most databases: a rollback keeps the (empty) table.
            return self._ingest_into_transaction(
                txn, (ns, name), table, reader, replace
            )
        w = CheckpointedWriter(table)
        rows = 0
        nbytes = 0
        self.metrics.add(active_put_streams=1, total_put_streams=1)
        try:
            try:
                for chunk in reader:
                    batch = chunk.data
                    if batch is not None and len(batch):
                        rows += len(batch)
                        nbytes += batch.nbytes
                        w.write(pa.table(batch))
            except Exception:
                # incomplete stream: drop staged files, commit nothing
                w.abort()
                raise
            # exactly-once: replaying the same transaction id is a no-op
            txn = msg.transaction_id.hex() if msg.transaction_id else uuid.uuid4().hex
            if replace:
                w.checkpoint_replace(txn)
            else:
                w.checkpoint(txn)
            self.metrics.add(rows_in=rows, bytes_in=nbytes)
        except LakeSoulError as e:
            raise flight.FlightServerError(str(e))
        finally:
            self.metrics.add(active_put_streams=-1)
        return rows

    def _ingest_into_transaction(self, txn: _Transaction, key, table, reader,
                                 replace: bool) -> int:
        from lakesoul_tpu_torch.streaming import CheckpointedWriter

        rows = 0
        nbytes = 0
        self.metrics.add(active_put_streams=1, total_put_streams=1)
        try:
            # streams of one transaction serialize: they share its writers
            with txn.lock:
                if txn.closed:
                    # the txn ended between our registry lookup and here —
                    # staging now would silently lose the rows
                    raise flight.FlightServerError(
                        "transaction has already ended or expired"
                    )
                w = txn.writers.get(key)
                if w is None:
                    w = txn.writers[key] = CheckpointedWriter(table)
                if replace:
                    txn.replace.add(key)
                try:
                    for chunk in reader:
                        batch = chunk.data
                        if batch is not None and len(batch):
                            rows += len(batch)
                            nbytes += batch.nbytes
                            w.write(pa.table(batch))
                except Exception:
                    # half a stream is in the staged writer and cannot be
                    # torn back out: poison the transaction so COMMIT refuses
                    txn.failed = True
                    raise
                if txn.closed:
                    # evicted while this stream held the lock (the evictor
                    # could not wait): clean up our own staged files
                    txn.abort()
                    raise flight.FlightServerError(
                        "transaction expired during ingest"
                    )
            self.metrics.add(rows_in=rows, bytes_in=nbytes)
        except LakeSoulError as e:
            raise flight.FlightServerError(str(e))
        finally:
            self.metrics.add(active_put_streams=-1)
        return rows

    # --------------------------------------------------------------- actions
    def _do_action(self, context, action):
        if action.type == "BeginTransaction":
            return self._begin_transaction()
        if action.type == "EndTransaction":
            _, msg = _unpack(action.body.to_pybytes())
            if msg is None:
                raise flight.FlightServerError(
                    "EndTransaction body must be an Any-wrapped request"
                )
            return self._end_transaction(msg)
        if action.type == "CreatePreparedStatement":
            _, msg = _unpack(action.body.to_pybytes())
            if msg is None:
                raise flight.FlightServerError(
                    "CreatePreparedStatement body must be an Any-wrapped request"
                )
            return self._create_prepared(context, msg)
        if action.type == "ClosePreparedStatement":
            _, msg = _unpack(action.body.to_pybytes())
            if msg is not None:
                self._prepared.pop(msg.prepared_statement_handle, None)
            return []
        return super()._do_action(context, action)

    def _create_prepared(self, context, msg):
        from lakesoul_tpu_torch.sql.parser import Select, SqlError, parse as parse_sql

        dataset_schema: pa.Schema | None = None
        if "?" not in msg.query:
            # the dialect has no `?` token: parameterized statements skip
            # validation until execution (post-binding); plain SELECTs are
            # validated now and executed once to derive the result schema
            # (DML reports it empty — clients learn it from execution)
            try:
                stmt = parse_sql(msg.query)
            except SqlError as e:
                raise flight.FlightServerError(str(e))
            if isinstance(stmt, Select):
                dataset_schema = self._execute_sql(context, msg.query).schema
        handle = uuid.uuid4().bytes
        now = time.monotonic()
        with self._stmt_lock:
            expired = [h for h, p in self._prepared.items() if p.expires < now]
            for h in expired:
                del self._prepared[h]
            while len(self._prepared) >= _PREPARED_CAP:
                self._prepared.pop(next(iter(self._prepared)))
            self._prepared[handle] = _PreparedStatement(msg.query, dataset_schema)
        result = pb.ActionCreatePreparedStatementResult(
            prepared_statement_handle=handle,
            dataset_schema=(
                dataset_schema.serialize().to_pybytes() if dataset_schema else b""
            ),
            parameter_schema=b"",
        )
        return [flight.Result(_pack(result))]

    def list_actions(self, context):
        return list(super().list_actions(context)) + [
            ("CreatePreparedStatement", "Flight SQL: create a prepared statement"),
            ("ClosePreparedStatement", "Flight SQL: close a prepared statement"),
            ("BeginTransaction", "Flight SQL: begin a server transaction"),
            ("EndTransaction", "Flight SQL: commit or roll back a transaction"),
        ]


class FlightSqlClient:
    """Minimal Flight SQL client speaking the standard protocol — what an
    ADBC/JDBC driver puts on the wire, usable anywhere pyarrow is (the image
    carries no ADBC driver; protocol-level parity is proven in tests)."""

    def __init__(self, location: str, *, token: str | None = None,
                 basic_auth: tuple[str, str] | None = None):
        import base64

        self._client = flight.FlightClient(location)
        self._options = None
        if token:
            self._options = flight.FlightCallOptions(
                headers=[(b"authorization", f"Bearer {token}".encode())]
            )
        elif basic_auth is not None:
            cred = base64.b64encode(
                f"{basic_auth[0]}:{basic_auth[1]}".encode()
            ).decode()
            self._options = flight.FlightCallOptions(
                headers=[(b"authorization", f"Basic {cred}".encode())]
            )

    def _info_to_table(self, info: flight.FlightInfo) -> pa.Table:
        parts = []
        for ep in info.endpoints:
            parts.append(
                self._client.do_get(ep.ticket, options=self._options).read_all()
            )
        return pa.concat_tables(parts) if parts else None

    def execute(self, query: str) -> pa.Table:
        desc = flight.FlightDescriptor.for_command(
            _pack(pb.CommandStatementQuery(query=query))
        )
        return self._info_to_table(
            self._client.get_flight_info(desc, options=self._options)
        )

    def execute_update(self, query: str) -> int:
        desc = flight.FlightDescriptor.for_command(
            _pack(pb.CommandStatementUpdate(query=query))
        )
        writer, reader = self._client.do_put(
            desc, pa.schema([]), options=self._options
        )
        writer.done_writing()
        buf = reader.read()
        writer.close()
        if buf is None:
            return 0
        return pb.DoPutUpdateResult.FromString(buf.to_pybytes()).record_count

    def ingest(self, table_name: str, data: pa.Table, *, db_schema: str = "default",
               mode: str = "append", transaction_id: bytes | None = None,
               primary_keys: list[str] | None = None) -> int:
        tdo = pb.CommandStatementIngest.TableDefinitionOptions(
            if_not_exist=pb.CommandStatementIngest.TableDefinitionOptions.TABLE_NOT_EXIST_OPTION_CREATE,
            if_exists={
                "append": pb.CommandStatementIngest.TableDefinitionOptions.TABLE_EXISTS_OPTION_APPEND,
                "replace": pb.CommandStatementIngest.TableDefinitionOptions.TABLE_EXISTS_OPTION_REPLACE,
                "fail": pb.CommandStatementIngest.TableDefinitionOptions.TABLE_EXISTS_OPTION_FAIL,
            }[mode],
        )
        cmd = pb.CommandStatementIngest(
            table_definition_options=tdo, table=table_name, schema=db_schema
        )
        if transaction_id is not None:
            cmd.transaction_id = transaction_id
        if primary_keys:
            cmd.options["primary_keys"] = ",".join(primary_keys)
        desc = flight.FlightDescriptor.for_command(_pack(cmd))
        writer, reader = self._client.do_put(desc, data.schema, options=self._options)
        for batch in data.to_batches():
            writer.write_batch(batch)
        writer.done_writing()
        buf = reader.read()
        writer.close()
        if buf is None:
            return 0
        return pb.DoPutUpdateResult.FromString(buf.to_pybytes()).record_count

    # --------------------------------------------------------- transactions
    def begin_transaction(self) -> bytes:
        """What an ADBC driver sends on connect with ``autocommit=False``."""
        action = flight.Action(
            "BeginTransaction", _pack(pb.ActionBeginTransactionRequest())
        )
        results = list(self._client.do_action(action, options=self._options))
        _, msg = _unpack(results[0].body.to_pybytes())
        return msg.transaction_id

    def _end_transaction(self, txn_id: bytes, end_action) -> None:
        action = flight.Action(
            "EndTransaction",
            _pack(pb.ActionEndTransactionRequest(
                transaction_id=txn_id, action=end_action
            )),
        )
        list(self._client.do_action(action, options=self._options))

    def commit(self, txn_id: bytes) -> None:
        self._end_transaction(
            txn_id, pb.ActionEndTransactionRequest.END_TRANSACTION_COMMIT
        )

    def rollback(self, txn_id: bytes) -> None:
        self._end_transaction(
            txn_id, pb.ActionEndTransactionRequest.END_TRANSACTION_ROLLBACK
        )

    # ------------------------------------------------------------- prepared
    def prepare(self, query: str) -> bytes:
        action = flight.Action(
            "CreatePreparedStatement",
            _pack(pb.ActionCreatePreparedStatementRequest(query=query)),
        )
        results = list(self._client.do_action(action, options=self._options))
        _, msg = _unpack(results[0].body.to_pybytes())
        return msg.prepared_statement_handle

    def execute_prepared(self, handle: bytes, params: list | None = None) -> pa.Table:
        if params is not None:
            desc = flight.FlightDescriptor.for_command(
                _pack(pb.CommandPreparedStatementQuery(prepared_statement_handle=handle))
            )
            batch = pa.record_batch(
                [pa.array([p]) for p in params],
                names=[f"p{i}" for i in range(len(params))],
            )
            writer, _ = self._client.do_put(desc, batch.schema, options=self._options)
            writer.write_batch(batch)
            writer.close()
        desc = flight.FlightDescriptor.for_command(
            _pack(pb.CommandPreparedStatementQuery(prepared_statement_handle=handle))
        )
        return self._info_to_table(
            self._client.get_flight_info(desc, options=self._options)
        )

    def close_prepared(self, handle: bytes) -> None:
        action = flight.Action(
            "ClosePreparedStatement",
            _pack(pb.ActionClosePreparedStatementRequest(prepared_statement_handle=handle)),
        )
        list(self._client.do_action(action, options=self._options))

    # ------------------------------------------------------------- metadata
    def _metadata(self, cmd) -> pa.Table:
        desc = flight.FlightDescriptor.for_command(_pack(cmd))
        return self._info_to_table(
            self._client.get_flight_info(desc, options=self._options)
        )

    def get_catalogs(self) -> pa.Table:
        return self._metadata(pb.CommandGetCatalogs())

    def get_db_schemas(self, pattern: str | None = None) -> pa.Table:
        msg = pb.CommandGetDbSchemas()
        if pattern is not None:
            msg.db_schema_filter_pattern = pattern
        return self._metadata(msg)

    def get_tables(self, *, table_pattern: str | None = None,
                   include_schema: bool = False) -> pa.Table:
        msg = pb.CommandGetTables(include_schema=include_schema)
        if table_pattern is not None:
            msg.table_name_filter_pattern = table_pattern
        return self._metadata(msg)

    def get_table_types(self) -> pa.Table:
        return self._metadata(pb.CommandGetTableTypes())

    def get_primary_keys(self, table: str, db_schema: str = "default") -> pa.Table:
        return self._metadata(pb.CommandGetPrimaryKeys(table=table, db_schema=db_schema))

    def get_sql_info(self, ids: list[int] | None = None) -> pa.Table:
        return self._metadata(pb.CommandGetSqlInfo(info=ids or []))

    def close(self) -> None:
        self._client.close()


def _serve_prometheus(metrics, port: int, host: str = "0.0.0.0"):
    """Prometheus exposition endpoint — THE single implementation lives in
    obs/exporter.py; this alias keeps the historical entry point."""
    from lakesoul_tpu_torch.obs import serve_prometheus

    return serve_prometheus(metrics, port, host)


def main(argv=None) -> int:
    """`lakesoul-flight-sql-server` — the reference's flight_sql_server
    binary (bin/flight_sql_server.rs:22): serve a warehouse over the
    standard Flight SQL protocol, optionally with JWT auth and a
    Prometheus /metrics endpoint."""
    import argparse
    import os

    p = argparse.ArgumentParser(
        "lakesoul-flight-sql-server",
        description="Arrow Flight SQL gateway over a lakesoul_tpu warehouse",
    )
    p.add_argument("--warehouse", required=True, help="warehouse root (any fsspec path)")
    p.add_argument("--db-path", default=None, help="metadata SQLite path (default: in-warehouse)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument(
        "--jwt-secret",
        default=os.environ.get("LAKESOUL_JWT_SECRET"),
        help="enable auth (env LAKESOUL_JWT_SECRET); omit for open access",
    )
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus metrics on this HTTP port")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where vector_search and CALL build_vector_index run"
                        " (cuda raises without a card)")
    args = p.parse_args(argv)

    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.device import resolve_device
    from lakesoul_tpu_torch.obs import configure_logging, registry

    resolve_device(args.device)  # no card: ConfigError, never the CPU in its place
    configure_logging()  # LAKESOUL_LOG_FORMAT=json selects structured logs
    catalog = LakeSoulCatalog(args.warehouse, db_path=args.db_path)
    server = LakeSoulFlightSqlServer(
        catalog, f"grpc://{args.host}:{args.port}", jwt_secret=args.jwt_secret,
        device=args.device,
    )
    metrics_srv = None
    if args.metrics_port:
        # metrics bind the SAME interface as the gateway: --host 127.0.0.1
        # must not leave /metrics world-reachable.  The endpoint serves the
        # WHOLE registry: stream, cache, executor, meta, compaction, loader
        metrics_srv = _serve_prometheus(registry(), args.metrics_port, args.host)
        print(f"metrics on http://{args.host}:{args.metrics_port}/metrics", flush=True)
    print(
        f"Flight SQL server on grpc://{args.host}:{server.port}"
        f" (auth={'jwt' if args.jwt_secret else 'open'})",
        flush=True,
    )
    try:
        server.serve()
    except KeyboardInterrupt:  # SIGINT: release the held index shards and exit 0
        server.shutdown()
    finally:
        if metrics_srv is not None:
            metrics_srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
