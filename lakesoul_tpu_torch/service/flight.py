"""Arrow Flight gateway (the port's copy of ``lakesoul_tpu/service/flight.py``).

Role parity with the reference's Flight SQL server
(rust/lakesoul-flight/src/flight_sql_service.rs:194): JWT-authenticated
clients stream table scans out (DoGet), ingest Arrow streams transactionally
(DoPut with exactly-once checkpoint ids), list tables, and run management
actions — over pyarrow.flight instead of tonic/gRPC-rust.

Tickets and descriptors are JSON:
  DoGet ticket: {"table": ..., "namespace": ..., "columns": [...],
                 "filter": <Filter JSON — op "substrait" carries base64
                 Substrait ExtendedExpression bytes, the format external
                 engines serialize predicates in>, "partitions": {...},
                 "incremental_start_ms": ..., "batch_size": ...}
  DoPut descriptor path: ["<namespace>.<table>"] with app_metadata
                 {"checkpoint_id": ...} for idempotent streaming commits.

Metrics parity with StreamWriteMetrics (flight_sql_service.rs:90): active and
total streams, rows and bytes in/out, exposed via the ``metrics`` action and
aggregated into the shared obs registry.  A client-supplied ``x-trace-id``
header pins server spans/logs to the caller's trace (and echoes back in the
response headers).

Tickets, descriptors, actions and the ``scan_stream`` exchange messages are
the reference's byte for byte, so a client of either package talks to a
gateway of either package.  Where the port runs on a device — the table
index behind ``vector_search`` and a ``CALL build_vector_index`` statement —
the server's ``device`` decides (``None`` = the CUDA card, ``"cpu"`` only
when asked); ``ann_search`` serves whatever plane the caller bound, on the
device that plane was opened on.  ``vector_search`` searches through one
``TableVectorIndex`` the server holds on its device: a shard is read when
its ``LATEST`` generation changes (a rebuild is seen on the next search),
not on every request, and the held shards are released at ``shutdown``."""

from __future__ import annotations

import base64
import contextlib
import json
import threading

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from lakesoul_tpu_torch.errors import LakeSoulError, OverloadedError, RBACError
from lakesoul_tpu_torch.io.filters import Filter
from lakesoul_tpu_torch.obs import StreamMetrics, sanitize_trace_id, span
from lakesoul_tpu_torch.runtime.resilience import AdmissionController
from lakesoul_tpu_torch.service.jwt import Claims, JwtServer, UserRegistry
from lakesoul_tpu_torch.service.rbac import RbacVerifier

TRACE_HEADER = "x-trace-id"


class _TraceMiddlewareFactory(flight.ServerMiddlewareFactory):
    def start_call(self, info, headers):
        raw = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.title())
        return _TraceMiddleware(sanitize_trace_id(raw[0] if raw else None))


class _TraceMiddleware(flight.ServerMiddleware):
    def __init__(self, trace_id: str | None):
        self.trace_id = trace_id

    def sending_headers(self):
        if self.trace_id:
            return {TRACE_HEADER: self.trace_id}
        return {}


class _AuthMiddlewareFactory(flight.ServerMiddlewareFactory):
    # successful Basic verifications are cached briefly: PBKDF2 is slow BY
    # DESIGN (~0.2s), and clients are expected to call `login` once — but a
    # client that keeps sending Basic headers must not pay (or inflict) a
    # KDF + registry read per RPC
    _BASIC_CACHE_TTL = 60.0

    def __init__(self, jwt_server: JwtServer | None, user_registry=None):
        self.jwt_server = jwt_server
        self.user_registry = user_registry
        self._basic_cache: dict[str, tuple[float, str, str]] = {}
        self._basic_lock = threading.Lock()

    def _verify_basic(self, header: str):
        import time as _time

        now = _time.monotonic()
        with self._basic_lock:
            hit = self._basic_cache.get(header)
            if hit is not None and hit[0] > now:
                return hit[1], hit[2]
        try:
            user, _, password = base64.b64decode(header[6:]).decode().partition(":")
            claims = self.user_registry.verify(user, password)
        except (RBACError, ValueError, UnicodeDecodeError) as e:
            raise flight.FlightUnauthenticatedError(str(e))
        with self._basic_lock:
            self._basic_cache[header] = (
                now + self._BASIC_CACHE_TTL, claims.sub, claims.group,
            )
            if len(self._basic_cache) > 1024:  # bound the credential cache
                self._basic_cache.clear()
        return claims.sub, claims.group

    def start_call(self, info, headers):
        if self.jwt_server is None:
            return _AuthMiddleware("anonymous", "public")
        auth = headers.get("authorization") or headers.get("Authorization")
        if not auth:
            raise flight.FlightUnauthenticatedError("missing authorization header")
        token = auth[0]
        if token.lower().startswith("basic ") and self.user_registry is not None:
            # handshake role: user/password authenticates this call; a fresh
            # bearer rides back in the response headers so standard clients
            # (`authenticate_basic_token`, ADBC) switch to it — the `login`
            # action remains for explicit TTL control
            user, group = self._verify_basic(token)
            bearer = self.jwt_server.create_token(Claims(sub=user, group=group))
            return _AuthMiddleware(user, group, bearer=bearer)
        if token.lower().startswith("bearer "):
            token = token[7:]
        try:
            claims = self.jwt_server.decode_token(token)
        except RBACError as e:
            raise flight.FlightUnauthenticatedError(str(e))
        return _AuthMiddleware(claims.sub, claims.group)


class _AuthMiddleware(flight.ServerMiddleware):
    def __init__(self, user: str, group: str, bearer: str | None = None):
        self.user = user
        self.group = group
        self.bearer = bearer

    def sending_headers(self):
        if self.bearer is not None:
            return {"authorization": f"Bearer {self.bearer}"}
        return {}


class _StreamSlot:
    """Admission-slot ownership token for a lazily-delivered stream.

    ``do_get`` acquires the slot, but the expensive work of the JSON scan
    path runs inside the ``GeneratorStream`` AFTER the handler returns — so
    releasing on return would let any number of streams decode concurrently
    and the admission bound would cover only the cheap planning prefix.
    Instead the handler calls :meth:`transfer` as it hands the lazy stream
    back and the stream's generator calls :meth:`release` when delivery
    finishes (or the client disconnects); eager handlers (flight_sql's
    materialized results) never transfer and ``do_get`` releases on return.
    ``release`` is idempotent — the generator and any error path may both
    reach it."""

    def __init__(self, admission):
        self._admission = admission
        self._guard = threading.Lock()
        self._released = False
        self.transferred = False

    def transfer(self) -> None:
        self.transferred = True

    def release(self) -> None:
        with self._guard:
            if self._released:
                return
            self._released = True
        self._admission.release()

    def __del__(self):
        # backstop: a transferred slot whose stream was dropped before the
        # generator ever STARTED (client vanished pre-first-batch) has no
        # finally to run — free the slot when the stream is collected
        if self.transferred:
            try:
                self.release()
            except Exception:
                pass


class LakeSoulFlightServer(flight.FlightServerBase):
    def __init__(
        self,
        catalog,
        location: str = "grpc://127.0.0.1:0",
        *,
        jwt_secret: str | None = None,
        max_inflight: int | None = None,
        max_queue: int | None = None,
        scanplane=None,
        ann_planes: dict | None = None,
        device=None,
    ):
        self.catalog = catalog
        # where vector_search searches the table index and SQL builds one
        # (None = the CUDA card, raising without one); the opened index
        # shards are held across requests, searches one at a time
        self.device = device
        self._vector_index = None
        self._vector_lock = threading.Lock()
        # scan-plane delivery (DoExchange "scan_stream"): a configured
        # ScanPlaneDelivery serves worker-produced spool segments (with the
        # same-host shm fast path); None = lazily-built inline delivery, so
        # a plain gateway still serves remote scans with zero fleet setup
        self.scanplane = scanplane
        # sharded ANN serving (action "ann_search"): plane name →
        # AnnPlaneBinding(endpoint, namespace, table); requests RBAC-check
        # against the indexed table and ride the endpoint's ragged
        # micro-batching behind the same admission gate as every action
        self.ann_planes = dict(ann_planes or {})
        self.jwt_server = JwtServer(jwt_secret) if jwt_secret else None
        self.user_registry = UserRegistry(catalog.client)
        self.rbac = RbacVerifier(catalog.client)
        self.metrics = StreamMetrics()
        # bounded in-flight + queue for EVERY data-plane handler
        # (do_get/do_put/do_action): beyond both bounds clients get Flight
        # UNAVAILABLE instead of an unbounded server-side backlog
        # (LAKESOUL_ADMISSION_MAX_INFLIGHT / _MAX_QUEUE when args None)
        self.admission = AdmissionController(
            "flight", max_inflight=max_inflight, max_queue=max_queue
        )
        # per-handler-thread slot token: do_get hands its admission slot to
        # the lazy stream it returns (see _StreamSlot)
        self._stream_slots = threading.local()
        super().__init__(
            location,
            middleware={
                "auth": _AuthMiddlewareFactory(self.jwt_server, self.user_registry),
                "trace": _TraceMiddlewareFactory(),
            },
        )

    # ------------------------------------------------------------- admission
    def _current_stream_slot(self):
        return getattr(self._stream_slots, "current", None)

    @contextlib.contextmanager
    def _admitted(self):
        """Admission-gate a handler: a typed shed (OverloadedError) becomes
        Flight UNAVAILABLE so well-behaved clients back off and retry."""
        try:
            self.admission.acquire()
        except OverloadedError as e:
            raise flight.FlightUnavailableError(str(e)) from e
        try:
            yield
        finally:
            self.admission.release()

    # ----------------------------------------------------------------- trace
    def _span(self, context, name: str, **attrs):
        """A server span pinned to the caller's x-trace-id when supplied."""
        trace_id = None
        mw = context.get_middleware("trace")
        if mw is not None:
            trace_id = mw.trace_id
        return span(name, trace_id=trace_id, **attrs)

    # ------------------------------------------------------------------ auth
    def _identity(self, context) -> tuple[str, str]:
        mw = context.get_middleware("auth")
        if mw is None:
            return "anonymous", "public"
        return mw.user, mw.group

    def _check(self, context, namespace: str, table: str) -> None:
        user, group = self._identity(context)
        try:
            self.rbac.check(user, group, namespace, table)
        except RBACError as e:
            raise flight.FlightUnauthorizedError(str(e))

    def _check_statement(self, context, namespace: str, stmt) -> None:
        """Per-statement RBAC: every referenced table, PLUS an explicit
        warehouse-wide gate for ``CALL clean()`` — its empty
        ``referenced_tables`` set must not silently skip RBAC, because
        clean destroys data under EVERY table."""
        from lakesoul_tpu_torch.sql.parser import Call, referenced_tables

        if isinstance(stmt, Call) and stmt.procedure == "clean":
            self._check_warehouse_wide(context)
        for target in sorted(referenced_tables(stmt)):
            self._check(context, namespace, target)

    def _check_warehouse_wide(self, context) -> None:
        """Wildcard permission: the caller's domain must grant access to
        EVERY table in the warehouse (an admin-shaped check — one
        unreachable table vetoes the warehouse-wide destructive op)."""
        user, group = self._identity(context)
        for ns in self.catalog.list_namespaces():
            for name in self.catalog.list_tables(ns):
                if not self.rbac.verify_permission_by_table_name(
                    user, group, ns, name
                ):
                    raise flight.FlightUnauthorizedError(
                        f"CALL clean() is warehouse-wide: user {user} (group"
                        f" {group}) lacks access to {ns}.{name}"
                    )

    # ----------------------------------------------------------------- lists
    def list_flights(self, context, criteria):
        for ns in self.catalog.list_namespaces():
            for name in self.catalog.list_tables(ns):
                table = self.catalog.table(name, ns)
                desc = flight.FlightDescriptor.for_path(f"{ns}.{name}")
                yield flight.FlightInfo(
                    table.schema, desc, [], -1, -1
                )

    def get_flight_info(self, context, descriptor):
        ns, name = self._parse_descriptor(descriptor)
        self._check(context, ns, name)
        table = self.catalog.table(name, ns)
        ticket = flight.Ticket(json.dumps({"table": name, "namespace": ns}).encode())
        endpoint = flight.FlightEndpoint(ticket, [])
        return flight.FlightInfo(table.schema, descriptor, [endpoint], -1, -1)

    @staticmethod
    def _parse_descriptor(descriptor) -> tuple[str, str]:
        if descriptor.path:
            full = descriptor.path[0]
            if isinstance(full, bytes):
                full = full.decode()
        else:
            full = descriptor.command.decode()
        ns, _, name = full.rpartition(".")
        return ns or "default", name

    # ----------------------------------------------------------------- DoGet
    def do_get(self, context, ticket):
        # slot ownership may be TRANSFERRED to the returned stream (lazy
        # scan delivery must stay inside the admission bound); released
        # here only when the handler kept it (eager results, errors)
        try:
            self.admission.acquire()
        except OverloadedError as e:
            raise flight.FlightUnavailableError(str(e)) from e
        slot = _StreamSlot(self.admission)
        self._stream_slots.current = slot
        try:
            return self._do_get(context, ticket)
        finally:
            self._stream_slots.current = None
            if not slot.transferred:
                slot.release()

    def _do_get(self, context, ticket):
        """Ungated handler body — subclasses override THIS (the admission
        gate wraps once at the public entry, never twice)."""
        with self._span(context, "flight.do_get") as sp:
            return self._do_get_json(context, ticket, sp.trace_id)

    def _do_get_json(self, context, ticket, trace_id):
        req = json.loads(ticket.ticket.decode())
        ns = req.get("namespace", "default")
        name = req["table"]
        self._check(context, ns, name)
        table = self.catalog.table(name, ns)
        scan = table.scan()
        if req.get("columns"):
            scan = scan.select(req["columns"])
        if req.get("filter"):
            scan = scan.filter(Filter._from_dict(req["filter"]))
        if req.get("partitions"):
            scan = scan.partitions(req["partitions"])
        if req.get("incremental_start_ms") is not None:
            scan = scan.incremental(req["incremental_start_ms"], req.get("incremental_end_ms"))
        if req.get("batch_size"):
            scan = scan.batch_size(req["batch_size"])
        if req.get("limit") is not None:
            scan = scan.limit(int(req["limit"]))

        metrics = self.metrics
        metrics.add(active_get_streams=1, total_get_streams=1)
        slot = self._current_stream_slot()

        def gen():
            # the stream outlives the do_get call: its own DETACHED span
            # (same trace) measures the full delivery, not just plan time —
            # detached because enter/exit run in different serving contexts
            try:
                with span(
                    "flight.stream_get", trace_id=trace_id, detached=True,
                    table=name,
                ):
                    for batch in scan.to_batches():
                        metrics.add(rows_out=len(batch))
                        yield batch
            finally:
                metrics.add(active_get_streams=-1)
                if slot is not None:
                    slot.release()

        # stream lazily with the scan's projected schema
        stream = flight.GeneratorStream(scan.projected_schema(), gen())
        if slot is not None:
            slot.transfer()
        return stream

    # ----------------------------------------------------------------- DoPut
    def do_put(self, context, descriptor, reader, writer):
        with self._admitted():
            return self._do_put(context, descriptor, reader, writer)

    def _do_put(self, context, descriptor, reader, writer):
        with self._span(context, "flight.do_put"):
            return self._do_put_json(context, descriptor, reader, writer)

    def _do_put_json(self, context, descriptor, reader, writer):
        ns, name = self._parse_descriptor(descriptor)
        self._check(context, ns, name)
        table = self.catalog.table(name, ns)
        self.metrics.add(active_put_streams=1, total_put_streams=1)
        try:
            from lakesoul_tpu_torch.streaming import CheckpointedWriter

            w = CheckpointedWriter(table)
            rows = 0
            nbytes = 0
            checkpoint_id = None
            for chunk in reader:
                batch = chunk.data
                if chunk.app_metadata:
                    meta = json.loads(chunk.app_metadata.to_pybytes().decode())
                    checkpoint_id = meta.get("checkpoint_id", checkpoint_id)
                if batch is not None and len(batch):
                    rows += len(batch)
                    nbytes += batch.nbytes
                    w.write(pa.table(batch))
            if checkpoint_id is not None:
                w.checkpoint(checkpoint_id)  # exactly-once epoch commit
            else:
                writer = w._ensure_writer()
                writer.flush()
                outputs = writer.take_staged()
                if outputs:
                    from lakesoul_tpu_torch.meta import DataFileOp

                    files = {}
                    for out in outputs:
                        files.setdefault(out.partition_desc, []).append(
                            DataFileOp(path=out.path, file_op="add", size=out.size,
                                       file_exist_cols=out.file_exist_cols)
                        )
                    self.catalog.client.commit_data_files(table.info, files, w.commit_op)
            self.metrics.add(rows_in=rows, bytes_in=nbytes)
        except LakeSoulError as e:
            raise flight.FlightServerError(str(e))
        finally:
            self.metrics.add(active_put_streams=-1)

    # ------------------------------------------------------------ DoExchange
    def do_exchange(self, context, descriptor, reader, writer):
        """Bidirectional scan-plane delivery (verb ``scan_stream``): the
        whole exchange runs inside the handler, so the plain admission
        gate bounds concurrent exchanges end to end (no slot transfer —
        unlike do_get there is no lazy stream outliving the call)."""
        with self._admitted():
            return self._do_exchange(context, descriptor, reader, writer)

    def _do_exchange(self, context, descriptor, reader, writer):
        """Ungated handler body — subclasses override THIS (single gate at
        the public entry, same contract as _do_get/_do_put/_do_action)."""
        with self._span(context, "flight.do_exchange"):
            return self._do_exchange_json(context, descriptor, reader, writer)

    def _do_exchange_json(self, context, descriptor, reader, writer):
        try:
            req = json.loads(descriptor.command.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise flight.FlightServerError(f"bad exchange descriptor: {e}")
        verb = req.get("verb")
        if verb != "scan_stream":
            raise flight.FlightServerError(f"unknown exchange verb {verb!r}")
        ns = req.get("namespace", "default")
        name = req.get("table")
        if not name:
            raise flight.FlightServerError("scan_stream needs a table")
        # same per-table RBAC as do_get: the exchange streams table data
        self._check(context, ns, name)
        delivery = self.scanplane
        if delivery is None:
            from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery

            delivery = self.scanplane = ScanPlaneDelivery(self.catalog)
        from lakesoul_tpu_torch.errors import TransientError

        try:
            delivery.handle_scan_stream(
                req, reader, writer, metrics=self.metrics
            )
        except TransientError as e:
            # e.g. the session plan racing a writer burst: retryable —
            # clients back off and reconnect like an admission shed
            raise flight.FlightUnavailableError(str(e)) from e
        except LakeSoulError as e:
            raise flight.FlightServerError(str(e))
        except TimeoutError as e:
            raise flight.FlightServerError(str(e))

    # --------------------------------------------------------------- actions
    def do_action(self, context, action):
        with self._admitted():
            return self._do_action(context, action)

    def _do_action(self, context, action):
        with self._span(context, "flight.do_action", action=action.type):
            return self._do_action_json(context, action)

    def _do_action_json(self, context, action):
        body = json.loads(action.body.to_pybytes().decode()) if action.body else {}
        if action.type == "create_table":
            schema = pa.ipc.read_schema(pa.BufferReader(bytes.fromhex(body["schema_ipc_hex"])))
            ns = body.get("namespace", "default")
            # a table that does not exist yet has no domain to check, so
            # creation is open to any AUTHENTICATED principal (reference
            # semantics: new tables land in the public domain)
            self.catalog.create_table(  # lakelint: ignore[rbac-gate-reachability] pre-create there is no table domain to check; the post-create _check below gates the result
                body["table"],
                schema,
                primary_keys=body.get("primary_keys"),
                range_partitions=body.get("range_partitions"),
                hash_bucket_num=body.get("hash_bucket_num"),
                cdc=body.get("cdc", False),
                namespace=ns,
            )
            # post-create gate: the creator must have access to what now
            # exists — a creation that lands in a domain the caller cannot
            # reach (raced concurrent create, non-default domain policy)
            # fails closed, AND rolls the registration back so an
            # unauthorized caller cannot squat the table name
            try:
                self._check(context, ns, body["table"])
            except flight.FlightUnauthorizedError:
                self.catalog.drop_table(body["table"], ns)  # lakelint: ignore[rbac-gate-reachability] rollback of the caller's own just-created empty shell after the check DENIED — deleting it IS the enforcement
                raise
            return [flight.Result(b"ok")]
        if action.type == "drop_table":
            ns = body.get("namespace", "default")
            self._check(context, ns, body["table"])
            self.catalog.drop_table(body["table"], ns)
            return [flight.Result(b"ok")]
        if action.type == "compact":
            ns = body.get("namespace", "default")
            self._check(context, ns, body["table"])
            n = self.catalog.table(body["table"], ns).compact(body.get("partitions"))
            return [flight.Result(json.dumps({"compacted": n}).encode())]
        if action.type == "metrics":
            return [flight.Result(json.dumps(self.metrics.snapshot()).encode())]
        if action.type == "login":
            # token-service role (reference: JWT token gRPC service): the
            # caller authenticated this call (basic or bearer); mint a fresh
            # bearer token for the session
            if self.jwt_server is None:
                raise flight.FlightServerError("server runs without auth")
            try:
                ttl = int(body.get("ttl_seconds", 3600))
            except (TypeError, ValueError):
                raise flight.FlightServerError("ttl_seconds must be an integer")
            # a short-lived token must not launder itself into a permanent
            # credential via login: cap at 24h
            ttl = max(1, min(ttl, 24 * 3600))
            user, group = self._identity(context)
            token = self.jwt_server.create_token(
                Claims(sub=user, group=group), ttl_seconds=ttl
            )
            return [flight.Result(json.dumps({"token": token}).encode())]
        if action.type == "data_assets":
            # per-table asset statistics as Arrow IPC (reference: the
            # data-assets stats job, entry/assets/CountDataAssets.java)
            from lakesoul_tpu_torch.service.assets import count_data_assets

            report = count_data_assets(self.catalog).to_arrow()
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, report.schema) as w:
                w.write_table(report)
            return [flight.Result(sink.getvalue().to_pybytes())]
        if action.type == "metrics_prometheus":
            return [flight.Result(self.metrics.prometheus_text().encode())]
        if action.type == "vector_search":
            # ANN serving over the gateway: any Flight client gets the same
            # top-k the Python surface gets (reference engines call the
            # vector index through their own bindings; the gateway is this
            # framework's multi-engine surface)
            ns = body.get("namespace", "default")
            self._check(context, ns, body["table"])
            query = np.asarray(body["query"], dtype=np.float32)
            table = self.catalog.table(body["table"], ns)
            with self._vector_lock:
                if self._vector_index is None:
                    from lakesoul_tpu_torch.vector.builder import TableVectorIndex

                    self._vector_index = TableVectorIndex(self.device)
                ids, dists = table.vector_search(
                    body["column"],
                    query,
                    top_k=int(body.get("top_k", 10)),
                    nprobe=int(body.get("nprobe", 8)),
                    partitions=body.get("partitions"),
                    index=self._vector_index,
                )
            return [
                flight.Result(
                    json.dumps(
                        {
                            "ids": [int(i) for i in ids],
                            "distances": [float(x) for x in dists],
                        }
                    ).encode()
                )
            ]
        if action.type == "ann_search":
            # fleet-scale ANN over a sharded plane: the query joins the
            # ShardedAnnEndpoint's current micro-batch (ragged dispatch), so
            # concurrent gateway callers share one scoring pass per shard;
            # a full pending queue sheds typed → UNAVAILABLE, like every
            # other overload in this gateway
            name = body.get("plane")
            binding = self.ann_planes.get(name)
            if binding is None:
                raise flight.FlightServerError(f"unknown ann plane {name!r}")
            self._check(context, binding.namespace, binding.table)
            nprobe = body.get("nprobe")
            top_k = body.get("top_k")
            try:
                queries = np.asarray(
                    body["queries"] if "queries" in body else body["query"],
                    dtype=np.float32,
                )
                single = queries.ndim == 1
                if single:
                    queries = queries[None, :]
                # submit() validates each query's dim against the plane, so
                # a malformed request fails HERE, typed — never inside the
                # shared micro-batch where it would take batch-mates down
                futs = [
                    binding.endpoint.submit(q, nprobe=nprobe) for q in queries
                ]
            except OverloadedError as e:
                raise flight.FlightUnavailableError(str(e)) from e
            except ValueError as e:
                raise flight.FlightServerError(f"bad ann_search query: {e}")
            out = []
            for fut in futs:
                ids, dists = fut.result(timeout=120)
                if top_k is not None:
                    ids, dists = ids[: int(top_k)], dists[: int(top_k)]
                out.append({
                    "ids": [int(i) for i in ids],
                    "distances": [float(x) for x in dists],
                })
            return [
                flight.Result(json.dumps(out[0] if single else out).encode())
            ]
        if action.type == "sql":
            # statement execution, Flight-SQL style: result as Arrow IPC bytes
            from lakesoul_tpu_torch.sql import SqlSession
            from lakesoul_tpu_torch.sql.parser import SqlError, parse as parse_sql

            ns = body.get("namespace", "default")
            stmt_text = (body.get("statement") or "").strip()
            if not stmt_text:
                raise flight.FlightServerError("empty SQL statement")
            try:
                stmt = parse_sql(stmt_text)
            except SqlError as e:
                raise flight.FlightServerError(str(e))
            # same per-table RBAC as do_get/do_put: EVERY table the statement
            # touches is checked — joins, derived tables, subqueries — not
            # just the primary FROM (CREATE TABLE targets a new one, skipped);
            # CALL clean() needs warehouse-wide (wildcard) access
            self._check_statement(context, ns, stmt)
            result = SqlSession(self.catalog, ns, device=self.device).execute(stmt_text)
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, result.schema) as w:
                w.write_table(result)
            return [flight.Result(sink.getvalue().to_pybytes())]
        raise flight.FlightServerError(f"unknown action {action.type}")

    def shutdown(self):
        super().shutdown()
        with self._vector_lock:
            if self._vector_index is not None:
                self._vector_index.release()

    def list_actions(self, context):
        return [
            ("create_table", "create a table; body: {table, schema_ipc_hex, primary_keys?, ...}"),
            ("drop_table", "drop a table; body: {table, namespace?}"),
            ("compact", "compact a table; body: {table, namespace?, partitions?}"),
            ("metrics", "server stream metrics snapshot"),
            ("sql", "execute a SQL statement; body: {statement, namespace?}"),
            ("vector_search", "ANN top-k; body: {table, column, query, top_k?, nprobe?, partitions?, namespace?}"),
            ("ann_search", "sharded-plane ANN top-k; body: {plane, query | queries, top_k?, nprobe?}"),
            ("metrics_prometheus", "metrics in Prometheus exposition format"),
            ("data_assets", "per-table asset statistics as Arrow IPC"),
            ("login", "exchange authenticated identity for a bearer token"),
        ]


class LakeSoulFlightClient:
    """Thin convenience client for the gateway."""

    def __init__(
        self,
        location: str,
        *,
        token: str | None = None,
        basic_auth: tuple[str, str] | None = None,
        trace_id: str | None = None,
    ):
        from lakesoul_tpu_torch.obs.tracing import ambient_trace_id

        self._client = flight.FlightClient(location)
        # no explicit id → the spawn-boundary ambient one, so a child
        # process's Flight calls ride the parent's trace end to end
        self._trace_id = sanitize_trace_id(trace_id) or ambient_trace_id()
        self._options = None
        if token:
            self._set_auth_header(b"authorization", f"Bearer {token}".encode())
        elif basic_auth is not None:
            user, password = basic_auth
            cred = base64.b64encode(f"{user}:{password}".encode()).decode()
            self._set_auth_header(b"authorization", f"Basic {cred}".encode())
        elif self._trace_id is not None:
            self._set_auth_header(None, None)

    def _set_auth_header(self, name: bytes | None, value: bytes | None) -> None:
        headers = []
        if name is not None:
            headers.append((name, value))
        if self._trace_id is not None:
            # server spans/logs carry this id (x-trace-id propagation)
            headers.append((TRACE_HEADER.encode(), self._trace_id.encode()))
        self._options = flight.FlightCallOptions(headers=headers)

    def login(self, *, ttl_seconds: int = 3600) -> str:
        """Exchange the current credentials for a bearer token and switch
        this client to it (the reference's token-service handshake)."""
        raw = self.action("login", {"ttl_seconds": ttl_seconds})[0]
        token = json.loads(raw.decode())["token"]
        self._set_auth_header(b"authorization", f"Bearer {token}".encode())
        return token

    def scan(self, table: str, **req) -> pa.Table:
        flt = req.get("filter")
        if isinstance(flt, Filter):
            req["filter"] = flt._to_dict()
        ticket = flight.Ticket(json.dumps({"table": table, **req}).encode())
        return self._client.do_get(ticket, options=self._options).read_all()

    def write(self, table: str, data: pa.Table, *, namespace: str = "default",
              checkpoint_id=None) -> None:
        desc = flight.FlightDescriptor.for_path(f"{namespace}.{table}")
        writer, _ = self._client.do_put(desc, data.schema, options=self._options)
        meta = (
            json.dumps({"checkpoint_id": checkpoint_id}).encode()
            if checkpoint_id is not None
            else None
        )
        for batch in data.to_batches():
            if meta is not None:
                writer.write_with_metadata(batch, meta)
            else:
                writer.write_batch(batch)
        writer.close()

    def action(self, name: str, body: dict | None = None) -> list:
        action = flight.Action(name, json.dumps(body or {}).encode())
        return [r.body.to_pybytes() for r in self._client.do_action(action, options=self._options)]

    def exchange(self, descriptor):
        """Open a DoExchange under this client's auth/trace headers
        (the scan-plane client drives the ``scan_stream`` protocol on the
        returned writer/reader pair)."""
        return self._client.do_exchange(descriptor, options=self._options)

    def list_tables(self) -> list[str]:
        return [
            f.descriptor.path[0].decode() if isinstance(f.descriptor.path[0], bytes)
            else f.descriptor.path[0]
            for f in self._client.list_flights(options=self._options)
        ]
