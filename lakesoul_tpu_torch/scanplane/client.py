"""Scan-plane client: a remote batch source any adapter can consume (the
port's copy of ``lakesoul_tpu/scanplane/client.py``).

:class:`ScanPlaneClient` drives the ``scan_stream`` DoExchange verb and
yields plain ``pyarrow.RecordBatch`` objects in the exact order the local
``scan.shard(rank, world).to_batches()`` would produce them — so it plugs
into ``to_torch_iter`` / the torch adapter through the batch-source seam
(:func:`LakeSoulScan.via_scanplane`) with byte-identical semantics, and
``device_put`` / collate / stats all stay client-side.

Reliability: the stream is RESUMABLE.  The client tracks (ranges
consumed, batches consumed within the current range); on a transient
Flight error (UNAVAILABLE shed, broken socket, gateway restart) it
reconnects with ``start_range``/``start_batch`` and the server — whose
production is deterministic — redelivers from exactly that position.
Combined with worker-side lease takeover this is the exactly-once story:
a SIGKILLed worker delays a range, never duplicates or drops one.

Attribution: each delivered range carries its producer's
``decode``/``merge``/``fill`` (sum, count) deltas; the client folds them
into the local registry tagged ``worker=<id>``
(the registry's ``merge_snapshot``), so a trainer's snapshot shows the
fleet's producer cost next to its own collate/queue stalls.
"""

from __future__ import annotations

import json
import logging
import sys
import time

import pyarrow as pa

from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.obs.stages import STAGE_FAMILY
from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

logger = logging.getLogger(__name__)


def _is_transient_flight_error(e: BaseException) -> bool:
    import pyarrow.flight as flight

    return isinstance(
        e,
        (
            flight.FlightUnavailableError,
            flight.FlightTimedOutError,
            flight.FlightInternalError,
            ConnectionError,
        ),
    )


class ScanPlaneClient:
    """One connection's worth of scan-plane consumption.

    Args:
        location: the gateway's Flight URI (``grpc://host:port``).
        token / basic_auth / trace_id: same auth surface as
            :class:`~lakesoul_tpu_torch.service.flight.LakeSoulFlightClient`.
        shm: ``"auto"`` (probe, use when the spool is readable here),
            ``True`` (require the probe to pass), ``False`` (never map the
            spool — pull ranges over the negotiated non-shm transport).
        transport: force one rung of the transport ladder (``"shm"`` /
            ``"spill"`` / ``"stream"``; default ``LAKESOUL_FLEET_TRANSPORT``
            or auto-negotiate).  A forced shm/spill whose probe fails
            raises instead of silently downgrading.
        max_attempts: reconnect budget per silent stretch — any delivered
            batch resets it (a long stream should not die because it hit
            N sheds spread over an hour).
    """

    def __init__(
        self,
        location: str,
        *,
        token: str | None = None,
        basic_auth: tuple[str, str] | None = None,
        trace_id: str | None = None,
        shm: "bool | str" = "auto",
        transport: str | None = None,
        max_attempts: int | None = None,
    ):
        from lakesoul_tpu_torch.fleet import transport as fleet_transport
        from lakesoul_tpu_torch.service.flight import LakeSoulFlightClient

        self.location = location
        self._token = token
        self._basic_auth = basic_auth
        self._fl = LakeSoulFlightClient(
            location, token=token, basic_auth=basic_auth, trace_id=trace_id
        )
        self._shm = shm
        # resolved once so a typo'd LAKESOUL_FLEET_TRANSPORT fails at
        # construction, not deep inside the first exchange
        self._transport = fleet_transport.forced_transport(transport)
        # projected schema of the last exchange (set at handshake): lets
        # consumers of empty slices still build schema-correct tables
        self.last_schema = None
        self._worker_labels: set[str] = set()
        self._policy = RetryPolicy.from_env(
            classify=_is_transient_flight_error,
            **({} if max_attempts is None else {"max_attempts": max_attempts}),
        )
        reg = registry()
        self._c_ranges = {
            m: reg.counter("lakesoul_scanplane_client_ranges_total", mode=m)
            for m in ("shm", "socket", "spill")
        }
        self._c_wait_exhausted = reg.counter(
            "lakesoul_scanplane_wait_exhausted_total"
        )
        self._c_reconnects = reg.counter("lakesoul_scanplane_client_reconnects_total")
        # delivered rows: the scan plane's contribution to the fleet
        # aggregate-rows/s north star (obs.fleet sums *_rows_total families)
        self._c_rows = reg.counter("lakesoul_scanplane_client_rows_total")

    # ------------------------------------------------------------------ api
    def login(self, **kw) -> str:
        return self._fl.login(**kw)

    def source(self, scan) -> "RemoteBatchSource":
        """The batch-source seam adapter for one scan (rank/world come from
        the scan's own ``shard()`` state)."""
        return RemoteBatchSource(self, scan)

    def iter_batches(
        self,
        request: dict,
        *,
        rank: int | None = None,
        world: int | None = None,
        start_range: int = 0,
        start_batch: int = 0,
        max_ranges: int | None = None,
    ):
        """Yield the request's record batches for this rank, in plan order,
        reconnect-resuming across transient Flight errors."""
        pos_range = start_range
        pos_batch = start_batch
        merged_stage_ranges: set[int] = set()
        # the first hello pins the session id: resuming by position is
        # only exactly-once against the SAME plan, so reconnects demand
        # that exact session back (the server fails the stream loudly if
        # a table commit or spool prune retired it)
        pin = {"session": None}
        delays = self._policy.delays()
        attempt = 0
        while True:
            made_progress = False
            remaining = None
            if max_ranges is not None:
                # the bound covers the ORIGINAL window: a reconnect after k
                # completed ranges must ask for max_ranges - k more, not
                # slide the window past the requested slice
                remaining = max_ranges - (pos_range - start_range)
                if remaining <= 0:
                    return
            try:
                for event, payload in self._exchange_once(
                    request, rank, world, pos_range, pos_batch, remaining,
                    merged_stage_ranges, pin,
                ):
                    if event == "batch":
                        self._c_rows.inc(payload.num_rows)
                        yield payload
                        pos_batch += 1
                        made_progress = True
                    elif event == "range_done":
                        pos_range += 1
                        pos_batch = 0
                        made_progress = True
                    else:  # "end"
                        return
                return
            except BaseException as e:  # noqa: BLE001 — classify() filters
                from lakesoul_tpu_torch.errors import ScanPlaneWaitTimeout

                # the gateway's wait-exhausted error crosses the wire as a
                # Flight error STRING carrying the typed marker: re-raise
                # the typed form (naming session + range) and meter it —
                # an unproduced range is a fleet-sizing fact, not a
                # transient to burn the reconnect budget on
                typed = ScanPlaneWaitTimeout.from_message(str(e))
                if typed is not None:
                    self._c_wait_exhausted.inc()
                    raise typed from e
                if not self._policy.classify(e):
                    raise
                if made_progress:
                    attempt = 0  # the stream is alive; reset the budget
                attempt += 1
                registry().counter(
                    "lakesoul_retry_attempts_total", op="scanplane.exchange"
                ).inc()
                if attempt >= self._policy.max_attempts:
                    registry().counter(
                        "lakesoul_retry_exhausted_total", op="scanplane.exchange"
                    ).inc()
                    raise
                delay = delays[min(attempt - 1, len(delays) - 1)] if delays else 0.0
                logger.warning(
                    "scanplane exchange interrupted at range-seq %d batch %d"
                    " (%s); reconnecting in %.3fs",
                    pos_range, pos_batch, e, delay,
                )
                self._c_reconnects.inc()
                # backoff rides the shared RetryPolicy schedule; the loop
                # itself must live here because a generator cannot be
                # re-run as a policy.run() callable
                time.sleep(delay)

    # ------------------------------------------------------------ internals
    def _exchange_once(
        self, request, rank, world, start_range, start_batch, max_ranges,
        merged_stage_ranges, pin,
    ):
        import pyarrow.flight as flight

        from lakesoul_tpu_torch.fleet import transport as fleet_transport
        from lakesoul_tpu_torch.scanplane.session import canonical_request

        req = dict(canonical_request(request))
        req.update({
            "verb": "scan_stream",
            "rank": rank,
            "world": world,
            "start_range": start_range,
            "start_batch": start_batch,
        })
        if max_ranges is not None:
            req["max_ranges"] = max_ranges
        if pin.get("session"):
            req["session"] = pin["session"]
        descriptor = flight.FlightDescriptor.for_command(
            json.dumps(req).encode()
        )
        writer, reader = self._fl.exchange(descriptor)
        try:
            hello = _read_meta(reader)
            if hello.get("kind") != "hello":
                raise flight.FlightServerError(
                    f"scanplane handshake expected hello, got {hello!r}"
                )
            if pin.get("session") is None:
                pin["session"] = hello.get("session")
            offers = hello.get("transports") or {
                "shm": hello.get("shm"), "spill": None, "stream": True,
            }
            chosen = self._negotiate(offers)
            fleet_transport.negotiated(chosen)
            writer.write_metadata(json.dumps({
                "kind": "mode",
                "shm": chosen == "shm",
                "transport": chosen,
            }).encode())
            try:
                # the server begins the stream right after the mode reply;
                # keep the projected schema for consumers whose slice
                # delivered zero batches (empty filtered ranges)
                self.last_schema = reader.schema
            except Exception:
                pass

            first_range = True  # start_batch applies only to the first one
            in_range = False  # a socket-mode range is currently streaming
            # per-range stream-transport accounting (bytes that actually
            # crossed the data plane + wall time to drain them)
            stream_bytes = 0
            stream_t0 = 0.0

            def _close_stream_range():
                self._c_ranges["socket"].inc()
                fleet_transport.meter_range(
                    "stream", stream_bytes,
                    time.perf_counter() - stream_t0,
                )

            while True:
                try:
                    chunk = reader.read_chunk()
                except StopIteration:
                    # server closed without "end": surface as a transient
                    # broken stream so the resume path kicks in
                    raise flight.FlightInternalError(
                        "scanplane stream ended without end-of-stream marker"
                    )
                meta = None
                if chunk.app_metadata is not None:
                    meta = json.loads(chunk.app_metadata.to_pybytes().decode())
                if chunk.data is not None:
                    # socket mode: the SERVER already skipped start_batch
                    stream_bytes += chunk.data.nbytes
                    yield ("batch", chunk.data)
                if meta is None:
                    continue
                kind = meta.get("kind")
                if kind == "range":
                    if in_range:
                        yield ("range_done", None)
                        _close_stream_range()
                        in_range = False
                    self._merge_stages(meta, merged_stage_ranges)
                    if meta.get("path"):
                        # shm fast path: the segment is mapped HERE; only
                        # this control message crossed the socket, so the
                        # client does its own resume skip
                        skip = start_batch if first_range else 0
                        yield from self._yield_segment(meta, skip)
                        yield ("range_done", None)
                        self._c_ranges["shm"].inc()
                    elif meta.get("spill"):
                        # spill rung: pull the sealed segment back off the
                        # object store (CRC-verified); like shm, only this
                        # control message crossed the socket
                        skip = start_batch if first_range else 0
                        yield from self._yield_spilled(meta, skip)
                        yield ("range_done", None)
                        self._c_ranges["spill"].inc()
                    else:
                        in_range = True
                        stream_bytes = 0
                        stream_t0 = time.perf_counter()
                    first_range = False
                elif kind == "end":
                    if in_range:
                        yield ("range_done", None)
                        _close_stream_range()
                    yield ("end", None)
                    return
        finally:
            # close the writer ourselves instead of `with writer:` — when
            # the body is already raising (a forced transport whose probe
            # failed, a consumer abandoning the generator), the server's
            # resulting broken-stream error at close time must not MASK
            # that exception; on a clean exit the close error still
            # propagates (same contract as the context manager)
            try:
                writer.close()
            except Exception:
                if sys.exc_info()[0] is None:
                    raise

    def _negotiate(self, offers: dict) -> str:
        """Pick the transport rung for one exchange.  A forced rung
        (ctor kwarg / ``LAKESOUL_FLEET_TRANSPORT``, with the legacy
        ``shm=True/False`` knob folded in) must hold — its probe failing
        raises.  Auto descends the ladder: prove-you-can-read the spool →
        shm, prove-you-can-read the spill prefix → spill, else stream."""
        from lakesoul_tpu_torch.errors import ConfigError
        from lakesoul_tpu_torch.fleet import transport as fleet_transport
        from lakesoul_tpu_torch.scanplane.delivery import probe_matches

        forced = self._transport
        if forced is None and self._shm is True:
            forced = "shm"
        if forced == "shm":
            if not probe_matches(offers.get("shm")):
                raise ConfigError(
                    "shm transport required but the server's spool is not"
                    " readable from this process (different host or mount)"
                )
            return "shm"
        if forced == "spill":
            if not fleet_transport.spill_probe_matches(offers.get("spill")):
                raise ConfigError(
                    "spill transport required but the server's spill prefix"
                    " is not readable from this process (no store access or"
                    " no LAKESOUL_FLEET_SPILL on the gateway)"
                )
            return "spill"
        if forced == "stream":
            return "stream"
        # auto: cheapest rung that proves readable (shm=False skips the
        # mapping rung entirely — the legacy socket-only knob)
        if self._shm is not False and probe_matches(offers.get("shm")):
            return "shm"
        if fleet_transport.spill_probe_matches(offers.get("spill")):
            return "spill"
        return "stream"

    def _yield_segment(self, meta, skip: int):
        from lakesoul_tpu_torch.fleet import transport as fleet_transport
        from lakesoul_tpu_torch.scanplane.spool import read_range
        import os

        sdir, name = os.path.split(meta["path"])
        index = int(name[len("range-"):-len(".arrow")])
        t0 = time.perf_counter()
        _, batches = read_range(sdir, index)
        try:
            nbytes = os.path.getsize(meta["path"])
        except OSError:
            nbytes = 0
        fleet_transport.meter_range(
            "shm", nbytes, time.perf_counter() - t0
        )
        for b in batches[skip:]:
            yield ("batch", b)

    def _yield_spilled(self, meta, skip: int):
        from lakesoul_tpu_torch.fleet import transport as fleet_transport

        t0 = time.perf_counter()
        nbytes, batches = fleet_transport.fetch_spilled(meta["spill"])
        fleet_transport.meter_range(
            "spill", nbytes, time.perf_counter() - t0
        )
        for b in batches[skip:]:
            yield ("batch", b)

    # distinct worker= labels one client will mint; a fleet whose workers
    # churn (restarts embed fresh pids/uuids in ids) must not grow the
    # process registry without bound — later workers fold into "other"
    MAX_WORKER_LABELS = 16

    def _merge_stages(self, meta, merged: set) -> None:
        stages = meta.get("stages") or {}
        index = meta.get("range")
        if not stages or index in merged:
            return
        merged.add(index)
        worker = meta.get("worker") or "unknown"
        if worker not in self._worker_labels:
            if len(self._worker_labels) >= self.MAX_WORKER_LABELS:
                worker = "other"
            else:
                self._worker_labels.add(worker)
        # the sidecar deltas are a remote snapshot in miniature: shape them
        # as snapshot() series and ride the SAME merge_snapshot path the
        # fleet aggregator uses (no-bucket histogram values fold via
        # Histogram.merge, so the published
        # lakesoul_scan_stage_seconds{stage=,worker=} series stay
        # byte-identical to the old hand-rolled stage_merge loop)
        snap = {}
        for stage, delta in stages.items():
            try:
                snap[f'{STAGE_FAMILY}{{stage="{stage}"}}'] = {
                    "sum": float(delta["s"]),
                    "count": int(delta["count"]),
                }
            except (KeyError, TypeError, ValueError):
                continue
        if snap:
            registry().merge_snapshot(
                snap,
                kinds={STAGE_FAMILY: "histogram"},
                labels={"worker": worker},
            )


def _read_meta(reader) -> dict:
    chunk = reader.read_chunk()
    if chunk.app_metadata is None:
        return {}
    return json.loads(chunk.app_metadata.to_pybytes().decode())


class RemoteBatchSource:
    """Batch-source seam adapter: ``iter_batches`` mirrors
    ``LakeSoulScan.to_batches`` (limit and ``skip_rows`` applied
    client-side; ``num_threads`` is the fleet's concern, ignored)."""

    remote = True

    def __init__(self, client: ScanPlaneClient, scan):
        from lakesoul_tpu_torch.scanplane.session import session_request_from_scan

        self._client = client
        self._scan = scan
        self._request = session_request_from_scan(scan)

    def iter_batches(self, *, num_threads=None, skip_rows: int = 0):
        del num_threads  # decode parallelism lives in the worker fleet
        limit = self._scan._limit
        remaining = limit
        skip = skip_rows
        for batch in self._client.iter_batches(
            self._request, rank=self._scan._rank, world=self._scan._world
        ):
            if skip:
                if skip >= batch.num_rows:
                    skip -= batch.num_rows
                    continue
                batch = batch.slice(skip)
                skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                if batch.num_rows > remaining:
                    yield batch.slice(0, remaining)
                    return
                remaining -= batch.num_rows
            yield batch

    # distributed-adapter support: a per-task payload that a worker
    # process can turn back into a one-range read without pickling clients
    def task_payload(self) -> dict:
        return {
            "location": self._client.location,
            "token": self._client._token,
            "basic_auth": self._client._basic_auth,
            "request": dict(self._request),
            "rank": self._scan._rank,
            "world": self._scan._world,
        }

    def num_task_ranges(self) -> int:
        """How many ranges this scan's rank would consume — the fan-out
        width for per-range task adapters (one cheap zero-range exchange:
        the count rides the handshake, no data is pulled)."""
        import pyarrow.flight as flight

        from lakesoul_tpu_torch.scanplane.session import canonical_request

        req = dict(canonical_request(self._request))
        req.update({
            "verb": "scan_stream",
            "rank": self._scan._rank,
            "world": self._scan._world,
            "max_ranges": 0,
        })
        writer, reader = self._client._fl.exchange(
            flight.FlightDescriptor.for_command(json.dumps(req).encode())
        )
        with writer:
            hello = _read_meta(reader)
            writer.write_metadata(json.dumps({"kind": "mode", "shm": False}).encode())
            # drain to end-of-stream so the server's slot releases cleanly
            while True:
                try:
                    reader.read_chunk()
                except StopIteration:
                    break
        return int(hello.get("nranges", 0))


def read_task_range(payload: dict, seq_index: int) -> pa.Table:
    """One distributed-adapter task: read the ``seq_index``-th range of the
    payload's rank sequence and return it as a table (a distributed adapter's per-task unit)."""
    client = ScanPlaneClient(
        payload["location"],
        token=payload.get("token"),
        basic_auth=payload.get("basic_auth"),
    )
    batches = list(client.iter_batches(
        payload["request"],
        rank=payload.get("rank"),
        world=payload.get("world"),
        start_range=seq_index,
        max_ranges=1,
    ))
    if batches:
        return pa.Table.from_batches(batches)
    # an empty range still needs the PROJECTED schema (captured from the
    # exchange handshake) or sibling tasks' blocks won't unify
    schema = getattr(client, "last_schema", None)
    if schema is None:
        schema = pa.schema([])
    return schema.empty_table()
