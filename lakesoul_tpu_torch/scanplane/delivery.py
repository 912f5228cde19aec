"""Server-side scan-plane delivery: the ``scan_stream`` DoExchange verb (the
port's copy of ``lakesoul_tpu/scanplane/delivery.py``).

The Flight gateway parses + RBAC-checks + admission-gates the exchange
(:meth:`LakeSoulFlightServer.do_exchange`) and hands the stream here.  Two
modes, one wire protocol:

- **spool mode** (a spool directory is configured): the delivery head
  publishes the session manifest (idempotent) and serves each of the
  client's ranges as soon as a worker spools it — batches over the socket,
  or, when the client proves it can read the spool (same host / shared
  tmpfs), a metadata-only message carrying the segment path: the client
  maps it zero-copy and the hot queue stage never touches the socket.
- **inline mode** (no spool): the gateway decodes ranges itself through
  the normal scan path — the degraded single-process shape, so a plain
  gateway serves remote scans for every adapter with zero fleet setup.

Wire protocol (all metadata is JSON):

==============  ==========================================================
``hello`` →     ``{kind, session, nranges, shm: {probe, token} | null,
                transports: {shm, spill, stream}}`` — each transport key
                carries its offer (probe + token) or null; ``stream`` is
                always ``true``.  The legacy top-level ``shm`` key is the
                same offer, kept for older clients.
← ``mode``      ``{kind, shm: bool, transport: "shm"|"spill"|"stream"}`` —
                client ALWAYS answers (symmetric read, no sniffing); a
                non-stream transport only after its probe verified.
                Older clients send only ``shm``.
``range`` →     ``{kind, range, rows, batches, worker?, fence?, stages?,
                path?, spill?}`` — ``path`` present = shm fast path,
                ``spill`` present = ``{path, crc32, nbytes}`` on the
                object store; either way no data messages follow for this
                range.  Neither = the range's record batches follow on
                the data plane (the ``stream`` transport).
``end`` →       ``{kind, ranges}``
==============  ==========================================================

Resume contract: ``start_range`` (position in the CLIENT's range
sequence) and ``start_batch`` (batches already delivered within that
range) — deterministic production makes redelivery byte-identical, so a
reconnecting client skips exactly what it already consumed and the stream
stays exactly-once end to end.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid

from lakesoul_tpu_torch.runtime.resilience import _env_float
from lakesoul_tpu_torch.scanplane import session as sess
from lakesoul_tpu_torch.scanplane import spool

logger = logging.getLogger(__name__)

ENV_WAIT_S = "LAKESOUL_SCANPLANE_WAIT_S"
ENV_SHM = "LAKESOUL_SCANPLANE_SHM"


def _shm_enabled() -> bool:
    return os.environ.get(ENV_SHM, "1") != "0"


class ScanPlaneDelivery:
    """One per gateway; stateless between exchanges except the spool."""

    def __init__(
        self,
        catalog,
        spool_dir: str | None = None,
        *,
        wait_s: float | None = None,
        offer_shm: bool | None = None,
        spill_prefix: str | None = None,
    ):
        from lakesoul_tpu_torch.fleet import transport as fleet_transport
        from lakesoul_tpu_torch.obs import registry

        self.catalog = catalog
        self.spool_dir = spool_dir
        self.wait_s = _env_float(ENV_WAIT_S, 120.0) if wait_s is None else float(wait_s)
        self.offer_shm = (
            (_shm_enabled() and spool_dir is not None)
            if offer_shm is None
            else bool(offer_shm)
        )
        # the object-store spill rung is offered only when a prefix is
        # configured (LAKESOUL_FLEET_SPILL) AND this head runs a spool —
        # spilling re-publishes sealed spool segments, inline mode has none
        self.spill_prefix = (
            fleet_transport.spill_prefix() if spill_prefix is None
            else (spill_prefix or None)
        )
        self._c_wait_exhausted = registry().counter(
            "lakesoul_scanplane_wait_exhausted_total"
        )

    # ------------------------------------------------------------- sessions
    def resolve_session(self, request: dict) -> sess.ScanSession:
        from lakesoul_tpu_torch.errors import LakeSoulError

        # a reconnecting client PINS its session: resuming by position is
        # only exactly-once against the SAME plan, so a pin that no longer
        # resolves (table advanced, spool pruned) must fail the stream
        # loudly instead of silently serving a different plan's rows
        pinned = request.get("session")
        if self.spool_dir is not None:
            if pinned:
                existing = sess.ScanSession.load(self.spool_dir, pinned)
                if existing is None:
                    raise LakeSoulError(
                        f"scanplane session {pinned} no longer exists (the"
                        " table advanced or the spool was pruned); restart"
                        " the scan"
                    )
                sess.touch_session(self.spool_dir, pinned)
                return existing
            # manifest-first: locating a session costs one partition-head
            # query; the full scan plan is only paid by the FIRST exchange
            # of a session, not by every client/reconnect
            _, _, sid = sess.ScanSession.locate(self.catalog, request)
            existing = sess.ScanSession.load(self.spool_dir, sid)
            if existing is not None:
                sess.touch_session(self.spool_dir, sid)
                return existing
            session = sess.ScanSession.plan(self.catalog, request)
            session.publish(self.spool_dir)
            return session
        session = sess.ScanSession.plan(self.catalog, request)
        if pinned and session.session_id != pinned:
            raise LakeSoulError(
                f"scanplane session {pinned} no longer matches the table"
                " state (a commit landed mid-stream); restart the scan"
            )
        return session

    # ------------------------------------------------------------- exchange
    def handle_scan_stream(self, request: dict, reader, writer, *, metrics=None) -> dict:
        """Serve one client's exchange; returns {rows, ranges} totals."""
        session = self.resolve_session(request)
        rank = request.get("rank")
        world = request.get("world")
        indices = session.client_ranges(rank, world)
        start_range = max(0, int(request.get("start_range") or 0))
        start_batch = max(0, int(request.get("start_batch") or 0))
        pending = indices[start_range:]
        if request.get("max_ranges") is not None:
            # a bounded slice of the client's sequence — the per-task unit
            # distributed adapters fan out over
            pending = pending[: max(0, int(request["max_ranges"]))]

        from lakesoul_tpu_torch.fleet import transport as fleet_transport

        shm_offer = None
        if self.offer_shm and self.spool_dir is not None:
            # the probe is the manifest itself: a client that can read it
            # and echo the token shares our filesystem, so segment paths
            # resolve on its side too
            shm_offer = {
                "probe": os.path.join(
                    session.dir(self.spool_dir), sess.MANIFEST_NAME
                ),
                "token": session.session_id,
            }
        spill_offer = None
        if self.spill_prefix is not None and self.spool_dir is not None:
            try:
                spill_offer = fleet_transport.write_spill_probe(
                    self.spill_prefix, session.session_id
                )
            except Exception:
                # an unreachable spill store degrades the OFFER, not the
                # stream — the ladder still has shm and stream rungs
                logger.warning(
                    "spill probe publication failed; not offering spill",
                    exc_info=True,
                )
        writer.write_metadata(json.dumps({
            "kind": "hello",
            "session": session.session_id,
            "nranges": len(indices),
            "version_digest": session.version_digest,
            "shm": shm_offer,
            "transports": {
                "shm": shm_offer,
                "spill": spill_offer,
                "stream": True,
            },
        }).encode())

        # symmetric negotiation: the client always answers with its mode
        chunk = reader.read_chunk()
        mode = {}
        if chunk.app_metadata is not None:
            mode = json.loads(chunk.app_metadata.to_pybytes().decode())
        transport = mode.get("transport") or (
            "shm" if mode.get("shm") else "stream"
        )
        # a claimed rung the server never offered falls to the floor: the
        # stream transport serves any client
        if transport == "shm" and shm_offer is None:
            transport = "stream"
        if transport == "spill" and spill_offer is None:
            transport = "stream"

        scan = sess.scan_for_request(self.catalog, session.request)
        writer.begin(sess.projected_schema(scan))

        rows_total = 0
        served = 0
        for seq, index in enumerate(pending):
            skip = start_batch if seq == 0 else 0
            if self.spool_dir is not None:
                rows_total += self._serve_spooled(
                    session, index, skip, transport, writer, metrics
                )
            else:
                rows_total += self._serve_inline(
                    scan, session, index, skip, writer, metrics
                )
            served += 1
        writer.write_metadata(json.dumps({
            "kind": "end", "ranges": served,
        }).encode())
        return {"rows": rows_total, "ranges": served}

    # ---------------------------------------------------------- spool mode
    def _wait_ready(self, session_id: str, sdir: str, index: int) -> None:
        from lakesoul_tpu_torch.errors import ScanPlaneWaitTimeout

        deadline = time.monotonic() + self.wait_s
        delay = 0.002
        while not spool.range_ready(sdir, index):
            if time.monotonic() >= deadline:
                # typed + metered: the operator learns WHICH shard starved
                # (and the autoscaler's merged view sees the starvation),
                # instead of a generic Flight stream error
                self._c_wait_exhausted.inc()
                raise ScanPlaneWaitTimeout(session_id, index, self.wait_s)
            time.sleep(delay)
            # cap the poll low: this wait sits on the client's critical
            # path once per range, and a produced range is typically only
            # milliseconds away (tmpfs rename)
            delay = min(delay * 1.5, 0.02)

    def _serve_spooled(self, session, index, skip, transport, writer, metrics) -> int:
        from lakesoul_tpu_torch.fleet import transport as fleet_transport

        sdir = session.dir(self.spool_dir)
        self._wait_ready(session.session_id, sdir, index)
        # a stream can outlive the session TTL (slow trainer, huge shard):
        # every served range freshens the manifest so the pruner never
        # sweeps a session mid-delivery
        sess.touch_session(self.spool_dir, session.session_id)
        sidecar = spool.read_sidecar(sdir, index)
        meta = {
            "kind": "range",
            "range": index,
            "rows": sidecar.get("rows", 0),
            "batches": sidecar.get("batches", 0),
            "worker": sidecar.get("worker"),
            "fence": sidecar.get("fence"),
            "stages": sidecar.get("stages") or {},
        }
        if transport in ("shm", "spill"):
            if transport == "shm":
                meta["path"] = spool.segment_path(sdir, index)
            else:
                # persist the sealed segment to the spill prefix
                # (idempotent; CRC sidecar is the publication barrier) and
                # hand the client the object's coordinates — the data
                # plane carries nothing for this range
                meta["spill"] = fleet_transport.spill_range(
                    self.spill_prefix, session.session_id, sdir, index
                )
            writer.write_metadata(json.dumps(meta).encode())
            rows = int(sidecar.get("rows", 0))
            if skip:
                # a resumed range: the client maps (or fetches) the whole
                # segment and skips locally, so meter only what it will
                # actually consume — sidecar batch_rows keeps this JSON
                # arithmetic (older sidecars without it fall back to a
                # zero-copy peek)
                per_batch = sidecar.get("batch_rows")
                if per_batch is None:
                    _, segs = spool.read_range(sdir, index)
                    per_batch = [b.num_rows for b in segs]
                rows = max(0, rows - sum(per_batch[:skip]))
            if metrics is not None:
                metrics.add(rows_out=rows)
            return rows
        writer.write_metadata(json.dumps(meta).encode())
        _, batches = spool.read_range(sdir, index)
        rows = 0
        for b in batches[skip:]:
            writer.write_batch(b)
            rows += b.num_rows
        if metrics is not None:
            metrics.add(rows_out=rows)
        return rows

    # --------------------------------------------------------- inline mode
    def _serve_inline(self, scan, session, index, skip, writer, metrics) -> int:
        unit = session.ranges[index]
        writer.write_metadata(json.dumps({
            "kind": "range", "range": index, "stages": {},
        }).encode())
        rows = 0
        for i, batch in enumerate(sess.iter_range_batches(scan, unit)):
            if i < skip:
                continue
            writer.write_batch(batch)
            rows += batch.num_rows
        if metrics is not None:
            metrics.add(rows_out=rows)
        return rows


# default-allocated spool dirs are pid-stamped so a later process can tell
# a live neighbour's spool from a SIGKILLed one's debris
_SPOOL_PREFIX = "lakesoul-scanplane-"
_OWNER_MARKER = ".spool-owner"


def _spool_base() -> str:
    import tempfile

    if os.path.isdir("/dev/shm") and os.access("/dev/shm", os.W_OK):
        return "/dev/shm"
    return tempfile.gettempdir()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


def prune_stale_spools(base: "str | None" = None) -> list[str]:
    """Remove default-allocated spool dirs whose owning process is gone.

    atexit covers clean exits; a SIGKILLed service leaves its tmpfs spool
    behind with nobody left to sweep it — so every fresh
    :func:`default_spool_dir` call sweeps predecessors' debris first.
    Only dirs this module allocated are candidates (prefix + owner
    marker); an operator-provided spool path is never touched."""
    import shutil

    base = base or _spool_base()
    removed: list[str] = []
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    for name in names:
        if not name.startswith(_SPOOL_PREFIX):
            continue
        path = os.path.join(base, name)
        try:
            with open(os.path.join(path, _OWNER_MARKER)) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            continue  # no readable marker: ownership unknown, leave it
        if pid == os.getpid() or _pid_alive(pid):
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def default_spool_dir() -> str:
    """A fresh spool location: tmpfs when available (the shared-memory
    fast path is then literal shared memory), else the system tempdir.

    The dir is pid-stamped and registered for pruning: atexit removes it
    on clean exit, and :func:`prune_stale_spools` (run here before every
    allocation) removes dirs whose owner died without one."""
    import atexit
    import shutil
    import tempfile

    from lakesoul_tpu_torch.runtime import atomicio

    base = _spool_base()
    prune_stale_spools(base)
    d = tempfile.mkdtemp(prefix=_SPOOL_PREFIX, dir=base)
    # the marker is read cross-process by prune_stale_spools — publish it
    # atomically so a concurrent pruner never sees a torn pid
    atomicio.publish_bytes(os.path.join(d, _OWNER_MARKER), str(os.getpid()).encode())
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


def probe_matches(offer: dict | None) -> bool:
    """Client-side shm probe: can we read the server's manifest and does
    it carry the session token?  Proves a shared filesystem (same host or
    shared tmpfs mount) before trusting segment paths."""
    if not offer:
        return False
    try:
        with open(offer["probe"]) as f:
            manifest = json.loads(f.read())
        return manifest.get("session") == offer.get("token")
    except (OSError, ValueError, KeyError):
        return False


def new_exchange_id() -> str:
    return uuid.uuid4().hex[:12]
