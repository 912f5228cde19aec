"""Scan-plane worker: lease a range, decode it, publish the spool segment
(the port's copy of ``lakesoul_tpu/scanplane/worker.py``).

One worker = one process (``python -m lakesoul_tpu_torch.scanplane worker``;
a killed worker's ranges are taken over by its peers).  Any number of workers share one spool +
one metadata store:

- work discovery is the spool itself (sessions with unproduced ranges) —
  crash-safe: published state IS the
  progress record, a killed worker loses nothing;
- mutual exclusion is a ``scanplane/<session>/<range>`` lease (the metadata
  store's lease table): TTL + heartbeat + fencing token, so a SIGKILLed holder's range
  is re-leased by a peer within one TTL, and a zombie that wakes after
  takeover is fenced out of *renewal* — its only side effect would be
  re-writing a byte-identical segment;
- production runs the SAME reader the single-process scan runs
  (``iter_scan_unit_batches`` with the session's batch size), so segments
  are byte-identical to the in-process stream — the whole exactly-once /
  byte-identity story rests on that determinism, not on delivery-side
  dedup.

Per-range stage attribution (``decode``/``merge``/``fill`` deltas) is
measured around production and shipped in the sidecar; delivery forwards
it to clients, which merge it into their registries tagged
``worker=<id>``.
"""

from __future__ import annotations

import logging
import os
import time

from lakesoul_tpu_torch.obs import registry, stage_counts, stage_seconds
from lakesoul_tpu_torch.obs import fleet
from lakesoul_tpu_torch.obs.tracing import span
from lakesoul_tpu_torch.fleet import transport
from lakesoul_tpu_torch.runtime import faults
from lakesoul_tpu_torch.runtime.resilience import _env_float
from lakesoul_tpu_torch.scanplane import session as sess
from lakesoul_tpu_torch.scanplane import spool

logger = logging.getLogger(__name__)

ENV_LEASE_TTL_S = "LAKESOUL_LEASE_TTL_S"
ENV_POLL_S = "LAKESOUL_SCANPLANE_POLL_S"

# the producer-side stages a worker attributes per range; loader-side
# stages (rebatch/collate/queue/device_put) happen in the client
PRODUCER_STAGES = ("decode", "merge", "fill")


class ScanPlaneWorker:
    """Poll the spool for unproduced ranges, lease, decode, publish."""

    LEASE_PREFIX = "scanplane/"

    def __init__(
        self,
        catalog,
        spool_dir: str,
        *,
        worker_id: str | None = None,
        lease_ttl_s: float | None = None,
        poll_interval_s: float | None = None,
    ):
        import uuid

        self.catalog = catalog
        self.spool_dir = spool_dir
        self.worker_id = (
            worker_id or f"scanworker-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        self.lease_ttl_s = (
            _env_float(ENV_LEASE_TTL_S, 30.0)
            if lease_ttl_s is None else float(lease_ttl_s)
        )
        self.poll_interval_s = (
            _env_float(ENV_POLL_S, 0.2)
            if poll_interval_s is None else float(poll_interval_s)
        )
        self._stop = None  # threading.Event, created when run_forever starts
        reg = registry()
        self._c_ranges = {
            k: reg.counter("lakesoul_scanplane_ranges_total", outcome=k)
            for k in ("produced", "lease_held", "fenced", "errors", "raced")
        }
        self._c_takeovers = reg.counter("lakesoul_scanplane_takeovers_total")
        self._h_range = reg.histogram("lakesoul_scanplane_range_seconds")
        # sessions whose table vanished or whose plan no longer loads —
        # skip without re-logging every poll
        self._dead_sessions: set[str] = set()
        # manifests are immutable once published (touch only freshens the
        # mtime), so parsed sessions memoize — an idle fleet must not
        # re-deserialize every manifest 5x/second forever
        self._session_cache: dict[str, sess.ScanSession] = {}

    # ----------------------------------------------------------------- work
    def poll_once(self) -> dict:
        """One pass over every session's unproduced ranges; returns outcome
        counts (the ``--once`` / test surface)."""
        counts = {
            "produced": 0, "lease_held": 0, "fenced": 0,
            "errors": 0, "raced": 0,
        }
        live = set()
        for session_id in sess.list_sessions(self.spool_dir):
            if session_id in self._dead_sessions:
                continue
            live.add(session_id)
            session = self._session_cache.get(session_id)
            if session is None:
                session = sess.ScanSession.load(self.spool_dir, session_id)
                if session is None:
                    continue
                self._session_cache[session_id] = session
            sdir = session.dir(self.spool_dir)
            ready = spool.ready_ranges(sdir)
            n = len(session.ranges)
            if len(ready) >= n:
                continue  # fully produced: nothing to lease
            # iterate from a per-worker offset: a fleet starting together
            # then fans out over DIFFERENT ranges instead of convoying on
            # range 0 (every collided acquire is a store write txn — the
            # offset turns O(workers²) collisions into ~none)
            offset = self._range_offset(n)
            store = self.catalog.client.store
            for step in range(n):
                index = (offset + step) % n
                if self._stop is not None and self._stop.is_set():
                    return counts
                if index in ready or spool.range_ready(sdir, index):
                    continue
                # read-only peek before the write-txn acquire: a live
                # peer's lease is the common case mid-fleet
                key = f"{self.LEASE_PREFIX}{session.session_id}/{index}"
                lease = store.get_lease(key)
                if lease is not None and not self._expired(lease, store):
                    counts["lease_held"] += 1
                    self._c_ranges["lease_held"].inc()
                    continue
                outcome = self._produce_leased(session, sdir, index)
                counts[outcome] = counts.get(outcome, 0) + 1
                self._c_ranges[outcome].inc()
        # pruned/vanished sessions leave the memo with their manifests
        for gone in [k for k in self._session_cache if k not in live]:
            del self._session_cache[gone]
        return counts

    def _range_offset(self, n: int) -> int:
        if n <= 1:
            return 0
        import zlib

        return zlib.crc32(self.worker_id.encode()) % n

    @staticmethod
    def _expired(lease, store) -> bool:
        # the store's shared wall-clock timebase (the lease table's
        # liveness clock; correctness stays with the fencing token)
        return lease.expires_at_ms <= store._lease_now_ms(None)

    def _produce_leased(self, session: sess.ScanSession, sdir: str, index: int) -> str:
        from lakesoul_tpu_torch.runtime.lease import LeaseHeartbeat
        from lakesoul_tpu_torch.errors import LeaseFencedError

        store = self.catalog.client.store
        key = f"{self.LEASE_PREFIX}{session.session_id}/{index}"
        ttl_ms = int(self.lease_ttl_s * 1000)
        lease = store.acquire_lease(key, self.worker_id, ttl_ms)
        if lease is None:
            return "lease_held"
        heartbeat = LeaseHeartbeat(
            store, key, self.worker_id, lease.fencing_token, ttl_ms
        )
        try:
            heartbeat.start()
            if lease.taken_over:
                self._c_takeovers.inc()
                logger.info(
                    "%s took over range lease %s (fencing token %d)",
                    self.worker_id, key, lease.fencing_token,
                )
            if spool.range_ready(sdir, index):
                # the previous holder published between our listing and the
                # acquire — nothing to do
                return "raced"
            # pin the lease-acquire to the obs spool BEFORE entering the
            # crash window below: if a SIGKILL lands mid-range, the
            # postmortem's last event names the session/range/fence held
            fleet.record_event(
                "scanplane.range.lease",
                session=session.session_id, range=index,
                fence=lease.fencing_token, flush=True,
            )
            # fault point: a worker hung (or SIGKILLed) here still holds
            # the lease — a takeover happens inside this window
            faults.maybe_inject("scanplane.range")
            spool.sweep_tmp_debris(sdir, index)
            started = time.perf_counter()
            with span(
                "scanplane.range.produce",
                session=session.session_id, range=index,
            ):
                self._produce(
                    session, sdir, index, lease.fencing_token, heartbeat
                )
            self._h_range.observe(time.perf_counter() - started)
            return "produced"
        except LeaseFencedError:
            logger.warning(
                "%s fenced on %s: a peer took over mid-range", self.worker_id, key
            )
            return "fenced"
        except Exception:
            logger.exception(
                "%s failed producing range %s", self.worker_id, key
            )
            fleet.flush_now(reason="scanplane.range_error")
            return "errors"
        finally:
            heartbeat.stop()
            store.release_lease(key, self.worker_id, lease.fencing_token)

    def _produce(self, session, sdir, index, fence, heartbeat) -> None:
        from lakesoul_tpu_torch.errors import LeaseFencedError
        from lakesoul_tpu_torch.runtime.resilience import is_transient

        try:
            scan = sess.scan_for_request(self.catalog, session.request)
        except Exception as e:
            # only PERSISTENT failures (table dropped, bad request) retire
            # the session; a transient store hiccup must not blacklist a
            # live session for the worker's whole lifetime
            if not is_transient(e):
                self._dead_sessions.add(session.session_id)
            raise
        unit = session.ranges[index]
        s0, c0 = stage_seconds(), stage_counts()

        def producing_batches():
            for batch in sess.iter_range_batches(scan, unit):
                if heartbeat.fenced or time.monotonic() >= heartbeat.valid_until:
                    # a peer fenced past us (or renewals stalled a full
                    # TTL): stop burning CPU — the peer re-produces, and
                    # our tmp files are its sweep debris
                    raise LeaseFencedError(
                        f"range lease lapsed while producing #{index}"
                    )
                yield batch

        out_schema = sess.projected_schema(scan)
        spool.write_range(
            sdir, index, out_schema, producing_batches(),
            holder=self.worker_id,
            meta={"fence": fence, "worker": self.worker_id},
            # evaluated after the decode generator drains: the registry
            # delta at that point is exactly this range's producer cost
            meta_fn=lambda: {"stages": _stage_delta(s0, c0)},
        )

    # ---------------------------------------------------------------- loop
    # how often a running worker re-sweeps expired sessions; startup also
    # sweeps, but a fleet that never restarts must not leak tmpfs forever
    PRUNE_PERIOD_S = 60.0

    def run_forever(self, *, max_polls: int | None = None, stop_event=None) -> None:
        import threading

        self._stop = stop_event or threading.Event()
        sess.prune_sessions(self.spool_dir)
        last_prune = time.monotonic()
        polls = 0
        while not self._stop.is_set():
            counts = self.poll_once()
            if any(counts[k] for k in ("produced", "fenced", "errors")):
                logger.info("%s poll: %s", self.worker_id, counts)
            polls += 1
            if max_polls is not None and polls >= max_polls:
                return
            if time.monotonic() - last_prune >= self.PRUNE_PERIOD_S:
                pruned = sess.prune_sessions(self.spool_dir)
                if pruned:
                    logger.info(
                        "%s pruned %d expired spool sessions",
                        self.worker_id, pruned,
                    )
                # the spill mirrors the spool's lifecycle: sessions the
                # pruner retired take their object-store copies with them
                spill = transport.spill_prefix()
                if spill:
                    transport.prune_spill(
                        spill, set(sess.list_sessions(self.spool_dir))
                    )
                last_prune = time.monotonic()
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()


def _stage_delta(s0: dict, c0: dict) -> dict:
    """Per-stage (sum, count) delta since the captured baseline, producer
    stages only — measured in-line because the worker produces one range
    at a time (single-threaded), so the registry delta IS this range's
    cost."""
    s1, c1 = stage_seconds(), stage_counts()
    out = {}
    for stage in PRODUCER_STAGES:
        ds = s1[stage] - s0[stage]
        dc = c1[stage] - c0[stage]
        if dc > 0 and ds >= 0:
            out[stage] = {"s": round(ds, 6), "count": dc}
    return out
