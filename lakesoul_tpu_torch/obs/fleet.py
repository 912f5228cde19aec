"""Fleet observability plane: every process role publishes, one place reads
(the port's copy of ``lakesoul_tpu/obs/fleet.py``; its chip count is the
CUDA cards of a process that initialised CUDA).

The metrics registry is strictly process-local, but the planes are
multi-process (fleet trainers, scanplane workers, leased compactors,
freshness writers, gateways) — and a SIGKILLed role takes its whole
telemetry with it.  This module is the cross-process substrate a
multi-host fleet reads its signals from:

- **Publisher** (:class:`FleetPublisher`, armed via :func:`arm` in every
  ``__main__`` entry): periodically writes this process's registry
  snapshot — with role / service-id / pid / heartbeat labels, the
  registry's kind map, and a chip count — to a shared obs spool
  (``LAKESOUL_OBS_SPOOL``) via the same tmp → fsync → ``os.replace``
  protocol the scan-plane spool uses, so a reader never sees a torn file
  and a crashed writer leaves only sweepable debris.
- **Aggregator** (:class:`FleetAggregator`): merges member snapshots into
  fleet-level series via :meth:`MetricsRegistry.merge_snapshot` (counters
  sum, gauges keep per-process identity labels, histograms merge
  bucket-aware), flags stale members by heartbeat age
  (``LAKESOUL_OBS_STALE_S``), derives the north-star figures (aggregate
  rows/s, rows/s/chip), and evaluates the freshness/throughput SLOs
  fleet-wide.  It exposes ``prometheus_text()`` / ``snapshot()`` so the
  existing ``/metrics`` exporter serves the FLEET view unchanged
  (``serve_prometheus(FleetAggregator(spool))``), and the console's
  ``fleet-status`` renders the same document.
- **Flight recorder** (:class:`FlightRecorder`): a bounded ring of recent
  events per process, flushed to the spool alongside the most recent
  finished spans — periodically, at exit, and on demand
  (:func:`flush_now` from fault paths) — so a SIGKILLed worker's last
  moments are recoverable (:meth:`FleetAggregator.postmortems`).
- **Trace handoff**: :func:`child_env` pins the active trace id into a
  spawned role's environment (``LAKESOUL_TRACE_ID``); root spans and
  Flight clients in the child default to it
  (:func:`~lakesoul_tpu_torch.obs.tracing.ambient_trace_id`), so one chaos run
  yields an end-to-end commit → worker-decode → client-delivery trace
  assembled by :meth:`FleetAggregator.trace`.

Identity discipline: process-identity metric labels (``role=``,
``service_id=``, ``worker=``) come from :func:`identity_labels` /
:func:`process_identity`, never hand-rolled strings — lakelint's
``fleet-identity-label`` rule enforces it, so fleet snapshots aggregate
under one coherent identity instead of a zoo of ad-hoc spellings.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import socket
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

from lakesoul_tpu_torch.obs.metrics import MetricsRegistry, registry
from lakesoul_tpu_torch.obs.tracing import (
    ENV_TRACE_ID,
    ambient_trace_id,
    current_trace_id,
    recent_spans,
    sanitize_trace_id,
)

__all__ = [
    "ENV_SPOOL",
    "ENV_FLUSH_S",
    "ENV_STALE_S",
    "FleetAggregator",
    "FleetPublisher",
    "FlightRecorder",
    "arm",
    "child_env",
    "flush_now",
    "identity",
    "identity_labels",
    "process_identity",
    "record_event",
    "recorder",
]

logger = logging.getLogger(__name__)

ENV_SPOOL = "LAKESOUL_OBS_SPOOL"
ENV_FLUSH_S = "LAKESOUL_OBS_FLUSH_S"
ENV_STALE_S = "LAKESOUL_OBS_STALE_S"

BUILD_INFO_FAMILY = "lakesoul_build_info"
START_TIME_FAMILY = "lakesoul_process_start_time_seconds"
FLUSH_FAMILY = "lakesoul_obs_flush_seconds"

_MEMBER_PREFIX = "member-"
_RECORDER_PREFIX = "recorder-"

# spool file names embed the service id: bound charset, no path tricks
_SAFE_ID_RE = re.compile(r"[^A-Za-z0-9._-]+")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def default_flush_s() -> float:
    """Publisher flush period (``LAKESOUL_OBS_FLUSH_S``, default 2 s — the
    fleet's telemetry latency, and the worst-case data loss window of a
    SIGKILLed member's postmortem)."""
    return max(0.05, _env_float(ENV_FLUSH_S, 2.0))


def default_stale_s() -> float:
    """Heartbeat age beyond which a member counts as stale/crashed
    (``LAKESOUL_OBS_STALE_S``, default 10 s — several flush periods, so a
    GC pause doesn't read as a death)."""
    return max(0.1, _env_float(ENV_STALE_S, 10.0))


# ------------------------------------------------------------------ identity


@dataclass(frozen=True)
class Identity:
    """Who this process is, fleet-wide: the one source of the identity
    labels every published series carries."""

    role: str
    service_id: str
    pid: int
    host: str
    started_unix: float

    def labels(self) -> dict:
        return {"role": self.role, "service_id": self.service_id}


_IDENTITY: Identity | None = None
_IDENTITY_LOCK = threading.Lock()


def process_identity(
    role: str | None = None, service_id: str | None = None
) -> Identity:
    """Set (or refine) this process's fleet identity and return it.  The
    first caller wins defaults: role ``process``, service id
    ``<role>-<pid>`` — re-arming with an explicit role/service-id replaces
    the placeholder."""
    global _IDENTITY
    with _IDENTITY_LOCK:
        if role is None and _IDENTITY is not None:
            return _IDENTITY
        role = role or (_IDENTITY.role if _IDENTITY else "process")
        pid = os.getpid()
        service_id = service_id or (
            _IDENTITY.service_id
            if _IDENTITY is not None and _IDENTITY.role == role
            else f"{role}-{pid}"
        )
        started = _IDENTITY.started_unix if _IDENTITY else time.time()
        _IDENTITY = Identity(
            role=str(role),
            service_id=_SAFE_ID_RE.sub("_", str(service_id))[:96],
            pid=pid,
            host=socket.gethostname(),
            started_unix=started,
        )
        return _IDENTITY


def identity() -> Identity:
    """This process's fleet identity (a default one is minted on first
    use; ``__main__`` entries set the real role via :func:`arm`)."""
    ident = _IDENTITY
    return ident if ident is not None else process_identity()


def identity_labels(**extra: str) -> dict:
    """THE sanctioned source of process-identity metric labels (``role=``,
    ``service_id=``) — lakelint's ``fleet-identity-label`` rule flags
    hand-rolled literals at metric call sites."""
    out = identity().labels()
    out.update(extra)
    return out


def stamp_process_gauges() -> None:
    """``lakesoul_build_info`` / ``lakesoul_process_start_time_seconds``
    gauges with the identity labels: every fleet snapshot self-identifies
    (version skew across a rolling fleet is visible on /metrics)."""
    ident = identity()
    labels = identity_labels()
    try:
        from lakesoul_tpu_torch import __version__ as version
    except Exception:  # partial import during interpreter teardown
        version = "unknown"
    reg = registry()
    reg.gauge(BUILD_INFO_FAMILY, version=version, **labels).set(1)
    reg.gauge(START_TIME_FAMILY, **labels).set(round(ident.started_unix, 3))


def _chip_count() -> int:
    # only report cards a process actually drives: never force CUDA's
    # initialisation (a telemetry flush must not create a context on a
    # card the process never touched)
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    try:
        return int(torch.cuda.device_count())
    except Exception:
        return 0


# ------------------------------------------------------------ flight recorder


class FlightRecorder:
    """Bounded ring of recent process events.  The publisher flushes it
    (plus the tracing module's recent-span ring) to the spool, so the ring
    as of the LAST flush is what a SIGKILL leaves behind — roles record
    their dangerous moments (lease acquired, range started) with
    ``flush=True`` to pin them before entering the window."""

    def __init__(self, maxlen: int = 512):
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._version = 0  # bumps per record(): publishers skip no-op writes

    def record(self, name: str, **attrs) -> None:
        evt = {"t_unix": round(time.time(), 3), "name": name}
        if attrs:
            evt["attrs"] = attrs
        with self._lock:
            self._ring.append(evt)
            self._version += 1

    def version(self) -> int:
        with self._lock:
            return self._version

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self) -> dict:
        return {"events": self.events(), "spans": recent_spans()[-256:]}


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    """THE process-wide flight recorder."""
    return _RECORDER


def record_event(name: str, *, flush: bool = False, **attrs) -> None:
    """Record one event; ``flush=True`` additionally pins the recorder to
    the spool right now (no-op when no publisher is armed) — used just
    before a crash-prone window so the postmortem shows the last step.
    The pin writes ONLY the recorder file (the member snapshot keeps its
    periodic cadence) so per-operation pinning stays cheap on hot paths."""
    _RECORDER.record(name, **attrs)
    if flush:
        pub = _PUBLISHER
        if pub is not None:
            try:
                pub.flush_recorder(reason=name)
            except Exception:
                logger.debug("fleet recorder pin failed", exc_info=True)


# ---------------------------------------------------------------- publisher


def _write_atomic(path: str, doc: dict) -> None:
    # the sanctioned publication seam (runtime/atomicio): a reader sees the
    # whole file or the previous one, never a torn write; fsync before
    # rename so a host crash can't replace good data with an empty inode.
    # lazy import — obs must stay importable before the runtime package
    # (runtime.pipeline imports the obs registry back).
    # serialize first, write once: json.dump's many small stream writes
    # cost ~4x a single f.write on span-heavy recorder docs, and flush
    # cost is budgeted against scan wall time (obs_fleet bench leg)
    from lakesoul_tpu_torch.runtime import atomicio

    atomicio.publish_bytes(path, json.dumps(doc).encode())


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None  # mid-replace race or debris: skip, next pass sees it


class FleetPublisher:
    """Periodic snapshot + flight-recorder publication for ONE process.

    ``start()`` writes immediately (a member is visible the moment it
    arms), then flushes every ``flush_s`` from a daemon thread; ``stop()``
    (atexit-registered by :func:`arm`) takes a final flush so a clean exit
    publishes its last state.  Flush cost is metered into
    ``lakesoul_obs_flush_seconds`` — the obs_fleet bench leg budgets it
    against scan wall time."""

    def __init__(
        self,
        spool_dir: str,
        *,
        flush_s: float | None = None,
        source: MetricsRegistry | None = None,
    ):
        self.spool_dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        self.flush_s = default_flush_s() if flush_s is None else max(0.05, float(flush_s))
        self._reg = source if source is not None else registry()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._flush_lock = threading.Lock()  # timer vs flush_now vs atexit
        self._h_flush = self._reg.histogram(FLUSH_FAMILY)
        self._rec_fp: tuple | None = None  # recorder content fingerprint

    def member_path(self) -> str:
        return os.path.join(
            self.spool_dir, f"{_MEMBER_PREFIX}{identity().service_id}.json"
        )

    def recorder_path(self) -> str:
        return os.path.join(
            self.spool_dir, f"{_RECORDER_PREFIX}{identity().service_id}.json"
        )

    @staticmethod
    def _head() -> dict:
        ident = identity()
        return {
            "role": ident.role,
            "service_id": ident.service_id,
            "pid": ident.pid,
            "host": ident.host,
            "started_unix": round(ident.started_unix, 3),
            "heartbeat_unix": round(time.time(), 3),
        }

    @staticmethod
    def _recorder_doc(reason: str) -> tuple[dict, tuple]:
        dump = _RECORDER.dump()
        spans = dump["spans"]
        last = spans[-1] if spans else {}
        fp = (
            _RECORDER.version(), len(spans),
            last.get("t_unix"), last.get("name"),
        )
        return dict(FleetPublisher._head(), reason=reason, **dump), fp

    def flush_recorder(self, reason: str) -> None:
        """Pin the flight recorder to the spool WITHOUT the member
        snapshot — the cheap path for per-operation pins (lease acquired,
        range started): a crash-prone window needs its last EVENT durable,
        while the metrics snapshot keeps its periodic cadence."""
        started = time.perf_counter()
        rec, rec_fp = self._recorder_doc(reason)
        with self._flush_lock:
            _write_atomic(self.recorder_path(), rec)  # lakelint: ignore[transitive-lock-held-call] the lock's purpose is serializing this write; no pool/lock reachable beneath
            self._rec_fp = rec_fp
        self._h_flush.observe(time.perf_counter() - started)

    def flush(self, reason: str = "periodic") -> None:
        started = time.perf_counter()
        member = dict(
            self._head(),
            chips=_chip_count(),
            kinds=self._reg.kinds(),
            snapshot=self._reg.snapshot(),
        )
        rec, rec_fp = self._recorder_doc(reason)
        with self._flush_lock:
            # the lock EXISTS to serialize these two writes (timer thread vs
            # flush_now vs atexit racing os.replace on the same paths); the
            # file IO never re-enters the pool or takes another lock
            _write_atomic(self.member_path(), member)  # lakelint: ignore[transitive-lock-held-call] the lock's purpose is serializing this write; no pool/lock reachable beneath
            # the recorder doc only changes when an event or span landed;
            # a periodic heartbeat with unchanged content skips the (span-
            # heavy, fsynced) rewrite — explicit-reason flushes always pin
            if reason != "periodic" or rec_fp != self._rec_fp:
                _write_atomic(self.recorder_path(), rec)  # lakelint: ignore[transitive-lock-held-call] same serialization lock, same leaf file IO
                self._rec_fp = rec_fp
        self._h_flush.observe(time.perf_counter() - started)

    def start(self) -> "FleetPublisher":
        self.flush(reason="start")
        if self._thread is None:
            self._thread = threading.Thread(  # lakelint: ignore[raw-thread] heartbeat must keep flushing while the role's own work occupies (or hangs) the pool — that hang is exactly what the postmortem records
                target=self._run, daemon=True, name="obs-fleet-publisher"
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            try:
                self.flush()
            except Exception:  # telemetry must never take the role down
                logger.debug("fleet publisher flush failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        try:
            self.flush(reason="stop")
        except Exception:
            logger.debug("fleet publisher final flush failed", exc_info=True)


_PUBLISHER: FleetPublisher | None = None
_ARM_LOCK = threading.Lock()


def arm(
    role: str,
    *,
    service_id: str | None = None,
    spool_dir: str | None = None,
    flush_s: float | None = None,
) -> FleetPublisher | None:
    """Arm fleet observability for this process: set the identity, stamp
    the build-info / start-time gauges, and — when an obs spool is
    configured (argument or ``LAKESOUL_OBS_SPOOL``) — start the snapshot
    publisher (atexit-flushed).  Every ``__main__`` role entry calls this;
    without a spool it only stamps identity, so library use costs nothing.
    Idempotent: the first armed publisher wins."""
    global _PUBLISHER
    process_identity(role=role, service_id=service_id)
    stamp_process_gauges()
    spool = spool_dir or os.environ.get(ENV_SPOOL) or ""
    if not spool:
        return None
    with _ARM_LOCK:
        if _PUBLISHER is None:
            pub = FleetPublisher(spool, flush_s=flush_s)
            pub.start()
            atexit.register(pub.stop)
            _PUBLISHER = pub
    return _PUBLISHER


def armed_publisher() -> FleetPublisher | None:
    return _PUBLISHER


def flush_now(reason: str = "manual") -> None:
    """Flush the armed publisher immediately (fault paths call this so a
    crash-adjacent state change reaches the spool before the window);
    no-op when nothing is armed."""
    pub = _PUBLISHER
    if pub is not None:
        try:
            pub.flush(reason=reason)
        except Exception:
            logger.debug("fleet flush_now failed", exc_info=True)


def child_env(base: dict | None = None, *, trace_id: str | None = None) -> dict:
    """Environment for a spawned role: inherits, then pins the active
    trace id (``LAKESOUL_TRACE_ID`` — explicit > current span > ambient)
    and the obs spool, so the child joins this process's trace AND fleet.
    This is the subprocess leg of trace propagation; ``x-trace-id`` covers
    the Flight legs."""
    env = dict(os.environ if base is None else base)
    tid = sanitize_trace_id(trace_id) or current_trace_id() or ambient_trace_id()
    if tid:
        env[ENV_TRACE_ID] = tid
    pub = _PUBLISHER
    spool = pub.spool_dir if pub is not None else os.environ.get(ENV_SPOOL)
    if spool:
        env[ENV_SPOOL] = spool
    return env


# --------------------------------------------------------------- aggregation


_TRANSPORT_BYTES_FAMILY = "lakesoul_fleet_transport_bytes_total"


def _member_transport(snapshot: dict) -> "tuple[str | None, int]":
    """(negotiated transport, bytes moved) for one member's snapshot: the
    rung that carried the most bytes, total across all rungs.  ``(None,
    0)`` for members that never used the transport seam (writers, the
    compactor)."""
    best = None
    best_bytes = -1
    total = 0
    for key, value in snapshot.items():
        if not key.startswith(_TRANSPORT_BYTES_FAMILY + "{"):
            continue
        if isinstance(value, dict):
            continue
        labels = key[key.index("{") + 1:-1]
        name = None
        for part in labels.split(","):
            k, _, v = part.partition("=")
            if k == "transport":
                name = v.strip('"')
        if name is None:
            continue
        nbytes = int(value)
        total += nbytes
        if nbytes > best_bytes:
            best, best_bytes = name, nbytes
    return best, total


class FleetAggregator:
    """Merge an obs spool's member snapshots into ONE fleet view.

    ``aggregate()`` returns the full document (members + staleness +
    north-star figures + fleet-wide SLOs + merged series snapshot);
    ``prometheus_text()`` / ``snapshot()`` make an aggregator a drop-in
    ``source`` for :func:`~lakesoul_tpu_torch.obs.exporter.serve_prometheus`, so
    the existing ``/metrics`` endpoint serves the fleet."""

    # counter families summed into the aggregate-rows/s north star: every
    # *_rows_total family plus the gateway's stream counters
    _ROWS_SUFFIX = "_rows_total"
    _ROWS_EXTRA = ("lakesoul_flight_rows_out",)

    def __init__(self, spool_dir: str, *, stale_after_s: float | None = None):
        self.spool_dir = spool_dir
        self.stale_after_s = (
            default_stale_s() if stale_after_s is None else float(stale_after_s)
        )

    # ------------------------------------------------------------- raw reads
    def _docs(self, prefix: str) -> list[dict]:
        try:
            names = sorted(os.listdir(self.spool_dir))
        except OSError:
            return []
        out = []
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            doc = _read_json(os.path.join(self.spool_dir, name))
            if doc is not None:
                out.append(doc)
        return out

    def members(self) -> list[dict]:
        """Every member's latest published snapshot document."""
        return self._docs(_MEMBER_PREFIX)

    def recorders(self) -> list[dict]:
        """Every member's latest flight-recorder dump."""
        return self._docs(_RECORDER_PREFIX)

    # ------------------------------------------------------------- aggregate
    def aggregate(
        self, *, now: float | None = None, min_rows_per_s: float | None = None
    ) -> dict:
        """ONE fleet document: merged series, per-member status with
        staleness, north-star rows/s (+ per chip), fleet-wide SLOs."""
        doc, _reg = self._aggregate(now=now, min_rows_per_s=min_rows_per_s)
        return doc

    def _aggregate(
        self, *, now: float | None = None, min_rows_per_s: float | None = None
    ) -> "tuple[dict, MetricsRegistry]":
        now = time.time() if now is None else float(now)
        reg = MetricsRegistry()
        members = []
        for doc in self.members():
            try:
                role = str(doc.get("role") or "unknown")
                service_id = str(doc.get("service_id") or "unknown")
                hb = float(doc.get("heartbeat_unix") or 0.0)
            except (TypeError, ValueError):
                continue
            age = max(0.0, now - hb)
            transport, moved = _member_transport(doc.get("snapshot") or {})
            member = {
                "role": role,
                "service_id": service_id,
                "pid": doc.get("pid"),
                "host": doc.get("host"),
                "chips": int(doc.get("chips") or 0),
                "started_unix": doc.get("started_unix"),
                "heartbeat_age_s": round(age, 3),
                "stale": age > self.stale_after_s,
                # the member's negotiated fleet transport (its dominant
                # rung by bytes moved) — console fleet-status's transport
                # column; the per-rung counters themselves sum into the
                # merged snapshot below
                "transport": transport,
                "transport_bytes": moved,
            }
            reg.merge_snapshot(
                doc.get("snapshot") or {},
                kinds=doc.get("kinds") or {},
                gauge_labels={"role": role, "service_id": service_id},
            )
            members.append(member)
        fleet = self._north_star(reg, members, now)
        slos = self._slos(reg, fleet, min_rows_per_s)
        # the fleet-level figures ride the merged registry too, so ONE
        # /metrics scrape carries members + staleness + north stars
        reg.gauge("lakesoul_fleet_members").set(len(members))
        reg.gauge("lakesoul_fleet_stale_members").set(
            sum(1 for m in members if m["stale"])
        )
        reg.gauge("lakesoul_fleet_chips").set(fleet["chips"])
        reg.gauge("lakesoul_fleet_rows_per_s").set(fleet["rows_per_s"])
        reg.gauge("lakesoul_fleet_rows_per_s_per_chip").set(
            fleet["rows_per_s_per_chip"]
        )
        doc = {
            "generated_unix": round(now, 3),
            "stale_after_s": self.stale_after_s,
            "members": members,
            "fleet": fleet,
            "slos": slos,
            "snapshot": reg.snapshot(),
        }
        return doc, reg

    def _north_star(self, reg: MetricsRegistry, members: list[dict], now: float) -> dict:
        rows = 0.0
        for key, value in reg.snapshot().items():
            if isinstance(value, dict):
                continue
            name = key.split("{", 1)[0]
            if name.endswith(self._ROWS_SUFFIX) or name in self._ROWS_EXTRA:
                rows += float(value)
        starts = [
            float(m["started_unix"]) for m in members
            if isinstance(m.get("started_unix"), (int, float))
        ]
        # the observation window is the fleet's lifetime so far, not any
        # single member's — rows/s is an aggregate claim
        window = (now - min(starts)) if starts else 0.0
        rows_per_s = rows / window if window > 0 else 0.0
        # chips are a HOST resource: several member processes on one host
        # see the same devices, so take the per-host max, then sum
        per_host: dict[str, int] = {}
        for m in members:
            if m["stale"]:
                continue
            host = str(m.get("host") or "")
            per_host[host] = max(per_host.get(host, 0), m["chips"])
        chips = sum(per_host.values())
        return {
            "rows": int(rows),
            "window_s": round(window, 3),
            "rows_per_s": round(rows_per_s, 3),
            "chips": chips,
            "rows_per_s_per_chip": round(rows_per_s / chips, 3) if chips else 0.0,
        }

    def _slos(
        self, reg: MetricsRegistry, fleet: dict, min_rows_per_s: float | None
    ) -> dict:
        from lakesoul_tpu_torch.freshness.slo import (
            FRESHNESS_FAMILY,
            VIOLATIONS_FAMILY,
            default_freshness_budget,
            default_freshness_slo_s,
        )

        count = 0
        total = 0.0
        p50 = p99 = 0.0
        fresh_series = reg.series(FRESHNESS_FAMILY)
        for _labels, h in fresh_series:
            v = h.value
            count += v["count"]
            total += v["sum"]
        if len(fresh_series) == 1:
            p50 = fresh_series[0][1].quantile(0.50)
            p99 = fresh_series[0][1].quantile(0.99)
        violations = sum(
            c.value for labels, c in reg.series(VIOLATIONS_FAMILY)
            if not str(labels.get("slo", "")).endswith("tput")
        )
        budget = default_freshness_budget()
        allowed = int(count * budget)
        out = {
            "freshness": {
                "target_s": default_freshness_slo_s(),
                "budget_fraction": budget,
                "count": count,
                "violations": int(violations),
                "allowed_violations": allowed,
                "in_budget": violations <= allowed,
                "p50_s": round(p50, 4),
                "p99_s": round(p99, 4),
                "mean_s": round(total / count, 4) if count else 0.0,
            },
            "throughput": {
                "rows_per_s": fleet["rows_per_s"],
                "min_rows_per_s": min_rows_per_s,
                "ok": (
                    None if min_rows_per_s is None
                    else fleet["rows_per_s"] >= float(min_rows_per_s)
                ),
            },
        }
        return out

    # ----------------------------------------------------- exporter adapters
    def snapshot(self) -> dict:
        """The full aggregate document (the exporter's JSON view)."""
        return self.aggregate()

    def prometheus_text(self) -> str:
        """Merged fleet series (incl. the ``lakesoul_fleet_*`` gauges) in
        Prometheus text — a drop-in exporter source:
        ``serve_prometheus(FleetAggregator(spool))``."""
        _doc, reg = self._aggregate()
        return reg.prometheus_text()

    # ----------------------------------------------------------- postmortems
    def stale_members(self, *, now: float | None = None) -> list[dict]:
        now = time.time() if now is None else float(now)
        out = []
        for doc in self.members():
            try:
                hb = float(doc.get("heartbeat_unix") or 0.0)
            except (TypeError, ValueError):
                continue
            if now - hb > self.stale_after_s:
                out.append(doc)
        return out

    def postmortems(self, *, now: float | None = None) -> list[dict]:
        """Flight-recorder dumps of STALE members, each paired with the
        member's last flushed snapshot — the crash-postmortem surface: a
        SIGKILLed worker's last recorded moments, recovered from the
        spool."""
        stale = {
            str(doc.get("service_id")): doc
            for doc in self.stale_members(now=now)
        }
        out = []
        for rec in self.recorders():
            sid = str(rec.get("service_id"))
            if sid in stale:
                out.append({
                    "service_id": sid,
                    "role": rec.get("role"),
                    "pid": rec.get("pid"),
                    "heartbeat_unix": rec.get("heartbeat_unix"),
                    "events": rec.get("events") or [],
                    "spans": rec.get("spans") or [],
                    "last_snapshot": stale[sid].get("snapshot") or {},
                })
        return out

    # ----------------------------------------------------------------- trace
    def trace(self, trace_id: str) -> list[dict]:
        """Every exported span of one trace across ALL members, annotated
        with the exporting member's role/pid and ordered by wall-clock end
        time — the end-to-end commit → decode → delivery view."""
        spans = []
        for rec in self.recorders():
            for s in rec.get("spans") or []:
                if s.get("trace_id") == trace_id:
                    spans.append(dict(
                        s, role=rec.get("role"), pid=rec.get("pid"),
                    ))
        spans.sort(key=lambda s: s.get("t_unix") or 0.0)
        return spans
