"""Queue-driven scanplane worker autoscaling, leased and fenced (the port's
copy of ``lakesoul_tpu/fleet/autoscale.py``).

One controller per spool SCOPE (the lease key hashes the spool path) owns
the worker fleet between a declared min/max.  The control loop is a pure
policy over observable signals — nothing here guesses:

- **backlog**: unproduced ranges across the spool's live sessions (the
  same work-discovery walk the workers run);
- **SLO burn** + **rows/s** + **queue stalls by consumer**: the
  :class:`~lakesoul_tpu_torch.obs.fleet.FleetAggregator` merged view, when an
  obs spool is armed — a fleet meeting its freshness budget needs no
  growth a backlog count alone would demand.

Scale-up is immediate (backlog maps to workers at
``ranges_per_worker``; an SLO breach with backlog jumps straight to
max).  Scale-down waits ``idle_polls_to_scale_down`` consecutive empty
polls — production is bursty per session, and worker churn costs real
process boots.

Fail-over is the metadata store's lease table: the controller holds
``fleet/autoscaler/<scope>`` under TTL + heartbeat + fencing token.  A
SIGKILLed controller's lease lapses within one TTL; a standby acquires
it with a BUMPED token and becomes leader; the zombie — if it wakes —
observes its failed renewal, demotes itself, and retires its own
children instead of fighting the new leader's fleet.  The spawned
children are the REAL worker entry (``python -m lakesoul_tpu_torch.scanplane
worker``) via :func:`~lakesoul_tpu_torch.obs.fleet.child_env`, so they join
the same obs fleet and trace.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import subprocess
import sys
import threading
from dataclasses import dataclass, field

from lakesoul_tpu_torch.obs import fleet as obs_fleet
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.runtime.resilience import _env_int
from lakesoul_tpu_torch.scanplane import session as sess
from lakesoul_tpu_torch.scanplane import spool as spool_mod

logger = logging.getLogger(__name__)

ENV_MIN_WORKERS = "LAKESOUL_FLEET_MIN_WORKERS"
ENV_MAX_WORKERS = "LAKESOUL_FLEET_MAX_WORKERS"

LEASE_PREFIX = "fleet/autoscaler/"


def lease_key(spool_dir: str) -> str:
    """The controller lease for one spool scope — peers watching the same
    spool contend for the same key no matter how they spelled the path."""
    scope = hashlib.md5(
        os.path.abspath(spool_dir).encode()
    ).hexdigest()[:12]
    return f"{LEASE_PREFIX}{scope}"


# ------------------------------------------------------------------ signals


@dataclass
class AutoscaleSignals:
    """One control tick's observed state (every field machine-derived)."""

    backlog: int = 0            # unproduced ranges across live sessions
    sessions: int = 0           # sessions with any backlog
    slo_breached: bool = False  # fleet freshness SLO out of budget
    rows_per_s: float = 0.0     # fleet north-star aggregate
    queue_stall_s: float = 0.0  # summed consumer queue-stall seconds


def spool_backlog(spool_dir: str) -> "tuple[int, int]":
    """(unproduced ranges, sessions with backlog) over the spool — the
    workers' own work-discovery walk, read-only."""
    backlog = 0
    sessions = 0
    for session_id in sess.list_sessions(spool_dir):
        session = sess.ScanSession.load(spool_dir, session_id)
        if session is None:
            continue
        missing = len(session.ranges) - len(
            spool_mod.ready_ranges(session.dir(spool_dir))
        )
        if missing > 0:
            backlog += missing
            sessions += 1
    return backlog, sessions


def collect_signals(
    spool_dir: str, *, obs_spool: str | None = None
) -> AutoscaleSignals:
    backlog, sessions = spool_backlog(spool_dir)
    sig = AutoscaleSignals(backlog=backlog, sessions=sessions)
    spool = obs_spool or os.environ.get(obs_fleet.ENV_SPOOL) or ""
    if spool:
        try:
            agg = obs_fleet.FleetAggregator(spool)
            doc = agg.aggregate()
            sig.slo_breached = not doc["slos"]["freshness"]["in_budget"]
            sig.rows_per_s = float(doc["fleet"]["rows_per_s"])
            for key, value in doc["snapshot"].items():
                if key.startswith("lakesoul_scan_stage_seconds{") \
                        and 'stage="queue"' in key and isinstance(value, dict):
                    sig.queue_stall_s += float(value.get("sum", 0.0))
        except Exception:
            logger.debug("fleet merged view unavailable", exc_info=True)
    return sig


# ------------------------------------------------------------------- policy


@dataclass
class AutoscalePolicy:
    """Pure target-size policy (the unit-testable machine).

    Stateful only in its idle counter: scale-down needs
    ``idle_polls_to_scale_down`` CONSECUTIVE backlog-free observations so
    one inter-session gap does not churn the fleet."""

    min_workers: int
    max_workers: int
    ranges_per_worker: int = 4
    idle_polls_to_scale_down: int = 3
    _idle: int = field(default=0, repr=False)

    def __post_init__(self):
        from lakesoul_tpu_torch.errors import ConfigError

        if not 0 <= self.min_workers <= self.max_workers:
            raise ConfigError(
                f"invalid autoscale bounds min={self.min_workers}"
                f" max={self.max_workers}"
            )

    def _clamp(self, n: int) -> int:
        return max(self.min_workers, min(self.max_workers, n))

    def target(self, signals: AutoscaleSignals, current: int) -> int:
        if signals.backlog > 0:
            self._idle = 0
            if signals.slo_breached:
                return self.max_workers  # burn budget: all hands
            want = math.ceil(signals.backlog / max(1, self.ranges_per_worker))
            # never shrink under live backlog: the tail of a session is
            # not a reason to churn workers mid-drain
            return self._clamp(max(want, current))
        self._idle += 1
        if self._idle >= self.idle_polls_to_scale_down:
            return self.min_workers
        return self._clamp(max(current, self.min_workers))


# ------------------------------------------------------------------ spawner


class WorkerSpawner:
    """Own the controller's worker children (real ``scanplane worker``
    entries).  LIFO retire; reap() notices SIGKILLed children so the
    control loop backfills them on its next tick."""

    def __init__(
        self,
        warehouse: str,
        spool_dir: str,
        *,
        db_path: str | None = None,
        lease_ttl_s: float | None = None,
        poll_s: float | None = None,
        tag: str = "fleet",
    ):
        self.warehouse = warehouse
        self.spool_dir = spool_dir
        self.db_path = db_path
        self.lease_ttl_s = lease_ttl_s
        self.poll_s = poll_s
        self.tag = tag
        self._children: list[subprocess.Popen] = []
        # terminated-but-not-yet-exited children, reaped by reap(): a
        # retired worker that never got waited would stay a zombie until
        # the controller itself exits
        self._retiring: list[subprocess.Popen] = []
        self._seq = 0

    @property
    def count(self) -> int:
        return len(self._children)

    def worker_argv(self, worker_id: str) -> list[str]:
        argv = [
            sys.executable, "-m", "lakesoul_tpu_torch.scanplane", "worker",
            "--warehouse", self.warehouse,
            "--spool", self.spool_dir,
            "--worker-id", worker_id,
        ]
        if self.db_path:
            argv += ["--db-path", self.db_path]
        if self.lease_ttl_s is not None:
            argv += ["--lease-ttl-s", str(self.lease_ttl_s)]
        if self.poll_s is not None:
            argv += ["--poll-s", str(self.poll_s)]
        return argv

    def spawn(self) -> dict:
        self._seq += 1
        worker_id = f"{self.tag}-{os.getpid()}-{self._seq}"
        proc = subprocess.Popen(
            self.worker_argv(worker_id),
            stdout=subprocess.DEVNULL,
            env=obs_fleet.child_env(),
        )
        self._children.append(proc)
        return {"worker_id": worker_id, "pid": proc.pid}

    def retire(self) -> "dict | None":
        if not self._children:
            return None
        proc = self._children.pop()
        proc.terminate()
        # hand the exiting child to reap() instead of wait()ing here —
        # blocking the control tick on a worker's shutdown grace would
        # stall every other scaling decision behind one slow drain
        self._retiring.append(proc)
        return {"pid": proc.pid}

    def reap(self) -> list[dict]:
        """Drop children that exited (crashed or SIGKILLed); the reported
        deficit is what the next control tick backfills.  Retired children
        are reaped here too (poll() collects the exit status) but are NOT
        a deficit — the controller asked them to leave."""
        dead = [p for p in self._children if p.poll() is not None]
        self._children = [p for p in self._children if p.poll() is None]
        self._retiring = [p for p in self._retiring if p.poll() is None]
        return [{"pid": p.pid, "returncode": p.returncode} for p in dead]

    def stop_all(self, timeout: float = 10.0) -> None:
        for p in self._children:
            if p.poll() is None:
                p.terminate()
        for p in self._children + self._retiring:
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.kill()
        self._children = []
        self._retiring = []


# --------------------------------------------------------------- controller


class WorkerAutoscaler:
    """The leased control loop: standby ↔ leader ↔ fenced.

    ``step()`` is one tick, returning the events it emitted (the
    ``__main__`` role prints them as JSON lines; tests drive it with an
    injected ``now_ms`` clock and a fake spawner).  With
    ``heartbeat=True`` (production) a daemon renewal thread keeps the
    lease alive between ticks; with ``heartbeat=False`` (deterministic
    tests) each tick renews synchronously under the injected clock."""

    def __init__(
        self,
        store,
        spawner,
        *,
        spool_dir: str,
        min_workers: int | None = None,
        max_workers: int | None = None,
        controller_id: str | None = None,
        lease_ttl_s: float = 10.0,
        policy: AutoscalePolicy | None = None,
        obs_spool: str | None = None,
        heartbeat: bool = True,
    ):
        import uuid

        self.store = store
        self.spawner = spawner
        self.spool_dir = spool_dir
        self.key = lease_key(spool_dir)
        self.controller_id = (
            controller_id or f"autoscaler-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        self.lease_ttl_ms = int(lease_ttl_s * 1000)
        min_w = _env_int(ENV_MIN_WORKERS, 1) if min_workers is None else min_workers
        max_w = _env_int(ENV_MAX_WORKERS, 8) if max_workers is None else max_workers
        self.policy = policy or AutoscalePolicy(min_w, max_w)
        self.obs_spool = obs_spool
        self._use_heartbeat = heartbeat
        self._heartbeat = None
        self._lease = None
        self.state = "standby"
        reg = registry()
        self._g_workers = reg.gauge("lakesoul_fleet_workers")
        self._c_events = {
            a: reg.counter("lakesoul_fleet_scale_events_total", action=a)
            for a in ("spawn", "retire", "backfill", "fenced", "takeover")
        }
        self._stop = None

    @property
    def fencing_token(self) -> "int | None":
        return self._lease.fencing_token if self._lease is not None else None

    # ------------------------------------------------------------ lease fsm
    def _acquire(self, now_ms: int | None) -> bool:
        lease = self.store.acquire_lease(
            self.key, self.controller_id, self.lease_ttl_ms, now_ms=now_ms
        )
        if lease is None:
            return False
        self._lease = lease
        self.state = "leader"
        if self._use_heartbeat:
            from lakesoul_tpu_torch.runtime.lease import LeaseHeartbeat

            self._heartbeat = LeaseHeartbeat(
                self.store, self.key, self.controller_id,
                lease.fencing_token, self.lease_ttl_ms,
            )
            self._heartbeat.start()
        return True

    def _renewed(self, now_ms: int | None) -> bool:
        if self._use_heartbeat:
            return not (self._heartbeat is not None and self._heartbeat.fenced)
        lease = self.store.renew_lease(
            self.key, self.controller_id, self._lease.fencing_token,
            self.lease_ttl_ms, now_ms=now_ms,
        )
        if lease is not None:
            self._lease = lease
            return True
        return False

    def _demote(self) -> None:
        """Fenced: a peer's token passed ours.  Stop acting AND retire our
        own children — the new leader owns sizing now, and a zombie's
        workers double the fleet it is trying to control."""
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        self.spawner.stop_all()
        self._lease = None
        self.state = "standby"
        self._g_workers.set(0)

    # ----------------------------------------------------------------- tick
    def step(self, *, now_ms: int | None = None) -> list[dict]:
        events: list[dict] = []
        if self.state == "standby":
            if not self._acquire(now_ms):
                return [{"event": "standby", "controller": self.controller_id}]
            taken_over = self._lease.fencing_token > 1
            if taken_over:
                self._c_events["takeover"].inc()
            events.append({
                "event": "leader",
                "controller": self.controller_id,
                "fence": self._lease.fencing_token,
                "takeover": taken_over,
            })
        elif not self._renewed(now_ms):
            self._c_events["fenced"].inc()
            self._demote()
            return events + [{
                "event": "fenced", "controller": self.controller_id,
            }]

        reaped = self.spawner.reap()
        for r in reaped:
            self._c_events["backfill"].inc()
            events.append({"event": "worker_exit", **r})
        signals = collect_signals(self.spool_dir, obs_spool=self.obs_spool)
        target = self.policy.target(signals, self.spawner.count)
        while self.spawner.count < target:
            spawned = self.spawner.spawn()
            self._c_events["spawn"].inc()
            events.append({"event": "spawn", **spawned})
        while self.spawner.count > target:
            retired = self.spawner.retire()
            self._c_events["retire"].inc()
            events.append({"event": "retire", **(retired or {})})
        self._g_workers.set(self.spawner.count)
        events.append({
            "event": "tick",
            "state": self.state,
            "workers": self.spawner.count,
            "target": target,
            "backlog": signals.backlog,
            "slo_breached": signals.slo_breached,
        })
        return events

    # ----------------------------------------------------------------- loop
    def run_forever(
        self,
        *,
        poll_s: float = 1.0,
        stop_event: "threading.Event | None" = None,
        on_event=None,
    ) -> None:
        self._stop = stop_event or threading.Event()
        while not self._stop.is_set():
            try:
                for ev in self.step():
                    if on_event is not None and ev.get("event") != "standby":
                        on_event(ev)
            except Exception:
                logger.exception("autoscaler tick failed")
            self._stop.wait(poll_s)

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self._lease is not None:
            try:
                self.store.release_lease(
                    self.key, self.controller_id, self._lease.fencing_token
                )
            except Exception:
                logger.debug("autoscaler lease release failed", exc_info=True)
            self._lease = None
        self.spawner.stop_all()
        self.state = "standby"


def emit_jsonl(event: dict) -> None:
    """The ``__main__`` role's event sink: one JSON line per action, so a
    bench/chaos parent can watch spawns and takeovers on stdout."""
    print(json.dumps(event, sort_keys=True), flush=True)
