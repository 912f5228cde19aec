"""The lease keepalive a leased job runs under (the port's copy of
``_LeaseHeartbeat`` in ``lakesoul_tpu/compaction/service.py``): the scan
plane's worker holds a range lease with it, the leased compaction service a
partition lease, and the worker autoscaler its controller lease."""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)


class LeaseHeartbeat:
    """Keeps the store-side lease row alive while a long job runs.

    Renews at TTL/3 on a daemon thread; each successful renewal extends
    ``valid_until`` (monotonic clock).  Without this, any job longer than
    one TTL is guaranteed fenced at commit — the staged output dies, a
    peer re-runs the same doomed job, and the partition livelocks.  A
    failed renewal means a peer fenced past us: the job observes
    ``fenced`` and aborts instead of wasting the rest of the pass (the
    commit-time lease guard stays the correctness backstop)."""

    def __init__(self, store, key: str, holder: str, token: int, ttl_ms: int):
        self._store = store
        self._key = key
        self._holder = holder
        self._token = token
        self._ttl_ms = ttl_ms
        self._ttl_s = ttl_ms / 1000.0
        self._period_s = max(self._ttl_s / 3.0, 0.05)
        # published by the heartbeat thread, read by the job thread: every
        # post-init write holds _guard so the hand-off is a clean release/
        # acquire (racecheck-proven), not a torn unlocked publish
        self._guard = threading.Lock()
        self.valid_until = time.monotonic() + self._ttl_s
        self.fenced = False
        self._stop = threading.Event()
        self._thread = threading.Thread(  # lakelint: ignore[raw-thread] lease keepalive must tick while the job itself occupies pool workers
            target=self._run, name=f"lease-heartbeat-{key}", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._period_s):
            try:
                renewed = self._store.renew_lease(
                    self._key, self._holder, self._token, self._ttl_ms
                )
            except Exception:
                # transient store error: the old window still stands, but a
                # PERSISTENT failure quietly lapses into a fenced job — log
                # each miss so that path is diagnosable after the fact
                logger.warning(
                    "lease renewal for %s failed; local validity lapses in"
                    " %.1fs", self._key,
                    max(self.valid_until - time.monotonic(), 0.0),
                    exc_info=True,
                )
                continue
            if renewed is None:
                with self._guard:
                    self.fenced = True  # expired or fenced: never revive, re-acquire
                return
            with self._guard:
                self.valid_until = time.monotonic() + self._ttl_s
