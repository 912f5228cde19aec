"""The deployable scan-plane service: gateway + worker fleet, one command
(the port's copy of ``lakesoul_tpu/scanplane/service.py``).

``python -m lakesoul_tpu_torch.scanplane`` (mirroring the reference's compaction entry)
starts a Flight gateway whose ``scan_stream`` exchanges serve from a spool
directory, and spawns N worker CHILD PROCESSES running the real worker
entry (``python -m lakesoul_tpu_torch.scanplane worker``) — the same processes
a takeover replaces, so what is tested is what deploys.  The first
stdout line is a JSON handle ``{"location": ..., "spool": ...}`` that
clients and tooling parse.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading

from lakesoul_tpu_torch.runtime.resilience import _env_int
from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery, default_spool_dir

logger = logging.getLogger(__name__)

ENV_WORKERS = "LAKESOUL_SCANPLANE_WORKERS"
ENV_SPOOL = "LAKESOUL_SCANPLANE_SPOOL"


class ScanPlaneService:
    """Own the gateway and the worker children for one warehouse."""

    def __init__(
        self,
        warehouse: str,
        *,
        db_path: str | None = None,
        location: str = "grpc://127.0.0.1:0",
        spool_dir: str | None = None,
        workers: int | None = None,
        lease_ttl_s: float | None = None,
        poll_s: float | None = None,
        jwt_secret: str | None = None,
        max_inflight: int | None = None,
        max_queue: int | None = None,
    ):
        from lakesoul_tpu_torch import LakeSoulCatalog
        from lakesoul_tpu_torch.service.flight import LakeSoulFlightServer

        self.warehouse = warehouse
        self.db_path = db_path
        self.workers = (
            _env_int(ENV_WORKERS, 2) if workers is None else int(workers)
        )
        self.spool_dir = (
            spool_dir or os.environ.get(ENV_SPOOL) or default_spool_dir()
        )
        os.makedirs(self.spool_dir, exist_ok=True)
        self.lease_ttl_s = lease_ttl_s
        self.poll_s = poll_s
        self._requested_location = location
        self.catalog = LakeSoulCatalog(warehouse, db_path=db_path)
        self.delivery = ScanPlaneDelivery(self.catalog, self.spool_dir)
        self.server = LakeSoulFlightServer(
            self.catalog,
            location,
            jwt_secret=jwt_secret,
            max_inflight=max_inflight,
            max_queue=max_queue,
            scanplane=self.delivery,
        )
        self._children: list[subprocess.Popen] = []
        self._stopping = threading.Event()

    # ---------------------------------------------------------------- fleet
    def worker_argv(self, index: int) -> list[str]:
        argv = [
            sys.executable, "-m", "lakesoul_tpu_torch.scanplane", "worker",
            "--warehouse", self.warehouse,
            "--spool", self.spool_dir,
            "--worker-id", f"scanworker-{os.getpid()}-{index}",
        ]
        if self.db_path:
            argv += ["--db-path", self.db_path]
        if self.lease_ttl_s is not None:
            argv += ["--lease-ttl-s", str(self.lease_ttl_s)]
        if self.poll_s is not None:
            argv += ["--poll-s", str(self.poll_s)]
        return argv

    def spawn_workers(self) -> None:
        from lakesoul_tpu_torch.obs import fleet

        # fleet.child_env pins the obs spool + active trace id into each
        # worker's environment: the children publish into the SAME fleet
        # and their spans join the service's trace
        env = fleet.child_env()
        for i in range(self.workers):
            # children must not inherit our stdout: the first-line JSON
            # handle contract belongs to the SERVICE stream alone
            self._children.append(subprocess.Popen(
                self.worker_argv(i), stdout=subprocess.DEVNULL, env=env,
            ))
        if self._children:
            logger.info(
                "scanplane: %d worker processes on spool %s",
                len(self._children), self.spool_dir,
            )

    # -------------------------------------------------------------- control
    @property
    def location(self) -> str:
        """The handle clients dial: the REQUESTED bind host (a service
        bound to a routable address must advertise it, not loopback) with
        the actually-bound port; wildcard/loopback binds advertise
        loopback — the operator's tooling runs on this host."""
        from urllib.parse import urlparse

        host = urlparse(self._requested_location).hostname or "127.0.0.1"
        if host == "0.0.0.0":
            host = "127.0.0.1"
        return f"grpc://{host}:{self.server.port}"

    def handle(self) -> dict:
        return {"location": self.location, "spool": self.spool_dir}

    def serve(self) -> None:
        """Print the handle, spawn the fleet, serve until interrupted
        (handle FIRST: parsers of the first stdout line must never race
        child output)."""
        print(json.dumps(self.handle()), flush=True)
        self.spawn_workers()
        try:
            self.server.serve()
        finally:
            self.stop()

    def stop(self, timeout: float = 10.0) -> None:
        if self._stopping.is_set():
            return
        self._stopping.set()
        for p in self._children:
            p.terminate()
        for p in self._children:
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.kill()
        self.server.shutdown()
