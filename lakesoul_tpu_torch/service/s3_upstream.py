"""Upstream S3 client for the storage proxy: SigV4 re-signing + DNS-based
backend discovery (the port's copy of ``lakesoul_tpu/service/s3_upstream.py``).

Role parity with rust/lakesoul-s3-proxy: sig-v4 re-signing of forwarded
requests (aws.rs) and DNS service discovery with health checks + failover
(main.rs:306-347,589-652 — the pingora backend-discovery loop).  The proxy
terminates client auth, then forwards the object operation to one healthy
upstream backend, signed with the proxy's credentials.

Everything is injectable (resolver, health check, clock) so the behavior is
unit-testable without the network; the e2e test runs a local fake S3 that
cryptographically verifies the signatures.
"""

from __future__ import annotations

import hashlib
import http.client
import logging
import socket
import threading
import time
from dataclasses import dataclass, field

from lakesoul_tpu_torch.runtime.resilience import CircuitBreaker, RetryPolicy
from lakesoul_tpu_torch.service import sigv4

logger = logging.getLogger(__name__)


_SSL_CTX = None
_SSL_CTX_LOCK = threading.Lock()


def _default_ssl_context():
    """One shared verifying context: building a fresh one per connection
    would re-read the system CA bundle on the proxy's per-request hot path;
    wrap_socket on a shared context is thread-safe."""
    global _SSL_CTX
    with _SSL_CTX_LOCK:
        if _SSL_CTX is None:
            import ssl

            _SSL_CTX = ssl.create_default_context()
        return _SSL_CTX


class VerifiedHTTPSConnection(http.client.HTTPSConnection):
    """HTTPS to a DNS-discovered IP with certificate verification against
    the REAL hostname: dialing the resolved IP directly would otherwise
    handshake with server_hostname=<ip literal> (no SNI), and real
    endpoints' certs carry DNS SANs only — every request would die with
    CERTIFICATE_VERIFY_FAILED."""

    def __init__(self, ip: str, port: int, *, server_hostname: str, timeout: float):
        super().__init__(ip, port, timeout=timeout)
        self._server_hostname = server_hostname
        self._verify_ctx = _default_ssl_context()

    def connect(self):
        http.client.HTTPConnection.connect(self)
        self.sock = self._verify_ctx.wrap_socket(
            self.sock, server_hostname=self._server_hostname
        )


def connect_backend(scheme: str, ip: str, port: int, host: str, timeout: float):
    """Connection to one discovered backend IP; https verifies against the
    logical host name."""
    if scheme == "https":
        return VerifiedHTTPSConnection(
            ip, port, server_hostname=host, timeout=timeout
        )
    return http.client.HTTPConnection(ip, port, timeout=timeout)


@dataclass
class S3UpstreamConfig:
    """Where and how to forward object operations."""

    endpoint: str  # e.g. "http://s3.internal:9000" — the Host header + DNS name
    bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    session_token: str | None = None
    # discovery knobs; retry_down_s None = shared resilience default
    # (LAKESOUL_RETRY_DOWN_S, 10 s)
    refresh_interval_s: float = 30.0
    retry_down_s: float | None = None
    connect_timeout_s: float = 5.0
    port: int | None = None  # derived from endpoint when None


class DnsDiscovery:
    """Resolve a hostname to backend IPs, health-check them, round-robin.

    ``resolver(host, port) -> list[ip]`` and ``health_check(ip, port) ->
    bool`` are injectable; defaults use getaddrinfo and a TCP connect.
    Per-backend failure handling is a :class:`CircuitBreaker` each
    (replacing the hand-rolled down-marking): one failure opens the
    backend's circuit for ``retry_down_s`` (``LAKESOUL_RETRY_DOWN_S`` when
    None), after which it half-opens for a probe; a reported success
    closes it.  The host-level worst state is published as
    ``lakesoul_circuit_state{circuit=<host>}``.  Resolution refreshes
    every ``refresh_interval_s``."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        resolver=None,
        health_check=None,
        refresh_interval_s: float = 30.0,
        retry_down_s: float | None = None,
        connect_timeout_s: float = 5.0,
        clock=time.monotonic,
    ):
        from lakesoul_tpu_torch.runtime.resilience import default_retry_down_s

        self.host = host
        self.port = port
        self._resolver = resolver or self._dns_resolve
        self._health = health_check  # None: health = TCP connect on refresh
        self._refresh_s = refresh_interval_s
        self._retry_down_s = (
            default_retry_down_s() if retry_down_s is None else float(retry_down_s)
        )
        self._timeout = connect_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._backends: list[str] = []
        self._breakers: dict[str, CircuitBreaker] = {}
        self._rr = 0
        self._last_refresh = float("-inf")
        self._refreshing = False

    def _breaker(self, ip: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(ip)
            if b is None:
                # name=None: per-IP labels would be unbounded cardinality —
                # the host-level gauge is published by _publish_state
                b = self._breakers[ip] = CircuitBreaker(
                    failure_threshold=1,
                    reset_timeout_s=self._retry_down_s,
                    clock=self._clock,
                )
            return b

    def _publish_state(self) -> None:
        from lakesoul_tpu_torch.obs import registry

        with self._lock:
            worst = max(
                (b.state for b in self._breakers.values()),
                default=CircuitBreaker.CLOSED,
            )
        registry().gauge("lakesoul_circuit_state", circuit=self.host).set(worst)

    @property
    def _down_until(self) -> dict[str, float]:
        """Compat view of the old down-marking table: ip → clock value when
        its OPEN circuit starts probing again."""
        with self._lock:
            breakers = dict(self._breakers)
        out = {}
        for ip, b in breakers.items():
            until = b.open_until()
            if until is not None:
                out[ip] = until
        return out

    def _dns_resolve(self, host: str, port: int) -> list[str]:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
        seen, out = set(), []
        for info in infos:
            ip = info[4][0]
            if ip not in seen:
                seen.add(ip)
                out.append(ip)
        return out

    def _tcp_alive(self, ip: str, port: int) -> bool:
        try:
            with socket.create_connection((ip, port), timeout=self._timeout):
                return True
        except OSError:
            return False

    def _maybe_refresh(self) -> None:
        """Stale-while-revalidate: at most ONE caller per interval runs the
        resolve + health checks, and it does so OUTSIDE the lock — concurrent
        requests keep using the current backend set instead of queueing
        behind multi-second TCP probes (the reference runs discovery on a
        background loop for the same reason, main.rs:306-347)."""
        with self._lock:
            now = self._clock()
            stale = now - self._last_refresh >= self._refresh_s or not self._backends
            if not stale or self._refreshing:
                return
            self._refreshing = True
        try:
            resolved = self._resolver(self.host, self.port)
            check = self._health or self._tcp_alive
            healthy = [ip for ip in resolved if check(ip, self.port)]
        except OSError as e:
            logger.warning("dns refresh for %s failed: %s", self.host, e)
            resolved, healthy = [], []
        finally:
            with self._lock:
                if healthy:
                    self._backends = healthy
                elif resolved:
                    # all checks failed: keep the resolution anyway — per-
                    # request failure reporting will rotate through them (a
                    # down health-check port must not blind the proxy to a
                    # live data port)
                    self._backends = resolved
                self._last_refresh = self._clock()
                self._refreshing = False
        if resolved:
            logger.info(
                "dns %s → %d backends (%d healthy)",
                self.host, len(resolved), len(healthy),
            )

    def pick(self) -> str:
        """One healthy backend IP (round robin); raises OSError when none."""
        self._maybe_refresh()
        deadline = time.monotonic() + self._timeout
        while True:
            with self._lock:
                if self._backends or not self._refreshing:
                    break
            # startup race: another caller's first refresh is still probing
            if time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        with self._lock:
            backends = list(self._backends)
            breakers = dict(self._breakers)
        # breaker state transitions are clock-driven; OPEN circuits sit
        # out, HALF_OPEN ones rejoin the rotation as probes
        candidates = [
            ip
            for ip in backends
            if (b := breakers.get(ip)) is None or b.state != CircuitBreaker.OPEN
        ]
        if not candidates and backends:
            # everything circuit-broken: fail open on the full set rather
            # than refusing service
            candidates = backends
        if not candidates:
            raise OSError(f"no backends for {self.host}")
        with self._lock:
            self._rr = (self._rr + 1) % len(candidates)
            return candidates[self._rr]

    def report_failure(self, ip: str) -> None:
        self._breaker(ip).record_failure()
        self._publish_state()
        logger.warning("backend %s circuit opened for %.0fs", ip, self._retry_down_s)

    def report_success(self, ip: str) -> None:
        """Close the backend's circuit after a successful request (a
        half-open probe that worked rejoins the pool for good)."""
        with self._lock:
            b = self._breakers.get(ip)
        if b is not None and b.state != CircuitBreaker.CLOSED:
            b.record_success()
            self._publish_state()

    def backends(self) -> list[str]:
        self._maybe_refresh()
        with self._lock:
            return list(self._backends)


class S3Upstream:
    """Forward object operations to the upstream, SigV4-signed (path-style:
    ``/<bucket>/<key>``)."""

    def __init__(self, config: S3UpstreamConfig, *, resolver=None, health_check=None):
        self.config = config
        scheme, _, rest = config.endpoint.partition("://")
        if rest == "":
            scheme, rest = "http", scheme
        host, _, port_s = rest.partition(":")
        self.scheme = scheme
        self.host_header = rest
        self.host = host
        self.port = config.port or (int(port_s) if port_s else (443 if scheme == "https" else 80))
        self.discovery = DnsDiscovery(
            host,
            self.port,
            resolver=resolver,
            health_check=health_check,
            refresh_interval_s=config.refresh_interval_s,
            retry_down_s=config.retry_down_s,
            connect_timeout_s=config.connect_timeout_s,
        )

    def _connect(self, ip: str) -> http.client.HTTPConnection:
        return connect_backend(
            self.scheme, ip, self.port, self.host, self.config.connect_timeout_s
        )

    def request(
        self,
        method: str,
        key: str,
        *,
        body: bytes | None = None,
        body_iter=None,
        content_length: int | None = None,
        range_header: str | None = None,
        query: str = "",
        retries: int = 1,
    ):
        """One signed request → (status, headers dict, response object).

        The response is streamed (``.read(n)``); callers must fully consume
        or close it.  ``body_iter`` streams an upload without buffering it
        (signed UNSIGNED-PAYLOAD, like the reference proxy's pass-through);
        streamed bodies can't be replayed, so only buffered/body-less
        requests retry.  On connection failure the backend is reported down
        and the request retries on the next one."""
        cfg = self.config
        # encode ONCE; the identical encoded form is signed and sent (S3
        # canonicalizes the path verbatim as received)
        path = sigv4.encode_path(f"/{cfg.bucket}/{key.lstrip('/')}")
        extra = {}
        if range_header:
            extra["range"] = range_header
        if body_iter is not None:
            payload_hash = sigv4.UNSIGNED_PAYLOAD
        elif body is not None:
            payload_hash = hashlib.sha256(body).hexdigest()
        else:
            payload_hash = sigv4.EMPTY_SHA256
        headers = sigv4.sign_request(
            method,
            self.host_header,
            path,
            query,
            extra,
            payload_hash,
            access_key=cfg.access_key,
            secret_key=cfg.secret_key,
            region=cfg.region,
            session_token=cfg.session_token,
        )
        if body is not None:
            headers["Content-Length"] = str(len(body))
        elif body_iter is not None:
            if content_length is None:
                raise ValueError("body_iter requires content_length")
            headers["Content-Length"] = str(content_length)
            retries = 0  # a consumed stream cannot be replayed

        # failover via the shared policy: each attempt picks the next
        # healthy backend (no backoff — a DIFFERENT backend is the remedy),
        # failures open that backend's circuit, success closes it
        def attempt():
            ip = self.discovery.pick()
            try:
                # connect INSIDE the reporting scope: refused/timed-out TCP
                # connects are the most common backend-down mode and must
                # open that backend's circuit like any request failure
                conn = self._connect(ip)
            except OSError as e:
                self.discovery.report_failure(ip)
                logger.warning("upstream connect to %s failed: %s", ip, e)
                raise
            try:
                wire_path = f"{path}?{sigv4.canonical_query(query)}" if query else path
                conn.request(
                    method, wire_path,
                    body=body_iter if body_iter is not None else body,
                    headers=headers,
                )
                resp = conn.getresponse()
                resp._proxy_conn = conn  # keep alive while streaming
            except OSError as e:
                conn.close()
                self.discovery.report_failure(ip)
                logger.warning("upstream %s %s via %s failed: %s", method, key, ip, e)
                raise
            self.discovery.report_success(ip)
            return resp

        policy = RetryPolicy(
            max_attempts=retries + 1, base_delay_s=0.0, jitter=0.0,
            classify=lambda e: isinstance(e, OSError),
        )
        try:
            resp = policy.run(attempt, op="proxy.upstream")
        except OSError as e:
            raise OSError(
                f"all upstream backends failed for {method} {key}: {e}"
            ) from e
        return resp.status, dict(resp.getheaders()), resp
