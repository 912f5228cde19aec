"""Spool-segment transport seam: shm, object-store spill, Flight stream (the
port's copy of ``lakesoul_tpu/fleet/transport.py``).

A produced range lives in the spool as one sealed Arrow IPC segment.  How
its bytes reach a trainer is the TRANSPORT — negotiated per exchange, one
of three rungs:

- ``shm``: the same-host fast path.  The client proves it can read the spool
  (manifest probe + session token) and maps the segment zero-copy; only
  the range's control message crosses the socket.
- ``spill``: the cross-host object-store rung.  The delivery head copies
  the sealed segment to ``<prefix>/<session>/range-<k>.arrow`` with a CRC
  sidecar (tmp → fsync → rename, the spool's own publication discipline)
  through the resilient fs; the client — any host with same-region store
  access — pulls the bytes back through the resilient fs and verifies the
  CRC before decoding.  Spill files are pruned WITH their session: a
  session manifest gone from the spool retires its spill directory.
- ``stream``: the Flight host-to-host floor — record batches on the
  exchange's data plane, no shared medium required.

Negotiation ladder (client side, per exchange): a forced transport
(``LAKESOUL_FLEET_TRANSPORT`` or the client kwarg) short-circuits; auto
probes shm, then spill, then falls back to stream.  Every rung's probe is
*prove you can read*: a token file the server wrote, read back over the
candidate medium.

Per-transport delivery is metered into the obs registry
(``lakesoul_fleet_transport_bytes_total{transport=}``,
``lakesoul_fleet_transport_seconds{transport=}``,
``lakesoul_fleet_transport_ranges_total{transport=}``) plus one
``lakesoul_fleet_transport_negotiated_total{transport=}`` tick per
exchange — the fleet aggregator and ``console fleet-status`` read these
back as the per-member transport column.
"""

from __future__ import annotations

import json
import logging
import os
import posixpath
import zlib

import pyarrow as pa

from lakesoul_tpu_torch.errors import ConfigError, IOError_
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.runtime import atomicio

logger = logging.getLogger(__name__)

ENV_TRANSPORT = "LAKESOUL_FLEET_TRANSPORT"
ENV_SPILL = "LAKESOUL_FLEET_SPILL"

TRANSPORTS = ("shm", "spill", "stream")

_PROBE_PREFIX = "probe-"
_CRC_SUFFIX = ".crc"


def forced_transport(value: str | None = None) -> str | None:
    """The operator's transport override: the explicit ``value`` (client
    kwarg) wins, else ``LAKESOUL_FLEET_TRANSPORT``; ``auto``/unset means
    negotiate.  Unknown names fail loudly — a typo'd override silently
    falling back to auto would defeat the point of forcing one."""
    raw = value if value is not None else os.environ.get(ENV_TRANSPORT)
    if raw is None or raw == "" or raw == "auto":
        return None
    if raw not in TRANSPORTS:
        raise ConfigError(
            f"unknown fleet transport {raw!r}; expected one of"
            f" {('auto',) + TRANSPORTS}"
        )
    return raw


def spill_prefix() -> str | None:
    """The configured object-store spill prefix (server side)."""
    return os.environ.get(ENV_SPILL) or None


# ---------------------------------------------------------------- metering


def negotiated(transport: str) -> None:
    registry().counter(
        "lakesoul_fleet_transport_negotiated_total", transport=transport
    ).inc()


def meter_range(transport: str, nbytes: int, seconds: float) -> None:
    """One delivered range's cost on one transport (client side: the
    consumer is where cross-host bytes/latency are felt)."""
    reg = registry()
    reg.counter(
        "lakesoul_fleet_transport_ranges_total", transport=transport
    ).inc()
    reg.counter(
        "lakesoul_fleet_transport_bytes_total", transport=transport
    ).inc(max(0, int(nbytes)))
    reg.histogram(
        "lakesoul_fleet_transport_seconds", transport=transport
    ).observe(max(0.0, float(seconds)))


# ------------------------------------------------------------- spill (server)


def _fs_for(path: str, *, write: bool = False):
    from lakesoul_tpu_torch.io.object_store import filesystem_for

    return filesystem_for(path, write=write)


def spill_session_dir(prefix: str, session_id: str) -> str:
    return posixpath.join(prefix, session_id)


def spill_segment_path(prefix: str, session_id: str, index: int) -> str:
    return posixpath.join(prefix, session_id, f"range-{index:05d}.arrow")


def spill_probe_path(prefix: str, session_id: str) -> str:
    return posixpath.join(prefix, f"{_PROBE_PREFIX}{session_id}.json")


def write_spill_probe(prefix: str, session_id: str) -> dict:
    """Publish the spill offer's probe file (idempotent): a token document
    any same-region reader can pull back.  Returns the offer dict the
    hello message carries."""
    path = spill_probe_path(prefix, session_id)
    fs, p = _fs_for(path, write=True)
    if not fs.exists(p):
        fs.makedirs(posixpath.dirname(p) or "/", exist_ok=True)
        atomicio.publish_bytes_fs(
            fs, p, json.dumps({"session": session_id}).encode()
        )
    return {"prefix": prefix, "probe": path, "token": session_id}


def spill_range(prefix: str, session_id: str, spool_session_dir: str, index: int) -> dict:
    """Persist one sealed spool segment to the spill prefix (idempotent —
    the CRC sidecar is the publication barrier, written LAST so a reader
    that sees it can trust the segment bytes fully landed).  Returns the
    range message's ``spill`` payload: ``{path, crc32, nbytes}``.

    Local filesystems get the spool's own tmp→fsync→rename discipline;
    object stores (whose PUT is already atomic) ride the resilient fs
    wrapper, so transient store failures retry underneath."""
    from lakesoul_tpu_torch.scanplane import spool as spool_mod

    seg = spill_segment_path(prefix, session_id, index)
    crc_path = seg + _CRC_SUFFIX
    fs, crc_p = _fs_for(crc_path, write=True)
    if fs.exists(crc_p):
        with fs.open(crc_p, "rb") as f:
            return json.loads(f.read().decode())
    src = spool_mod.segment_path(spool_session_dir, index)
    with open(src, "rb") as f:
        payload = f.read()
    fs_seg, seg_p = _fs_for(seg, write=True)
    fs_seg.makedirs(posixpath.dirname(seg_p), exist_ok=True)
    atomicio.publish_bytes_fs(fs_seg, seg_p, payload)
    doc = {
        "path": seg,
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        "nbytes": len(payload),
    }
    # the CRC doc is the barrier: published only after the segment bytes
    # are durable above
    atomicio.publish_bytes_fs(fs, crc_p, json.dumps(doc, sort_keys=True).encode())
    return doc


def prune_spill(prefix: str, live_sessions: "set[str]") -> int:
    """Retire spill directories (and probe files) whose session manifest
    is gone from the spool — the spill mirrors the spool's lifecycle, so
    the session pruner is its pruner too.  Best-effort: a concurrent
    reader mid-pull sees a vanished object as a transient and resumes."""
    try:
        fs, p = _fs_for(prefix)
        names = [posixpath.basename(n.rstrip("/")) for n in fs.ls(p, detail=False)]
    except (OSError, FileNotFoundError):
        return 0
    pruned = 0
    for name in names:
        if name.startswith(_PROBE_PREFIX) and name.endswith(".json"):
            sid = name[len(_PROBE_PREFIX):-len(".json")]
            if sid not in live_sessions:
                try:
                    fs.rm_file(posixpath.join(p, name))
                except (OSError, FileNotFoundError):
                    pass
            continue
        if name not in live_sessions:
            try:
                fs.rm(posixpath.join(p, name), recursive=True)
                pruned += 1
            except (OSError, FileNotFoundError):
                continue
    return pruned


# ------------------------------------------------------------- spill (client)


def spill_probe_matches(offer: "dict | None") -> bool:
    """Client-side spill probe: pull the offer's probe object through the
    resilient fs and match the session token — proves this process can
    read the spill prefix (same region / shared credentials) before the
    exchange commits to the spill rung."""
    if not offer:
        return False
    try:
        fs, p = _fs_for(offer["probe"])
        with fs.open(p, "rb") as f:
            doc = json.loads(f.read().decode())
        return doc.get("session") == offer.get("token")
    except (OSError, ValueError, KeyError):
        return False


def fetch_spilled(spill: dict) -> "tuple[int, list[pa.RecordBatch]]":
    """Pull one spilled segment, verify its CRC, decode its batches.
    Returns ``(nbytes, batches)``.  A CRC mismatch is a loud IO error —
    a torn or truncated object must never decode into silently-wrong
    training data."""
    fs, p = _fs_for(spill["path"])
    with fs.open(p, "rb") as f:
        payload = f.read()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(spill["crc32"]) or len(payload) != int(spill["nbytes"]):
        raise IOError_(
            f"spilled segment {spill['path']} failed verification"
            f" (crc {crc:#x} != {int(spill['crc32']):#x} or"
            f" {len(payload)} != {spill['nbytes']} bytes)"
        )
    with pa.ipc.open_file(pa.BufferReader(payload)) as reader:
        batches = [
            reader.get_batch(i) for i in range(reader.num_record_batches)
        ]
    return len(payload), batches
