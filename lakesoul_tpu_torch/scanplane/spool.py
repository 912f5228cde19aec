"""Range spool: Arrow IPC segments published by workers, mapped by readers
(the port's copy of ``lakesoul_tpu/scanplane/spool.py``).

One spool segment per produced range, in the Arrow IPC **file** format so
readers get zero-copy record batches off ``pa.memory_map`` (point the
spool at tmpfs — ``/dev/shm`` — and the segment IS shared memory; the
same-host DoExchange fast path sends only the segment path over the
socket).  A JSON sidecar rides next to each segment with row/byte counts,
the producing worker + fencing token, and the per-stage
``lakesoul_scan_stage_seconds`` deltas observed while producing it.

Publication protocol (crash-safe without coordination, routed through the
sanctioned ``runtime/atomicio`` seam):

1. stage ``range-<k>.arrow.tmp-<holder>`` (write + fsync, not yet visible)
2. publish the sidecar atomically (tmp → fsync → replace)
3. commit the staged segment — the segment's rename is the publication
   barrier: readers poll for the ``.arrow`` name and only then read the
   sidecar, which is guaranteed present.

A worker SIGKILLed mid-write leaves only ``*.tmp-<holder>`` debris (swept
by the next producer of that range); two producers racing the same range
(a fenced zombie and its successor) rename byte-identical files, so
last-wins is harmless.
"""

from __future__ import annotations

import json
import os

import pyarrow as pa

from lakesoul_tpu_torch.runtime import atomicio

SEGMENT_SUFFIX = ".arrow"
SIDECAR_SUFFIX = ".json"


def segment_path(session_dir: str, index: int) -> str:
    return os.path.join(session_dir, f"range-{index:05d}{SEGMENT_SUFFIX}")


def sidecar_path(session_dir: str, index: int) -> str:
    return os.path.join(session_dir, f"range-{index:05d}{SIDECAR_SUFFIX}")


def range_ready(session_dir: str, index: int) -> bool:
    return os.path.exists(segment_path(session_dir, index))


def ready_ranges(session_dir: str) -> set[int]:
    try:
        names = os.listdir(session_dir)
    except FileNotFoundError:
        return set()
    out = set()
    for name in names:
        if name.startswith("range-") and name.endswith(SEGMENT_SUFFIX):
            try:
                out.add(int(name[len("range-"):-len(SEGMENT_SUFFIX)]))
            except ValueError:
                continue
    return out


def write_range(
    session_dir: str,
    index: int,
    schema: pa.Schema,
    batches,
    *,
    holder: str,
    meta: "dict | None" = None,
    meta_fn=None,
) -> dict:
    """Produce one range segment + sidecar via the tmp→rename protocol.

    ``batches`` is consumed lazily (the decode streams straight into the
    IPC writer — the spool never materializes a range in memory beyond one
    batch).  ``meta_fn``, when given, is called AFTER the batches are
    consumed (per-range stage deltas only exist once production finished)
    and its dict is folded into the sidecar.  Returns the sidecar dict."""
    seg = segment_path(session_dir, index)
    side = sidecar_path(session_dir, index)
    rows = 0
    batch_rows: list[int] = []

    def _produce(f):
        # a plain python file, not pa.OSFile: the IPC writer's close must
        # leave the sink open for atomicio's durability fsync
        nonlocal rows
        with pa.ipc.new_file(f, schema) as w:
            for batch in batches:
                w.write_batch(batch)
                rows += batch.num_rows
                batch_rows.append(batch.num_rows)

    staged = atomicio.stage_stream(seg, _produce, holder=holder)
    sidecar = {
        "range": index,
        "rows": rows,
        "batches": len(batch_rows),
        # per-batch row counts: resume metering and skip arithmetic stay
        # JSON math instead of re-reading the segment
        "batch_rows": batch_rows,
        "nbytes": staged.nbytes,
        "holder": holder,
        **(meta or {}),
        **(meta_fn() if meta_fn is not None else {}),
    }
    # sidecar first: once the segment name appears, its sidecar is readable
    # — the segment's commit rename is the publication barrier
    atomicio.publish_bytes(side, json.dumps(sidecar, sort_keys=True).encode())
    staged.commit()
    return sidecar


def read_sidecar(session_dir: str, index: int) -> dict:
    with open(sidecar_path(session_dir, index)) as f:
        return json.loads(f.read())


def read_range(session_dir: str, index: int) -> "tuple[pa.Schema, list[pa.RecordBatch]]":
    """Map a published segment and return its batches ZERO-COPY: the
    batches are views over the mapping, which Arrow keeps alive through
    buffer parents until the last consumer drops its view — so the reader
    handle can close immediately (no dangling-pointer window)."""
    with pa.memory_map(segment_path(session_dir, index)) as source:
        with pa.ipc.open_file(source) as reader:
            schema = reader.schema
            batches = [
                reader.get_batch(i) for i in range(reader.num_record_batches)
            ]
    return schema, batches


def sweep_tmp_debris(session_dir: str, index: int) -> None:
    """Remove tmp files a dead producer left for one range (called by the
    next lease holder before producing — the lease serializes sweepers)."""
    prefixes = (
        os.path.basename(segment_path(session_dir, index)) + ".tmp-",
        os.path.basename(sidecar_path(session_dir, index)) + ".tmp-",
    )
    try:
        names = os.listdir(session_dir)
    except FileNotFoundError:
        return
    for name in names:
        if any(name.startswith(p) for p in prefixes):
            try:
                os.unlink(os.path.join(session_dir, name))
            except OSError:
                continue
    return
