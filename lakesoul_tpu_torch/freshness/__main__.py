"""``python -m lakesoul_tpu_torch.freshness`` — freshness-harness process
roles (the port's copy of ``lakesoul_tpu/freshness/__main__.py``).

``writer`` is the real CDC-ingest process of the three-role harness
(``tests/test_torch_freshness.py``, ``chip_smoke.py``'s freshness phase): it
streams checkpointed upserts into a CDC table at a declared cadence and
prints an **oracle** JSON line the follower's delivery is judged against —
total rows, a sha256 over the sorted ``(seq, id, v)`` tuples (delivery
order is bucket-grouped, so the oracle is order-invariant), and the
per-checkpoint commit instants.  The line, commit ids and rows are the
reference writer's, so either package's follower judges either's writer.

Every row carries a unique, strictly-increasing ``seq``, so "delivered
rows exactly match the oracle" is a sha comparison with no dedup
ambiguity; ``id`` cycles a bounded keyspace so successive checkpoints are
genuine UPSERTS (same PKs re-written) and compaction has real merge work.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def _row_value(seq: int) -> float:
    # deterministic value stream: oracle and delivery hash the same floats
    return float((seq * 2654435761) % 1_000_003) / 997.0


def oracle_sha(rows: "list[tuple[int, int, float]]") -> str:
    h = hashlib.sha256()
    for seq, id_, v in sorted(rows):
        h.update(f"{seq}:{id_}:{v:.6f};".encode())
    return h.hexdigest()


def run_writer(args) -> dict:
    import pyarrow as pa

    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.obs import fleet, registry
    from lakesoul_tpu_torch.obs.tracing import span
    from lakesoul_tpu_torch.streaming.cdc import CheckpointedWriter

    fleet.arm("freshness-writer")
    c_rows = registry().counter("lakesoul_writer_rows_total")
    catalog = LakeSoulCatalog(args.warehouse, db_path=args.db_path)
    schema = pa.schema([
        ("id", pa.int64()),
        ("seq", pa.int64()),
        ("v", pa.float64()),
    ])
    if args.create and not catalog.table_exists(args.table):
        catalog.create_table(
            args.table,
            schema,
            primary_keys=["id"],
            hash_bucket_num=args.hash_buckets,
            cdc=True,
        )
    table = catalog.table(args.table)
    cdc_col = table.info.cdc_column
    writer = CheckpointedWriter(table)

    rows: list[tuple[int, int, float]] = []
    commit_ts: list[int] = []
    seq = 0
    for ckpt in range(args.commits):
        ids, seqs, vals, kinds = [], [], [], []
        for _ in range(args.rows_per_commit):
            # ids cycle the keyspace but stay unique WITHIN a commit (the
            # follower reads per-commit units raw, so an in-commit dup
            # would be merge-collapsed and break the oracle)
            id_ = seq % args.keyspace
            v = _row_value(seq)
            ids.append(id_)
            seqs.append(seq)
            vals.append(v)
            kinds.append("insert" if seq < args.keyspace else "update")
            rows.append((seq, id_, v))
            seq += 1
        # the COMMIT leg of the end-to-end trace: a root span joins the
        # spawning harness's trace via LAKESOUL_TRACE_ID, so the fleet
        # spool can assemble commit → worker-decode → client-delivery
        with span("freshness.commit", ckpt=ckpt, rows=args.rows_per_commit):
            writer.write(pa.table(
                {"id": ids, "seq": seqs, "v": vals, cdc_col: kinds},
                schema=table.schema,
            ))
            writer.checkpoint(ckpt)
        c_rows.inc(len(ids))
        commit_ts.append(int(time.time() * 1000))
        if args.interval_s > 0 and ckpt + 1 < args.commits:
            time.sleep(args.interval_s)
    return {
        "role": "writer",
        "table": args.table,
        "rows": len(rows),
        "commits": args.commits,
        "sha256": oracle_sha(rows),
        "commit_timestamps_ms": commit_ts,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "lakesoul-freshness",
        description="freshness-harness process roles",
    )
    sub = p.add_subparsers(dest="role", required=True)
    w = sub.add_parser("writer", help="stream checkpointed CDC upserts")
    w.add_argument("--warehouse", required=True)
    w.add_argument("--db-path", default=None)
    w.add_argument("--table", default="fresh")
    w.add_argument("--commits", type=int, default=20)
    w.add_argument("--rows-per-commit", type=int, default=1000)
    w.add_argument("--interval-s", type=float, default=0.2)
    w.add_argument("--keyspace", type=int, default=4096)
    w.add_argument("--hash-buckets", type=int, default=2)
    w.add_argument("--create", action="store_true")
    w.add_argument("--oracle-out", default=None,
                   help="also write the oracle JSON to this path (atomic)")
    args = p.parse_args(argv)

    if args.rows_per_commit > args.keyspace:
        p.error("--rows-per-commit must not exceed --keyspace"
                " (in-commit duplicate PKs would merge-collapse)")
    oracle = run_writer(args)
    line = json.dumps(oracle, sort_keys=True)
    if args.oracle_out:
        # tmp→fsync→rename: a bare tmp+replace could land an empty oracle
        # doc after a host crash (rename without fsync)
        from lakesoul_tpu_torch.runtime import atomicio

        atomicio.publish_bytes(args.oracle_out, line.encode())
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
