"""``python -m lakesoul_tpu_torch.fleet`` — the fleet-plane process entries,
the port of ``lakesoul_tpu/fleet/__main__.py``.

- ``train``: one emulated training host.  Resolves its position on the
  data axis (``LAKESOUL_FLEET_PROCESS_INDEX``/``_COUNT``, else
  ``torch.distributed``'s rank and world size), consumes its shard through
  ``to_torch_iter(multihost=True)`` — on the CUDA card (raising without
  one), or as host arrays with ``--device cpu`` — and prints ``{rows,
  batches, sha256, ...}`` hashed over the collated batches' bytes, the
  per-rank identity oracle compared against single-process shard scans.
  ``--device-put`` is accepted, as the reference's command line has it:
  the card is already the default.  ``--location`` reads the shard through
  a scan-plane gateway instead of decoding in-process.
- ``autoscale``: the leased worker controller.  Watches one spool's
  backlog (plus the obs fleet's merged SLO view when armed) and sizes a
  ``python -m lakesoul_tpu_torch.scanplane worker`` fleet between
  ``--min/--max``.  Every action is one JSON line on stdout (``{"event":
  "spawn", "pid": ...}``, the reference's lines) so a parent can watch
  spawns, takeovers and backfills without scraping logs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import time


def _cmd_autoscale(args) -> int:
    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.obs import fleet
    from lakesoul_tpu_torch.fleet.autoscale import (
        WorkerAutoscaler,
        WorkerSpawner,
        emit_jsonl,
    )

    catalog = LakeSoulCatalog(args.warehouse, db_path=args.db_path)
    spawner = WorkerSpawner(
        args.warehouse,
        args.spool,
        db_path=args.db_path,
        lease_ttl_s=args.worker_lease_ttl_s,
        poll_s=args.worker_poll_s,
    )
    controller = WorkerAutoscaler(
        catalog.client.store,
        spawner,
        spool_dir=args.spool,
        min_workers=args.min_workers,
        max_workers=args.max_workers,
        controller_id=args.controller_id,
        lease_ttl_s=args.lease_ttl_s,
    )
    fleet.arm("fleet-autoscaler", service_id=controller.controller_id)
    emit_jsonl({
        "event": "autoscaler",
        "controller": controller.controller_id,
        "spool": args.spool,
        "min": controller.policy.min_workers,
        "max": controller.policy.max_workers,
    })
    try:
        controller.run_forever(poll_s=args.poll_s, on_event=emit_jsonl)
    except KeyboardInterrupt:
        pass
    finally:
        controller.stop()
    return 0


def _cmd_train(args) -> int:
    import torch

    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.fleet.multihost import digest_batch, process_axis
    from lakesoul_tpu_torch.obs import fleet
    from lakesoul_tpu_torch.obs.tracing import span

    index, count = process_axis()
    fleet.arm("fleet-train", service_id=f"rank{index}")
    catalog = LakeSoulCatalog(args.warehouse, db_path=args.db_path)
    scan = catalog.scan(args.table, args.namespace).batch_size(args.batch_size)
    if args.location:
        scan = scan.via_scanplane(args.location)
    local_devices = torch.cuda.device_count()
    digest = hashlib.sha256()
    rows = 0
    batches = 0
    started_unix = time.time()
    start = time.perf_counter()
    with span("fleet.train.consume", table=args.table, rank=index):
        # the iterator's own default puts each batch on the card and raises
        # without one; `--device cpu` keeps the host arrays
        host = {"device_put": False} if args.device == "cpu" else {}
        it = scan.to_torch_iter(multihost=True, drop_remainder=False, **host)
        for batch in it:
            # hash each collated batch's bytes key by key (a card batch is
            # copied back first): deterministic for equal contents wherever
            # the batch lies, so the same loop over a single-process
            # scan.shard(rank, world) is the byte-identity oracle
            rows += digest_batch(digest, batch)
            batches += 1
            if args.step_s:
                # emulated per-batch training step: the host's devices are
                # busy for a fixed wall slice
                time.sleep(args.step_s)
    elapsed = time.perf_counter() - start
    print(json.dumps({
        "rows": rows,
        "batches": batches,
        "sha256": digest.hexdigest(),
        "elapsed_s": round(elapsed, 4),
        "started_unix": started_unix,
        "ended_unix": time.time(),
        "process_index": index,
        "process_count": count,
        "local_devices": local_devices,
    }), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "lakesoul-fleet",
        description="fleet plane: worker autoscaling + multi-host trainers",
    )
    sub = p.add_subparsers(dest="role")

    pa_ = sub.add_parser("autoscale", help="leased scanplane worker controller")
    pa_.add_argument("--warehouse", required=True)
    pa_.add_argument("--db-path", default=None)
    pa_.add_argument("--spool", required=True)
    pa_.add_argument("--min-workers", type=int, default=None,
                     help="floor (default LAKESOUL_FLEET_MIN_WORKERS or 1)")
    pa_.add_argument("--max-workers", type=int, default=None,
                     help="ceiling (default LAKESOUL_FLEET_MAX_WORKERS or 8)")
    pa_.add_argument("--lease-ttl-s", type=float, default=10.0,
                     help="controller lease TTL (fail-over bound)")
    pa_.add_argument("--poll-s", type=float, default=1.0)
    pa_.add_argument("--controller-id", default=None)
    pa_.add_argument("--worker-lease-ttl-s", type=float, default=None)
    pa_.add_argument("--worker-poll-s", type=float, default=None)
    pa_.set_defaults(fn=_cmd_autoscale)


    pt = sub.add_parser("train", help="one emulated training host (rows + sha256)")
    pt.add_argument("--warehouse", required=True)
    pt.add_argument("--db-path", default=None)
    pt.add_argument("--table", required=True)
    pt.add_argument("--namespace", default="default")
    pt.add_argument("--batch-size", type=int, default=8192)
    pt.add_argument("--location", default=None,
                    help="scanplane gateway location; omit to decode in-process")
    pt.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: batches on the card (raises without one); cpu: host arrays")
    pt.add_argument("--device-put", action="store_true",
                    help="the reference's flag for batches on the device: the default here")
    pt.add_argument("--step-s", type=float, default=0.0,
                    help="emulated per-batch training-step seconds (bench"
                         " knob: makes consumption device-bound)")
    pt.set_defaults(fn=_cmd_train)

    args = p.parse_args(argv)
    if args.role is None:
        p.error("choose a role: autoscale | train")
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
