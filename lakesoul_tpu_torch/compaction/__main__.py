"""``python -m lakesoul_tpu_torch.compaction`` — the standalone compaction
service process (the port's copy of ``lakesoul_tpu/compaction/__main__.py``;
the role of the reference's Spark compaction-service job): polls the shared
metadata store for committed-version gaps and compacts them under
per-partition leases, so any number of these processes — of either package
— can run against one warehouse without double-compacting.

The port's tests (tests/test_torch_compaction.py) and ``chip_smoke.py``'s
freshness phase run THIS entry point as the child they SIGKILL — what is
tested is what deploys."""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "lakesoul-compactor",
        description="leased compaction service over a lakesoul warehouse",
    )
    p.add_argument("--warehouse", required=True)
    p.add_argument("--db-path", default=None)
    p.add_argument("--lease-ttl-s", type=float, default=None,
                   help="lease TTL (default LAKESOUL_LEASE_TTL_S or 30)")
    p.add_argument("--poll-s", type=float, default=None,
                   help="poll interval (default LAKESOUL_COMPACTION_POLL_S or 5)")
    p.add_argument("--min-file-num", type=int, default=2)
    p.add_argument("--version-gap", type=int, default=None,
                   help="committed-version gap that marks a partition as a"
                        " compaction candidate (default: store trigger gap)")
    p.add_argument("--service-id", default=None)
    p.add_argument("--once", action="store_true",
                   help="one poll+work cycle, print outcome counts as JSON, exit")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.compaction.service import LeasedCompactionService
    from lakesoul_tpu_torch.obs import fleet

    catalog = LakeSoulCatalog(args.warehouse, db_path=args.db_path)
    svc = LeasedCompactionService(
        catalog,
        service_id=args.service_id,
        lease_ttl_s=args.lease_ttl_s,
        poll_interval_s=args.poll_s,
        min_file_num=args.min_file_num,
        version_gap=args.version_gap,
    )
    fleet.arm("compactor", service_id=svc.service_id)
    if args.once:
        print(json.dumps(svc.poll_once()), flush=True)
        return 0
    print(
        f"compaction service {svc.service_id} polling every"
        f" {svc.poll_interval_s}s (lease ttl {svc.lease_ttl_s}s)",
        flush=True,
    )
    try:
        svc.run_forever()
    except KeyboardInterrupt:
        svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
