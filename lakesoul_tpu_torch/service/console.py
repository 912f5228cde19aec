"""Interactive console / CLI over a warehouse (the port's copy of
``lakesoul_tpu/service/console.py``).

Role parity with the reference's lakesoul-console (rust/lakesoul-console:
exec_from_repl + file exec): inspect tables, scan with filters, write files,
compact, clean — without an engine.  Usable as a REPL
(``python -m lakesoul_tpu_torch.service.console -w /path/wh``) or one-shot
(``... -c "scan mytable limit 5"``).  Its SQL runs on the CUDA card unless
given ``--device cpu`` (a ``CALL build_vector_index`` builds there); ``lint``
runs the port's lakelint (``lakesoul_tpu_torch.analysis``) and prints what its
CLI prints."""

from __future__ import annotations

import argparse
import shlex
import sys


class Console:
    SQL_STARTS = (
        "select", "insert", "create", "drop", "show", "describe", "alter",
        "call", "update", "delete", "with", "explain",
    )

    def __init__(self, catalog, *, device=None):
        self.catalog = catalog
        from lakesoul_tpu_torch.sql import SqlSession

        self.sql = SqlSession(catalog, device=device)

    def execute(self, line: str) -> str:
        stripped = line.strip().rstrip(";")
        if not stripped:
            return ""
        words = stripped.lower().split()
        first = words[0]
        # `show`/`drop` are both console commands and SQL keywords: the SQL
        # forms are `show tables` / `drop table …`
        is_sql = first in self.SQL_STARTS and not (
            (first == "show" and (len(words) < 2 or words[1] != "tables"))
            or (first == "drop" and (len(words) < 2 or words[1] != "table"))
        )
        try:
            if is_sql:
                return self.sql.execute(stripped).to_pandas().to_string()
            toks = shlex.split(stripped)
            cmd, args = toks[0].lower().replace("-", "_"), toks[1:]
            handler = getattr(self, f"cmd_{cmd}", None)
            if handler is None:
                return f"unknown command: {cmd!r} (try 'help')"
            return handler(args)
        except Exception as e:  # surfaced, not fatal — it's a REPL
            return f"error: {type(e).__name__}: {e}"

    # ---------------------------------------------------------------- cmds
    def cmd_help(self, args) -> str:
        return (
            "SQL: SELECT / INSERT INTO / CREATE TABLE / DROP TABLE / SHOW TABLES / DESCRIBE\n"
            "commands:\n"
            "  tables                       list tables\n"
            "  show <table>                 schema + properties\n"
            "  scan <table> [limit N]       print rows\n"
            "  count <table>                row count\n"
            "  write <table> <parquet>      append a parquet file's rows\n"
            "  compact <table>              compact all partitions\n"
            "  versions <table>             partition version chains\n"
            "  assets                       per-table data-asset statistics\n"
            "  clean                        run the cleaner (TTLs, discard list)\n"
            "  cache-stats                  page cache counters (via the obs registry)\n"
            "  obs-stats [prefix]           full metrics-registry snapshot\n"
            "  fleet-status [spool]         aggregated fleet view of an obs spool\n"
            "                               (default LAKESOUL_OBS_SPOOL)\n"
            "  lint [--rule ID] [--format text|json|sarif]\n"
            "                               lakelint static analysis over the package\n"
            "  user-add <name> <pw> [group] register a gateway/proxy user\n"
            "  drop <table>                 drop a table\n"
            "  quit"
        )

    def cmd_tables(self, args) -> str:
        out = []
        for ns in self.catalog.list_namespaces():
            for t in self.catalog.list_tables(ns):
                out.append(f"{ns}.{t}")
        return "\n".join(out) or "(no tables)"

    def cmd_show(self, args) -> str:
        t = self.catalog.table(args[0])
        info = t.info
        lines = [f"table: {info.table_namespace}.{info.table_name}",
                 f"path: {info.table_path}",
                 f"primary keys: {info.primary_keys}",
                 f"range partitions: {info.range_partition_columns}",
                 f"properties: {info.properties}",
                 "schema:"]
        for fld in t.schema:
            lines.append(f"  {fld.name}: {fld.type}")
        return "\n".join(lines)

    def cmd_scan(self, args) -> str:
        name = args[0]
        limit = None
        if len(args) >= 3 and args[1].lower() == "limit":
            limit = int(args[2])
        table = self.catalog.table(name).to_arrow()
        if limit is not None:
            table = table.slice(0, limit)
        return table.to_pandas().to_string()

    def cmd_count(self, args) -> str:
        return str(self.catalog.table(args[0]).scan().count_rows())

    def cmd_write(self, args) -> str:
        import pyarrow.parquet as pq

        t = self.catalog.table(args[0])
        data = pq.read_table(args[1])
        files = t.write_arrow(data)
        return f"wrote {data.num_rows} rows in {len(files)} files"

    def cmd_compact(self, args) -> str:
        n = self.catalog.table(args[0]).compact()
        return f"compacted {n} partitions"

    def cmd_versions(self, args) -> str:
        t = self.catalog.table(args[0])
        store = self.catalog.client.store
        lines = []
        for head in store.get_all_latest_partition_info(t.info.table_id):
            for v in store.get_partition_versions(t.info.table_id, head.partition_desc):
                lines.append(
                    f"{head.partition_desc} v{v.version} {v.commit_op.value}"
                    f" commits={len(v.snapshot)} ts={v.timestamp}"
                )
        return "\n".join(lines) or "(empty)"

    def cmd_assets(self, args) -> str:
        from lakesoul_tpu_torch.service.assets import count_data_assets

        return count_data_assets(self.catalog).to_arrow().to_pandas().to_string()

    def cmd_clean(self, args) -> str:
        from lakesoul_tpu_torch.compaction import Cleaner

        result = Cleaner(self.catalog).clean_all()
        return " ".join(f"{k}={v}" for k, v in result.items())

    def cmd_user_add(self, args) -> str:
        if len(args) < 2:
            return "usage: user-add <name> <password> [group]"
        from lakesoul_tpu_torch.service.jwt import UserRegistry

        group = args[2] if len(args) > 2 else "public"
        UserRegistry(self.catalog.client).register(args[0], args[1], group=group)
        return f"registered user {args[0]} (group {group})"

    def cmd_cache_stats(self, args) -> str:
        # instantiating the configured cache (if any) registers it; the
        # numbers then come from the registry-backed aggregate, so every
        # cache the process opened is covered, not just the configured dir
        from lakesoul_tpu_torch.io.object_store import cache_stats

        cache_stats(self.catalog.storage_options)
        from lakesoul_tpu_torch.io.page_cache import registry_cache_stats

        stats = registry_cache_stats()
        return " ".join(f"{k}={v}" for k, v in stats.items())

    def cmd_obs_stats(self, args) -> str:
        """Dump the process-wide metrics registry (optionally filtered by a
        series-name prefix, e.g. ``obs-stats lakesoul_cache``)."""
        from lakesoul_tpu_torch.obs import registry

        prefix = args[0] if args else ""
        lines = []
        for name, value in sorted(registry().snapshot().items()):
            if not name.startswith(prefix):
                continue
            if isinstance(value, dict):  # histogram → compact summary
                mean = (value["sum"] / value["count"]) if value["count"] else 0.0
                lines.append(
                    f"{name} count={value['count']} sum={value['sum']:.6f}"
                    f" mean={mean:.6f}"
                )
            else:
                lines.append(f"{name} {value}")
        return "\n".join(lines) or "(no metrics recorded)"

    def cmd_fleet_status(self, args) -> str:
        """Aggregate an obs spool (``fleet-status [spool-dir]``; default
        ``LAKESOUL_OBS_SPOOL``): members with heartbeat staleness, the
        north-star rows/s figures, fleet-wide SLO state, and any crash
        postmortems recoverable from the spool."""
        import os

        from lakesoul_tpu_torch.obs import FleetAggregator

        spool = args[0] if args else os.environ.get("LAKESOUL_OBS_SPOOL", "")
        if not spool:
            return "fleet-status: no spool (pass a dir or set LAKESOUL_OBS_SPOOL)"
        agg = FleetAggregator(spool)
        doc = agg.aggregate()
        if not doc["members"]:
            return f"fleet-status: no members published under {spool}"
        lines = [f"fleet @ {spool} ({len(doc['members'])} members,"
                 f" stale after {doc['stale_after_s']}s):"]
        for m in sorted(doc["members"], key=lambda m: (m["role"], m["service_id"])):
            mark = "STALE" if m["stale"] else "live"
            # transport column: which fleet-transport rung this member
            # negotiated (dominant by bytes) and how much it moved — "-"
            # for members that never touched the seam
            via = (
                f"{m['transport']}:{m['transport_bytes']}B"
                if m.get("transport") else "-"
            )
            lines.append(
                f"  {m['role']:<18} {m['service_id']:<28} pid={m['pid']}"
                f" heartbeat_age={m['heartbeat_age_s']:.1f}s"
                f" transport={via} [{mark}]"
            )
        f = doc["fleet"]
        lines.append(
            f"north star: {f['rows']} rows / {f['window_s']}s ="
            f" {f['rows_per_s']} rows/s"
            + (f" ({f['rows_per_s_per_chip']} rows/s/chip on {f['chips']}"
               f" chips)" if f["chips"] else " (no chips reported)")
        )
        fr = doc["slos"]["freshness"]
        lines.append(
            f"freshness SLO: {fr['violations']}/{fr['count']} over"
            f" {fr['target_s']}s target (allowed {fr['allowed_violations']})"
            f" → {'IN BUDGET' if fr['in_budget'] else 'BREACHED'}"
            f" p50={fr['p50_s']}s p99={fr['p99_s']}s"
        )
        pms = agg.postmortems()
        for pm in pms:
            last = pm["events"][-1] if pm["events"] else None
            lines.append(
                f"postmortem: {pm['role']} {pm['service_id']} (pid {pm['pid']})"
                f" — {len(pm['events'])} events, {len(pm['spans'])} spans;"
                f" last event: {last['name'] if last else '(none)'}"
            )
        return "\n".join(lines)

    def cmd_lint(self, args) -> str:
        """Run lakelint (the project-native static analysis) over the
        installed package with the checked-in baseline — same checks, same
        ``--rule``/``--format`` filters and the same bytes as
        ``python -m lakesoul_tpu_torch.analysis`` prints on its standard
        output; stale baseline entries go to standard error, as there.

        Usage: ``lint [--rule ID]... [--format text|json|sarif]``"""
        from lakesoul_tpu_torch.analysis import Baseline, EngineError, run
        from lakesoul_tpu_torch.analysis.__main__ import (
            FORMATS, _select_rules, render, report_stale,
        )
        from lakesoul_tpu_torch.analysis.engine import default_baseline_path

        rule_ids: list[str] = []
        fmt = "text"
        it = iter(args)
        for tok in it:
            if tok == "--rule":
                rule_ids.append(next(it, ""))
            elif tok == "--format":
                fmt = next(it, "text")
            else:
                return f"lint: unknown argument {tok!r}"
        if fmt not in FORMATS:
            return f"lint: unknown format {fmt!r} (choose from {'/'.join(FORMATS)})"
        try:
            rules = _select_rules(rule_ids or None)
            findings, baseline = run(
                rules=rules, baseline=Baseline.load(default_baseline_path())
            )
        except EngineError as e:
            return f"lint: engine error: {e}"
        if not rule_ids:  # a rule filter makes other entries look stale
            report_stale(baseline)
        return render(findings, rules, fmt)

    def cmd_drop(self, args) -> str:
        self.catalog.drop_table(args[0])
        return f"dropped {args[0]}"

    # ---------------------------------------------------------------- repl
    def repl(self) -> None:
        print("lakesoul_tpu_torch console — 'help' for commands")
        while True:
            try:
                line = input("lakesoul> ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip().lower() in ("quit", "exit"):
                break
            out = self.execute(line)
            if out:
                print(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="lakesoul_tpu_torch console")
    parser.add_argument("-w", "--warehouse", required=True)
    parser.add_argument("-c", "--command", help="run one command and exit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where SQL runs on a device (cuda raises without a card)")
    args = parser.parse_args(argv)
    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.device import resolve_device
    from lakesoul_tpu_torch.obs import configure_logging

    resolve_device(args.device)  # no card: ConfigError, never the CPU in its place
    configure_logging()  # LAKESOUL_LOG_FORMAT=json selects structured logs
    console = Console(LakeSoulCatalog(args.warehouse), device=args.device)
    if args.command:
        print(console.execute(args.command))
        return 0
    console.repl()
    return 0


if __name__ == "__main__":
    sys.exit(main())
