"""The port's console (``lakesoul_tpu_torch/service/console.py``) against the
reference's (``lakesoul_tpu/service/console.py``).

- The reference's console tests (in ``test_gateway.py``, ``test_obs.py``,
  ``test_obs_fleet.py``, ``test_sql.py``, ``test_analysis.py`` and
  ``test_analysis_clean.py``), each with a counterpart here, on the CPU.
  ``lint`` runs the port's lakelint and prints what its CLI
  (``python -m lakesoul_tpu_torch.analysis``) prints for the same filters.
- On one warehouse the two consoles print the same thing for the same
  commands and statements.
- The command line: ``-c`` runs one command, the REPL reads standard input,
  and ``--device cuda`` (the default) refuses to start without a card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pytest

from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.service.console import Console as RefConsole
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.service.console import Console

SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64())])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINT_CLEAN = "lint clean: no unsuppressed findings"


def _console(tmp_warehouse):
    return Console(LakeSoulCatalog(str(tmp_warehouse)), device="cpu")


def test_console_commands(tmp_warehouse):
    cat = LakeSoulCatalog(str(tmp_warehouse))
    cat.create_table("t", SCHEMA, primary_keys=["id"]).write_arrow(
        pa.table({"id": [1, 2], "v": [1.0, 2.0]}))
    c = Console(cat, device="cpu")
    assert "default.t" in c.execute("tables")
    assert "primary keys: ['id']" in c.execute("show t")
    assert c.execute("count t") == "2"
    assert "v0" in c.execute("versions t")
    assert "unknown command" in c.execute("bogus")
    assert "error:" in c.execute("show nope")
    c.execute("drop t")
    assert c.execute("tables") == "(no tables)"


def test_obs_stats_console_command(tmp_warehouse):
    c = _console(tmp_warehouse)
    c.catalog.create_table("obs_c", SCHEMA).write_arrow(pa.table({"id": [1], "v": [1.0]}))
    assert "lakesoul_meta_commits_total" in c.execute("obs-stats lakesoul_meta")
    cache_out = c.execute("cache-stats")
    assert "hits=" in cache_out and "hit_rate=" in cache_out


def _member(spool, *, role, service_id, snapshot, kinds=None, heartbeat_unix=None,
            started_unix=None):
    now = time.time()
    doc = {"role": role, "service_id": service_id, "pid": 1234, "host": "h1",
           "started_unix": now - 10.0 if started_unix is None else started_unix,
           "heartbeat_unix": now if heartbeat_unix is None else heartbeat_unix,
           "chips": 0, "kinds": kinds or {}, "snapshot": snapshot}
    with open(os.path.join(spool, f"member-{service_id}.json"), "w") as f:
        json.dump(doc, f)


def _recorder(spool, *, role, service_id, events):
    doc = {"role": role, "service_id": service_id, "pid": 1234, "heartbeat_unix": time.time(),
           "reason": "test", "events": list(events), "spans": []}
    with open(os.path.join(spool, f"recorder-{service_id}.json"), "w") as f:
        json.dump(doc, f)


@pytest.fixture()
def spool(tmp_path):
    d = tmp_path / "obs-spool"
    d.mkdir()
    return str(d)


def test_fleet_status_renders_members_north_star_and_postmortems(tmp_warehouse, spool):
    now = time.time()
    _member(spool, role="scanplane-worker", service_id="w1",
            snapshot={"lakesoul_scanplane_client_rows_total": 500},
            kinds={"lakesoul_scanplane_client_rows_total": "counter"}, started_unix=now - 10.0)
    _member(spool, role="compactor", service_id="dead1", snapshot={},
            heartbeat_unix=now - 120.0, started_unix=now - 200.0)
    _recorder(spool, role="compactor", service_id="dead1",
              events=[{"t_unix": now - 130.0, "name": "compaction.lease"}])
    c = _console(tmp_warehouse)
    out = c.execute(f"fleet-status {spool}")
    for want in ("2 members", "scanplane-worker", "[live]", "[STALE]", "north star", "rows/s",
                 "freshness SLO", "postmortem: compactor dead1", "compaction.lease"):
        assert want in out, want
    assert "fleet-status" in c.execute("help")
    # the reference's console renders the same spool the same way, up to the
    # clock readings (heartbeat ages, the window) that move between the calls
    ref = RefConsole(RefCatalog(str(tmp_warehouse))).execute(f"fleet-status {spool}")
    assert re.sub(r"\d+\.\d+", "#", out) == re.sub(r"\d+\.\d+", "#", ref)


def test_fleet_status_without_spool_or_members(tmp_warehouse, spool, monkeypatch):
    monkeypatch.delenv("LAKESOUL_OBS_SPOOL", raising=False)
    c = _console(tmp_warehouse)
    assert "no spool" in c.execute("fleet-status")
    assert "no members" in c.execute(f"fleet-status {spool}")


def test_sql_in_console(tmp_warehouse):
    c = _console(tmp_warehouse)
    c.execute("CREATE TABLE t (id bigint, v double)")
    c.execute("INSERT INTO t VALUES (1, 1.0), (2, 2.0)")
    assert "2" in c.execute("SELECT count(*) AS n FROM t")
    assert "error" in c.execute("SELECT * FROM missing_table")


def test_assets_clean_cache_commands(tmp_warehouse):
    c = _console(tmp_warehouse)
    c.execute("CREATE TABLE m (id bigint, v double)")
    c.execute("INSERT INTO m VALUES (1, 1.0)")
    assets = c.execute("assets")
    assert "m" in assets and "live_files" in assets
    assert "versions_dropped=" in c.execute("clean")
    assert "hits=" in c.execute("cache-stats")


LINT_LINES = ["lint", "lint --rule raw-thread", "lint --format json", "lint --format sarif"]


@pytest.mark.parametrize("line", LINT_LINES)
def test_lint_answers_that_the_analysis_package_is_not_ported(tmp_warehouse, line):
    """The counterparts of the reference's ``test_console_lint_command`` and
    ``test_console_lint_mirrors_cli_filters``: the console's ``lint`` prints
    what the port's CLI prints for the same filters, byte for byte, and the
    package lints clean.  The CLI lints beside the console."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("LAKESOUL_", "JAX_"))}
    cli = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.analysis", *line.split()[1:]], cwd=ROOT,
        env={**env, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        c = _console(tmp_warehouse)
        got = c.execute(line)
        out, err = cli.communicate(timeout=240)
    except BaseException:
        cli.kill()
        cli.communicate()
        raise
    assert cli.returncode == 0, err
    assert got + "\n" == out and err == ""
    if "--format" in line:
        payload = json.loads(got)
        if "sarif" in line:
            assert payload["version"] == "2.1.0" and payload["runs"][0]["results"] == []
            assert len(payload["runs"][0]["tool"]["driver"]["rules"]) == 40
        else:
            assert payload == []
    else:
        assert got == LINT_CLEAN
    assert "lint [--rule ID]" in c.execute("help")
    assert c.execute("lint --rule nope").startswith("lint: engine error")


def test_both_consoles_print_the_same(tmp_path):
    wh, db = str(tmp_path / "wh"), str(tmp_path / "m.db")
    cat = LakeSoulCatalog(wh, db_path=db)
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    rng = np.random.default_rng(3)
    t.write_arrow(pa.table({"id": np.arange(40), "v": rng.normal(size=40)}))
    t.upsert(pa.table({"id": np.arange(30, 50), "v": rng.normal(size=20)}))
    port = Console(cat, device="cpu")
    ref = RefConsole(RefCatalog(wh, db_path=db))
    for line in ("help", "tables", "show t", "count t", "versions t", "scan t limit 4",
                 "SHOW TABLES", "DESCRIBE t",
                 "SELECT count(*) AS n, sum(v) AS s FROM t WHERE id >= 20",
                 "SELECT id, v FROM t WHERE id BETWEEN 28 AND 33 ORDER BY id",
                 "bogus", "show nope", "user-add", "fleet-status /nonexistent/spool"):
        assert port.execute(line) == ref.execute(line), line
    assert port.execute("INSERT INTO t VALUES (100, 1.5)") == ref.execute(
        "INSERT INTO t VALUES (101, 2.5)").replace("101", "100")
    assert port.execute("count t") == ref.execute("count t") == "52"


def test_sql_takes_the_card_unless_asked(tmp_warehouse, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = LakeSoulCatalog(str(tmp_warehouse))
    schema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), 8))])
    vecs = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    cat.create_table("d", schema, primary_keys=["id"]).write_arrow(pa.table(
        {"id": np.arange(64, dtype=np.int64),
         "emb": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), 8)}, schema=schema))
    out = Console(cat).execute("CALL build_vector_index('d', 'emb')")
    assert out.startswith("error: ConfigError: CUDA is not available"), out
    assert "64" in Console(cat, device="cpu").execute("CALL build_vector_index('d', 'emb')")


def test_console_cli(tmp_warehouse, capsys, monkeypatch):
    import io

    import torch

    from lakesoul_tpu_torch.errors import ConfigError
    from lakesoul_tpu_torch.service.console import main

    cat = LakeSoulCatalog(str(tmp_warehouse))
    cat.create_table("t", SCHEMA).write_arrow(pa.table({"id": np.arange(7), "v": np.ones(7)}))
    wh = str(tmp_warehouse)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("LAKESOUL_", "JAX_"))}
    out = subprocess.run(
        [sys.executable, "-m", "lakesoul_tpu_torch.service.console", "-w", wh, "-c", "count t",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": ROOT})
    assert out.returncode == 0 and out.stdout == "7\n", out.stderr
    assert main(["-w", wh, "-c", "lint", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == LINT_CLEAN + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO("tables\ncount t\nquit\n"))
    assert main(["-w", wh, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == (
        "lakesoul_tpu_torch console — 'help' for commands\n"
        "lakesoul> default.t\nlakesoul> 7\nlakesoul> ")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        main(["-w", wh, "-c", "count t"])
    assert capsys.readouterr().out == ""
