"""The port's fleet ``train`` role and the fleet telemetry plane
(``obs/fleet.py``, ``obs/exporter.py``, ``obs/logging.py``,
``freshness/slo.py``, ``utils/memory.py``) against the reference.

- ``python -m lakesoul_tpu_torch.fleet train`` as two ranks on one
  warehouse: each line's ``rows``, ``batches`` and ``sha256`` equal the
  reference's ``python -m lakesoul_tpu.fleet train`` on the same table and
  the in-process oracle (``digest_batch`` folded over the host batches of
  ``scan.shard(rank, 2).to_torch_iter(device_put=False)``: the table has a
  string column, which no tensor holds).  The port's role puts batches on
  the card unless ``--device cpu`` is given, which the CPU runs pass.
- The behaviours ``tests/test_obs_fleet.py`` pins for the reference, run on
  both packages (``pkg``), and each package's aggregator reading members
  the other published: one fleet document.
"""

from __future__ import annotations

import hashlib
import importlib
import io
import json
import logging
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.fleet.multihost import digest_batch
from lakesoul_tpu_torch.analysis import fscheck
from lakesoul_tpu_torch.analysis.arm import armed
from lakesoul_tpu_torch.runtime import atomicio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("lakesoul_tpu", "lakesoul_tpu_torch")
ROWS = 6000
# host batches: the reference's default, the port's opt-out from the card
HOST = {"lakesoul_tpu": (), "lakesoul_tpu_torch": ("--device", "cpu")}


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """One table: a primary key over 4 hash buckets, an upsert wave (merge
    on read), a string column (hashed by value)."""
    wh = str(tmp_path_factory.mktemp("fleet_wh"))
    cat = LakeSoulCatalog(wh)
    rng = np.random.default_rng(0)

    def rows(ids):
        n = len(ids)
        return pa.table({"id": ids.astype(np.int64),
                         "f0": rng.normal(size=n).astype(np.float32),
                         "label": rng.integers(0, 2, n).astype(np.int32),
                         "tag": pa.array([f"t{i % 7}" for i in ids])})

    t = cat.create_table("t", rows(np.arange(1)).schema, primary_keys=["id"],
                         hash_bucket_num=4)
    t.write_arrow(rows(np.arange(ROWS)))
    t.upsert(rows(rng.choice(ROWS, 500, replace=False)))
    return wh


def _train(pkg: str, wh: str, world: int, extra=()) -> list[dict]:
    procs = []
    for rank in range(world):
        env = dict(os.environ, LAKESOUL_FLEET_PROCESS_INDEX=str(rank),
                   LAKESOUL_FLEET_PROCESS_COUNT=str(world), JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
        env.pop("LAKESOUL_OBS_SPOOL", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.fleet", "train", "--warehouse", wh, "--table", "t",
             "--batch-size", "1000", *HOST[pkg], *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True))
    lines = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        lines.append(json.loads(out.strip().splitlines()[-1]))
    return lines


@pytest.fixture(scope="module")
def trained(warehouse):
    return {pkg: _train(pkg, warehouse, 2) for pkg in PKGS}


def _oracle(wh: str, rank: int, world: int) -> tuple[int, int, str]:
    scan = LakeSoulCatalog(wh).scan("t").batch_size(1000).shard(rank, world)
    digest, rows, batches = hashlib.sha256(), 0, 0
    for b in scan.to_torch_iter(device_put=False, drop_remainder=False):
        rows += digest_batch(digest, b)
        batches += 1
    return rows, batches, digest.hexdigest()


@pytest.mark.parametrize("rank", [0, 1])
def test_train_lines_equal_the_reference_and_the_oracle(rank, trained, warehouse):
    got, want = trained["lakesoul_tpu_torch"][rank], trained["lakesoul_tpu"][rank]
    assert (got["rows"], got["batches"], got["sha256"]) == \
        (want["rows"], want["batches"], want["sha256"])
    assert (got["rows"], got["batches"], got["sha256"]) == _oracle(warehouse, rank, 2)
    assert (got["process_index"], got["process_count"]) == (rank, 2)
    assert got["rows"] > 0


def test_train_lines_have_the_reference_keys(trained):
    got = trained["lakesoul_tpu_torch"]
    assert [sorted(x) for x in got] == [sorted(x) for x in trained["lakesoul_tpu"]]
    assert sum(x["rows"] for x in got) == ROWS
    for x in got:
        assert x["local_devices"] == 0  # torch.cuda.device_count() here: no card
        assert x["started_unix"] <= x["ended_unix"] and x["elapsed_s"] >= 0


def test_one_rank_reads_the_whole_table(warehouse):
    (got,) = _train("lakesoul_tpu_torch", warehouse, 1)
    assert (got["rows"], got["batches"], got["sha256"]) == _oracle(warehouse, 0, 1)
    assert got["rows"] == ROWS


def test_train_defaults_to_the_card(warehouse, monkeypatch, capsys):
    """Without ``--device cpu`` the role asks the iterator for the card: with
    none it raises, and never falls back to host batches; ``--device-put``
    (the reference's flag) is taken and changes nothing."""
    import torch

    from lakesoul_tpu_torch.fleet.__main__ import main

    for env in ("LAKESOUL_OBS_SPOOL", "LAKESOUL_FLEET_PROCESS_INDEX",
                "LAKESOUL_FLEET_PROCESS_COUNT"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device-put"], ["--device", "cuda"]):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            main(["train", "--warehouse", warehouse, "--table", "t", *extra])
    assert main(["train", "--warehouse", warehouse, "--table", "t", "--batch-size", "1000",
                 "--device", "cpu", "--device-put"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["rows"], got["batches"], got["sha256"]) == _oracle(warehouse, 0, 1)


def test_digest_of_a_tensor_batch_is_the_numpy_batchs():
    import torch

    b = {"a": np.arange(5, dtype=np.int64), "s": np.array(["x", "y"] * 2 + ["z"], object)}
    d1, d2 = hashlib.sha256(), hashlib.sha256()
    assert digest_batch(d1, b) == digest_batch(d2, {**b, "a": torch.from_numpy(b["a"])}) == 5
    assert d1.hexdigest() == d2.hexdigest()


@pytest.mark.parametrize("argv,match", [
    (["autoscale", "--spool", "/nonexistent", "--min-workers", "3", "--max-workers", "1"],
     "autoscale"),
    (["autoscale", "--spool", "/nonexistent", "--min-workers", "-1", "--lease-ttl-s", "5"],
     "autoscale"),
])
def test_unported_roles_raise(argv, match, warehouse):
    """The autoscale role is ported (``tests/test_torch_autoscale.py`` runs
    it): what it refuses is what the reference refuses, bounds that no
    fleet can meet, before it spawns anything."""
    from lakesoul_tpu_torch.fleet.__main__ import main

    with pytest.raises(ConfigError, match=match):
        main([argv[0], "--warehouse", warehouse, *argv[1:]])


# ------------------------------------------------------------------ obs plane
@pytest.fixture(params=PKGS)
def pkg(request):
    """The same behaviour pinned on the reference and on the port."""
    name = request.param
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("obs.fleet", "obs.exporter", "obs.metrics", "obs.tracing", "obs.logging",
                      "freshness.slo", "utils.memory")}
    return type("Pkg", (), {"name": name, **{k.split(".")[1]: v for k, v in mods.items()}})


@pytest.fixture()
def spool(tmp_path):
    d = tmp_path / "obs-spool"
    d.mkdir()
    return str(d)


def _member(spool_dir, *, role, service_id, snapshot, kinds=None, heartbeat_unix=None,
            started_unix=None, chips=0, host="h1", pid=1234):
    now = time.time()
    doc = {"role": role, "service_id": service_id, "pid": pid, "host": host,
           "started_unix": now - 10.0 if started_unix is None else started_unix,
           "heartbeat_unix": now if heartbeat_unix is None else heartbeat_unix,
           "chips": chips, "kinds": kinds or {}, "snapshot": snapshot}
    atomicio.publish_bytes(os.path.join(spool_dir, f"member-{service_id}.json"),
                           json.dumps(doc).encode())


def _recorder(spool_dir, *, role, service_id, spans=(), pid=1234):
    doc = {"role": role, "service_id": service_id, "pid": pid, "heartbeat_unix": time.time(),
           "reason": "test", "events": [], "spans": list(spans)}
    atomicio.publish_bytes(os.path.join(spool_dir, f"recorder-{service_id}.json"),
                           json.dumps(doc).encode())


class _DocSource:
    def prometheus_text(self):
        return "# TYPE lakesoul_t_total counter\nlakesoul_t_total 1\n"

    def snapshot(self):
        return {"lakesoul_t_total": 1}


class _RaisingSource:
    def prometheus_text(self):
        raise RuntimeError("collector exploded")

    def snapshot(self):
        raise RuntimeError("collector exploded")


def _get(port, path, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_exporter_negotiates_and_answers_health(pkg):
    srv = pkg.exporter.serve_prometheus(_DocSource(), port=0, host="127.0.0.1")
    try:
        port = srv.server_address[1]
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain") and "lakesoul_t_total 1" in body
        status, ctype, body = _get(port, "/metrics", accept="application/json")
        assert (status, ctype, json.loads(body)) == (200, "application/json",
                                                     {"lakesoul_t_total": 1})
        pkg.fleet.process_identity(role="exporter-test")
        status, _, body = _get(port, "/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["status"] == "ok"
        assert doc["role"] == "exporter-test" and doc["pid"] == os.getpid()
    finally:
        srv.shutdown()


def test_exporter_raising_source_returns_500_body(pkg):
    srv = pkg.exporter.serve_prometheus(_RaisingSource(), port=0, host="127.0.0.1")
    try:
        port = srv.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/metrics")
        assert ei.value.code == 500
        body = ei.value.read().decode()
        assert "RuntimeError" in body and "collector exploded" in body
        assert _get(port, "/healthz")[0] == 200
    finally:
        srv.shutdown()


def test_exporter_serves_a_fleet_aggregate(pkg, spool):
    _member(spool, role="fleet-train", service_id="rank0",
            snapshot={"lakesoul_loader_rows_total": 10}, kinds={"lakesoul_loader_rows_total":
                                                                "counter"})
    srv = pkg.exporter.serve_prometheus(pkg.fleet.FleetAggregator(spool), port=0,
                                        host="127.0.0.1")
    try:
        _, _, text = _get(srv.server_address[1], "/metrics")
        assert "lakesoul_fleet_members 1" in text
        _, _, body = _get(srv.server_address[1], "/metrics", accept="application/json")
        assert json.loads(body)["snapshot"]["lakesoul_loader_rows_total"] == 10
    finally:
        srv.shutdown()


def test_arm_without_spool_stamps_identity_gauges_only(pkg, monkeypatch):
    fleet = pkg.fleet
    monkeypatch.delenv(fleet.ENV_SPOOL, raising=False)
    assert fleet.arm("unit-test-role", service_id="unit-test-1") is None
    snap = pkg.metrics.registry().snapshot()
    build = [k for k in snap if k.startswith("lakesoul_build_info")
             and 'role="unit-test-role"' in k and 'service_id="unit-test-1"' in k]
    assert build and snap[build[0]] == 1
    assert 'version="0.1.0"' in build[0]
    start = [k for k in snap if k.startswith("lakesoul_process_start_time_seconds")
             and 'service_id="unit-test-1"' in k]
    assert start and snap[start[0]] == pytest.approx(time.time(), abs=120)
    labels = fleet.identity_labels(worker="w")
    assert (labels["role"], labels["service_id"], labels["worker"]) == \
        ("unit-test-role", "unit-test-1", "w")


def test_publisher_flush_writes_member_and_recorder_docs(pkg, spool):
    fleet = pkg.fleet
    fleet.process_identity(role="pubtest", service_id="pubtest-1")
    src = pkg.metrics.MetricsRegistry()
    src.counter("lakesoul_pub_rows_total").inc(12)
    pub = fleet.FleetPublisher(spool, flush_s=60.0, source=src)
    fleet.record_event("pubtest.step", detail="x")
    pub.flush(reason="unit")
    member = json.load(open(os.path.join(spool, "member-pubtest-1.json")))
    assert (member["role"], member["pid"]) == ("pubtest", os.getpid())
    assert member["snapshot"]["lakesoul_pub_rows_total"] == 12
    assert member["kinds"]["lakesoul_pub_rows_total"] == "counter"
    rec = json.load(open(os.path.join(spool, "recorder-pubtest-1.json")))
    assert rec["reason"] == "unit" and any(e["name"] == "pubtest.step" for e in rec["events"])
    assert src.histogram(fleet.FLUSH_FAMILY).value["count"] >= 1
    assert sorted(os.listdir(spool)) == ["member-pubtest-1.json", "recorder-pubtest-1.json"]


def test_periodic_flush_and_stop(pkg, spool):
    fleet = pkg.fleet
    fleet.process_identity(role="pubtest", service_id="pubtest-2")
    pub = fleet.FleetPublisher(spool, flush_s=0.05, source=pkg.metrics.MetricsRegistry())
    pub.start()
    try:
        path = os.path.join(spool, "member-pubtest-2.json")
        first = beat = json.load(open(path))["heartbeat_unix"]
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and beat <= first:
            time.sleep(0.05)
            beat = json.load(open(path))["heartbeat_unix"]
        assert beat > first, "periodic flush never advanced the heartbeat"
    finally:
        pub.stop()


def test_child_env_pins_trace_and_spool(pkg, spool, monkeypatch):
    fleet, tracing = pkg.fleet, pkg.tracing
    monkeypatch.delenv(tracing.ENV_TRACE_ID, raising=False)
    monkeypatch.delenv(fleet.ENV_SPOOL, raising=False)
    monkeypatch.setattr(fleet, "_PUBLISHER", None)
    env = fleet.child_env()
    assert tracing.ENV_TRACE_ID not in env and fleet.ENV_SPOOL not in env
    with tracing.span("parent.op") as s:
        assert fleet.child_env()[tracing.ENV_TRACE_ID] == s.trace_id
    assert fleet.child_env(trace_id="pinned-id-1")[tracing.ENV_TRACE_ID] == "pinned-id-1"
    pub = fleet.FleetPublisher(spool, flush_s=60.0, source=pkg.metrics.MetricsRegistry())
    monkeypatch.setattr(fleet, "_PUBLISHER", pub)
    assert fleet.child_env()[fleet.ENV_SPOOL] == spool


def _fleet_spool(spool, now):
    _member(spool, role="fleet-train", service_id="rank0",
            snapshot={"lakesoul_loader_rows_total": 600,
                      'lakesoul_build_info{role="fleet-train",service_id="rank0",'
                      'version="0.1.0"}': 1},
            kinds={"lakesoul_loader_rows_total": "counter", "lakesoul_build_info": "gauge"},
            started_unix=now - 10.0, chips=2)
    _member(spool, role="fleet-train", service_id="rank1",
            snapshot={"lakesoul_loader_rows_total": 400},
            kinds={"lakesoul_loader_rows_total": "counter"}, started_unix=now - 5.0, chips=2)
    _member(spool, role="compactor", service_id="c1",
            snapshot={"lakesoul_compaction_jobs_total": 3},
            kinds={"lakesoul_compaction_jobs_total": "counter"},
            heartbeat_unix=now - 60.0, started_unix=now - 90.0)


def test_aggregator_merges_members_with_staleness(pkg, spool):
    now = time.time()
    _fleet_spool(spool, now)
    agg = pkg.fleet.FleetAggregator(spool, stale_after_s=5.0)
    doc = agg.aggregate(now=now)
    by_sid = {m["service_id"]: m for m in doc["members"]}
    assert len(by_sid) == 3 and by_sid["c1"]["stale"]
    assert not by_sid["rank0"]["stale"] and not by_sid["rank1"]["stale"]
    snap = doc["snapshot"]
    assert snap["lakesoul_loader_rows_total"] == 1000
    assert doc["fleet"]["rows"] == 1000 and doc["fleet"]["chips"] == 2
    assert doc["fleet"]["window_s"] == pytest.approx(90.0, abs=1.0)
    assert (snap["lakesoul_fleet_members"], snap["lakesoul_fleet_stale_members"]) == (3, 1)
    text = agg.prometheus_text()
    assert "lakesoul_fleet_members 3" in text and "lakesoul_loader_rows_total 1000" in text


def test_fleet_wide_freshness_slo(pkg, spool):
    slo = pkg.slo
    src = pkg.metrics.MetricsRegistry()
    h = src.histogram(slo.FRESHNESS_FAMILY, buckets=slo.FRESHNESS_BUCKETS)
    for v in (0.5, 1.0, 2.0, 3.0):
        h.observe(v)
    src.counter(slo.VIOLATIONS_FAMILY, slo="freshness_10.0s").inc(0)
    _member(spool, role="follower", service_id="f1",
            snapshot=json.loads(json.dumps(src.snapshot())), kinds=src.kinds())
    doc = pkg.fleet.FleetAggregator(spool, stale_after_s=30.0).aggregate()
    fr = doc["slos"]["freshness"]
    assert fr["count"] == 4 and fr["violations"] == 0 and fr["in_budget"] is True
    assert fr["mean_s"] == pytest.approx(6.5 / 4)
    assert doc["slos"]["throughput"]["ok"] is None
    doc = pkg.fleet.FleetAggregator(spool, stale_after_s=30.0).aggregate(min_rows_per_s=1e9)
    assert doc["slos"]["throughput"]["ok"] is False


def test_trace_assembly_and_postmortem(pkg, spool):
    fleet = pkg.fleet
    tid = "trace-abc"
    _recorder(spool, role="writer", service_id="fw", pid=10,
              spans=[{"name": "a.commit", "trace_id": tid, "t_unix": 1.0},
                     {"name": "unrelated", "trace_id": "other", "t_unix": 1.5}])
    _recorder(spool, role="fleet-train", service_id="rank0", pid=20,
              spans=[{"name": "fleet.train.consume", "trace_id": tid, "t_unix": 2.0}])
    trace = fleet.FleetAggregator(spool).trace(tid)
    assert [(s["name"], s["pid"]) for s in trace] == [("a.commit", 10),
                                                      ("fleet.train.consume", 20)]
    fleet.process_identity(role="victim-role", service_id="victim-1")
    src = pkg.metrics.MetricsRegistry()
    src.counter("lakesoul_victim_rows_total").inc(77)
    fleet.FleetPublisher(spool, flush_s=60.0, source=src).flush(reason="last")
    time.sleep(0.06)
    agg = fleet.FleetAggregator(spool, stale_after_s=0.05)
    assert [m["service_id"] for m in agg.stale_members()] == ["victim-1"]
    (pm,) = agg.postmortems()
    assert pm["role"] == "victim-role"
    assert pm["last_snapshot"]["lakesoul_victim_rows_total"] == 77


def test_torn_or_garbage_files_are_skipped(pkg, spool):
    # garbage on purpose, to prove the aggregator skips it: not a publication
    with fscheck.untraced():
        with open(os.path.join(spool, "member-torn.json"), "w") as f:
            f.write('{"role": "x", ')
        with open(os.path.join(spool, "member-list.json"), "w") as f:
            f.write("[1, 2]")
    _member(spool, role="ok", service_id="ok1", snapshot={})
    doc = pkg.fleet.FleetAggregator(spool, stale_after_s=30.0).aggregate()
    assert [m["service_id"] for m in doc["members"]] == ["ok1"]


def test_both_aggregators_give_one_document(spool):
    """Members published by either package's publisher, read by either
    package's aggregator: the same fleet document."""
    from lakesoul_tpu.obs import fleet as ref_fleet
    from lakesoul_tpu.obs.metrics import MetricsRegistry as RefRegistry
    from lakesoul_tpu_torch.obs import fleet as port_fleet
    from lakesoul_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry

    now = time.time()
    _fleet_spool(spool, now)
    for i, (fleet, reg) in enumerate(((ref_fleet, RefRegistry), (port_fleet, PortRegistry))):
        fleet.process_identity(role="fleet-train", service_id=f"pub{i}")
        src = reg()
        src.counter("lakesoul_loader_rows_total").inc(50 + i)
        src.histogram("lakesoul_loader_batch_seconds").observe(0.25)
        fleet.FleetPublisher(spool, flush_s=60.0, source=src).flush(reason="unit")
    docs = [f.FleetAggregator(spool, stale_after_s=30.0).aggregate(now=now + 1.0)
            for f in (ref_fleet, port_fleet)]
    assert docs[0]["snapshot"]["lakesoul_loader_rows_total"] == 1101
    assert json.dumps(docs[0], sort_keys=True) == json.dumps(docs[1], sort_keys=True)
    texts = [f.FleetAggregator(spool, stale_after_s=30.0) for f in (ref_fleet, port_fleet)]
    assert "lakesoul_fleet_members 5" in texts[1].prometheus_text()


def test_chip_count_never_initialises_cuda(monkeypatch):
    import torch

    from lakesoul_tpu_torch.obs import fleet

    monkeypatch.delenv(fleet.ENV_SPOOL, raising=False)
    fleet.arm("chip-count-test", service_id="cc-1")
    assert fleet._chip_count() == 0
    assert not torch.cuda.is_initialized()


def test_json_log_formatter_stamps_the_trace_id(pkg):
    stream = io.StringIO()
    handler = pkg.logging.configure_logging(logging.INFO, stream=stream, fmt="json")
    root = pkg.name
    try:
        log = logging.getLogger(f"{root}.unit")
        with pkg.tracing.span("log.op") as s:
            log.info("inside %d", 1)
        log.info("outside")
        again = pkg.logging.configure_logging(logging.INFO, stream=stream, fmt="json")
        assert [h for h in logging.getLogger(root).handlers if h is handler] == []
        handler = again
    finally:
        logging.getLogger(root).removeHandler(handler)
    inside, outside = (json.loads(line) for line in stream.getvalue().splitlines())
    assert (inside["msg"], inside["level"], inside["logger"]) == ("inside 1", "INFO",
                                                                  f"{root}.unit")
    assert inside["trace_id"] == s.trace_id and "trace_id" not in outside


def test_text_log_format_is_the_default(pkg, monkeypatch):
    monkeypatch.delenv("LAKESOUL_LOG_FORMAT", raising=False)
    handler = pkg.logging.configure_logging(stream=io.StringIO())
    try:
        assert not isinstance(handler.formatter, pkg.logging.JsonLogFormatter)
    finally:
        logging.getLogger(pkg.name).removeHandler(handler)


def test_slo_monitor_matches_the_reference():
    from lakesoul_tpu.freshness.slo import SloMonitor as Ref
    from lakesoul_tpu.freshness.slo import ThroughputSlo as RefTput
    from lakesoul_tpu_torch.freshness import SloMonitor, ThroughputSlo

    lat = np.random.default_rng(3).exponential(2.0, 500)
    mons = [cls(5.0, budget_fraction=0.05, slo="freshness_unit") for cls in (Ref, SloMonitor)]
    for m in mons:
        for v in lat:
            m.observe(float(v))
    assert mons[0].snapshot() == mons[1].snapshot()
    assert mons[1].snapshot()["violations"] > 0
    tputs = [cls(1e12, slo="tput_unit") for cls in (RefTput, ThroughputSlo)]
    for t in tputs:
        t.start()
        t.add_rows(10)
    got, want = (t.evaluate() for t in tputs)
    assert got["ok"] is want["ok"] is False and sorted(got) == sorted(want)


def test_rss_matches_the_reference():
    from lakesoul_tpu.utils import memory as ref
    from lakesoul_tpu_torch.utils import memory

    assert memory.current_rss_mb() == pytest.approx(ref.current_rss_mb(), rel=0.05)
    assert memory.peak_rss_mb() >= ref.peak_rss_mb() > 0
    assert memory.peak_rss_mb() >= memory.current_rss_mb() * 0.95


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
