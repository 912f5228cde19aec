"""The port's freshness follower (``lakesoul_tpu_torch/freshness/``, with
``scan.follow`` and ``to_torch_iter(follow=...)``) against the reference's,
on one warehouse and one SQLite metadata store.

- Rows: the port's ``FreshFollower`` delivers the reference's batches, in
  its order; the ``FollowerState`` JSON at each position is the reference's,
  and a state written by either package resumes the other row for row, also
  across a compaction.
- Faults: transient poll faults retry on the seeded schedule with the
  reference's retry counts; a decode fault mid-unit delivers no duplicate;
  permanent failure and retry exhaustion raise the reference's types.
- SLO and shutdown: commit-to-visible latency lands in
  ``lakesoul_freshness_seconds``; ``settle_ms`` is a deprecated no-op; a
  parked follower stops within one tick.
- ``to_torch_iter(follow=..., device="cpu")`` is a continuous, single-pass
  source whose ``follow_state_json`` resumes exactly (in either package),
  and it refuses ``checkpoint`` and ``cache="device"`` with the reference's
  messages.
- The writer role prints the reference writer's line, and the three roles
  (writer, leased compactor, follower) in one process hold both SLOs under
  faults with delivery equal to the writer's oracle.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import lakesoul_tpu.freshness as ref_freshness
import lakesoul_tpu.runtime.faults as ref_faults
from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.errors import ConfigError as RefConfigError
from lakesoul_tpu.obs import registry as ref_registry
from lakesoul_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.freshness import (
    FollowBatchSource,
    FollowerState,
    FreshFollower,
    SloMonitor,
    ThroughputSlo,
    default_follow_poll_s,
)
from lakesoul_tpu_torch.meta.entity import CommitOp, now_millis
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.runtime import faults
from lakesoul_tpu_torch.runtime.resilience import RetryPolicy

SCHEMA = pa.schema([("id", pa.int64()), ("seq", pa.int64()), ("v", pa.float64())])
PKGS = ("port", "ref")


@pytest.fixture
def cats(tmp_path):
    """Both packages' catalogs over one warehouse and one metadata store."""
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    return {"port": LakeSoulCatalog(wh, db_path=db), "ref": RefCatalog(wh, db_path=db)}


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _commit(table, base: int, n: int) -> None:
    table.upsert(pa.table({
        "id": list(range(base, base + n)),
        "seq": list(range(base, base + n)),
        "v": [float(base + i) for i in range(n)],
    }, schema=SCHEMA))


def _table(cats, name, *, commits=4, per=10, buckets=2):
    t = cats["port"].create_table(name, SCHEMA, primary_keys=["id"], hash_bucket_num=buckets)
    start = now_millis() - 1
    for c in range(commits):
        _commit(t, c * per, per)
    return start


def _follower(pkg, cats, name, **kw):
    scan = cats[pkg].table(name).scan().batch_size(kw.pop("batch_size", 7))
    cls = FreshFollower if pkg == "port" else ref_freshness.FreshFollower
    if isinstance(kw.get("state"), str):
        state_cls = FollowerState if pkg == "port" else ref_freshness.FollowerState
        kw["state"] = state_cls.from_json(kw["state"])
    return cls(scan, poll_interval=0.01, **{"max_polls": 3, **kw})


def _seqs(batches) -> list[int]:
    return [s for b in batches for s in b.column("seq").to_pylist()]


def _policy(pkg, attempts=10):
    cls = RetryPolicy if pkg == "port" else RefRetryPolicy
    return cls(max_attempts=attempts, base_delay_s=0.001, max_delay_s=0.01, seed=7)


# ------------------------------------------------------------------ rows
@pytest.mark.parametrize("buckets,batch", [(1, 7), (2, 7), (2, 64)])
def test_follower_delivers_the_references_batches(cats, buckets, batch):
    start = _table(cats, "t", buckets=buckets)
    got = {pkg: list(_follower(pkg, cats, "t", start_timestamp_ms=start,
                               batch_size=batch).iter_batches())
           for pkg in PKGS}
    assert [len(b) for b in got["port"]] == [len(b) for b in got["ref"]]
    assert all(p.equals(r) for p, r in zip(got["port"], got["ref"]))
    assert sorted(_seqs(got["port"])) == list(range(40))


def test_state_json_at_every_position_is_the_references(cats):
    start = _table(cats, "t")
    states = {}
    for pkg in PKGS:
        f = _follower(pkg, cats, "t", start_timestamp_ms=start)
        states[pkg] = [f.state_json() for _ in f.iter_batches()]
    assert len(states["port"]) >= 6
    assert states["port"] == states["ref"]
    doc = json.loads(states["port"][1])
    assert sorted(doc) == ["cursors", "pending", "rows_into_current"]
    assert FollowerState.from_json(states["port"][1]).to_json() == states["port"][1]


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "across_compaction"])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_a_state_from_either_package_resumes_the_other(cats, writer, reader, compact):
    """Kill a follower mid-stream, restart from its persisted state in the
    other package: concatenated delivery is an uninterrupted follow's — no
    duplicate, no gap — also when a compaction rewrote the files the
    recorded units point at between the kill and the restart."""
    start = _table(cats, "t")
    oracle = _seqs(_follower("ref", cats, "t", start_timestamp_ms=start).iter_batches())
    f1 = _follower(writer, cats, "t", start_timestamp_ms=start)
    got: list[int] = []
    it = f1.iter_batches()
    for i, b in enumerate(it):
        got.extend(b.column("seq").to_pylist())
        if i == 1:
            state = f1.state_json()
            break
    it.close()
    if compact:
        assert cats["port"].table("t").compact() == 1
        _commit(cats["port"].table("t"), 40, 10)
    got += _seqs(_follower(reader, cats, "t", state=state).iter_batches())
    if compact:
        assert sorted(got) == list(range(50)) and len(got) == 50
    else:
        assert got == oracle


def test_lagged_consumer_resume_state_is_the_references(cats):
    """resume_state(k) rebuilds the position of a consumer k rows in — the
    loader-pipeline shape where prefetch runs ahead — as the reference."""
    start = _table(cats, "t", commits=3)
    out = {}
    for pkg in PKGS:
        f = _follower(pkg, cats, "t", start_timestamp_ms=start)
        it = f.iter_batches()
        b1, b2 = next(it), next(it)
        next(it)
        out[pkg] = (f.resume_state(len(b1) + 3).to_json(),
                    b1.column("seq").to_pylist() + b2.column("seq").to_pylist()[:3])
        it.close()
    assert out["port"] == out["ref"]
    state, head = out["port"]
    rest = _seqs(_follower("port", cats, "t", state=state).iter_batches())
    assert head + rest == _seqs(_follower("ref", cats, "t", start_timestamp_ms=start)
                                .iter_batches())
    with pytest.raises(ConfigError, match="snapshot ring"):
        FreshFollower(cats["port"].table("t").scan(), start_timestamp_ms=start).resume_state(5)


def test_cursor_dict_resume_is_mutated_in_place(cats):
    from lakesoul_tpu_torch.meta.client import follow_cursors_from_json, follow_cursors_to_json

    t = cats["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _commit(t, 0, 5)
    cursors = cats["port"].client.init_follow_cursors("t", now_millis())
    _commit(t, 10, 5)
    f = FreshFollower(t.scan(), cursors=cursors, poll_interval=0.01, max_polls=2)
    assert sorted(_seqs(f.iter_batches())) == list(range(10, 15))
    restored = follow_cursors_from_json(follow_cursors_to_json(cursors))
    _commit(t, 20, 5)
    f2 = FreshFollower(t.scan(), cursors=restored, poll_interval=0.01, max_polls=2)
    assert sorted(_seqs(f2.iter_batches())) == list(range(20, 25))
    with pytest.raises(ConfigError, match="not both"):
        FreshFollower(t.scan(), cursors={}, state=FollowerState())


# ---------------------------------------------------------------- faults
def _retry_counts(pkg):
    reg = registry() if pkg == "port" else ref_registry()
    return (reg.counter("lakesoul_retry_attempts_total", op="follow.poll").value,
            reg.counter("lakesoul_retry_attempts_total", op="follow.decode").value)


def test_transient_poll_faults_retry_as_the_reference(cats):
    """p=0.4 flaky polls on the same fault seed: the same rows, and the
    same number of retried attempts as the reference on its schedule."""
    start = _table(cats, "t", commits=3)
    oracle = _seqs(_follower("ref", cats, "t", start_timestamp_ms=start).iter_batches())
    out = {}
    for pkg, mod in (("port", faults), ("ref", ref_faults)):
        mod._RNG.seed(4)
        mod.install("follow.poll:0.4:flaky")
        before = _retry_counts(pkg)
        rows = _seqs(_follower(pkg, cats, "t", start_timestamp_ms=start, max_polls=6,
                               retry_policy=_policy(pkg)).iter_batches())
        mod.clear()
        after = _retry_counts(pkg)
        out[pkg] = (rows, [a - b for a, b in zip(after, before)])
    assert out["port"] == out["ref"]
    assert out["port"][0] == oracle and out["port"][1][0] > 0


def test_transient_store_faults_are_absorbed(cats):
    start = _table(cats, "t", commits=3)
    oracle = _seqs(_follower("ref", cats, "t", start_timestamp_ms=start).iter_batches())
    for spec in ("follow.poll:0.4:flaky", "object_store.cat_file:0.2:flaky",
                 "object_store.open:0.2:flaky"):
        faults.install(spec)
    got = _seqs(_follower("port", cats, "t", start_timestamp_ms=start, max_polls=6,
                          retry_policy=_policy("port")).iter_batches())
    assert got == oracle


def test_a_decode_fault_mid_unit_delivers_no_duplicate(cats):
    start = _table(cats, "t", commits=1, per=50, buckets=1)  # one unit, 8 batches
    faults.install("object_store.open:0.5:flaky")
    faults.install("object_store.cat_file:0.5:flaky")
    before = _retry_counts("port")[1]
    got = _seqs(_follower("port", cats, "t", start_timestamp_ms=start,
                          retry_policy=_policy("port", 20)).iter_batches())
    assert sorted(got) == list(range(50)) and len(got) == 50
    assert _retry_counts("port")[1] >= before


@pytest.mark.parametrize("case", ["permanent", "exhausted"])
def test_failures_raise_the_references_types(cats, case, monkeypatch):
    cats["port"].create_table("t", SCHEMA)
    raised = {}
    for pkg, mod, err in (("port", faults, ConfigError), ("ref", ref_faults, RefConfigError)):
        cat = cats[pkg]
        if case == "permanent":
            def boom(*a, _err=err, **k):
                raise _err("permanent")

            monkeypatch.setattr(cat.client, "poll_scan_plan", boom)
        else:
            mod.install("follow.poll:1.0:flaky")  # every attempt fails
        f = _follower(pkg, cats, "t", max_polls=2, retry_policy=_policy(pkg, 3))
        with pytest.raises(Exception) as e:
            list(f.iter_batches())
        raised[pkg] = type(e.value).__name__
        mod.clear()
    assert raised["port"] == raised["ref"] == (
        "ConfigError" if case == "permanent" else "ConnectionError")


# ------------------------------------------------------ SLO and shutdown
def test_commit_to_visible_lands_in_the_histogram_and_budget(cats):
    start = _table(cats, "t", commits=2, buckets=1)
    from lakesoul_tpu_torch.freshness.slo import FRESHNESS_BUCKETS

    hist = registry().histogram("lakesoul_freshness_seconds", buckets=FRESHNESS_BUCKETS)
    before = hist.value["count"]
    slo = SloMonitor(target_s=30.0, slo="test-port-follow")
    assert len(_seqs(_follower("port", cats, "t", start_timestamp_ms=start,
                               slo=slo).iter_batches())) == 20
    snap = slo.snapshot()
    assert snap["count"] >= 1 and snap["violations"] == 0 and snap["in_budget"]
    assert 0.0 <= snap["p99_s"] < 30.0
    assert hist.value["count"] - before == snap["count"]


def test_scan_follow_passes_the_slo_through(cats):
    t = cats["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    slo = SloMonitor(target_s=30.0, slo="test-port-follow-2")
    stop = threading.Event()
    _commit(t, 0, 5)
    start = cats["port"].client.store.get_latest_partition_info(t.info.table_id, "-5").timestamp - 1
    seen = []
    for b in t.scan().follow(start, poll_interval=0.01, stop_event=stop, slo=slo):
        seen.extend(b.column("seq").to_pylist())
        if len(seen) >= 5:
            stop.set()
    assert seen == list(range(5)) and slo.snapshot()["count"] >= 1


def test_settle_ms_is_a_deprecated_noop(cats):
    t = cats["port"].create_table("t", SCHEMA)
    stop = threading.Event()
    stop.set()
    with pytest.deprecated_call():
        assert list(t.scan().follow(stop_event=stop, settle_ms=250)) == []


def test_a_parked_follower_stops_within_one_tick(cats):
    t = cats["port"].create_table("t", SCHEMA)
    stop, done = threading.Event(), threading.Event()

    def run():
        list(t.scan().follow(stop_event=stop, poll_interval=30.0))
        done.set()

    threading.Thread(target=run, daemon=True).start()
    time.sleep(0.3)  # park it on the 30 s wait
    t0 = time.monotonic()
    stop.set()
    assert done.wait(timeout=5.0)
    assert time.monotonic() - t0 < 2.0


def test_default_poll_interval_reads_the_references_env(monkeypatch):
    monkeypatch.setenv("LAKESOUL_FOLLOW_POLL_S", "0.25")
    assert default_follow_poll_s() == ref_freshness.follower.default_follow_poll_s() == 0.25
    monkeypatch.setenv("LAKESOUL_FOLLOW_POLL_S", "x")
    assert default_follow_poll_s() == 1.0


# ------------------------------------------------- to_torch_iter(follow=)
def _iter(cats, name, pkg="port", **follow):
    scan = cats[pkg].table(name).scan().batch_size(16)
    follow = {"poll_interval": 0.02, **follow}
    if pkg == "port":
        return scan.to_torch_iter(follow=follow, device="cpu", drop_remainder=False)
    return scan.to_jax_iter(follow=follow, device_put=False, drop_remainder=False)


def _stop_when_delivered(stop, rows, timeout_s=30.0):
    """End a follow stream the way a trainer does: through its stop_event,
    once the follower handed ``rows`` rows to the loader
    (``lakesoul_follow_rows_total``) — a consumer on a device trails the
    head by the windows in flight, so waiting for consumer rows would hang."""
    counter = registry().counter("lakesoul_follow_rows_total")
    base = counter.value

    def watch():
        deadline = time.monotonic() + timeout_s
        while counter.value - base < rows and time.monotonic() < deadline:
            time.sleep(0.005)
        stop.set()

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    return th


def test_follow_is_a_continuous_training_source(cats):
    start = _table(cats, "t", per=32)
    stop = threading.Event()
    it = _iter(cats, "t", start_timestamp_ms=start, stop_event=stop)
    watcher = _stop_when_delivered(stop, 128)
    seen: list[int] = []
    for batch in it:
        assert str(batch["seq"].dtype) == "torch.int64"
        seen.extend(batch["seq"].tolist())
    watcher.join(5.0)
    # ended through its stop_event: the iterator drained what was in flight
    assert sorted(seen) == list(range(128)) and len(seen) == 128


@pytest.mark.parametrize("resumer", PKGS)
def test_follow_state_json_resumes_exactly(cats, resumer):
    start = _table(cats, "t", per=32)
    stop1 = threading.Event()
    it1 = _iter(cats, "t", start_timestamp_ms=start, stop_event=stop1)
    seen: list[int] = []
    for i, batch in enumerate(it1):
        seen.extend(batch["seq"].tolist())
        if i == 3:
            saved = it1.follow_state_json()  # next to the model checkpoint
            stop1.set()
            break
    stop2 = threading.Event()
    it2 = _iter(cats, "t", resumer, state=saved, stop_event=stop2)
    if resumer == "port":
        _stop_when_delivered(stop2, 128 - len(seen))
        seen.extend(s for batch in it2 for s in batch["seq"].tolist())
    else:
        for batch in it2:  # the reference's host delivery is immediate
            seen.extend(batch["seq"].tolist())
            if len(seen) >= 128:
                stop2.set()
                break
    # rows prefetched but undelivered at the save point replay, none
    # skipped, none doubled
    assert sorted(seen) == list(range(128)) and len(seen) == 128


@pytest.mark.parametrize("kw", [{"checkpoint": "ckpt"}, {"cache": "device"}, {"state_json": 1}],
                         ids=["checkpoint", "cache_device", "state_json_without_follow"])
def test_follow_refusals_are_the_references(cats, kw):
    from lakesoul_tpu.data.jax_iter import LoaderCheckpoint as RefCkpt
    from lakesoul_tpu_torch.data.torch_iter import LoaderCheckpoint

    _table(cats, "t", commits=1)
    msgs = {}
    for pkg, err in (("port", ConfigError), ("ref", RefConfigError)):
        scan = cats[pkg].table("t").scan()
        with pytest.raises(err) as e:
            if "state_json" in kw:
                it = (scan.to_torch_iter(device_put=False) if pkg == "port"
                      else scan.to_jax_iter(device_put=False))
                it.follow_state_json()
            else:
                opts = dict(kw)
                if opts.get("checkpoint"):
                    opts["checkpoint"] = LoaderCheckpoint() if pkg == "port" else RefCkpt()
                (scan.to_torch_iter(follow=True, device="cpu", **opts) if pkg == "port"
                 else scan.to_jax_iter(follow=True, **opts))
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["ref"]


def test_follow_iterator_is_single_pass(cats):
    start = _table(cats, "t", commits=1, per=32)
    stop = threading.Event()
    it = _iter(cats, "t", start_timestamp_ms=start, stop_event=stop)
    _stop_when_delivered(stop, 32)
    assert sum(len(batch["seq"]) for batch in it) == 32
    with pytest.raises(ConfigError, match="single-pass"):
        iter(it).__next__()


def test_batch_source_seam_resolution(cats):
    from lakesoul_tpu_torch.data.batch_source import ScanBatchSource, batch_source_for

    start = _table(cats, "t", commits=1)
    scan = cats["port"].table("t").scan()
    assert isinstance(batch_source_for(scan), ScanBatchSource)
    src = batch_source_for(scan, follow={"start_timestamp_ms": start})
    assert isinstance(src, FollowBatchSource)
    assert batch_source_for(scan, follow=src) is src
    # a persisted position resumes from it — never silently follow-from-now
    state = FollowerState()
    for value in (state, state.to_json()):
        resumed = batch_source_for(scan, follow=value)
        assert isinstance(resumed, FollowBatchSource)
        assert resumed.resume_state(0) is not None
    with pytest.raises(ConfigError, match="follow must be True"):
        batch_source_for(scan, follow=42)
    with pytest.raises(ConfigError, match="not started"):
        FollowBatchSource(scan).resume_state(3)


def test_follow_on_the_card_needs_one(cats):
    """The iterator's default device is the card: without one, follow mode
    raises like every entry point of the port instead of running on the
    CPU."""
    import torch

    _table(cats, "t", commits=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(Exception, match="(?i)cuda|card"):
        cats["port"].table("t").scan().to_torch_iter(follow=True)


# ---------------------------------------------------------- writer role
def _writer_line(pkg, tmp_path, capsys, *extra):
    import lakesoul_tpu.freshness.__main__ as ref_main
    import lakesoul_tpu_torch.freshness.__main__ as port_main

    main = port_main.main if pkg == "port" else ref_main.main
    root = tmp_path / pkg
    root.mkdir()
    out = root / "oracle.json"
    assert main(["writer", "--warehouse", str(root / "wh"), "--db-path", str(root / "meta.db"),
                 "--create", "--commits", "4", "--rows-per-commit", "300",
                 "--keyspace", "700", "--interval-s", "0", "--oracle-out", str(out),
                 *extra]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.read_text() == line
    return json.loads(line), root


def test_writer_line_is_the_references(tmp_path, capsys):
    lines = {pkg: _writer_line(pkg, tmp_path, capsys) for pkg in PKGS}
    port, ref = (dict(lines[p][0]) for p in PKGS)
    assert len(port.pop("commit_timestamps_ms")) == len(ref.pop("commit_timestamps_ms")) == 4
    assert port == ref and port["rows"] == 1200
    # the same commits: checkpoint ids are the reference's
    ids = {}
    for pkg in PKGS:
        root = lines[pkg][1]
        cat = LakeSoulCatalog(str(root / "wh"), db_path=str(root / "meta.db"))
        t = cat.table("fresh")
        vs = cat.client.store.get_partition_versions(t.info.table_id, "-5")
        ids[pkg] = [v.commit_op.value for v in vs]
        rows = t.scan().to_arrow().sort_by("id")
        ids[pkg + "_rows"] = rows.select(["id", "seq", "v"]).to_pydict()
    assert ids["port"] == ids["ref"] and ids["port_rows"] == ids["ref_rows"]


def test_oracle_sha_is_the_references():
    from lakesoul_tpu.freshness.__main__ import _row_value as ref_value
    from lakesoul_tpu.freshness.__main__ import oracle_sha as ref_sha
    from lakesoul_tpu_torch.freshness.__main__ import _row_value, oracle_sha

    rows = [(s, s % 7, _row_value(s)) for s in range(50)]
    assert [_row_value(s) for s in range(50)] == [ref_value(s) for s in range(50)]
    assert oracle_sha(rows) == ref_sha(rows) == oracle_sha(list(reversed(rows)))
    assert oracle_sha(rows) != oracle_sha(rows[:2])


def test_writer_rejects_in_commit_duplicate_pks(tmp_path):
    from lakesoul_tpu_torch.freshness.__main__ import main

    with pytest.raises(SystemExit):
        main(["writer", "--warehouse", str(tmp_path / "wh"),
              "--rows-per-commit", "10", "--keyspace", "5"])


# ------------------------------------------------- three roles, one process
def test_three_roles_in_one_process_hold_both_slos_under_faults(tmp_path, monkeypatch):
    """``tests/test_freshness_chaos.py``'s in-process leg on the port's
    roles: a writer thread, a leased compaction service thread and the
    follower under p=0.3 flaky-store and flaky-poll faults; delivery equals
    the writer's oracle, both SLOs hold, and a compaction commits."""
    from lakesoul_tpu_torch.compaction import LeasedCompactionService
    from lakesoul_tpu_torch.freshness.__main__ import oracle_sha
    from lakesoul_tpu_torch.streaming.cdc import CheckpointedWriter

    for k, v in (("LAKESOUL_RETRY_MAX_ATTEMPTS", "10"), ("LAKESOUL_RETRY_BASE_S", "0.002"),
                 ("LAKESOUL_RETRY_CAP_S", "0.02"), ("LAKESOUL_RETRY_SEED", "7")):
        monkeypatch.setenv(k, v)
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    catalog = LakeSoulCatalog(wh, db_path=db)
    t = catalog.create_table("fresh", SCHEMA, primary_keys=["id"], hash_bucket_num=2, cdc=True)
    start_ts = now_millis() - 1
    commits, per, keyspace = 10, 400, 1024
    expected = commits * per
    svc = LeasedCompactionService(LakeSoulCatalog(wh, db_path=db), service_id="inproc-compactor",
                                  lease_ttl_s=5.0, poll_interval_s=0.05, version_gap=3)
    svc_thread = threading.Thread(target=svc.run_forever, daemon=True)
    oracle: list = []

    def write_role():
        w, cdc_col, seq = CheckpointedWriter(t), t.info.cdc_column, 0
        for ckpt in range(commits):
            seqs = list(range(seq, seq + per))
            ids = [s % keyspace for s in seqs]
            vals = [float(s % 1009) / 7.0 for s in seqs]
            kinds = ["insert" if s < keyspace else "update" for s in seqs]
            oracle.extend(zip(seqs, ids, vals))
            seq += per
            w.write(pa.table({"id": ids, "seq": seqs, "v": vals, cdc_col: kinds},
                             schema=t.schema))
            w.checkpoint(ckpt)
            time.sleep(0.05)

    writer = threading.Thread(target=write_role, daemon=True)
    slo = SloMonitor(target_s=10.0, budget_fraction=0.05, slo="port-chaos-inproc")
    tput = ThroughputSlo(100.0, slo="port-chaos-inproc-tput")
    stop = threading.Event()
    follower = FreshFollower(
        catalog.table("fresh").scan().batch_size(2048), start_timestamp_ms=start_ts,
        poll_interval=0.05, stop_event=stop,
        retry_policy=RetryPolicy(max_attempts=12, base_delay_s=0.002, max_delay_s=0.05, seed=7),
        slo=slo)
    rows: list = []

    def consume():
        for b in follower.iter_batches():
            rows.extend(zip(*(b.column(c).to_pylist() for c in ("seq", "id", "v"))))
            if len(rows) >= expected:
                stop.set()

    for spec in ("follow.poll:0.3:flaky", "object_store.cat_file:0.3:flaky",
                 "object_store.open:0.3:flaky"):
        faults.install(spec)
    try:
        tput.start()
        svc_thread.start()
        writer.start()
        th = threading.Thread(target=consume, daemon=True)
        th.start()
        th.join(timeout=90.0)
        tput.add_rows(len(rows))
    finally:
        faults.clear()
        svc.stop()
        stop.set()
    writer.join(timeout=30.0)
    svc_thread.join(timeout=10.0)
    assert not writer.is_alive() and not svc_thread.is_alive()
    assert len(rows) == expected, f"delivered {len(rows)} of {expected}"
    assert oracle_sha(rows) == oracle_sha(oracle)
    snap = slo.snapshot()
    assert snap["count"] >= 1 and snap["in_budget"] and snap["p99_s"] <= 10.0, snap
    assert tput.evaluate()["ok"]
    versions = catalog.client.store.get_partition_versions(t.info.table_id, "-5")
    assert any(v.commit_op == CommitOp.COMPACTION for v in versions)
