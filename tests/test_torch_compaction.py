"""The port's compaction package (``lakesoul_tpu_torch/compaction/``) against
the reference's: the same seeded calls on twin warehouses, or both packages
on one warehouse and one SQLite metadata store where the point is that they
work together.

- ``CompactionService``: store triggers and ``sweep`` give the reference's
  partition versions (ops, file counts) and scan sha256.
- ``LeasedCompactionService``: a zombie's commit is fenced; a job longer
  than its TTL completes through the heartbeat; ``PollingWatermarkNotifier``
  derives the reference's candidates and isolates a raising listener; a
  reference compactor and a port compactor on one store fence each other.
- ``Cleaner``: with ``now_ms`` pinned, its counts and the files it leaves
  are the reference's; ``CALL clean`` returns the reference's table.
- ``python -m lakesoul_tpu_torch.compaction --once`` runs in a subprocess.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import lakesoul_tpu.compaction as ref_compaction
from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.compaction.events import PollingWatermarkNotifier as RefNotifier
from lakesoul_tpu.errors import LeaseFencedError as RefLeaseFencedError
from lakesoul_tpu.sql import SqlSession as RefSqlSession
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.compaction import Cleaner, CompactionService, LeasedCompactionService
from lakesoul_tpu_torch.compaction.events import PollingWatermarkNotifier
from lakesoul_tpu_torch.errors import LeaseFencedError
from lakesoul_tpu_torch.meta.entity import CommitOp
from lakesoul_tpu_torch.meta.store import COMPACTION_TRIGGER_VERSION_GAP
from lakesoul_tpu_torch.obs import registry
from lakesoul_tpu_torch.runtime import faults
from lakesoul_tpu_torch.runtime.resilience import RetryPolicy
from lakesoul_tpu_torch.sql import SqlSession
from lakesoul_tpu_torch.analysis.arm import armed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64())])
PKGS = ("port", "ref")
CATALOGS = {"port": LakeSoulCatalog, "ref": RefCatalog}
MODS = {
    "port": {"CompactionService": CompactionService, "Cleaner": Cleaner,
             "Leased": LeasedCompactionService, "Fenced": LeaseFencedError,
             "Notifier": PollingWatermarkNotifier},
    "ref": {"CompactionService": ref_compaction.CompactionService,
            "Cleaner": ref_compaction.Cleaner, "Leased": ref_compaction.LeasedCompactionService,
            "Fenced": RefLeaseFencedError, "Notifier": RefNotifier},
}


@pytest.fixture
def twins(tmp_path):
    """One warehouse per package, written by the same seeded calls."""
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        out[pkg] = CATALOGS[pkg](str(tmp_path / pkg / "wh"), db_path=str(tmp_path / pkg / "meta.db"))
    return out


@pytest.fixture
def shared(tmp_path):
    """Both packages on one warehouse and one metadata store."""
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    return {pkg: CATALOGS[pkg](wh, db_path=db) for pkg in PKGS}


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


def _stack_versions(t, n=12, rows=6):
    for i in range(n):
        t.upsert(pa.table({"id": np.arange(rows, dtype=np.int64), "v": np.full(rows, float(i))}))


def _sha(table) -> str:
    got = table.scan().to_arrow().sort_by("id")
    return hashlib.sha256(repr(got.to_pydict()).encode()).hexdigest()


def _versions(cat, t):
    """(version, op, files) per partition version: what a compaction leaves."""
    store = cat.client.store
    out = []
    for head in store.get_all_latest_partition_info(t.info.table_id):
        for v in store.get_partition_versions(t.info.table_id, head.partition_desc):
            files = sum(len(c.file_ops) for c in store.get_data_commit_info(
                t.info.table_id, head.partition_desc, list(v.snapshot)))
            out.append((head.partition_desc, v.version, v.commit_op.value, files, v.expression))
    return out


def _data_files(cat) -> list[str]:
    root = cat.warehouse
    return sorted(os.path.relpath(os.path.join(d, f), root).split(os.sep)[0]
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".parquet"))


# ------------------------------------------------------ CompactionService
def test_store_triggers_compact_as_the_reference(twins):
    out = {}
    for pkg, cat in twins.items():
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
        svc = MODS[pkg]["CompactionService"](cat, workers=1, min_file_num=2)
        svc.start()
        try:
            for i in range(COMPACTION_TRIGGER_VERSION_GAP + 1):
                t.write_arrow(pa.table({"id": [i], "v": [float(i)]}))
            svc.drain()
        finally:
            svc.stop()
        out[pkg] = (svc.stats.triggered, svc.stats.compacted, svc.stats.errors,
                    [v[2:4] for v in _versions(cat, t)], _sha(t))
    assert out["port"] == out["ref"]
    assert out["port"][1] >= 1 and out["port"][2] == 0
    assert ("CompactionCommit", 1) in out["port"][3]


def test_sweep_compacts_as_the_reference(twins):
    out = {}
    for pkg, cat in twins.items():
        for name, buckets in (("s", 1), ("h", 3)):
            t = cat.create_table(name, SCHEMA, primary_keys=["id"], hash_bucket_num=buckets)
            t.write_arrow(pa.table({"id": [1, 2, 3], "v": [1.0, 2.0, 3.0]}))
            t.write_arrow(pa.table({"id": [2, 5], "v": [20.0, 5.0]}))
        svc = MODS[pkg]["CompactionService"](cat, min_file_num=2)
        first, again = svc.sweep(), svc.sweep()
        out[pkg] = (first, again, [_versions(cat, cat.table(n)) for n in ("s", "h")],
                    [_sha(cat.table(n)) for n in ("s", "h")])
    strip = lambda o: (o[0], o[1], [[v[1:4] for v in vs] for vs in o[2]], o[3])  # noqa: E731
    assert strip(out["port"]) == strip(out["ref"])
    assert out["port"][:2] == (2, 0)


# ------------------------------------------------ LeasedCompactionService
def test_a_zombie_compaction_commit_is_fenced(shared):
    """``tests/test_lease.py``'s zombie: a compactor past its TTL and
    replaced cannot land its commit; the peer's lands stamped with its
    token."""
    cat = shared["port"]
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t)
    store = cat.client.store
    zombie = store.acquire_lease("compaction/x", "zombie", ttl_ms=1)
    time.sleep(0.01)
    peer = store.acquire_lease("compaction/x", "peer", ttl_ms=60_000)
    assert peer.taken_over and peer.fencing_token == 2
    before = t.to_arrow().sort_by("id")
    with pytest.raises(LeaseFencedError):
        t.compact(lease=zombie)
    head = store.get_latest_partition_info(t.info.table_id, "-5")
    assert head.commit_op != CommitOp.COMPACTION
    assert t.refresh().to_arrow().sort_by("id").equals(before)
    assert store.list_uncommitted_commits() == []
    assert t.compact(lease=peer) == 1
    head = store.get_latest_partition_info(t.info.table_id, "-5")
    assert (head.commit_op, head.expression) == (CommitOp.COMPACTION, "fence=2")


def test_a_job_longer_than_its_ttl_completes_through_the_heartbeat(shared):
    cat = shared["port"]
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t)
    svc = LeasedCompactionService(cat, lease_ttl_s=0.3, poll_interval_s=0.01)
    faults.install("compaction.leased_job:1.0:delay:0.9")  # 3x the TTL in the lease
    counts = svc.poll_once()
    assert counts["compacted"] == 1 and counts["fenced"] == 0, counts
    head = cat.client.store.get_latest_partition_info(t.info.table_id, "-5")
    assert (head.commit_op, head.expression) == (CommitOp.COMPACTION, "fence=1")
    assert svc.poll_once()["candidates"] == 0
    assert registry().gauge("lakesoul_lease_state", key=f"compaction/{t.info.table_id}/-5").value == 0


def test_a_lapsed_lease_fences_the_job_before_it_compacts(shared, monkeypatch):
    """The heartbeat's renewal failing (a peer fenced past it) makes the
    job raise ``LeaseFencedError`` before the compaction, counted
    ``fenced``, never retried into a silent success."""
    cat = shared["port"]
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t)
    monkeypatch.setattr(cat.client.store, "renew_lease", lambda *a, **k: None)
    svc = LeasedCompactionService(cat, lease_ttl_s=0.15, poll_interval_s=0.01)
    faults.install("compaction.leased_job:1.0:delay:0.3")
    counts = svc.poll_once()
    assert counts["fenced"] == 1 and counts["compacted"] == 0, counts
    head = cat.client.store.get_latest_partition_info(t.info.table_id, "-5")
    assert head.commit_op != CommitOp.COMPACTION


def test_polling_notifier_gives_the_references_candidates(shared):
    for name in ("t", "u"):
        _stack_versions(shared["port"].create_table(name, SCHEMA, primary_keys=["id"],
                                                    hash_bucket_num=2), n=7)
    seen = {}
    for pkg, cat in shared.items():
        for gap in (3, 10):
            n = MODS[pkg]["Notifier"](cat.client.store, version_gap=gap)
            got = []
            n.listen(got.append)
            assert n.poll() == len(got)
            seen[pkg, gap] = sorted((e.table_id, e.partition_desc, e.version, e.table_path)
                                    for e in got)
    assert seen["port", 3] == seen["ref", 3] and len(seen["port", 3]) == 2
    assert seen["port", 10] == seen["ref", 10] == []


def test_a_raising_listener_does_not_starve_the_others(shared):
    t = shared["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t, n=4, rows=5)
    n = PollingWatermarkNotifier(shared["port"].client.store, version_gap=2)
    seen: list = []

    def bad(ev):
        raise RuntimeError("listener bug")

    n.listen(bad)
    n.listen(seen.append)
    errors = registry().counter("lakesoul_notifier_listener_errors_total")
    before = errors.value
    delivered = n.poll()
    assert delivered >= 1 and len(seen) == delivered
    assert errors.value - before == delivered


def test_store_errors_retry_then_fail_only_the_poll(shared):
    t = shared["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t, n=4, rows=5)
    store = shared["port"].client.store
    calls = {"n": 0}

    class FlakyStore:
        def get_compaction_candidates(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ConnectionError("transient store blip")
            return store.get_compaction_candidates(*a, **k)

    policy = RetryPolicy(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01, seed=7)
    n = PollingWatermarkNotifier(FlakyStore(), version_gap=2, retry_policy=policy)
    n.listen(lambda ev: None)
    assert n.poll() >= 1 and calls["n"] == 2

    class DeadStore:
        def get_compaction_candidates(self, *a, **k):
            raise ConnectionError("store down")

    dead = PollingWatermarkNotifier(DeadStore(), version_gap=2, retry_policy=policy)
    dead.listen(lambda ev: None)
    polls = registry().counter("lakesoul_notifier_poll_errors_total")
    before = polls.value
    assert dead.poll() == 0 and polls.value - before == 1


@pytest.mark.parametrize("holder,taker", [("ref", "port"), ("port", "ref")])
def test_a_reference_and_a_port_compactor_fence_each_other(shared, holder, taker):
    """Both packages' compactors on one store share the lease keys: a
    holder that stalls past its TTL is taken over by the other package's
    service, whose commit is stamped ``fence=2``, and the holder's late
    commit is fenced with its own package's error."""
    t = shared["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t)
    key = f"compaction/{t.info.table_id}/-5"
    zombie = shared[holder].client.store.acquire_lease(key, "zombie", ttl_ms=1)
    held = MODS[taker]["Leased"](shared[taker], lease_ttl_s=30, poll_interval_s=0.01)
    time.sleep(0.01)
    counts = held.poll_once()
    assert counts["compacted"] == 1 and held.stats.takeovers == 1, counts
    head = shared["port"].client.store.get_latest_partition_info(t.info.table_id, "-5")
    assert (head.commit_op, head.expression) == (CommitOp.COMPACTION, "fence=2")
    _stack_versions(shared[holder].table("t"), n=3)
    with pytest.raises(MODS[holder]["Fenced"]):
        shared[holder].table("t").compact(lease=zombie)


def test_a_peer_holding_the_lease_is_skipped_in_either_package(shared):
    t = shared["port"].create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
    _stack_versions(t)
    key = f"compaction/{t.info.table_id}/-5"
    got = {}
    for other, pkg in (("ref", "port"), ("port", "ref")):
        lease = shared[other].client.store.acquire_lease(key, f"{other}-process", ttl_ms=60_000)
        got[pkg] = MODS[pkg]["Leased"](shared[pkg], lease_ttl_s=1, poll_interval_s=0.01).poll_once()
        shared[other].client.store.release_lease(key, f"{other}-process", lease.fencing_token)
    assert got["port"] == got["ref"] == {"candidates": 1, "compacted": 0, "skipped": 0,
                                         "lease_held": 1, "fenced": 0, "conflicts": 0,
                                         "errors": 0}


def test_leased_service_skips_a_judged_head_until_it_advances(twins):
    out = {}
    for pkg, cat in twins.items():
        t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=1)
        _stack_versions(t, n=4, rows=3)
        svc = MODS[pkg]["Leased"](cat, lease_ttl_s=30, poll_interval_s=0.01, version_gap=2,
                                  min_file_num=50)
        first, second = svc.poll_once(), svc.poll_once()
        out[pkg] = (first, second, svc.stats.triggered, svc.stats.skipped)
    assert out["port"] == out["ref"]
    assert out["port"][0]["skipped"] == 1 and out["port"][1]["skipped"] == 1


# ------------------------------------------------------------------ cleaner
CLEAN_CASES = ["versions_and_discard", "recent_untouched", "version_retention_property",
               "partition_ttl", "fresh_ttl", "invalid_ttl", "clean_all"]


def _clean(pkg, cat, case):
    cls = MODS[pkg]["Cleaner"]
    future = 10**14
    props = {"version_retention_property": {"lakesoul.version.retention": "0"},
             "partition_ttl": {"partition.ttl": "0"}, "fresh_ttl": {"partition.ttl": "7"},
             "invalid_ttl": {"partition.ttl": "soon", "lakesoul.version.retention": "nan"}}
    t = cat.create_table("c", SCHEMA, primary_keys=["id"], hash_bucket_num=1,
                         properties=props.get(case))
    t.write_arrow(pa.table({"id": [1], "v": [1.0]}))
    if case == "recent_untouched":
        return cls(cat).clean_table("c")
    t.write_arrow(pa.table({"id": [2], "v": [2.0]}))
    if case in ("partition_ttl", "fresh_ttl", "invalid_ttl"):
        time.sleep(0.002)
        c = cls(cat)
        return c.expire_partitions("c"), c.clean_table("c")
    t.compact()
    if case == "versions_and_discard":
        c = cls(cat, retention_ms=1, discard_grace_ms=1)
        return c.clean_table("c", now_ms=future), c.clean_discarded_files(now_ms=future)
    if case == "version_retention_property":
        time.sleep(0.002)
        return cls(cat).clean_table("c")
    t2 = cat.create_table("d", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    _stack_versions(t2, n=3)
    t2.compact()
    return cls(cat, retention_ms=1, discard_grace_ms=1).clean_all(now_ms=future)


@pytest.mark.parametrize("case", CLEAN_CASES)
def test_the_cleaner_matches_the_reference(twins, case, caplog):
    out = {}
    for pkg, cat in twins.items():
        with caplog.at_level(logging.WARNING):
            result = _clean(pkg, cat, case)
        tables = sorted(cat.list_tables())
        out[pkg] = (result, _data_files(cat), [_sha(cat.table(n)) for n in tables],
                    [len(_versions(cat, cat.table(n))) for n in tables])
    assert out["port"] == out["ref"]
    if case == "versions_and_discard":
        assert out["port"][0][0]["versions_dropped"] >= 2 and out["port"][0][1] == 2
    if case == "partition_ttl":
        assert out["port"][0][0] == 1 and out["port"][1] == []
    if case == "invalid_ttl":
        assert any("ttl" in r.getMessage() for r in caplog.records
                   if r.name == "lakesoul_tpu_torch.compaction.cleaner")


def test_call_clean_returns_the_references_table(twins):
    got = {}
    for pkg, cat in twins.items():
        t = cat.create_table("c", SCHEMA, primary_keys=["id"], hash_bucket_num=1,
                             properties={"lakesoul.version.retention": "0"})
        t.write_arrow(pa.table({"id": [1], "v": [1.0]}))
        t.write_arrow(pa.table({"id": [2], "v": [2.0]}))
        t.compact()
        time.sleep(0.002)
        session = SqlSession(cat, device="cpu") if pkg == "port" else RefSqlSession(cat)
        got[pkg] = session.execute("CALL clean()")
    assert got["port"].equals(got["ref"])
    assert got["port"].column_names == ["versions_dropped", "files_deleted",
                                        "discarded_deleted", "partitions_expired"]
    assert got["port"].column("versions_dropped")[0].as_py() >= 2


# -------------------------------------------------------------- entry point
def test_the_compaction_entry_point_runs_once(twins):
    """``python -m lakesoul_tpu_torch.compaction --once`` in a subprocess:
    its line is the reference service's counts on a twin warehouse."""
    want = {}
    for pkg, cat in twins.items():
        for name in ("t", "u"):
            _stack_versions(cat.create_table(name, SCHEMA, primary_keys=["id"],
                                             hash_bucket_num=2), n=4)
        if pkg == "ref":
            want = ref_compaction.LeasedCompactionService(cat, version_gap=3).poll_once()
    port = twins["port"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("LAKESOUL_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "lakesoul_tpu_torch.compaction", "--warehouse", port.warehouse,
         "--db-path", port.client.store.db_path, "--once", "--version-gap", "3",
         "--service-id", "once", "--min-file-num", "2"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == want and got["compacted"] == 2
    for name in ("t", "u"):
        head = port.client.store.get_latest_partition_info(port.table(name).info.table_id, "-5")
        assert (head.commit_op, head.expression) == (CommitOp.COMPACTION, "fence=1")


def test_run_forever_stops_within_one_tick(shared):
    svc = LeasedCompactionService(shared["port"], lease_ttl_s=5, poll_interval_s=30.0)
    th = threading.Thread(target=svc.run_forever, daemon=True)
    th.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    svc.stop()
    th.join(5.0)
    assert not th.is_alive() and time.monotonic() - t0 < 2.0
    assert svc.service_id.startswith("compactor-")



# --------------------------------------------- a compaction beside a hot writer
# The reference's compaction commit needs the head it read
# (lakesoul_tpu/meta/client.py, the Compaction branch of _commit_data_once),
# so a writer that commits more often than one pass takes starves it: the
# port's compact() catches up, merging again only what the writer added.


def _racing(monkeypatch, moves):
    """Run ``moves`` (callables) one before each compaction commit attempt:
    each moves the head, so that attempt loses its race.  Returns the head
    versions the attempts were made against."""
    from lakesoul_tpu_torch.catalog import LakeSoulTable

    real = LakeSoulTable._commit_staged
    pending, attempts = list(moves), []

    def racing(self, head, outputs, commit_op, **kw):
        if commit_op is CommitOp.COMPACTION:
            attempts.append(head.version)
            if pending:
                pending.pop(0)()
        return real(self, head, outputs, commit_op, **kw)

    monkeypatch.setattr(LakeSoulTable, "_commit_staged", racing)
    return attempts


def _upsert(t, ids, v):
    return lambda: t.upsert(pa.table({"id": np.asarray(ids, np.int64),
                                      "v": np.full(len(ids), float(v))}))


def _hot_table(tmp_path):
    cat = LakeSoulCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "meta.db"))
    t = cat.create_table("hot", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    _stack_versions(t, n=6, rows=8)
    return cat, t


def _parquet_paths(cat) -> set:
    return {os.path.join(d, f) for d, _, fs in os.walk(cat.warehouse) for f in fs
            if f.endswith(".parquet")}


def _head_paths(cat, t) -> set:
    store = cat.client.store
    head = store.get_latest_partition_info(t.info.table_id, "-5")
    return {op.path for c in store.get_data_commit_info(t.info.table_id, "-5", list(head.snapshot))
            for op in c.file_ops}


def test_a_compaction_catches_up_with_appends_that_land_mid_pass(tmp_path, monkeypatch):
    cat, t = _hot_table(tmp_path)
    attempts = _racing(monkeypatch, [_upsert(t, [1, 9], 100.0), _upsert(t, [2], 101.0),
                                     _upsert(t, [1, 11], 102.0)])
    rounds = registry().counter("lakesoul_compaction_catch_ups_total")
    before = rounds.value
    assert t.compact() == 1
    assert len(attempts) == 4 and rounds.value - before == 3  # three lost races, then the commit
    store = cat.client.store
    head = store.get_latest_partition_info(t.info.table_id, "-5")
    assert head.commit_op == CommitOp.COMPACTION
    assert all(u.primary_keys == [] for u in t.scan().scan_plan())  # read without a merge
    want = {i: 5.0 for i in range(8)}
    want.update({1: 102.0, 2: 101.0, 9: 100.0, 11: 102.0})
    got = t.scan().to_arrow().sort_by("id").to_pydict()
    assert dict(zip(got["id"], got["v"])) == want
    # every file on disk is the head's or awaits the cleaner: no staged debris
    discarded = {f for f, _, _ in store.list_discard_files()}
    assert _parquet_paths(cat) == _head_paths(cat, t) | discarded
    assert not (_head_paths(cat, t) & discarded)


def test_a_writer_that_wins_past_the_bound_makes_it_a_conflict(tmp_path, monkeypatch):
    """Catch-up is bounded: a writer that lands a commit before each of the
    pass's ``COMPACT_CATCH_UP`` + 1 commit attempts leaves it the
    reference's conflict, with what it staged deleted."""
    from lakesoul_tpu_torch.catalog import COMPACT_CATCH_UP
    from lakesoul_tpu_torch.errors import CommitConflictError

    cat, t = _hot_table(tmp_path)
    attempts = _racing(monkeypatch, [_upsert(t, [k], 7.0 + k) for k in range(COMPACT_CATCH_UP + 1)])
    rounds = registry().counter("lakesoul_compaction_catch_ups_total")
    before, files = rounds.value, _parquet_paths(cat)
    with pytest.raises(CommitConflictError):
        t.compact()
    assert len(attempts) == COMPACT_CATCH_UP + 1 and rounds.value - before == COMPACT_CATCH_UP
    # the staged outputs are gone: what is new on disk is the upserts' files
    assert _parquet_paths(cat) == files | _head_paths(cat, t)
    assert cat.client.store.get_latest_partition_info(t.info.table_id, "-5").commit_op \
        is not CommitOp.COMPACTION


def test_a_rewrite_mid_pass_is_still_a_conflict(tmp_path, monkeypatch):
    """Catch-up follows appends and merges only: a DML rewrite (or a delete)
    replaced the snapshot the pass read, so the job gives up and deletes
    what it staged."""
    from lakesoul_tpu_torch.errors import CommitConflictError
    from lakesoul_tpu_torch.io.filters import col

    cat, t = _hot_table(tmp_path)
    _racing(monkeypatch, [lambda: t.delete_where(col("id") == 4)])
    with pytest.raises(CommitConflictError, match="not only appended to"):
        t.compact()
    store = cat.client.store
    discarded = {f for f, _, _ in store.list_discard_files()}
    assert _parquet_paths(cat) == _head_paths(cat, t) | discarded
    assert store.get_latest_partition_info(t.info.table_id, "-5").commit_op is CommitOp.UPDATE


@pytest.mark.parametrize("past_the_bound", [False, True])
def test_the_leased_service_keeps_up_with_a_hot_writer(tmp_path, monkeypatch, past_the_bound):
    """A writer that lands an upsert before each of the job's first five
    commit attempts: the job commits in its first attempt's catch-up
    rounds.  One that lands an upsert before every commit attempt of all
    three tries (each is ``COMPACT_CATCH_UP`` + 1 attempts) outruns the
    bound: the job gives up, and says so."""
    from lakesoul_tpu_torch.catalog import COMPACT_CATCH_UP

    cat, t = _hot_table(tmp_path)
    n = 3 * (COMPACT_CATCH_UP + 1) if past_the_bound else 5
    _racing(monkeypatch, [_upsert(t, [k % 8], 50.0 + k) for k in range(n)])
    exhausted = registry().counter("lakesoul_retry_exhausted_total", op="compaction.conflict")
    before = exhausted.value
    svc = LeasedCompactionService(cat, service_id="hot", lease_ttl_s=30.0, version_gap=3)
    out = svc.poll_once()
    if past_the_bound:
        assert out["compacted"] == 0 and out["conflicts"] == 1, out
        assert exhausted.value == before + 1
    else:
        assert out["compacted"] == 1 and out["conflicts"] == 0, out
        assert exhausted.value == before
    got = t.scan().to_arrow().sort_by("id").to_pydict()
    want = {i: 5.0 for i in range(8)}
    want.update({k % 8: 50.0 + k for k in range(n)})
    assert dict(zip(got["id"], got["v"])) == want


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
