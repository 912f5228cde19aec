"""The port's scan-plane worker autoscaler (``lakesoul_tpu_torch/fleet/
autoscale.py`` and ``python -m lakesoul_tpu_torch.fleet autoscale``) against
the reference's.

- Policy: ``AutoscalePolicy.target`` gives the reference's answers over a
  grid of signals and fleet sizes.
- Signals: ``spool_backlog`` and ``collect_signals`` are equal on one spool.
- Controller: ``WorkerAutoscaler`` with a fake spawner emits the reference's
  event sequence — leader, spawn, backfill, a failed renewal and demotion,
  a standby's takeover with a bumped token — and a reference controller and
  a port controller on one spool contend for the same lease.
- Spawner: ``worker_argv`` names the port's worker; a retired child is
  reaped, never a deficit.
- The entry point: reaches its minimum, backfills a SIGKILLed worker, and
  leaves no child behind after SIGINT.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import lakesoul_tpu.fleet.autoscale as ref_autoscale
from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.errors import ConfigError as RefConfigError
from lakesoul_tpu.scanplane.session import ScanSession as RefSession
from lakesoul_tpu.scanplane.worker import ScanPlaneWorker as RefWorker
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.fleet import autoscale
from lakesoul_tpu_torch.obs import fleet as obs_fleet
from lakesoul_tpu_torch.scanplane.session import ScanSession
from lakesoul_tpu_torch.scanplane.worker import ScanPlaneWorker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64()), ("f", pa.float32())])
PKGS = ("port", "ref")
MODS = {"port": autoscale, "ref": ref_autoscale}
SESSIONS = {"port": ScanSession, "ref": RefSession}
WORKERS = {"port": ScanPlaneWorker, "ref": RefWorker}


@pytest.fixture
def shared(tmp_path, monkeypatch):
    """``tests/test_fleet.py``'s table, both packages' catalogs over it."""
    monkeypatch.delenv(obs_fleet.ENV_SPOOL, raising=False)
    wh, db = str(tmp_path / "wh"), str(tmp_path / "meta.db")
    cat = LakeSoulCatalog(wh, db_path=db)
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    rng = np.random.default_rng(7)
    rows, commits = 6000, 3
    per = rows // commits
    for _ in range(commits):
        ids = np.sort(rng.choice(rows * 2, per, replace=False)).astype(np.int64)
        t.upsert(pa.table({"id": ids, "v": rng.normal(size=per),
                           "f": rng.normal(size=per).astype(np.float32)}, schema=SCHEMA))
    return {"port": cat, "ref": RefCatalog(wh, db_path=db), "root": tmp_path}


class _FakeSpawner:
    """A spawner whose children are list entries, not processes."""

    def __init__(self):
        self._children, self._dead, self._seq, self.stopped = [], [], 0, 0

    @property
    def count(self):
        return len(self._children)

    def spawn(self):
        self._seq += 1
        child = {"worker_id": f"fake-{self._seq}", "pid": 40_000 + self._seq}
        self._children.append(child)
        return child

    def retire(self):
        return {"pid": self._children.pop()["pid"]} if self._children else None

    def kill_one(self):
        self._dead.append(self._children.pop(0))

    def reap(self):
        dead = [{"pid": c["pid"], "returncode": -9} for c in self._dead]
        self._dead = []
        return dead

    def stop_all(self, timeout=10.0):
        self.stopped += 1
        self._children = []


# ------------------------------------------------------------------ policy
POLICY_GRID = {
    "backlog_maps_to_workers": ((1, 8, 4, 3), [(1, False, 0), (9, False, 1), (100, False, 1)]),
    "slo_breach_jumps_to_max": ((1, 6, 4, 3), [(2, True, 1), (0, True, 6), (3, False, 6)]),
    "never_shrinks_under_backlog": ((1, 8, 4, 3), [(2, False, 5), (1, False, 7)]),
    "idle_debounce": ((1, 8, 4, 3), [(0, False, 4)] * 3 + [(0, False, 1)]),
    "idle_streak_resets": ((1, 8, 4, 2), [(0, False, 3), (4, False, 3), (0, False, 3),
                                          (0, False, 3)]),
    "zero_floor": ((0, 3, 2, 1), [(0, False, 0), (5, False, 0), (0, False, 3)]),
    "max_one": ((1, 1, 1, 1), [(50, True, 0), (0, False, 1)]),
    "rpw_zero_is_one": ((0, 5, 0, 2), [(3, False, 0), (9, False, 3)]),
}


@pytest.mark.parametrize("case", sorted(POLICY_GRID))
def test_policy_gives_the_references_targets(case):
    (lo, hi, rpw, idle), steps = POLICY_GRID[case]
    got = {}
    for pkg in PKGS:
        mod = MODS[pkg]
        p = mod.AutoscalePolicy(lo, hi, ranges_per_worker=rpw, idle_polls_to_scale_down=idle)
        got[pkg] = [p.target(mod.AutoscaleSignals(backlog=b, slo_breached=s), current=c)
                    for b, s, c in steps]
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("bounds", [(5, 2), (-1, 2)])
def test_invalid_bounds_are_refused_as_the_reference(bounds):
    with pytest.raises(ConfigError) as p:
        autoscale.AutoscalePolicy(*bounds)
    with pytest.raises(RefConfigError) as r:
        ref_autoscale.AutoscalePolicy(*bounds)
    assert str(p.value) == str(r.value)


def test_lease_key_is_the_references(tmp_path):
    spool = str(tmp_path / "spool")
    assert autoscale.lease_key(spool) == ref_autoscale.lease_key(spool)
    assert autoscale.lease_key(spool).startswith("fleet/autoscaler/")
    assert autoscale.lease_key(spool + "/.") == autoscale.lease_key(spool)


# ----------------------------------------------------------------- signals
def test_signals_are_the_references_on_one_spool(shared):
    spool = str(shared["root"] / "spool")
    got = lambda: {pkg: (MODS[pkg].spool_backlog(spool),  # noqa: E731
                         vars(MODS[pkg].collect_signals(spool)))
                   for pkg in PKGS}
    first = got()
    assert first["port"] == first["ref"] and first["port"][0] == (0, 0)
    session = ScanSession.plan(shared["port"], {"table": "t"})
    session.publish(spool)
    second = got()
    assert second["port"] == second["ref"]
    assert second["port"][0] == (len(session.ranges), 1)
    ScanPlaneWorker(shared["port"], spool, lease_ttl_s=10).poll_once()
    assert got()["port"][0] == got()["ref"][0] == (0, 0)


def test_collect_signals_reads_an_armed_obs_spool(shared, tmp_path):
    obs = tmp_path / "obs"
    obs.mkdir()
    obs_fleet.FleetPublisher(str(obs), flush_s=60.0).flush(reason="test")
    spool = str(shared["root"] / "spool")
    port = vars(autoscale.collect_signals(spool, obs_spool=str(obs)))
    ref = vars(ref_autoscale.collect_signals(spool, obs_spool=str(obs)))
    # the rate divides the member's rows by the seconds since it started:
    # read a moment apart, the two differ
    assert port.pop("rows_per_s") >= 0.0 and ref.pop("rows_per_s") >= 0.0
    # the published snapshot is this process's registry: whether its
    # freshness SLO is breached depends on what ran here before
    assert port == ref and isinstance(port["slo_breached"], bool)


# -------------------------------------------------------------- controller
def _controllers(shared, *, min_w=1, max_w=4, cid="A"):
    """One controller per package, each on its own spool holding the same
    published session (so the lease keys differ and the backlogs agree)."""
    out = {}
    for pkg in PKGS:
        spool = str(shared["root"] / f"spool-{pkg}")
        SESSIONS[pkg].plan(shared[pkg], {"table": "t"}).publish(spool)
        out[pkg] = MODS[pkg].WorkerAutoscaler(
            shared[pkg].client.store, _FakeSpawner(), spool_dir=spool, min_workers=min_w,
            max_workers=max_w, controller_id=cid, lease_ttl_s=10.0, heartbeat=False)
    return out


def test_leader_scales_to_backlog_then_down_as_the_reference(shared):
    ctls = _controllers(shared)
    now, got = 1_000_000, {}
    for pkg, ctl in ctls.items():
        ctl.policy.idle_polls_to_scale_down = 2
        events = ctl.step(now_ms=now)
        WORKERS[pkg](shared[pkg], ctl.spool_dir, lease_ttl_s=10).poll_once()
        events += ctl.step(now_ms=now + 1000) + ctl.step(now_ms=now + 2000)
        got[pkg] = (events, ctl.fencing_token, ctl.spawner.count)
        ctl.stop()
    assert got["port"] == got["ref"]
    kinds = [e["event"] for e in got["port"][0]]
    assert kinds[0] == "leader" and "spawn" in kinds
    assert [e["workers"] for e in got["port"][0] if e["event"] == "tick"][-1] == 1
    assert got["port"][1:] == (1, 1)


def test_a_sigkilled_worker_is_backfilled_as_the_reference(shared):
    ctls = _controllers(shared, min_w=2)
    got = {}
    for pkg, ctl in ctls.items():
        events = ctl.step(now_ms=1_000_000)
        ctl.spawner.kill_one()  # SIGKILL from outside
        events += ctl.step(now_ms=1_001_000)
        got[pkg] = (events, ctl.spawner.count)
        ctl.stop()
    assert got["port"] == got["ref"]
    kinds = [e["event"] for e in got["port"][0]]
    assert "worker_exit" in kinds and kinds.index("worker_exit") < len(kinds) - 2


@pytest.mark.parametrize("a_pkg,b_pkg", [("port", "port"), ("ref", "port"), ("port", "ref")])
def test_fenced_takeover_bumps_the_token_and_demotes_the_zombie(shared, a_pkg, b_pkg):
    """``tests/test_fleet.py``'s takeover, with each controller of either
    package on ONE spool: B stands by while A leads, takes the lease over
    with a bumped token once A goes silent for a TTL, and A, waking,
    demotes itself and retires its own children."""
    spool = str(shared["root"] / "spool")
    ScanSession.plan(shared["port"], {"table": "t"}).publish(spool)

    def ctl(pkg, cid):
        return MODS[pkg].WorkerAutoscaler(
            shared[pkg].client.store, _FakeSpawner(), spool_dir=spool, min_workers=1,
            max_workers=4, controller_id=cid, lease_ttl_s=10.0, heartbeat=False)

    a, b = ctl(a_pkg, "A"), ctl(b_pkg, "B")
    assert a.key == b.key
    t0 = 1_000_000
    assert a.step(now_ms=t0)[0] == {"event": "leader", "controller": "A", "fence": 1,
                                    "takeover": False}
    assert b.step(now_ms=t0 + 500) == [{"event": "standby", "controller": "B"}]
    events = b.step(now_ms=t0 + 10_001)
    assert events[0] == {"event": "leader", "controller": "B", "fence": 2, "takeover": True}
    assert b.spawner.count >= 1 and a.spawner.count >= 1
    assert a.step(now_ms=t0 + 10_500) == [{"event": "fenced", "controller": "A"}]
    assert a.state == "standby" and a.fencing_token is None
    assert a.spawner.count == 0 and a.spawner.stopped >= 1
    assert b.step(now_ms=t0 + 11_000)[-1]["state"] == "leader"
    b.stop()
    a.stop()


def test_stop_releases_the_lease_for_an_immediate_successor(shared):
    spool = str(shared["root"] / "spool")
    mk = lambda cid: autoscale.WorkerAutoscaler(  # noqa: E731
        shared["port"].client.store, _FakeSpawner(), spool_dir=spool, controller_id=cid,
        heartbeat=False)
    a = mk("A")
    a.step(now_ms=1_000_000)
    a.stop()
    b = mk("B")
    assert b.step(now_ms=1_000_100)[0]["event"] == "leader"
    b.stop()


def test_the_heartbeat_keeps_a_leader_and_a_lost_lease_demotes_it(shared):
    """With the production heartbeat (the port's ``runtime/lease.py``), a
    leader keeps its lease past its TTL, and a renewal the store refuses
    demotes it on the next tick."""
    spool = str(shared["root"] / "spool")
    store = shared["port"].client.store
    ctl = autoscale.WorkerAutoscaler(store, _FakeSpawner(), spool_dir=spool, min_workers=1,
                                     controller_id="A", lease_ttl_s=0.3)
    assert ctl.step()[0]["event"] == "leader"
    time.sleep(0.5)
    assert ctl.step()[-1]["state"] == "leader"
    store.acquire_lease(ctl.key, "thief", 60_000, now_ms=10**15)  # past A's expiry
    deadline = time.monotonic() + 5.0
    while not ctl._heartbeat.fenced and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ctl.step() == [{"event": "fenced", "controller": "A"}]
    assert ctl.spawner.count == 0
    ctl.stop()


# ----------------------------------------------------------------- spawner
def test_worker_argv_names_the_ports_worker(tmp_path):
    kw = dict(db_path=str(tmp_path / "meta.db"), lease_ttl_s=2.0, poll_s=0.05)
    port = autoscale.WorkerSpawner(str(tmp_path / "wh"), str(tmp_path / "spool"), **kw)
    ref = ref_autoscale.WorkerSpawner(str(tmp_path / "wh"), str(tmp_path / "spool"), **kw)
    argv = port.worker_argv("fleet-1-1")
    assert argv[1:4] == ["-m", "lakesoul_tpu_torch.scanplane", "worker"]
    want = ref.worker_argv("fleet-1-1")
    assert argv[4:] == want[4:] and want[2] == "lakesoul_tpu.scanplane"


def test_a_retired_child_is_reaped_and_never_a_deficit(tmp_path):
    sp = autoscale.WorkerSpawner(str(tmp_path / "wh"), str(tmp_path / "spool"))
    sp.worker_argv = lambda worker_id: [sys.executable, "-c", "import time; time.sleep(60)"]
    sp.spawn()
    child = sp._children[0]
    assert sp.retire() == {"pid": child.pid}
    assert sp._retiring == [child] and sp.count == 0
    deadline, deficit = time.monotonic() + 10.0, []
    while sp._retiring and time.monotonic() < deadline:
        deficit += sp.reap()
        time.sleep(0.05)
    assert sp._retiring == [] and child.returncode is not None and deficit == []
    assert sp.retire() is None


def test_emit_jsonl_prints_the_references_line(capsys):
    ev = {"event": "spawn", "worker_id": "w", "pid": 7}
    autoscale.emit_jsonl(ev)
    ref_autoscale.emit_jsonl(ev)
    port, ref = capsys.readouterr().out.splitlines()
    assert port == ref == json.dumps(ev, sort_keys=True)


# ------------------------------------------------------------- entry point
def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_the_autoscale_entry_point_backfills_and_leaves_no_child(shared):
    """``python -m lakesoul_tpu_torch.fleet autoscale`` reaches its minimum,
    backfills a SIGKILLed worker after its ``worker_exit`` line, and on
    SIGINT stops every worker it spawned."""
    spool = str(shared["root"] / "spool")
    os.makedirs(spool)
    cat = shared["port"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop(obs_fleet.ENV_SPOOL, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.fleet", "autoscale",
         "--warehouse", cat.warehouse, "--db-path", cat.client.store.db_path,
         "--spool", spool, "--min-workers", "2", "--max-workers", "3",
         "--lease-ttl-s", "5", "--poll-s", "0.1", "--worker-poll-s", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT)
    events: list[dict] = []

    def pump():
        for line in proc.stdout:
            try:
                events.append(json.loads(line))
            except ValueError:
                continue

    threading.Thread(target=pump, daemon=True).start()

    def wait_for(pred, timeout_s):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return False

    spawned = lambda: [e["pid"] for e in list(events) if e.get("event") == "spawn"]  # noqa: E731
    try:
        assert wait_for(lambda: len(spawned()) >= 2, 60.0), events[-5:]
        first = events[0]
        assert first["event"] == "autoscaler" and (first["min"], first["max"]) == (2, 3)
        assert any(e.get("event") == "leader" and e["fence"] == 1 for e in events)
        victim = spawned()[0]
        os.kill(victim, signal.SIGKILL)

        def backfilled():
            snap = list(events)
            exits = [i for i, e in enumerate(snap)
                     if e.get("event") == "worker_exit" and e["pid"] == victim]
            return exits and any(e.get("event") == "spawn" for e in snap[exits[0] + 1:])

        assert wait_for(backfilled, 30.0), events[-8:]
        children = spawned()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30.0) == 0
        assert wait_for(lambda: not any(_alive(p) for p in children), 10.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10.0)
        for pid in spawned():
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
