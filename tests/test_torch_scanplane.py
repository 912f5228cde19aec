"""The port's scan plane (``lakesoul_tpu_torch/scanplane/``, with
``fleet/transport.py``) against the reference's, on one warehouse and one
SQLite metadata store.

- Sessions: the session id, the ranges and the manifest are the reference's
  for the same scan; unsessionable scans are refused with its messages.
- Workers: every range's spool segment a port worker writes has the same
  bytes as the reference worker's.
- Delivery: a client's ranges are ``scan.shard(r, w)``'s; inline, spool,
  shm, spill and stream delivery give the local scan's batches; a worker
  killed mid-stream is taken over and the stream completes exactly once;
  explicit resume positions redeliver exactly.
- Interop: the port's client against the reference's gateway, and the
  reference's client against the port's, give the local scan's sha256.
- Consumers: ``via_scanplane(...).to_torch_iter(device="cpu")`` equals the
  local iterator byte for byte, with the workers' stage series merged;
  ``fleet train --location`` on two ranks prints the reference's lines and
  the shard oracle's; the ``service`` entry serves a ``drive`` client.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu.errors import ConfigError as RefConfigError
from lakesoul_tpu.scanplane.client import ScanPlaneClient as RefClient
from lakesoul_tpu.scanplane.delivery import ScanPlaneDelivery as RefDelivery
from lakesoul_tpu.scanplane.session import ScanSession as RefSession
from lakesoul_tpu.scanplane.session import session_request_from_scan as ref_request
from lakesoul_tpu.scanplane.worker import ScanPlaneWorker as RefWorker
from lakesoul_tpu.service.flight import LakeSoulFlightServer as RefServer
from lakesoul_tpu_torch import LakeSoulCatalog
from lakesoul_tpu_torch.errors import ConfigError, LakeSoulError
from lakesoul_tpu_torch.fleet.multihost import digest_batch
from lakesoul_tpu_torch.obs import queue_seconds_by_consumer, registry
from lakesoul_tpu_torch.scanplane import spool as spool_mod
from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient
from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery
from lakesoul_tpu_torch.scanplane.session import ScanSession, session_request_from_scan
from lakesoul_tpu_torch.scanplane.worker import ScanPlaneWorker
from lakesoul_tpu_torch.service.flight import LakeSoulFlightServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = pa.schema([("id", pa.int64()), ("v", pa.float64()), ("f", pa.float32())])
REQ = {"table": "t", "batch_size": 2048}


def _make_table(root, *, rows=24_000, commits=3):
    """``tests/test_scanplane.py``'s table: a primary key over 2 buckets,
    three upsert waves (merge on read)."""
    cat = LakeSoulCatalog(str(root / "wh"), db_path=str(root / "meta.db"))
    t = cat.create_table("t", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    rng = np.random.default_rng(7)
    per = rows // commits
    for _ in range(commits):
        ids = np.sort(rng.choice(rows * 2, per, replace=False)).astype(np.int64)
        t.upsert(pa.table({"id": ids, "v": rng.normal(size=per),
                           "f": rng.normal(size=per).astype(np.float32)}, schema=SCHEMA))
    return cat, t


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("scanplane")
    cat, t = _make_table(root)
    return root, cat, t


def _ref_catalog(root):
    return RefCatalog(str(root / "wh"), db_path=str(root / "meta.db"))


class _Plane:
    """An in-process fleet of either package: a gateway with spool delivery
    (``spool=False``: inline) and worker threads."""

    def __init__(self, cat, spool, *, ref=False, workers=1, wait_s=30.0):
        Delivery, Server, Worker = ((RefDelivery, RefServer, RefWorker) if ref else
                                    (ScanPlaneDelivery, LakeSoulFlightServer, ScanPlaneWorker))
        self.spool = str(spool) if spool else None
        if self.spool:
            os.makedirs(self.spool, exist_ok=True)
        self.delivery = Delivery(cat, self.spool, wait_s=wait_s)
        kw = {} if ref else {"device": "cpu"}
        self.server = Server(cat, "grpc://127.0.0.1:0", scanplane=self.delivery, **kw)
        threading.Thread(target=self.server.serve, daemon=True).start()
        self.location = f"grpc://127.0.0.1:{self.server.port}"
        self._stops = []
        for i in range(workers if self.spool else 0):
            w = Worker(cat, self.spool, lease_ttl_s=10, poll_interval_s=0.02,
                       worker_id=f"{'r' if ref else 'w'}{i}")
            stop = threading.Event()
            self._stops.append(stop)
            threading.Thread(target=w.run_forever, kwargs={"stop_event": stop},
                             daemon=True).start()

    def close(self):
        for s in self._stops:
            s.set()
        self.server.shutdown()


@pytest.fixture(scope="module")
def plane(table, tmp_path_factory):
    root, cat, _ = table
    p = _Plane(cat, tmp_path_factory.mktemp("spool"), workers=2)
    yield p
    p.close()


def _sha(batches) -> tuple[str, int]:
    """``scanplane drive``'s digest: each batch as a fresh IPC stream."""
    digest, rows = hashlib.sha256(), 0
    for b in batches:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, b.schema) as w:
            w.write_batch(b)
        digest.update(sink.getvalue().to_pybytes())
        rows += b.num_rows
    return digest.hexdigest(), rows


def _equal(got, want):
    assert len(got) == len(want) > 0
    assert all(a.equals(b) for a, b in zip(got, want))


# ------------------------------------------------------------------- sessions
def _manifest(session) -> dict:
    d = json.loads(session.to_json())
    d.pop("created_ms")
    return d


@pytest.mark.parametrize("req", [
    REQ,
    {"table": "t", "namespace": "default", "columns": ["id", "f"], "batch_size": 999},
    {"table": "t", "filter": {"op": "lt", "col": "id", "value": 9000}},
], ids=["plain", "projection", "filter"])
def test_sessions_equal_the_references(table, req):
    root, cat, t = table
    port, ref = ScanSession.plan(cat, req), RefSession.plan(_ref_catalog(root), req)
    assert port.session_id == ref.session_id
    assert _manifest(port) == _manifest(ref)
    assert len(port.ranges) == len(t.scan().scan_plan()) >= 2
    for world in (2, 3):
        for rank in range(world):
            assert port.client_ranges(rank, world) == ref.client_ranges(rank, world)
            assert [tuple(port.ranges[i].data_files) for i in port.client_ranges(rank, world)] \
                == [tuple(u.data_files) for u in t.scan().shard(rank, world).scan_plan()]


def test_session_requests_from_scans_equal_the_references(table):
    root, cat, t = table
    rt = _ref_catalog(root).table("t")
    scans = [(t.scan(), rt.scan()),
             (t.scan().select(["id"]).filter("id < 10").batch_size(7).with_cdc_deletes(),
              rt.scan().select(["id"]).filter("id < 10").batch_size(7).with_cdc_deletes())]
    for p, r in scans:
        assert session_request_from_scan(p) == ref_request(r)
    bad = [(t.scan().snapshot_at(1), rt.scan().snapshot_at(1)),
           (t.scan().incremental(0, 5), rt.scan().incremental(0, 5)),
           (t.scan().cache(), rt.scan().cache()),
           (t.scan().vector_search("v", [0.0]), rt.scan().vector_search("v", [0.0]))]
    for p, r in bad:
        with pytest.raises(ConfigError) as pe:
            session_request_from_scan(p)
        with pytest.raises(RefConfigError) as re_:
            ref_request(r)
        assert str(pe.value) == str(re_.value)


def test_a_manifest_published_by_either_loads_in_the_other(table, tmp_path):
    root, cat, _ = table
    port = ScanSession.plan(cat, REQ)
    port.publish(str(tmp_path / "a"))
    assert RefSession.load(str(tmp_path / "a"), port.session_id).to_json() == port.to_json()
    ref = RefSession.plan(_ref_catalog(root), REQ)
    ref.publish(str(tmp_path / "b"))
    assert ScanSession.load(str(tmp_path / "b"), ref.session_id).to_json() == ref.to_json()


# -------------------------------------------------------------------- workers
def _segment_shas(spool_dir, session) -> list:
    sdir = session.dir(spool_dir)
    out = []
    for i in range(len(session.ranges)):
        with open(spool_mod.segment_path(sdir, i), "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def test_worker_segments_are_the_references_byte_for_byte(table, tmp_path):
    root, cat, t = table
    shas = {}
    for pkg, c, Session, Worker in (("port", cat, ScanSession, ScanPlaneWorker),
                                    ("ref", _ref_catalog(root), RefSession, RefWorker)):
        sp = str(tmp_path / pkg)
        session = Session.plan(c, {"table": "t", "batch_size": 4096})
        session.publish(sp)
        counts = Worker(c, sp, lease_ttl_s=10, worker_id=f"{pkg}-w").poll_once()
        assert counts["produced"] == len(session.ranges) and counts["errors"] == 0
        shas[pkg] = _segment_shas(sp, session)
        side = spool_mod.read_sidecar(session.dir(sp), 0)
        assert side["fence"] >= 1 and side["worker"] == f"{pkg}-w"
        assert "decode" in side["stages"] and side["rows"] == sum(side["batch_rows"])
    assert shas["port"] == shas["ref"]
    # the segments concatenated are the in-process scan
    sdir = ScanSession.plan(cat, {"table": "t", "batch_size": 4096}).dir(str(tmp_path / "port"))
    got = [b for i in range(len(shas["port"])) for b in spool_mod.read_range(sdir, i)[1]]
    _equal(got, list(t.scan().batch_size(4096).to_batches()))


def test_a_live_lease_is_respected_then_taken_over(table, tmp_path):
    _, cat, _ = table
    sp = str(tmp_path / "spool")
    session = ScanSession.plan(cat, {"table": "t"})
    session.publish(sp)
    store = cat.client.store
    key = f"scanplane/{session.session_id}/0"
    assert store.acquire_lease(key, "peer", 60_000) is not None
    worker = ScanPlaneWorker(cat, sp, lease_ttl_s=5)
    assert worker.poll_once()["lease_held"] == 1
    held = store.get_lease(key)
    assert store.renew_lease(key, "peer", held.fencing_token, 1) is not None
    time.sleep(0.05)
    assert worker.poll_once()["produced"] >= 1
    assert spool_mod.read_sidecar(session.dir(sp), 0)["fence"] == held.fencing_token + 1


# ------------------------------------------------------------------- delivery
@pytest.mark.parametrize("how", ["inline", "shm", "socket", "stream", "spill"])
def test_every_delivery_gives_the_local_batches(table, plane, how, tmp_path, monkeypatch):
    _, cat, t = table
    kw = {"socket": {"shm": False}, "stream": {"transport": "stream"},
          "spill": {"transport": "spill"}, "shm": {"shm": True}}.get(how, {})
    if how == "spill":
        monkeypatch.setenv("LAKESOUL_FLEET_SPILL", str(tmp_path / "spill"))
        p = _Plane(cat, tmp_path / "spool")  # the spill offer is read at construction
    else:
        p = plane if how != "inline" else _Plane(cat, None)
    reg = registry()
    before = reg.counter("lakesoul_fleet_transport_negotiated_total",
                         transport={"inline": "stream", "socket": "stream"}.get(how, how)).value
    try:
        client = ScanPlaneClient(p.location, **kw)
        want = list(t.scan().batch_size(2048).to_batches())
        _equal(list(client.iter_batches(REQ)), want)
        for rank in range(2):
            _equal(list(client.iter_batches(REQ, rank=rank, world=2)),
                   list(t.scan().batch_size(2048).shard(rank, 2).to_batches()))
    finally:
        if p is not plane:
            p.close()
    after = reg.counter("lakesoul_fleet_transport_negotiated_total",
                        transport={"inline": "stream", "socket": "stream"}.get(how, how)).value
    assert after == before + 3
    if how == "spill":
        assert os.listdir(tmp_path / "spill")


def test_a_forced_transport_that_cannot_be_proven_raises(plane):
    with pytest.raises(ConfigError, match="spill transport required"):
        list(ScanPlaneClient(plane.location, transport="spill").iter_batches(REQ))
    with pytest.raises(ConfigError, match="unknown fleet transport"):
        ScanPlaneClient(plane.location, transport="carrier-pigeon")


def test_a_worker_killed_mid_stream_is_taken_over_exactly_once(table, tmp_path):
    _, cat, t = table
    p = _Plane(cat, tmp_path / "spool", workers=0, wait_s=60)
    try:
        req = {"table": "t", "batch_size": 4096}
        session = p.delivery.resolve_session(req)
        n = len(session.ranges)
        store = cat.client.store
        held = [(f"scanplane/{session.session_id}/{i}",) for i in range(1, n)]
        held = [(k, store.acquire_lease(k, "blocker", 60_000)) for (k,) in held]
        dead = ScanPlaneWorker(cat, p.spool, worker_id="w-dead", lease_ttl_s=5)
        counts = dead.poll_once()
        assert counts["produced"] == 1 and counts["lease_held"] == n - 1
        got, errors, done = [], [], threading.Event()

        def consume():
            try:
                got.extend(ScanPlaneClient(p.location).iter_batches(req))
            except BaseException as e:  # surfaced below
                errors.append(e)
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        time.sleep(0.5)
        assert not done.is_set() and len(got) >= 1  # range 0 delivered, then a stall
        for key, lease in held:
            store.release_lease(key, "blocker", lease.fencing_token)
        ScanPlaneWorker(cat, p.spool, worker_id="w-peer", lease_ttl_s=5).poll_once()
        assert done.wait(30.0), "the client never completed after the takeover"
        assert not errors, errors
        _equal(got, list(t.scan().batch_size(4096).to_batches()))
    finally:
        p.close()


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "socket"])
def test_explicit_resume_positions_redeliver_exactly(table, plane, shm):
    client = ScanPlaneClient(plane.location, shm=shm)
    full = list(client.iter_batches(REQ))
    session = plane.delivery.resolve_session(REQ)
    first = spool_mod.read_sidecar(session.dir(plane.spool),
                                   session.client_ranges(None, None)[0])["batches"]
    assert first > 2
    _equal(list(client.iter_batches(REQ, start_range=1, start_batch=2)), full[first + 2:])
    one = list(client.iter_batches(REQ, start_range=1, max_ranges=1))
    assert len(one) == spool_mod.read_sidecar(session.dir(plane.spool),
                                              session.client_ranges(None, None)[1])["batches"]


def test_per_range_tasks_rebuild_the_shard(table, plane):
    """The distributed-adapter surface: a rank's range count rides the
    handshake, and its ranges read one task at a time make up its shard."""
    from lakesoul_tpu_torch.scanplane.client import read_task_range

    _, _, t = table
    scan = t.scan().batch_size(2048).shard(1, 2)
    source = ScanPlaneClient(plane.location).source(scan)
    n = source.num_task_ranges()
    assert n == len(scan.scan_plan()) >= 1
    payload = json.loads(json.dumps(source.task_payload()))  # crosses a process as JSON
    got = pa.concat_tables([read_task_range(payload, i) for i in range(n)])
    assert got.equals(scan.to_arrow())


def test_default_spools_are_owned_and_only_dead_owners_are_pruned(tmp_path):
    """The port's pruner and the reference's take the same dirs: a dir of
    theirs whose owner died, never a live owner's, an unmarked one or an
    operator's spool."""
    from lakesoul_tpu.scanplane import delivery as ref_delivery
    from lakesoul_tpu_torch.scanplane import delivery

    mine = delivery.default_spool_dir()
    with open(os.path.join(mine, ".spool-owner")) as f:
        assert f.read() == str(os.getpid())
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    left = {}
    for pkg, prune in (("port", delivery.prune_stale_spools),
                       ("ref", ref_delivery.prune_stale_spools)):
        base = tmp_path / pkg
        for name, owner in (("lakesoul-scanplane-dead", dead),
                            ("lakesoul-scanplane-live", str(os.getpid())),
                            ("lakesoul-scanplane-unmarked", None), ("operator-spool", None)):
            os.makedirs(base / name)
            if owner is not None:
                (base / name / ".spool-owner").write_text(owner)
        assert prune(str(base)) == [str(base / "lakesoul-scanplane-dead")]
        left[pkg] = sorted(os.listdir(base))
    assert left["port"] == left["ref"] == ["lakesoul-scanplane-live",
                                           "lakesoul-scanplane-unmarked", "operator-spool"]
    assert os.path.isdir(mine)


def test_a_pinned_session_that_is_gone_fails_loudly(table, tmp_path):
    root, cat, t = table
    p = _Plane(cat, tmp_path / "spool", workers=0)
    try:
        pinned = p.delivery.resolve_session(REQ)
        shutil.rmtree(pinned.dir(p.spool))
        with pytest.raises(LakeSoulError, match="no longer exists"):
            p.delivery.resolve_session({**REQ, "session": pinned.session_id})
    finally:
        p.close()


# -------------------------------------------------------------------- interop
@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_clients_and_gateways_interoperate(table, client_pkg, tmp_path):
    """The port's client against the reference's fleet, and the reference's
    client against the port's: the local scan's sha256 either way, over the
    shm fast path and over the socket."""
    root, cat, t = table
    gateway_is_ref = client_pkg == "port"
    p = _Plane(_ref_catalog(root) if gateway_is_ref else cat, tmp_path / "spool",
               ref=gateway_is_ref)
    Client = ScanPlaneClient if client_pkg == "port" else RefClient
    try:
        want = _sha(t.scan().batch_size(2048).shard(1, 2).to_batches())
        for shm in (True, False):
            got = _sha(Client(p.location, shm=shm).iter_batches(REQ, rank=1, world=2))
            assert got == want and got[1] > 0
    finally:
        p.close()


# ------------------------------------------------------------------ consumers
def _tensor_batches(it):
    return [{k: v.clone().numpy() for k, v in b.items()} for b in it]


def test_to_torch_iter_via_the_plane_is_the_local_iterator(table, plane):
    _, _, t = table
    scan = t.scan().batch_size(1500)
    it = scan.via_scanplane(plane.location).to_torch_iter(device="cpu", drop_remainder=False,
                                                          consumer="trainer-0")
    got = _tensor_batches(it)
    want = _tensor_batches(scan.to_torch_iter(device="cpu", drop_remainder=False))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()
    stats = it.stats()
    assert stats["rows"] == t.scan().count_rows() and stats["batches"] == len(got)
    assert "trainer-0" in queue_seconds_by_consumer()
    tagged = [k for k in registry().snapshot()
              if k.startswith("lakesoul_scan_stage_seconds") and 'stage="decode"' in k
              and ('worker="w0"' in k or 'worker="w1"' in k)]
    assert tagged, "the workers' stages were not merged into the client's registry"


def _spool_digest(spool_dir) -> dict:
    out = {}
    for dirpath, _, files in os.walk(spool_dir):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, spool_dir)] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("route", ["local", "spool"])
def test_cpu_tensors_over_read_only_buffers_are_writable(table, plane, route):
    """An aligned window hands out Arrow's read-only views and a spool window
    a mapped segment's: each CPU tensor is a copy of them, so torch raises no
    "not writable" warning, and an in-place ``add_`` on every delivered
    tensor leaves the spool and the table as they were."""
    import warnings

    _, _, t = table
    scan = t.scan().batch_size(2048)
    source = scan if route == "local" else scan.via_scanplane(plane.location)
    want = _tensor_batches(scan.to_torch_iter(device="cpu", drop_remainder=False))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*not writable.*")
        got = list(source.to_torch_iter(device="cpu", drop_remainder=False))
    spool_before = _spool_digest(plane.spool)
    assert len(got) == len(want) > 1
    assert spool_before or route == "local"
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in g.items():
            assert v.numpy().tobytes() == w[k].tobytes()
            v.add_(1)
    assert _spool_digest(plane.spool) == spool_before
    again = _tensor_batches(source.to_torch_iter(device="cpu", drop_remainder=False))
    assert len(again) == len(want)
    for b, w in zip(again, want):
        assert {k: v.tobytes() for k, v in b.items()} == {k: v.tobytes() for k, v in w.items()}


def test_to_batches_to_arrow_limit_and_the_torch_adapter_route_remote(table, plane):
    _, _, t = table
    scan = t.scan().batch_size(4096)
    remote = scan.via_scanplane(ScanPlaneClient(plane.location))
    local = list(scan.to_batches())
    _equal(list(remote.to_batches()), local)
    assert sum(b.num_rows for b in remote.limit(5000).to_batches()) == 5000
    assert remote.to_arrow().equals(pa.Table.from_batches(local))
    _equal(list(remote.to_torch()), list(scan.to_torch()))


def _train(pkg, root, location, world=2):
    procs = []
    for rank in range(world):
        env = dict(os.environ, LAKESOUL_FLEET_PROCESS_INDEX=str(rank),
                   LAKESOUL_FLEET_PROCESS_COUNT=str(world), JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
        env.pop("LAKESOUL_OBS_SPOOL", None)
        host = ("--device", "cpu") if pkg == "lakesoul_tpu_torch" else ()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.fleet", "train", "--warehouse", str(root / "wh"),
             "--db-path", str(root / "meta.db"), "--table", "t", "--batch-size", "1000",
             "--location", location, *host],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True))
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return lines


def test_fleet_train_location_lines_equal_the_references_and_the_oracle(table, plane):
    root, cat, t = table
    got = _train("lakesoul_tpu_torch", root, plane.location)
    ref = _train("lakesoul_tpu", root, plane.location)
    for rank in range(2):
        digest, rows, batches = hashlib.sha256(), 0, 0
        for b in t.scan().batch_size(1000).shard(rank, 2).to_torch_iter(device="cpu",
                                                                         drop_remainder=False):
            rows += digest_batch(digest, b)
            batches += 1
        oracle = (rows, batches, digest.hexdigest())
        for line in (got[rank], ref[rank]):
            assert (line["rows"], line["batches"], line["sha256"]) == oracle
        assert (got[rank]["process_index"], got[rank]["process_count"]) == (rank, 2)
        assert sorted(got[rank]) == sorted(ref[rank])
    assert sum(x["rows"] for x in got) == t.scan().count_rows()


def test_the_service_entry_serves_a_drive_client(tmp_path):
    _, t = _make_table(tmp_path, rows=8000)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    svc = subprocess.Popen(
        [sys.executable, "-m", "lakesoul_tpu_torch.scanplane", "service",
         "--warehouse", str(tmp_path / "wh"), "--db-path", str(tmp_path / "meta.db"),
         "--workers", "1", "--spool", str(tmp_path / "spool"), "--lease-ttl-s", "5",
         "--poll-s", "0.05"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = []
        reader = threading.Thread(target=lambda: line.append(svc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(60)
        handle = json.loads(line[0])
        assert sorted(handle) == ["location", "spool"] and handle["spool"] == str(
            tmp_path / "spool")
        drv = subprocess.run(
            [sys.executable, "-m", "lakesoul_tpu_torch.scanplane", "drive", "--location",
             handle["location"], "--table", "t", "--batch-size", "4096"],
            env=env, capture_output=True, text=True, timeout=120)
        assert drv.returncode == 0, drv.stderr[-2000:]
        out = json.loads(drv.stdout)
        assert (out["sha256"], out["rows"]) == _sha(t.scan().batch_size(4096).to_batches())
    finally:
        workers = _children(svc.pid)
        # SIGINT: the service stops its workers and waits for them (SIGTERM
        # would end it at once and orphan them)
        svc.send_signal(signal.SIGINT)
        try:
            svc.wait(20.0)
        except subprocess.TimeoutExpired:
            svc.kill()
            svc.wait(10.0)
        alive = [pid for pid in workers if _alive(pid)]
        for pid in alive:
            os.kill(pid, signal.SIGKILL)
    assert workers and not alive, (workers, alive)


def _children(pid: int) -> list:
    out = []
    for name in os.listdir("/proc"):
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if name.isdigit() and int(fields[1]) == pid:
            out.append(int(name))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False
