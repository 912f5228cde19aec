"""The port's Ray and Daft adapters (``lakesoul_tpu_torch/data/ray_adapter.py``,
``daft_adapter.py``) against the reference's wire-faithful stubs
(``tests/test_adapters.py``): case for case the reference's stub tests,
and on one warehouse the same rows read through both packages' adapters.
A ``via_scanplane`` scan fans out one Ray task per scan-plane range, over a
gateway of the port's; a write stages files on the workers and commits
once (version-0 heads)."""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pyarrow as pa
import pytest
from test_adapters import SCHEMA, _install_daft_stub, _install_ray_stub, _StubDataset

from lakesoul_tpu import LakeSoulCatalog as RefCatalog
from lakesoul_tpu_torch import LakeSoulCatalog


@pytest.fixture()
def table(tmp_warehouse):
    catalog = LakeSoulCatalog(str(tmp_warehouse))
    t = catalog.create_table("adp", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
    t.write_arrow(pa.table({"id": [1, 2, 3, 4], "v": [1.0, 2.0, 3.0, 4.0]}))
    t.upsert(pa.table({"id": [2], "v": [20.0]}))
    return t


def _ref_table(t):
    """The same table through the reference's catalog (one warehouse)."""
    return RefCatalog(t.catalog.warehouse).table("adp")


def _rows(tab: pa.Table) -> list:
    return tab.sort_by("id").to_pylist()


class TestRayAdapter:
    def test_read_round_trip(self, table, monkeypatch):
        _install_ray_stub(monkeypatch)
        from lakesoul_tpu_torch.data.ray_adapter import read_lakesoul

        got = read_lakesoul(table.scan()).to_arrow().sort_by("id")
        assert got.column("id").to_pylist() == [1, 2, 3, 4]
        assert got.column("v").to_pylist() == [1.0, 20.0, 3.0, 4.0]  # MOR applied

    def test_read_respects_filter_and_projection(self, table, monkeypatch):
        _install_ray_stub(monkeypatch)
        from lakesoul_tpu_torch.data.ray_adapter import read_lakesoul
        from lakesoul_tpu_torch.io.filters import col

        got = read_lakesoul(table.scan().filter(col("v") > 2.5).select(["id"])).to_arrow()
        got = got.sort_by("id")
        assert got.column_names == ["id"]
        assert got.column("id").to_pylist() == [2, 3, 4]

    def test_write_stages_then_single_commit(self, tmp_warehouse, monkeypatch):
        _install_ray_stub(monkeypatch)
        import ray

        from lakesoul_tpu_torch.data.ray_adapter import write_lakesoul

        catalog = LakeSoulCatalog(str(tmp_warehouse))
        t = catalog.create_table("rw", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        write_lakesoul(_StubDataset(
            pa.table({"id": [1, 2, 3], "v": [1.0, 2.0, 3.0]}).to_pylist()), t)
        assert t.to_arrow().sort_by("id").column("id").to_pylist() == [1, 2, 3]
        heads = catalog.client.store.get_all_latest_partition_info(t.info.table_id)
        assert heads and all(h.version == 0 for h in heads)  # one commit
        assert ray is sys.modules["ray"]

    def test_read_and_write_compose(self, table, monkeypatch):
        _install_ray_stub(monkeypatch)
        from lakesoul_tpu_torch.data.ray_adapter import read_lakesoul, write_lakesoul

        dst = table.catalog.create_table("adp_copy", SCHEMA, primary_keys=["id"],
                                         hash_bucket_num=1)
        write_lakesoul(read_lakesoul(table.scan()), dst)
        assert dst.to_arrow().sort_by("id").equals(table.to_arrow().sort_by("id"))

    def test_both_packages_read_the_same_rows(self, table, monkeypatch):
        """One table, both adapters, one stub: the same rows, and one read
        task per scan unit on each side."""
        _install_ray_stub(monkeypatch)
        from lakesoul_tpu.data.ray_adapter import read_lakesoul as ref_read
        from lakesoul_tpu_torch.data.ray_adapter import read_lakesoul

        ref = _ref_table(table)
        got, want = read_lakesoul(table.scan()), ref_read(ref.scan())
        assert _rows(got.to_arrow()) == _rows(want.to_arrow())
        assert len(table.scan().scan_plan()) == len(ref.scan().scan_plan()) == 2

    def test_a_write_by_either_adapter_reads_the_same_in_both(self, table, monkeypatch):
        _install_ray_stub(monkeypatch)
        from lakesoul_tpu.data.ray_adapter import write_lakesoul as ref_write
        from lakesoul_tpu_torch.data.ray_adapter import write_lakesoul

        rows = pa.table({"id": [5, 6, 7], "v": [5.0, 6.0, 7.0]}).to_pylist()
        cat = table.catalog
        mine = cat.create_table("by_port", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        cat.create_table("by_ref", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        write_lakesoul(_StubDataset(rows), mine)
        ref_write(_StubDataset(rows), RefCatalog(cat.warehouse).table("by_ref"))
        theirs = LakeSoulCatalog(cat.warehouse).table("by_ref")
        assert _rows(mine.to_arrow()) == _rows(theirs.to_arrow()) == sorted(
            rows, key=lambda r: r["id"])
        assert _rows(RefCatalog(cat.warehouse).table("by_port").to_arrow()) == _rows(
            mine.to_arrow())


class TestDaftAdapter:
    def test_round_trip(self, table, monkeypatch):
        _install_daft_stub(monkeypatch)
        from lakesoul_tpu_torch.data.daft_adapter import read_lakesoul, write_lakesoul

        dst = table.catalog.create_table("adp_daft", SCHEMA, primary_keys=["id"],
                                         hash_bucket_num=1)
        write_lakesoul(read_lakesoul(table.scan()), dst)
        assert dst.to_arrow().sort_by("id").equals(table.to_arrow().sort_by("id"))

    def test_read_is_lazy_and_per_unit(self, table, monkeypatch):
        _install_daft_stub(monkeypatch)
        import lakesoul_tpu_torch.io.reader as reader_mod
        from lakesoul_tpu_torch.data.daft_adapter import read_lakesoul

        calls = []
        real = reader_mod.read_scan_unit
        monkeypatch.setattr(reader_mod, "read_scan_unit",
                            lambda *a, **k: (calls.append(1) or real(*a, **k)))
        df = read_lakesoul(table.scan())
        assert calls == [], "read_lakesoul decoded eagerly"
        n_units = len(table.scan().scan_plan())
        assert n_units >= 2
        tables = list(df.to_arrow_iter())
        assert len(calls) == n_units and len(tables) == n_units
        got = pa.concat_tables(tables).sort_by("id")
        assert got.column("v").to_pylist() == [1.0, 20.0, 3.0, 4.0]

    def test_write_streams_iter_single_commit(self, tmp_warehouse, monkeypatch):
        _install_daft_stub(monkeypatch)
        import daft

        from lakesoul_tpu_torch.data.daft_adapter import write_lakesoul

        catalog = LakeSoulCatalog(str(tmp_warehouse))
        t = catalog.create_table("dw", SCHEMA, primary_keys=["id"], hash_bucket_num=2)
        parts = [pa.table({"id": [1, 2], "v": [1.0, 2.0]}), pa.table({"id": [3], "v": [3.0]}),
                 pa.table({"id": [4, 5], "v": [4.0, 5.0]})]
        ops = write_lakesoul(daft.from_arrow(iter(parts)), t)
        assert ops
        assert t.to_arrow().sort_by("id").column("id").to_pylist() == [1, 2, 3, 4, 5]
        heads = catalog.client.store.get_all_latest_partition_info(t.info.table_id)
        assert all(h.version == 0 for h in heads)

    def test_both_packages_read_the_same_units(self, table, monkeypatch):
        _install_daft_stub(monkeypatch)
        from lakesoul_tpu.data.daft_adapter import read_lakesoul as ref_read
        from lakesoul_tpu_torch.data.daft_adapter import read_lakesoul

        got = [_rows(t) for t in read_lakesoul(table.scan()).to_arrow_iter()]
        want = [_rows(t) for t in ref_read(_ref_table(table).scan()).to_arrow_iter()]
        assert sorted(map(str, got)) == sorted(map(str, want)) and len(got) == 2


def test_ray_adapter_fans_out_per_scanplane_range(tmp_path, monkeypatch):
    """``via_scanplane`` scans: one Ray task per scan-plane range, each
    pulling its range from the port's gateway, the rows equal to the local
    scan's and to the reference's adapter through the same gateway."""
    _install_ray_stub(monkeypatch)
    from lakesoul_tpu.data.ray_adapter import read_lakesoul as ref_read
    from lakesoul_tpu.scanplane.client import ScanPlaneClient as RefClient
    from lakesoul_tpu_torch.data import ray_adapter
    from lakesoul_tpu_torch.scanplane import client as client_mod
    from lakesoul_tpu_torch.scanplane.client import ScanPlaneClient
    from lakesoul_tpu_torch.scanplane.delivery import ScanPlaneDelivery
    from lakesoul_tpu_torch.scanplane.worker import ScanPlaneWorker
    from lakesoul_tpu_torch.service.flight import LakeSoulFlightServer

    cat = LakeSoulCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "meta.db"))
    schema = pa.schema([("id", pa.int64()), ("v", pa.float64())])
    t = cat.create_table("t", schema, primary_keys=["id"], hash_bucket_num=2)
    rng = np.random.default_rng(3)
    for _ in range(2):
        ids = np.sort(rng.choice(16_000, 6_000, replace=False)).astype(np.int64)
        t.upsert(pa.table({"id": ids, "v": rng.normal(size=len(ids))}, schema=schema))
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    server = LakeSoulFlightServer(cat, "grpc://127.0.0.1:0",
                                  scanplane=ScanPlaneDelivery(cat, spool, wait_s=30.0),
                                  device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    stop = threading.Event()
    worker = ScanPlaneWorker(cat, spool, lease_ttl_s=10, poll_interval_s=0.02, worker_id="w0")
    pump = threading.Thread(target=worker.run_forever, kwargs={"stop_event": stop}, daemon=True)
    pump.start()
    location = f"grpc://127.0.0.1:{server.port}"
    tasks = []
    real = client_mod.read_task_range
    monkeypatch.setattr(client_mod, "read_task_range",
                        lambda payload, i: (tasks.append(i) or real(payload, i)))
    try:
        scan = t.scan().batch_size(4096).via_scanplane(ScanPlaneClient(location))
        got = ray_adapter.read_lakesoul(scan).to_arrow()
        n_ranges = len(tasks)
        assert n_ranges >= 2 and sorted(tasks) == list(range(n_ranges))
        want = t.to_arrow()
        assert _rows(got) == _rows(want)
        ref_scan = RefCatalog(str(tmp_path / "wh"), db_path=str(tmp_path / "meta.db")).table(
            "t").scan().batch_size(4096).via_scanplane(RefClient(location))
        assert _rows(ref_read(ref_scan).to_arrow()) == _rows(got)
    finally:
        stop.set()
        pump.join(timeout=10)
        server.shutdown()
