"""The port stands alone: no module of ``lakesoul_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package.

Two checks: a static scan of every import statement, and a subprocess in
which a meta-path finder makes ``jax``, ``jaxlib`` and ``lakesoul_tpu``
unimportable while every port module is imported, a tiny index is built
and searched on the CPU, and so is a tiny two-shard ANN plane, the MLP,
ResNet and BERT each take one tiny train step, a tiny primary-key table is
created, written, upserted and read through ``to_torch_iter`` (a streamed
epoch, then a replayed one with ``cache="device"``, then through a Flight
gateway's scan plane, which also answers an ``ann_search`` over the tiny
plane), a tiny vector
table is indexed (``build_vector_index``) and searched (``vector_search``,
``scan().vector_search``), and a gloo process group of one rank takes a
tiny BERT plan step (``parallel/``, ``make_mesh``), saves and restores it
through the sharded checkpointer, and takes a ``cross_chip_topk``; a SQL
query, a string filter, the kernel register on the CPU and a fleet
publisher read by its aggregator through the exporter run too; every
``parallel`` module, ``annplane/collective``, ``entry`` and every module
added with the SQL layer and the fleet plane are among the modules
imported, as is every module of the scan plane, the gateway, the transport
seam and the checkpointed writer, and every module of the compaction
package, the follower, the writer role, database sync and the autoscaler.
It has to be a subprocess: ``tests/conftest.py`` imports jax into every
test process.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "lakesoul_tpu")


def _port_files():
    files = sorted((ROOT / "lakesoul_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def test_no_port_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _blocked(n)]
    assert not offenders, offenders


def test_blocked_names_are_exact_roots():
    assert _blocked("jax.numpy") and _blocked("lakesoul_tpu.vector")
    assert not _blocked("lakesoul_tpu_torch.vector") and not _blocked("jaxtyping_free")


_CHILD = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "lakesoul_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())

    import json
    import numpy as np
    import torch
    import lakesoul_tpu_torch
    from lakesoul_tpu_torch.errors import ConfigError

    mods = [m.name for m in pkgutil.walk_packages(lakesoul_tpu_torch.__path__, "lakesoul_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (imports; main() is not run)

    from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 24)).astype(np.float32)
    cfg = VectorIndexConfig("v", 24, nlist=4)
    idx = IvfRabitqIndex.train(x, np.arange(400), cfg, device="cpu")
    ids, d = idx.search(x[7], SearchParams(top_k=3, nprobe=4, rerank_depth=400))
    assert int(ids[0]) == 7, ids
    idx.enable_device_cache()
    ids_b, _ = idx.batch_search(x[:5], SearchParams(top_k=3, nprobe=4, rerank_depth=400))
    assert [int(i[0]) for i in ids_b] == [0, 1, 2, 3, 4], ids_b
    import tempfile
    from lakesoul_tpu_torch.annplane import AnnPlane, AnnPlaneConfig, ShardedAnnBuilder
    root = tempfile.mkdtemp() + "/plane"
    pcfg = AnnPlaneConfig(index=cfg, shard_budget_bytes=200 * AnnPlaneConfig(
        index=cfg, shard_budget_bytes=1 << 20).bytes_per_vector())
    m = ShardedAnnBuilder(root, pcfg, device="cpu").build([(x[:300], np.arange(300)),
                                                          (x[300:], np.arange(300, 400))])
    assert len(m["shards"]) == 2, m
    plane = AnnPlane.open(root, device="cpu")
    ids_p, _ = plane.batch_search(x[[7, 250, 399]], SearchParams(top_k=1, nprobe=8,
                                                                 rerank_depth=200))
    assert [int(i[0]) for i in ids_p] == [7, 250, 399], ids_p
    from lakesoul_tpu_torch.models import (MLP, Bert, BertConfig, ResNet, ResNetConfig, adam,
                                           make_bert_train_state, make_bert_train_step,
                                           make_mlp_train_step, make_resnet_train_step, sgd)
    mlp = MLP(4, hidden=8, device="cpu")
    losses = [make_mlp_train_step(mlp, adam(mlp.parameters(), 1e-2), device="cpu")(
        rng.normal(size=(16, 4)).astype(np.float32), rng.integers(0, 2, 16))]
    rn = ResNet(ResNetConfig(num_classes=10, width=8), device="cpu")
    losses.append(make_resnet_train_step(rn, sgd(rn.parameters(), 0.05), device="cpu")(
        rng.normal(size=(2, 32, 32, 3)).astype(np.float32), np.array([1, 2])))
    bert, opt = make_bert_train_state(BertConfig.tiny(), device="cpu")
    ids = rng.integers(0, 1024, size=(2, 16))
    losses.append(make_bert_train_step(bert, opt, device="cpu")(
        ids, np.where(rng.random((2, 16)) < 0.3, ids, -100), np.ones((2, 16), bool)))
    assert all(bool(torch.isfinite(l)) for l in losses), losses
    import pyarrow as pa
    from lakesoul_tpu_torch import LakeSoulCatalog
    cat = LakeSoulCatalog(tempfile.mkdtemp())
    data = pa.table({"id": np.arange(50, dtype=np.int64), "v": rng.normal(size=50)})
    tbl = cat.create_table("t", data.schema, primary_keys=["id"], hash_bucket_num=2)
    tbl.write_arrow(data)
    tbl.upsert(pa.table({"id": np.arange(5, dtype=np.int64), "v": np.zeros(5)}))
    got = [b for b in tbl.scan().batch_size(16).to_torch_iter(device="cpu", drop_remainder=False)]
    assert sum(len(b["id"]) for b in got) == 50, got
    assert float(sum(b["v"][b["id"] < 5].abs().sum() for b in got)) == 0.0
    it = tbl.scan().batch_size(16).to_torch_iter(device="cpu", cache="device",
                                                 drop_remainder=False)
    first = [b["id"].clone() for b in it]
    replayed = [b["id"].clone() for b in it]
    assert it.stats()["replay"]["ready"] and it.stats()["replay"]["epochs_served"] == 1
    assert [r.tolist() for r in replayed] == [f.tolist() for f in first]
    vschema = pa.schema([("id", pa.int64()), ("emb", pa.list_(pa.float32(), 24))])
    vt = cat.create_table("vecs", vschema, primary_keys=["id"], hash_bucket_num=2)
    vt.write_arrow(pa.table({"id": np.arange(400, dtype=np.int64),
                             "emb": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 24)},
                            schema=vschema))
    assert vt.build_vector_index("emb", nlist=4, device="cpu") == 400
    vids, _ = vt.vector_search("emb", x[7], top_k=3, nprobe=4, device="cpu")
    assert int(vids[0]) == 7, vids
    rows = vt.scan().vector_search("emb", x[7], top_k=3, nprobe=4, device="cpu").to_arrow()
    assert 7 in rows.column("id").to_pylist()
    import datetime
    import torch.distributed as dist
    from lakesoul_tpu_torch.annplane.collective import cross_chip_topk
    from lakesoul_tpu_torch.parallel import make_mesh
    for name in ("collectives", "launch", "mesh", "moe", "pipeline", "ring_attention", "ulysses"):
        assert f"lakesoul_tpu_torch.parallel.{name}" in mods, name
    assert "lakesoul_tpu_torch.annplane.collective" in mods and "lakesoul_tpu_torch.entry" in mods
    dist.init_process_group("gloo", store=dist.FileStore(tempfile.mkdtemp() + "/store", 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    plan = make_mesh(device_type="cpu")
    bert, opt = make_bert_train_state(BertConfig.tiny(), plan=plan)
    loss = make_bert_train_step(bert, opt, plan=plan, sequence_parallel="ulysses")(
        ids, np.where(rng.random((2, 16)) < 0.3, ids, -100), np.ones((2, 16), bool))
    assert bool(torch.isfinite(loss)), loss
    from lakesoul_tpu_torch.models import TrainCheckpointer
    ck = TrainCheckpointer(tempfile.mkdtemp())
    ck.save(1, bert.state_dict(), opt.state_dict(), plan=plan)
    p1, o1, at = ck.restore_latest(like=(bert.state_dict(), opt.state_dict()), plan=plan)
    assert at == 1 and all(torch.equal(p1[k], v) for k, v in bert.state_dict().items())
    d, r, src = cross_chip_topk(np.array([0.5, 0.1], np.float32), np.array([7, 9], np.int32),
                                k=1, group=dist.group.WORLD)
    assert (float(d[0]), int(r[0]), int(src[0])) == (np.float32(0.1), 9, 0)
    dist.destroy_process_group()
    for name in ("sql.parser", "sql.executor", "sql.tpch", "obs.fleet", "obs.exporter",
                 "obs.logging", "freshness.slo", "utils.memory", "tensorplane.smoke",
                 "fleet.__main__", "models.checkpoint", "data.hf_adapter", "scanplane",
                 "scanplane.session", "scanplane.spool", "scanplane.worker",
                 "scanplane.delivery", "scanplane.client", "scanplane.service",
                 "scanplane.__main__", "service.flight", "service.jwt", "service.rbac",
                 "service.assets", "fleet.transport", "streaming.cdc", "runtime.lease"):
        assert f"lakesoul_tpu_torch.{name}" in mods, name
    from lakesoul_tpu_torch.sql import SqlSession
    out = SqlSession(cat, device="cpu").execute("SELECT count(*) AS n FROM t WHERE id < 10")
    assert out.column("n").to_pylist() == [10], out
    assert tbl.scan().filter("id < 10 AND v = 0").count_rows() == 5
    from lakesoul_tpu_torch.tensorplane.smoke import run_smoke
    report = run_smoke(device="cpu")
    assert report["ok"] and {c["status"] for c in report["cases"]} == {"cpu_plain"}, report
    from lakesoul_tpu_torch.obs import FleetAggregator, FleetPublisher, serve_prometheus
    spool = tempfile.mkdtemp()
    FleetPublisher(spool, flush_s=60.0).flush(reason="isolation")
    srv = serve_prometheus(FleetAggregator(spool), port=0, host="127.0.0.1")
    srv.shutdown()
    assert len(FleetAggregator(spool).members()) == 1
    import threading
    from lakesoul_tpu_torch.annplane import AnnPlaneBinding, ShardedAnnEndpoint
    from lakesoul_tpu_torch.scanplane import ScanPlaneDelivery, ScanPlaneWorker
    from lakesoul_tpu_torch.service import LakeSoulFlightClient, LakeSoulFlightServer
    spool_dir = tempfile.mkdtemp()
    with ShardedAnnEndpoint(plane, SearchParams(top_k=1, nprobe=8, rerank_depth=200)) as ep:
        srv = LakeSoulFlightServer(cat, scanplane=ScanPlaneDelivery(cat, spool_dir), device="cpu",
                                   ann_planes={"p": AnnPlaneBinding(ep, "default", "t")})
        threading.Thread(target=srv.serve, daemon=True).start()
        loc = f"grpc://127.0.0.1:{srv.port}"
        stop = threading.Event()
        threading.Thread(target=ScanPlaneWorker(cat, spool_dir, poll_interval_s=0.02).run_forever,
                         kwargs={"stop_event": stop}, daemon=True).start()
        remote = [b for b in tbl.scan().batch_size(16).via_scanplane(loc).to_torch_iter(
            device="cpu", drop_remainder=False)]
        assert sum(len(b["id"]) for b in remote) == 50, remote
        hit = json.loads(LakeSoulFlightClient(loc).action(
            "ann_search", {"plane": "p", "query": x[250].tolist()})[0])
        assert hit["ids"] == [250], hit
        stop.set()
        srv.shutdown()
    for name in ("compaction", "compaction.service", "compaction.events", "compaction.cleaner",
                 "compaction.__main__", "freshness.follower", "freshness.__main__",
                 "streaming.db_sync", "fleet.autoscale"):
        assert f"lakesoul_tpu_torch.{name}" in mods, name
    if not torch.cuda.is_available():
        for make in (lambda: IvfRabitqIndex(cfg), lambda: AnnPlane.open(root), make_mesh,
                     lambda: MLP(4), lambda: Bert(BertConfig.tiny()),
                     lambda: tbl.scan().to_torch_iter()):
            try:
                make()
            except ConfigError:
                pass
            else:
                raise AssertionError("device=None without CUDA must raise")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("ISOLATED", len(mods))
    """
)


def test_port_imports_and_runs_with_jax_and_the_jax_package_blocked():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED" in out.stdout
