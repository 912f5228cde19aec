"""The port's loader (``to_torch_iter``) against the reference's
(``to_jax_iter``), on the CPU.

Every batch of ``to_torch_iter(device="cpu")`` must equal, byte for byte and
dtype for dtype, the host batch of ``to_jax_iter(device_put=False)`` over the
same table (written once, by the reference package).  Resume, stats, the
stage series, the process axis and its shards, the raises, and the slice as
a whole — the Titanic MLP trained from one table by both packages, whose
every step's loss must agree to rtol 1e-4 (the step alone agrees to 1e-5,
``test_torch_models_train.py``) — follow.
"""

import hashlib

import jax
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu
import lakesoul_tpu.fleet.multihost as ref_multihost
import lakesoul_tpu.obs as ref_obs
import lakesoul_tpu_torch
import lakesoul_tpu_torch.fleet.multihost as port_multihost
import lakesoul_tpu_torch.obs as port_obs
from lakesoul_tpu.models.mlp import init_mlp_params
from lakesoul_tpu.models.train import make_mlp_train_step as ref_mlp_step
from lakesoul_tpu.tensorplane.columns import tensor_field
from lakesoul_tpu_torch.data.torch_iter import LoaderCheckpoint
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.models import MLP, adam, convert, make_mlp_train_step
from lakesoul_tpu_torch.analysis.arm import armed

N_ROWS = 1000
BATCH = 96


def _write(wh, kind: str):
    """One table, written by the reference package."""
    cat = lakesoul_tpu.LakeSoulCatalog(str(wh))
    rng = np.random.default_rng(3)
    n = N_ROWS
    cols = {
        "id": np.arange(n, dtype=np.int64),
        "x64": rng.normal(size=n),
        "x32": rng.normal(size=n).astype(np.float32),
        "k": rng.integers(0, 5, n).astype(np.int32),
    }
    fields = [("id", pa.int64()), ("x64", pa.float64()), ("x32", pa.float32()), ("k", pa.int32())]
    if kind == "tensor":
        cols["emb"] = pa.FixedSizeListArray.from_arrays(
            pa.array(rng.normal(size=n * 6).astype(np.float32)), 6)
        fields.append(tensor_field("emb", (2, 3), "float32"))
    elif kind == "fallback":
        cols["flag"] = rng.random(n) < 0.5
        cols["maybe"] = pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.2)
        fields += [("flag", pa.bool_()), ("maybe", pa.int64())]
    elif kind == "strings":
        cols["name"] = [f"n{i}" for i in range(n)]
        fields.append(("name", pa.string()))
    schema = pa.schema(fields)
    t = cat.create_table("t", schema, primary_keys=["id"], hash_bucket_num=4)
    data = pa.table(cols, schema=schema)
    t.write_arrow(data)
    t.upsert(data.slice(0, 150))  # merge-on-read
    return wh


def _scans(wh, batch=BATCH):
    ref = lakesoul_tpu.LakeSoulCatalog(str(wh)).table("t").scan().batch_size(batch)
    port = lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("t").scan().batch_size(batch)
    return ref, port


def _host(leaf) -> np.ndarray:
    """A delivered leaf as a numpy array we own (the ring reuses buffers)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.numpy()
    return np.array(leaf, copy=True)


def _collect(it) -> list:
    return [jax.tree_util.tree_map(_host, b) for b in it]


def _assert_same(port_batches, ref_batches):
    assert len(port_batches) == len(ref_batches) > 1
    for p, r in zip(port_batches, ref_batches):
        pl, pt = jax.tree_util.tree_flatten(p)
        rl, rt = jax.tree_util.tree_flatten(r)
        assert pt == rt
        for a, b in zip(pl, rl):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _features(b):
    x = np.stack([b["x32"], b["x64"].astype(np.float32), b["k"].astype(np.float32)], axis=0)
    return {"x": x, "y": b["k"] % 2, "n": np.int64(len(b["k"]))}


CASES = {
    # name: (table kind, to_*_iter kwargs)
    "i64_f64_kept": ("plain", {}),
    "tensor_column": ("tensor", {}),
    "bool_and_nulls": ("fallback", {}),
    "drop_remainder": ("plain", {"drop_remainder": True}),
    "keep_remainder": ("plain", {"drop_remainder": False}),
    "transform": ("plain", {"transform": _features, "drop_remainder": False}),
    "io_threads": ("plain", {"io_threads": 2, "drop_remainder": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_batches_equal_the_references_host_batches(tmp_path, case):
    kind, kw = CASES[case]
    ref, port = _scans(_write(tmp_path, kind))
    want = _collect(ref.to_jax_iter(device_put=False, **kw))
    got_raw = list(port.to_torch_iter(device="cpu", **kw))
    got = [jax.tree_util.tree_map(_host, b) for b in got_raw]
    _assert_same(got, want)
    leaves = jax.tree_util.tree_leaves(got_raw[0])
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in leaves)
    if case == "i64_f64_kept":
        # jax demotes these with x64 off; the port keeps them
        assert got_raw[0]["id"].dtype == torch.int64
        assert got_raw[0]["x64"].dtype == torch.float64
    if case == "tensor_column":
        assert got_raw[0]["emb"].shape == (BATCH, 2, 3)
    rows = sum(len(b["y"]) if "y" in b else len(b["id"]) for b in want)
    assert rows == (N_ROWS if kw.get("drop_remainder") is False else N_ROWS // BATCH * BATCH)


def test_collate_reuse_ring_host_batches_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("LAKESOUL_COLLATE_REUSE", "1")
    # the scan's batches are per hash bucket (~250 rows): windows of 96
    # span them, so the fused collate writes into the ring's slots
    ref, port = _scans(_write(tmp_path, "plain"))
    it = port.to_torch_iter(device_put=False, drop_remainder=False)
    assert it._ring is not None
    got = _collect(it)
    _assert_same(got, _collect(ref.to_jax_iter(device_put=False, drop_remainder=False)))
    # on the CPU a delivered tensor aliases its buffer: the ring stays down
    assert port.to_torch_iter(device="cpu")._ring is None


def test_checkpoint_resume_lands_on_the_references_row(tmp_path):
    ref, port = _scans(_write(tmp_path, "plain"))
    resumed = {}
    for name, scan, make in (
        ("ref", ref, lambda s, c: s.to_jax_iter(device_put=False, checkpoint=c)),
        ("port", port, lambda s, c: s.to_torch_iter(device="cpu", checkpoint=c)),
    ):
        ckpt = (lakesoul_tpu.data.jax_iter.LoaderCheckpoint() if name == "ref"
                else LoaderCheckpoint())
        it = iter(make(scan, ckpt))
        for _ in range(3):
            next(it)
        it.close()
        saved = ckpt.to_json()
        ckpt = type(ckpt).from_json(saved)
        assert ckpt.rows_delivered == 3 * BATCH
        resumed[name] = _collect(make(scan, ckpt))
    _assert_same(resumed["port"], resumed["ref"])


def test_stats_keys_and_stage_series_are_the_references(tmp_path):
    ref, port = _scans(_write(tmp_path, "plain"))
    r_it = ref.to_jax_iter()
    p_it = port.to_torch_iter(device="cpu")
    for _ in r_it:
        pass
    for _ in p_it:
        pass
    assert set(p_it.stats()) == set(r_it.stats())
    assert p_it.stats()["rows"] == r_it.stats()["rows"] == N_ROWS // BATCH * BATCH
    assert port_obs.SCAN_STAGES == ref_obs.SCAN_STAGES

    def stages(obs):
        return {lab["stage"] for lab, _ in obs.registry().series("lakesoul_scan_stage_seconds")}

    loader = {"rebatch", "collate", "queue", "device_put", "merge"}
    assert loader <= stages(port_obs) and loader <= stages(ref_obs)


def test_a_string_leaf_to_a_device_raises_naming_its_column(tmp_path):
    _, port = _scans(_write(tmp_path, "strings"))
    with pytest.raises(ConfigError, match="'name'"):
        for _ in port.to_torch_iter(device="cpu"):
            pass
    # on the host a string column stays an object array, as in the reference
    b = next(iter(port.to_torch_iter(device_put=False)))
    assert b["name"].dtype == object


@pytest.mark.parametrize("kw", [{"sharding": object()}, {"cache": "device", "device_put": False},
                                {"follow": 42}],
                         ids=["sharding", "cache_device", "follow"])
def test_options_the_port_does_not_take_raise(tmp_path, kw):
    """``follow`` is ported (``tests/test_torch_freshness.py``): a value
    that names no follow position raises, as in the reference, instead of
    following from now."""
    _, port = _scans(_write(tmp_path, "plain"))
    with pytest.raises(ConfigError):
        port.to_torch_iter(device="cpu", **kw)


def test_via_scanplane_raises(tmp_path):
    """``via_scanplane`` is ported: what it refuses is what the reference
    refuses — an unknown forced transport at once, and a scan no shared
    session can serve (a snapshot read) when it is consumed, before any
    connection is made."""
    _, port = _scans(_write(tmp_path, "plain"))
    with pytest.raises(ConfigError, match="unknown fleet transport"):
        port.via_scanplane("grpc://localhost:1", transport="pigeon")
    remote = port.snapshot_at(1).via_scanplane("grpc://localhost:1")
    with pytest.raises(ConfigError, match="snapshot/incremental scans must run locally"):
        remote.to_arrow()


def test_to_torch_iter_with_no_card_raises(tmp_path):
    assert not torch.cuda.is_available()
    _, port = _scans(_write(tmp_path, "plain"))
    with pytest.raises(ConfigError, match="CUDA is not available"):
        port.to_torch_iter()


@pytest.mark.parametrize("env,ok", [
    ({"LAKESOUL_FLEET_PROCESS_INDEX": "2", "LAKESOUL_FLEET_PROCESS_COUNT": "4"}, (2, 4)),
    ({"LAKESOUL_FLEET_PROCESS_INDEX": "1"}, None),
    ({"LAKESOUL_FLEET_PROCESS_COUNT": "4"}, None),
    ({"LAKESOUL_FLEET_PROCESS_INDEX": "x", "LAKESOUL_FLEET_PROCESS_COUNT": "4"}, None),
    ({"LAKESOUL_FLEET_PROCESS_INDEX": "4", "LAKESOUL_FLEET_PROCESS_COUNT": "4"}, None),
    ({"LAKESOUL_FLEET_PROCESS_INDEX": "0", "LAKESOUL_FLEET_PROCESS_COUNT": "0"}, None),
    ({}, (0, 1)),
])
def test_process_axis_env_override_and_its_validation(monkeypatch, env, ok):
    for k in ("LAKESOUL_FLEET_PROCESS_INDEX", "LAKESOUL_FLEET_PROCESS_COUNT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ok is None:
        with pytest.raises(ConfigError):
            port_multihost.process_axis()
        with pytest.raises(lakesoul_tpu.errors.ConfigError):
            ref_multihost.process_axis()
    else:
        assert port_multihost.process_axis() == ref_multihost.process_axis() == ok


def test_process_axis_asks_torch_distributed(monkeypatch):
    import torch.distributed as dist

    for k in ("LAKESOUL_FLEET_PROCESS_INDEX", "LAKESOUL_FLEET_PROCESS_COUNT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 5)
    assert port_multihost.process_axis() == (3, 5)


def test_shard_scan_equals_the_references_shards_by_digest(tmp_path, monkeypatch):
    ref, port = _scans(_write(tmp_path, "plain"))
    world, total = 4, 0
    for rank in range(world):
        monkeypatch.setenv("LAKESOUL_FLEET_PROCESS_INDEX", str(rank))
        monkeypatch.setenv("LAKESOUL_FLEET_PROCESS_COUNT", str(world))
        d_port, d_ref = hashlib.sha256(), hashlib.sha256()
        rows = sum(port_multihost.digest_batch(d_port, b) for b in
                   port.to_torch_iter(device_put=False, multihost=True, drop_remainder=False))
        want = sum(ref_multihost.digest_batch(d_ref, b) for b in
                   ref.shard(rank, world).to_jax_iter(device_put=False, drop_remainder=False))
        assert rows == want > 0
        assert d_port.hexdigest() == d_ref.hexdigest()
        assert len(port.auto_shard().scan_plan()) == len(ref.shard(rank, world).scan_plan())
        total += rows
    assert total == port.count_rows() == N_ROWS


def test_titanic_mlp_from_one_table_agrees_step_by_step(tmp_path):
    """The example's loop in both packages: a hash-partitioned table with an
    upsert, 5 epochs of batch 256, Adam 1e-2, from the same weights."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "titanic_mlp", pathlib.Path(__file__).resolve().parent.parent / "examples" / "titanic_mlp.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    data = example.make_synthetic_titanic()
    cat = lakesoul_tpu_torch.LakeSoulCatalog(str(tmp_path))
    t = cat.create_table("titanic", data.schema, primary_keys=["passenger_id"], hash_bucket_num=4)
    t.write_arrow(data)
    t.upsert(data.slice(0, 200))
    feature_cols = ["pclass", "age", "fare", "sex"]

    def transform(b):
        x = np.stack([b[c].astype(np.float32) for c in feature_cols], axis=1)
        x = (x - x.mean(0)) / (x.std(0) + 1e-6)
        return {"x": x, "y": b["survived"].astype(np.int32)}

    params = init_mlp_params(jax.random.key(0), len(feature_cols), hidden=64)
    m = MLP(len(feature_cols), hidden=64, device="cpu")
    m.load_state_dict(convert.from_reference_params(params))
    step = make_mlp_train_step(m, adam(m.parameters(), 1e-2), device="cpu")
    tx = optax.adam(1e-2)
    state = tx.init(params)
    ref_step, _ = ref_mlp_step(tx)
    ref_table = lakesoul_tpu.LakeSoulCatalog(str(tmp_path)).table("titanic")
    got, want = [], []
    for _ in range(5):
        for b in t.scan().batch_size(256).auto_shard().to_torch_iter(
                device="cpu", transform=transform, drop_remainder=False):
            got.append(float(step(b["x"], b["y"])))
        for b in ref_table.scan().batch_size(256).auto_shard().to_jax_iter(
                transform=transform, drop_remainder=False):
            params, state, loss = ref_step(params, state, b["x"], b["y"])
            want.append(float(loss))
    assert len(got) == len(want) == 5 * 8
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


# the runtime detectors this suite is named for (lakesoul_tpu_torch/analysis/
# arm.py), when their LAKESOUL_*CHECK variable is set: a violation fails the test
@pytest.fixture(autouse=True)
def _detectors():
    with armed(__name__, device="cpu") as found:
        yield
    assert not found, found.render()
