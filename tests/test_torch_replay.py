"""The port's device replay cache (``to_torch_iter(cache="device")``,
``lakesoul_tpu_torch/tensorplane/replay.py``) against the reference's
(``to_jax_iter(cache="device")``), on the CPU, over one table written by the
reference package.

The table holds only 32-bit columns (``id`` int32, a declared ``emb``
tensor of float32, ``label`` int32): the reference demotes 64-bit columns
on delivery and the port keeps them, so on such a table the two packages'
batches, residency bills and spill records are equal byte for byte.  The
permuted replay is held to its contract instead (determinism under a seed,
the stream's rows as a multiset, another order the next epoch), with the
batch order itself bit-identical to the reference's: both draw it from
numpy's ``default_rng((seed, epoch))``.  Every comparison is exact: no
tolerance."""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu
import lakesoul_tpu.obs as ref_obs
import lakesoul_tpu_torch
import lakesoul_tpu_torch.obs as port_obs
from lakesoul_tpu.errors import ConfigError as RefConfigError
from lakesoul_tpu.tensorplane.columns import tensor_field
from lakesoul_tpu.tensorplane.replay import DeviceReplayCache as RefCache
from lakesoul_tpu_torch.data.torch_iter import LoaderCheckpoint
from lakesoul_tpu_torch.errors import ConfigError
from lakesoul_tpu_torch.tensorplane import ENV_BUDGET, DeviceReplayCache, ReplaySpill
from lakesoul_tpu_torch.tensorplane.replay import _batch_device_bytes

SHAPE, WIDTH, N_ROWS, BATCH = (4, 8), 32, 2048, 256
PER_BATCH = BATCH * (WIDTH * 4 + 4 + 4)  # emb f32 + id + label, as both packages bill it
SPILL_COUNTERS = ("lakesoul_replay_spilled_batches_total", "lakesoul_replay_spilled_bytes_total")


@pytest.fixture
def wh(tmp_path):
    schema = pa.schema([("id", pa.int32()), tensor_field("emb", SHAPE, "float32"),
                        ("label", pa.int32())])
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N_ROWS, WIDTH)).astype(np.float32)
    t = lakesoul_tpu.LakeSoulCatalog(str(tmp_path)).create_table(
        "tensors", schema, properties={"lakesoul.file_format": "lsf"})
    t.write_arrow(pa.table({
        "id": np.arange(N_ROWS, dtype=np.int32),
        "emb": pa.FixedSizeListArray.from_arrays(pa.array(emb.ravel()), WIDTH).cast(
            schema.field("emb").type),
        "label": rng.integers(0, 5, N_ROWS).astype(np.int32),
    }, schema=schema))
    return tmp_path


def _iters(wh, **kw):
    ref = lakesoul_tpu.LakeSoulCatalog(str(wh)).table("tensors").scan().batch_size(BATCH)
    port = lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("tensors").scan().batch_size(BATCH)
    return ref.to_jax_iter(cache="device", **kw), port.to_torch_iter(device="cpu", cache="device",
                                                                     **kw)


def _epoch(it) -> list:
    """One epoch as host numpy dicts we own."""
    return [{k: np.array(v.numpy() if isinstance(v, torch.Tensor) else v, copy=True)
             for k, v in b.items()} for b in it]


def _assert_same(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()


def _counters(reg) -> tuple:
    return tuple(reg().counter(n).value for n in SPILL_COUNTERS)


def test_epochs_one_to_three_byte_identical(wh):
    ref, port = _iters(wh)
    for epoch in range(3):
        want, got = _epoch(ref), _epoch(port)
        _assert_same(got, want)
        assert port.stats()["replay"] == ref.stats()["replay"]
        if epoch == 0:
            st = port.stats()["replay"]
            assert st["ready"] and not st["spilled"]
            assert st["resident_rows"] == N_ROWS and st["resident_batches"] == 8
            assert st["resident_bytes"] == 8 * PER_BATCH
    assert got[0]["emb"].shape == (BATCH,) + SHAPE  # the declared shape
    assert port.stats()["replay"]["epochs_served"] == 2
    assert port._device_cached is not None and len(port._device_cached) == 8


def test_spill_record_counters_and_spilled_replay_equal(wh):
    budget = 3 * PER_BATCH + 64
    ref_before, port_before = _counters(ref_obs.registry), _counters(port_obs.registry)
    ref, port = _iters(wh, replay_budget_bytes=budget)
    want, got = _epoch(ref), _epoch(port)
    _assert_same(got, want)
    assert isinstance(port._replay.spill, ReplaySpill)
    assert dataclasses.asdict(port._replay.spill) == dataclasses.asdict(ref._replay.spill) == {
        "budget_bytes": budget, "batch_rows": BATCH, "batch_bytes": PER_BATCH,
        "resident_batches": 3, "resident_bytes": 3 * PER_BATCH}
    ref_delta = np.subtract(_counters(ref_obs.registry), ref_before)
    port_delta = np.subtract(_counters(port_obs.registry), port_before)
    # every refused offer is metered: the crossing one and the four after it
    assert list(port_delta) == list(ref_delta) == [5, 5 * PER_BATCH]
    assert port.stats()["replay"] == ref.stats()["replay"]
    assert port.stats()["replay"]["spilled"]
    # resident prefix from the cache + the re-streamed tail, twice
    for _ in range(2):
        _assert_same(_epoch(port), want)
        _assert_same(_epoch(ref), want)


def test_spilled_permuted_cache_replays_in_stream_order(wh):
    ref, port = _iters(wh, replay_permute=True, replay_seed=1,
                       replay_budget_bytes=2 * PER_BATCH + 64)
    want = _epoch(ref)
    stream = _epoch(port)
    _assert_same(stream, want)
    assert port.stats()["replay"]["spilled"]
    _assert_same(_epoch(port), stream)
    _assert_same(_epoch(ref), want)


def test_abandoned_epoch_leaves_the_cache_unfilled(wh):
    for it in _iters(wh):
        for _ in it:
            break  # abandon: partial replay would silently drop data
        assert not it._replay.ready and it._replay.resident_batches == 0
        assert len(_epoch(it)) == 8  # the next pass streams and completes
        assert it._replay.ready


def test_env_budget_and_bad_values(wh, monkeypatch):
    monkeypatch.setenv(ENV_BUDGET, str(2 * PER_BATCH + 64))
    for it in _iters(wh):
        list(it)
        assert it.stats()["replay"]["spilled"]
        assert it.stats()["replay"]["resident_batches"] == 2
    monkeypatch.setenv(ENV_BUDGET, "not-a-number")
    with pytest.raises(RefConfigError) as r:
        _iters(wh)
    port_scan = lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("tensors").scan()
    with pytest.raises(ConfigError) as p:
        port_scan.to_torch_iter(device="cpu", cache="device")
    assert str(p.value) == str(r.value)


MISUSE = {
    "permute_without_cache": {"replay_permute": True},
    "budget_without_cache": {"replay_budget_bytes": 1 << 20},
    "seed_without_cache": {"replay_seed": 7},
    "unknown_cache_mode": {"cache": "host"},
    "cache_with_checkpoint": {"cache": "device", "checkpoint": "ckpt"},
    "cache_without_device_put": {"cache": "device", "device_put": False},
    "cache_with_follow": {"cache": "device", "follow": True},
}


@pytest.mark.parametrize("case", sorted(MISUSE))
def test_misuse_raises_typed_as_the_reference(wh, case):
    kw = dict(MISUSE[case])
    ref_kw, port_kw = dict(kw), dict(kw)
    if kw.get("checkpoint") == "ckpt":
        ref_kw["checkpoint"] = lakesoul_tpu.data.jax_iter.LoaderCheckpoint()
        port_kw["checkpoint"] = LoaderCheckpoint()
    ref = lakesoul_tpu.LakeSoulCatalog(str(wh)).table("tensors").scan()
    port = lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("tensors").scan()
    with pytest.raises(RefConfigError) as r:
        ref.to_jax_iter(**ref_kw)
    with pytest.raises(ConfigError) as p:
        port.to_torch_iter(device="cpu", **port_kw)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("case", ["replay_before_seal", "offer_after_seal", "zero_budget"])
def test_state_machine_misuse_typed_as_the_reference(case):
    def drive(cls, err):
        if case == "zero_budget":
            with pytest.raises(err) as e:
                cls(budget_bytes=0)
            return str(e.value)
        cache = cls(budget_bytes=1 << 20)
        if case == "replay_before_seal":
            with pytest.raises(err) as e:
                list(cache.replay())
            return str(e.value)
        cache.seal()
        with pytest.raises(err) as e:
            cache.offer(1, {"x": np.zeros(1, np.float32)})
        return str(e.value)

    assert drive(DeviceReplayCache, ConfigError) == drive(RefCache, RefConfigError)


def test_every_refused_offer_is_metered():
    before = port_obs.registry().counter(SPILL_COUNTERS[0]).value
    cache = DeviceReplayCache(budget_bytes=1024)
    batch = {"x": torch.zeros(64, 4)}  # 1 KiB
    assert cache.offer(64, batch)
    for _ in range(5):  # the crossing offer + 4 more refusals
        assert not cache.offer(64, batch)
    assert port_obs.registry().counter(SPILL_COUNTERS[0]).value - before == 5
    assert cache.resident_batches == 1 and cache.spill.resident_bytes == 1024


def test_batch_bills_the_bytes_each_storage_holds():
    from lakesoul_tpu.tensorplane import aligned_empty, deliver
    from lakesoul_tpu.tensorplane.replay import _batch_device_bytes as ref_bytes

    host = aligned_empty((64, 8), np.float32)
    # one leaf of its own storage: what the reference bills on one device
    assert _batch_device_bytes({"x": torch.from_numpy(host)}) == ref_bytes(
        deliver({"x": host})) == 64 * 8 * 4
    big = torch.zeros(100, 8)
    # a view pins its whole storage; a storage two leaves share bills once
    assert _batch_device_bytes({"a": big[:10], "b": big[50:]}) == 100 * 8 * 4
    # a host array (no storage on a device) bills its bytes, as the reference's
    assert _batch_device_bytes({"x": np.zeros((4, 4), np.float32)}) == ref_bytes(
        {"x": np.zeros((4, 4), np.float32)}) == 64


def test_interleaved_iterations_share_the_cache_safely(wh):
    """Two active iterations of ONE loader: only the first claims the fill,
    so the sealed epoch holds each batch once and both streams deliver the
    whole table — in the port as in the reference."""
    for it in _iters(wh):
        a, b = iter(it), iter(it)
        rows_a = rows_b = 0
        for x, y in zip(a, b):
            rows_a += x["id"].shape[0]
            rows_b += y["id"].shape[0]
        assert rows_a == rows_b == N_ROWS
        st = it.stats()["replay"]
        assert st["ready"] and st["resident_rows"] == N_ROWS and st["resident_batches"] == 8
        replay = _epoch(it)
        assert len(replay) == 8  # not 16: the epoch was sealed once
        assert np.array_equal(np.sort(np.concatenate([x["id"] for x in replay])),
                              np.arange(N_ROWS))
    for it in _iters(wh):
        g1, g2 = iter(it), iter(it)
        next(g1)
        assert 1 + sum(1 for _ in g2) == 9  # the non-owner runs to the end
        assert sum(1 for _ in g1) == 7  # the owner finishes afterwards and seals
        assert it.stats()["replay"]["resident_batches"] == 8


def test_with_the_reuse_ring_on(wh, monkeypatch):
    """``LAKESOUL_COLLATE_REUSE=1``: on the CPU a delivered tensor aliases its
    collate buffer, so the port keeps the ring down and a cached batch owns
    its bytes; the replayed epochs equal the reference's."""
    monkeypatch.setenv("LAKESOUL_COLLATE_REUSE", "1")
    ref, port = _iters(wh)
    assert port._ring is None
    want = _epoch(ref)
    _assert_same(_epoch(port), want)
    for _ in range(2):
        _assert_same(_epoch(port), want)
        _assert_same(_epoch(ref), want)


def test_consumer_gets_fresh_containers(wh):
    _, port = _iters(wh)
    want = _epoch(port)
    for b in port:  # a consumer that mutates what it is handed
        b["id"] = None
        b.clear()
    _assert_same(_epoch(port), want)


def _ids(epoch) -> list:
    return [b["id"] for b in epoch]


def test_permuted_replay_deterministic_multiset_and_reordered(wh):
    def replayed(seed):
        ref, port = _iters(wh, replay_permute=True, replay_seed=seed)
        stream = _epoch(port)
        _assert_same(stream, _epoch(ref))
        return stream, _epoch(port), _epoch(ref), port

    stream, a, ref_a, it_a = replayed(7)
    _, b, _, _ = replayed(7)
    _assert_same(b, a)  # one seed, one epoch
    ids = np.concatenate(_ids(a))
    assert not np.array_equal(ids, np.arange(N_ROWS))  # permuted
    assert np.array_equal(np.sort(ids), np.arange(N_ROWS))  # nothing lost
    # the stream's rows as a multiset: every (id, emb, label) row comes back
    by_id = {int(r): (e.tobytes(), int(lab)) for s in stream
             for r, e, lab in zip(s["id"], s["emb"], s["label"])}
    for x in a:
        for r, e, lab in zip(x["id"], x["emb"], x["label"]):
            assert by_id[int(r)] == (e.tobytes(), int(lab))
    # rows permuted within a batch, batches in the reference's order:
    # numpy's default_rng((seed, epoch)), drawn the same in both packages
    order = np.random.default_rng((7, 0)).permutation(8)
    for k, pos in enumerate(order):
        assert set(a[k]["id"].tolist()) == set(stream[pos]["id"].tolist()) \
            == set(ref_a[k]["id"].tolist())
    # the next epoch of the same iterator draws another permutation...
    c = np.concatenate(_ids(_epoch(it_a)))
    assert not np.array_equal(c, ids) and np.array_equal(np.sort(c), np.arange(N_ROWS))
    # ...and another seed another epoch
    _, d, _, _ = replayed(8)
    assert not np.array_equal(np.concatenate(_ids(d)), ids)
