"""Crash-prefix replay in the port (``lakesoul_tpu_torch/analysis/fscheck.py``),
case for case the reference's ``tests/test_fscheck.py``: the port's
publication protocols — spool range write, session manifest, obs fleet
docs, the spill rung, the plane manifest store + ``AnnPlane.open`` — replay
torn-state free at EVERY op prefix, while seeded bad publications
(in-place writes, unfsynced renames, CRC barriers before their data) are
caught with the publishing stack and the offending prefix.  Also pins the
directory fsync (the port's ``atomicio.fsync_dir``), the detector's control
surface (env gate, enable/disable restore, watch scoping), and the replay's
explicit device: ``AnnPlane.open`` runs where ``replay(device=)`` says, and
without a card ``device=None`` raises instead of falling back to the CPU."""

import builtins
import json
import os

import numpy as np
import pyarrow as pa
import pytest

from lakesoul_tpu_torch.analysis import fscheck
from lakesoul_tpu_torch.runtime import atomicio

SCHEMA = pa.schema([("x", pa.int64())])


def _doc(obj) -> bytes:
    return json.dumps(obj).encode()


def one_batch(values=(1, 2, 3)):
    return pa.record_batch([pa.array(list(values))], schema=SCHEMA)


@pytest.fixture(autouse=True)
def _pristine_detector():
    """Every test starts and ends with the real filesystem surface."""
    assert not fscheck.enabled()
    yield
    fscheck.disable()
    fscheck.reset()


# ------------------------------------------------------------ control plane


def test_env_gate(monkeypatch):
    monkeypatch.delenv("LAKESOUL_FSCHECK", raising=False)
    assert not fscheck.env_requested()
    monkeypatch.setenv("LAKESOUL_FSCHECK", "1")
    assert fscheck.env_requested()
    monkeypatch.setenv("LAKESOUL_FSCHECK", "0")
    assert not fscheck.env_requested()


def test_enable_disable_restores_surface():
    real_open, real_replace, real_fsync = builtins.open, os.replace, os.fsync
    fscheck.enable()
    fscheck.enable()  # idempotent
    assert builtins.open is not real_open
    assert os.replace is not real_replace
    fscheck.disable()
    fscheck.disable()
    assert builtins.open is real_open
    assert os.replace is real_replace
    assert os.fsync is real_fsync


def test_unrelated_paths_stay_untraced(tmp_path):
    with fscheck.watch():
        with open(tmp_path / "notes.txt", "w") as f:
            f.write("scratch")
        os.replace(tmp_path / "notes.txt", tmp_path / "notes2.txt")
    assert fscheck.ops() == []
    assert fscheck.replay() == []


# ------------------------------------------------- real protocols stay clean


def test_spool_session_obs_replay_clean(tmp_path):
    from lakesoul_tpu_torch.scanplane import spool

    sess = tmp_path / "sess"
    sess.mkdir()
    with fscheck.watch() as w:
        spool.write_range(str(sess), 0, SCHEMA, [one_batch()], holder="w1")
        atomicio.publish_bytes(
            str(sess / "manifest.json"),
            _doc(
                {
                    "session": "s",
                    "request": {},
                    "version_digest": "v",
                    "ranges": [],
                    "created_ms": 1,
                }
            ),
        )
        atomicio.publish_bytes(
            str(tmp_path / "member-abc.json"),
            _doc({"service": "x", "heartbeat_ms": 1}),
        )
        fscheck.replay()
    # the protocol stages, fsyncs, then renames — every prefix is
    # old-complete or new-complete under every torn variant
    assert w.violations == [], "\n\n".join(v.render() for v in w.violations)
    kinds = [op.kind for op in fscheck.ops()]
    assert "fsync" in kinds and "replace" in kinds


def test_spill_rung_replay_clean(tmp_path):
    from lakesoul_tpu_torch.fleet import transport
    from lakesoul_tpu_torch.scanplane import spool

    sess = tmp_path / "sess"
    sess.mkdir()
    spool.write_range(str(sess), 0, SCHEMA, [one_batch()], holder="w1")
    with fscheck.watch() as w:
        spill = transport.spill_range(
            str(tmp_path / "spill"), "sessA", str(sess), 0
        )
        transport.write_spill_probe(str(tmp_path / "spill"), "sessA")
        fscheck.replay()
    assert w.violations == [], "\n\n".join(v.render() for v in w.violations)
    # the round-trip still verifies after replay (nothing was mutated)
    nbytes, batches = transport.fetch_spilled(spill)
    assert nbytes == spill["nbytes"] and batches[0].num_rows == 3


def test_plane_store_replay_clean(tmp_path):
    from lakesoul_tpu_torch.annplane import AnnPlane, AnnPlaneConfig, ShardedAnnBuilder
    from lakesoul_tpu_torch.vector.config import VectorIndexConfig

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    ids = np.arange(600, dtype=np.uint64)
    index = VectorIndexConfig(column="e", dim=16, nlist=4, total_bits=4)
    probe = AnnPlaneConfig(
        index=index, shard_budget_bytes=1 << 30, keep_raw=True
    )
    cfg = AnnPlaneConfig(
        index=index,
        shard_budget_bytes=300 * probe.bytes_per_vector(),
        keep_raw=True,
    )
    root = str(tmp_path / "p")

    def stream():
        for lo in range(0, 600, 200):
            yield vecs[lo : lo + 200], ids[lo : lo + 200]

    with fscheck.watch() as w:
        ShardedAnnBuilder(root, cfg, device="cpu").build(stream())
        AnnPlane.open(root, device="cpu")
        fscheck.replay(device="cpu")
    # every PLANE pointer swing replays old-or-new: AnnPlane.open at each
    # prefix sees the previous complete record, a mid-build record (a
    # loud, typed refusal), or the finished plane — never a CRC error
    assert w.violations == [], "\n\n".join(v.render() for v in w.violations)
    assert any(
        op.kind == "replace" and os.path.basename(op.dst) == "PLANE"
        for op in fscheck.ops()
    )


# -------------------------------------------------- seeded torn publications


def test_in_place_write_caught(tmp_path):
    with fscheck.watch() as w:
        with open(tmp_path / "member-bad.json", "w") as f:
            f.write(json.dumps({"service": "y"}))
        found = fscheck.replay()
    assert found and all(v.kind == "torn-state" for v in found)
    v = found[0]
    assert v.prefix >= 1
    assert "neither old-complete nor new-complete" in v.message
    rendered = v.render()
    assert "publishing op:" in rendered and "reader:" in rendered
    assert "test_torch_fscheck" in rendered  # the producing stack names this test
    assert w.violations == found


def test_unfsynced_rename_caught_online(tmp_path):
    tmp = tmp_path / "recorder-bad.json.tmp-1"
    with fscheck.watch() as w:
        with open(tmp, "w") as f:
            f.write("{}")
        os.replace(tmp, tmp_path / "recorder-bad.json")
    kinds = {v.kind for v in w.violations}
    assert "unfsynced-rename" in kinds
    (v,) = [v for v in w.violations if v.kind == "unfsynced-rename"]
    assert "never" in v.message and "fsync" in v.message


def test_crc_barrier_before_data_caught(tmp_path):
    crc = tmp_path / "range-00007.arrow.crc"
    tmp = str(crc) + ".tmp-x"
    with fscheck.watch() as w:
        with open(tmp, "w") as f:
            f.write(
                json.dumps(
                    {
                        "path": str(tmp_path / "range-00007.arrow"),
                        "crc32": 0,
                        "nbytes": 3,
                    }
                )
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, crc)
    assert "barrier-before-data" in {v.kind for v in w.violations}


def test_data_then_crc_is_clean_online(tmp_path):
    # the sanctioned spill ordering: segment durable first, CRC doc last
    seg = tmp_path / "range-00008.arrow"
    with fscheck.watch() as w:
        for path, payload in (
            (seg, b"segment-bytes"),
            (str(seg) + ".crc", json.dumps({"path": str(seg)}).encode()),
        ):
            t = str(path) + ".tmp-x"
            with open(t, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(t, path)
    assert [v.kind for v in w.violations] == []


# ------------------------------------------------------- directory fsync


def test_fsync_dir_records_fsyncdir(tmp_path):
    """The port has no ``LAKESOUL_FSYNC_DIR`` switch: a publication that
    must survive a host crash calls ``atomicio.fsync_dir`` itself (the
    checkpointer does).  The trace records it after the rename it makes
    durable."""
    doc = str(tmp_path / "member-dir.json")
    with fscheck.watch():
        atomicio.publish_bytes(doc, b"{}")
    assert not any(op.kind == "fsyncdir" for op in fscheck.ops())
    fscheck.reset()
    with fscheck.watch() as w:
        atomicio.publish_bytes(doc, b"{}")
        atomicio.fsync_dir(str(tmp_path))
        fscheck.replay()
    ops = fscheck.ops()
    kinds = [op.kind for op in ops]
    assert "fsyncdir" in kinds, kinds
    assert kinds.index("fsyncdir") > kinds.index("replace")
    assert ops[kinds.index("fsyncdir")].path == str(tmp_path)
    assert w.violations == []


# ------------------------------------------------------ the replay's device


def _plane_trace(tmp_path):
    from lakesoul_tpu_torch.annplane import AnnPlaneConfig, ShardedAnnBuilder
    from lakesoul_tpu_torch.vector.config import VectorIndexConfig

    vecs = np.random.default_rng(1).normal(size=(200, 16)).astype(np.float32)
    cfg = AnnPlaneConfig(index=VectorIndexConfig(column="e", dim=16, nlist=2),
                         shard_budget_bytes=1 << 30)
    with fscheck.watch():
        ShardedAnnBuilder(str(tmp_path / "p"), cfg, device="cpu").build(
            [(vecs, np.arange(200, dtype=np.uint64))])


def test_replay_opens_the_plane_on_the_named_device(tmp_path, monkeypatch):
    from lakesoul_tpu_torch.annplane import search

    seen = []
    real = search.AnnPlane.open.__func__

    def spy(cls, root, storage_options=None, *, device=None, **kw):
        seen.append(device)
        return real(cls, root, storage_options, device=device, **kw)

    _plane_trace(tmp_path)
    monkeypatch.setattr(search.AnnPlane, "open", classmethod(spy))
    assert fscheck.replay(device="cpu") == []
    assert seen and {str(d) for d in seen} == {"cpu"}


def test_replay_without_a_card_raises_rather_than_falling_back(tmp_path, monkeypatch):
    import torch

    from lakesoul_tpu_torch.errors import ConfigError

    _plane_trace(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        fscheck.replay()
    # a trace that opens no plane needs no device at all
    fscheck.reset()
    with fscheck.watch():
        atomicio.publish_bytes(str(tmp_path / "member-x.json"), b"{}")
    assert fscheck.replay() == []
