"""Slice 4's table feeds on the CPU: ``examples/resnet_from_table.py`` and
``examples/bert_mlm_from_table.py`` through both packages.

Each example's table is written as the example writes it (by the reference
package), then read by the reference's ``to_jax_iter(device_put=False)`` and
the port's ``to_torch_iter(device="cpu")`` with the example's own transform
(ResNet: pixels / 255 as float32 NHWC, int32 labels; BERT: numpy
``default_rng(0)`` masking of 15 %, [MASK] = 3, labels -100 elsewhere, an
all-ones mask): every batch must be byte-identical.  Then three train steps
of each package from the same weights (carried by ``models/convert.py``)
on those batches: losses within rtol 1e-4.  BERT's run free; each of
ResNet's starts from the reference's updated weights, and its own update
is held against the reference's within the reference's spread (its float32
gradient at init is ill-conditioned: see the test).  The models run at float32 here:
the reference's bf16 ResNet cannot be differentiated on this jax
(ROADMAP Queue 3), and bf16 sums in another order would need a bf16
tolerance.  ``chip_smoke.py``'s card feed splits the ResNet transform at the
copy (the uint8 view on the host, the float pass on the card): held equal to
the example's here too."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

import lakesoul_tpu
import lakesoul_tpu_torch
from lakesoul_tpu.models import bert as JB
from lakesoul_tpu.models import resnet as JR
from lakesoul_tpu.models import train as JT
from lakesoul_tpu.parallel.mesh import make_mesh
from lakesoul_tpu_torch.models import (
    Bert,
    BertConfig,
    ResNet,
    ResNetConfig,
    adamw,
    convert,
    make_bert_train_step,
    make_resnet_train_step,
    sgd,
)

STEPS, LOSS_RTOL, SPREAD_FACTOR = 3, 1e-4, 3.0
IMG, NUM_CLASSES, N_IMAGES, IMG_BATCH = 32, 10, 128, 32  # examples/resnet_from_table.py:26-44, B = 4 x dp at dp 8
VOCAB, T, N_DOCS, DOC_BATCH = 512, 32, 64, 2  # examples/bert_mlm_from_table.py:39-48


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(batch) -> dict:
    return {k: np.array(v.numpy() if isinstance(v, torch.Tensor) else v, copy=True)
            for k, v in batch.items()}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


# ------------------------------------------------------------------ ResNet
def _image_table(wh):
    """The example's image table: uint8 pixels as fixed-size lists, labels,
    ``hash_bucket_num=4``, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (N_IMAGES, IMG * IMG * 3), dtype=np.uint8)
    schema = pa.schema([("image_id", pa.int64()), ("pixels", pa.list_(pa.uint8(), IMG * IMG * 3)),
                        ("label", pa.int32())])
    t = lakesoul_tpu.LakeSoulCatalog(str(wh)).create_table(
        "imagenet_mini", schema, primary_keys=["image_id"], hash_bucket_num=4)
    t.write_arrow(pa.table({
        "image_id": np.arange(N_IMAGES),
        "pixels": pa.FixedSizeListArray.from_arrays(pixels.reshape(-1), IMG * IMG * 3),
        "label": rng.integers(0, NUM_CLASSES, N_IMAGES).astype(np.int32)}, schema=schema))
    return (lakesoul_tpu.LakeSoulCatalog(str(wh)).table("imagenet_mini"),
            lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("imagenet_mini"))


def resnet_transform(b):
    """examples/resnet_from_table.py's transform."""
    imgs = np.stack(b["pixels"]).reshape(-1, IMG, IMG, 3).astype(np.float32) / 255.0
    return {"x": imgs, "y": b["label"].astype(np.int32)}


@pytest.fixture(scope="module")
def image_batches(tmp_path_factory):
    ref_t, port_t = _image_table(tmp_path_factory.mktemp("images"))
    want = [_host(b) for b in ref_t.scan().auto_shard().batch_size(IMG_BATCH).to_jax_iter(
        transform=resnet_transform, device_put=False)]
    got = [_host(b) for b in port_t.scan().auto_shard().batch_size(IMG_BATCH).to_torch_iter(
        transform=resnet_transform, device="cpu")]
    return ref_t, port_t, want, got


def test_resnet_feed_batches_equal_the_references(image_batches):
    _, _, want, got = image_batches
    _assert_batches_equal(got, want)
    assert got[0]["x"].shape == (IMG_BATCH, IMG, IMG, 3) and got[0]["x"].dtype == np.float32
    assert sum(len(b["y"]) for b in got) == N_IMAGES


def test_resnet_three_steps_from_the_table_agree(image_batches):
    """Three SGD steps on the table's batches, each from the reference's
    weights after the step before (carried by ``convert``): the loss within
    rtol 1e-4, and every updated parameter within 1e-4 of the update's size
    plus 3x the reference's own spread over four reorderings of the batch
    (as ``test_torch_models_resnet.py``: a random 50-layer net with batch
    statistics amplifies float32 rounding, and a reordering moves the
    reference's own update of some leaves by percents, so a fixed rtol
    cannot hold it).  Batches of 32, the example's ``4 x dp`` at dp 8: at
    4 images a 1e-6 relative change of the weights moves the reference's
    own update far more than a reordering does, so its spread would not
    measure its conditioning.  A 1 % error in the port's learning rate
    fails this test.  ``optax.sgd``
    and ``torch.optim.SGD`` without momentum keep no optimizer state: both
    are held empty."""
    _, _, want, got = image_batches
    jcfg = JR.ResNetConfig(num_classes=NUM_CLASSES, width=8, dtype="float32")
    params = jax.tree.map(np.array, JR.init_resnet_params(jcfg, jax.random.key(0)))
    model = ResNet(ResNetConfig(num_classes=NUM_CLASSES, width=8, dtype="float32"), device="cpu")
    tx = optax.sgd(0.05)
    ref_step = JT.make_resnet_train_step(jcfg, tx)
    opt = sgd(model.parameters(), 0.05)
    step = make_resnet_train_step(model, opt, device="cpu")

    def ref_update(x, y):
        # the step donates its inputs: every call gets its own copies
        p, opt_state, loss = ref_step(jax.tree.map(jnp.array, params), tx.init(params), x, y)
        assert not jax.tree.leaves(opt_state)
        return convert._flatten(jax.tree.map(np.array, p)), float(loss)

    for w, g in zip(want[:STEPS], got[:STEPS]):
        model.load_state_dict(convert.from_reference_params(params))
        before = convert._flatten(params)
        updated, ref_loss = ref_update(w["x"], w["y"])
        spread = dict.fromkeys(updated, 0.0)
        for r in range(1, 5):
            perm = np.roll(np.arange(len(w["y"])), r)[::(-1 if r % 2 else 1)]
            for k, v in ref_update(w["x"][perm], w["y"][perm])[0].items():
                spread[k] = max(spread[k], float(np.abs(v - updated[k]).max()))
        loss = step(torch.from_numpy(g["x"]), torch.from_numpy(g["y"]))
        np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL)
        mine = convert._flatten(convert.to_reference_params(model))
        assert set(mine) == set(updated)
        bad = [k for k, v in updated.items()
               if np.abs(mine[k] - v).max()
               > 1e-4 * np.abs(v - before[k]).max() + SPREAD_FACTOR * spread[k]
               + 1e-6 * np.abs(v).max()]
        assert not bad, bad
        assert all(not st or st.get("momentum_buffer") is None for st in opt.state.values())
        params = convert._unflatten(updated)


def test_chip_smokes_split_transform_equals_the_examples(image_batches):
    """The card feed's split: the uint8 NHWC view on the host, then float32
    / 255 after the copy — the example's batch, bit for bit."""
    _, port_t, want, _ = image_batches
    cs = _chip_smoke()
    cs.RESNET_IMG = IMG
    got = []
    for b in port_t.scan().auto_shard().batch_size(IMG_BATCH).to_torch_iter(
            transform=cs.resnet_table_transform, device="cpu"):
        got.append(_host({"x": cs.resnet_table_images(torch, b["x"]), "y": b["y"]}))
    _assert_batches_equal(got, want)


# -------------------------------------------------------------------- BERT
def _token_table(wh):
    """The example's "C4" rows: pre-tokenized sequences in a PK table
    (``hash_bucket_num=4``) from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, VOCAB, (N_DOCS, T)).astype(np.int32)
    schema = pa.schema([("doc_id", pa.int64()), ("tokens", pa.list_(pa.int32(), T))])
    t = lakesoul_tpu.LakeSoulCatalog(str(wh)).create_table(
        "c4", schema, primary_keys=["doc_id"], hash_bucket_num=4)
    t.write_arrow(pa.table({"doc_id": np.arange(N_DOCS),
                            "tokens": pa.FixedSizeListArray.from_arrays(tokens.reshape(-1), T)},
                           schema=schema))
    return (lakesoul_tpu.LakeSoulCatalog(str(wh)).table("c4"),
            lakesoul_tpu_torch.LakeSoulCatalog(str(wh)).table("c4"))


def bert_transform():
    """examples/bert_mlm_from_table.py's transform, with its generator where
    the example's stands after drawing the tokens."""
    rng = np.random.default_rng(0)
    rng.integers(4, VOCAB, (N_DOCS, T))

    def transform(b):
        ids = np.stack(b["tokens"])  # [rows, T]
        labels = np.full_like(ids, -100)
        mask_pos = rng.random(ids.shape) < 0.15
        labels[mask_pos] = ids[mask_pos]
        masked = ids.copy()
        masked[mask_pos] = 3  # [MASK]
        return {"ids": masked.astype(np.int32), "labels": labels.astype(np.int32),
                "mask": np.ones_like(ids, dtype=bool)}

    return transform


@pytest.fixture(scope="module")
def token_batches(tmp_path_factory):
    ref_t, port_t = _token_table(tmp_path_factory.mktemp("tokens"))
    want = [_host(b) for b in ref_t.scan().batch_size(DOC_BATCH).to_jax_iter(
        transform=bert_transform(), device_put=False)]
    got = [_host(b) for b in port_t.scan().batch_size(DOC_BATCH).to_torch_iter(
        transform=bert_transform(), device="cpu")]
    return want, got, port_t


def test_bert_feed_batches_equal_the_references(token_batches):
    want, got, _ = token_batches
    _assert_batches_equal(got, want)
    labelled = sum(int((b["labels"] >= 0).sum()) for b in got)
    assert 0.1 < labelled / (N_DOCS * T) < 0.2  # ~15 % masked
    assert all((b["ids"][b["labels"] >= 0] == 3).all() for b in got)


def test_bert_three_steps_from_the_table_agree(token_batches):
    want, got, _ = token_batches
    fields = dict(vocab_size=VOCAB, hidden=64, layers=2, heads=2, ff=128, max_len=T,
                  dtype="float32")
    plan = make_mesh(jax.devices()[:1])
    params, opt_state, tx, shardings = JT.make_bert_train_state(JB.BertConfig(**fields), plan,
                                                                lr=1e-3)
    ref_step = JT.make_bert_train_step(JB.BertConfig(**fields), plan, tx, shardings)
    model = Bert(BertConfig(**fields), device="cpu")
    model.load_state_dict(convert.from_reference_params(jax.tree.map(np.asarray, params)))
    step = make_bert_train_step(model, adamw(model.parameters(), 1e-3), device="cpu")
    for w, g in zip(want[:STEPS], got[:STEPS]):
        params, opt_state, ref_loss = ref_step(params, opt_state, w["ids"], w["labels"],
                                               w["mask"])
        loss = step(*(torch.from_numpy(g[k]) for k in ("ids", "labels", "mask")))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)


def test_chip_smokes_bert_transform_equals_the_examples(token_batches):
    want, _, port_t = token_batches
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    rng.integers(4, VOCAB, (N_DOCS, T))
    got = [_host(b) for b in port_t.scan().batch_size(DOC_BATCH).to_torch_iter(
        transform=cs.bert_table_transform(rng), device="cpu")]
    _assert_batches_equal(got, want)
