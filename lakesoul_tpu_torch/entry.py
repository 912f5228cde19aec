"""The package's entry points, the port of ``__graft_entry__.py``.

- ``entry()``: the flagship model's forward (BERT-base MLM, fed by the
  data plane) and example arguments.
- ``dryrun_multichip(n)``: every parallel axis over ``n`` gloo CPU ranks,
  three train steps at tiny widths (``parallel/launch.py``):
    1. dp x tp x sp — BERT MLM, ring attention over sp, fed by a primary-key
                      table (written, upserted, scanned with merge-on-read)
                      through ``to_torch_iter``;
    2. dp x pp      — the same encoder pipelined over the layer stack (GPipe
                      over the ring shift);
    3. dp x ep      — MoE BERT with experts sharded over ep.

    python -m lakesoul_tpu_torch.entry [N]     # N ranks, default 8
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

TABLE = "dryrun_tokens"


def entry(device=None):
    """→ (fn, example_args): ``fn(model, input_ids, attn_mask)`` is BERT-base's
    forward → logits [8, 128, 30522]; ``device=None`` is the card."""
    from lakesoul_tpu_torch.models.bert import Bert, BertConfig, bert_forward

    cfg = BertConfig(vocab_size=30522, hidden=768, layers=12, heads=12, ff=3072, max_len=512)
    model = Bert(cfg, seed=0, device=device)
    dev = model.tok_emb.device

    def fn(model, input_ids, attn_mask):
        return bert_forward(model, input_ids, attn_mask)

    B, T = 8, 128
    rng = np.random.default_rng(0)
    input_ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                                device=dev)
    attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    return fn, (model, input_ids, attn_mask)


def _tiny_cfg(plan):
    from lakesoul_tpu_torch.models.bert import BertConfig

    # tiny widths, but every axis real: heads/ffn split over tp, the
    # sequence over sp, the batch over dp
    return BertConfig(vocab_size=512, hidden=64 * plan.tp, layers=2, heads=2 * plan.tp,
                      ff=128 * plan.tp, max_len=16 * plan.sp)


def _write_table(wh: str, vocab: int, T: int, n_rows: int, seed: int = 0) -> None:
    """A primary-key token table with an upsert wave, so the scan merges on read."""
    import pyarrow as pa

    from lakesoul_tpu_torch import LakeSoulCatalog

    rng = np.random.default_rng(seed)
    schema = pa.schema([("row", pa.int64())] + [(f"t{i}", pa.int32()) for i in range(T)])
    table = LakeSoulCatalog(wh).create_table(TABLE, schema, primary_keys=["row"],
                                             hash_bucket_num=2)
    cols = {"row": np.arange(n_rows, dtype=np.int64)}
    cols.update({f"t{i}": rng.integers(0, vocab, n_rows).astype(np.int32) for i in range(T)})
    table.write_arrow(pa.table(cols, schema=schema))
    upd = {"row": np.arange(0, n_rows, 3, dtype=np.int64)}
    upd.update({f"t{i}": rng.integers(0, vocab, len(upd["row"])).astype(np.int32)
                for i in range(T)})
    table.upsert(pa.table(upd, schema=schema))


def _masked(rng, ids: np.ndarray) -> np.ndarray:
    return np.where(rng.random(ids.shape) < 0.15, ids, -100).astype(np.int32)


def _dryrun_rank(wh: str, n: int) -> dict:
    """One rank's three legs (every rank of the run calls it)."""
    from lakesoul_tpu_torch import LakeSoulCatalog
    from lakesoul_tpu_torch.models.bert import BertConfig
    from lakesoul_tpu_torch.models.train import (
        make_bert_pipeline_train_state,
        make_bert_pipeline_train_step,
        make_bert_train_state,
        make_bert_train_step,
    )
    from lakesoul_tpu_torch.parallel.mesh import make_mesh

    out = {}
    plan = make_mesh(device_type="cpu")
    cfg = _tiny_cfg(plan)
    model, opt = make_bert_train_state(cfg, plan=plan, lr=1e-3)
    step = make_bert_train_step(model, opt, plan=plan)
    B, T = 2 * plan.dp, cfg.max_len
    # each leg draws from its own seed, the same on every rank: one global
    # batch (the loader may run the transform ahead on later batches)
    rng = np.random.default_rng(0)

    def collate(b):
        ids = np.stack([b[f"t{i}"] for i in range(T)], axis=1)
        return {"ids": ids, "labels": _masked(rng, ids), "mask": np.ones_like(ids, dtype=bool)}

    it = iter(LakeSoulCatalog(wh).table(TABLE).scan().batch_size(B).to_torch_iter(
        transform=collate, device="cpu"))
    batch = next(it)
    it.close()
    loss = step(*(plan.shard_batch(batch[k]) for k in ("ids", "labels", "mask")))
    out["table"] = {"mesh": (plan.dp, plan.tp, plan.sp), "loss": float(loss)}
    if n % 2:  # pp/ep need an even split; odd counts covered axes 1-3 above
        return out

    pp = max(2, n // 2)
    plan_pp = make_mesh(dp=n // pp, tp=1, sp=1, pp=pp, device_type="cpu")
    cfg_pp = BertConfig(vocab_size=256, hidden=32, layers=pp, heads=2, ff=64, max_len=16)
    model, opt = make_bert_pipeline_train_state(cfg_pp, plan_pp)
    pstep = make_bert_pipeline_train_step(model, opt, plan_pp, n_micro=4)
    B, rng = 4 * plan_pp.dp, np.random.default_rng(1)
    ids = rng.integers(0, cfg_pp.vocab_size, (B, T := cfg_pp.max_len)).astype(np.int32)
    batch = (ids, _masked(rng, ids), np.ones((B, T), np.int32))
    loss = pstep(*(plan_pp.shard_batch(a, seq=False) for a in batch))
    out["pipeline"] = {"dp": plan_pp.dp, "pp": pp, "loss": float(loss)}

    ep = max(2, n // 2)
    plan_ep = make_mesh(dp=n // ep, tp=1, sp=1, ep=ep, device_type="cpu")
    cfg_ep = BertConfig(vocab_size=256, hidden=32, layers=2, heads=2, ff=64, max_len=16,
                        n_experts=ep)
    model, opt = make_bert_train_state(cfg_ep, plan=plan_ep)
    estep = make_bert_train_step(model, opt, plan=plan_ep)
    B, rng = 4 * plan_ep.dp, np.random.default_rng(2)
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    batch = (ids, _masked(rng, ids), np.ones((B, T), bool))
    loss = estep(*(plan_ep.shard_batch(a) for a in batch))
    out["moe"] = {"dp": plan_ep.dp, "ep": ep, "loss": float(loss)}
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """Every parallel axis over ``n_devices`` gloo CPU ranks, the first leg
    fed by the data plane; raises unless every rank's every loss is finite
    and the ranks agree.  → rank 0's record."""
    from lakesoul_tpu_torch.parallel.launch import run_ranks
    from lakesoul_tpu_torch.parallel.mesh import _factor

    dp, tp, sp = _factor(n_devices)
    with tempfile.TemporaryDirectory(prefix="lakesoul_dryrun_") as wh:
        _write_table(wh, 512, 16 * sp, 4 * 2 * dp)
        outs = run_ranks("lakesoul_tpu_torch.entry:_dryrun_rank", n_devices, (wh, n_devices))
    for leg, rec in outs[0].items():
        losses = [o[leg]["loss"] for o in outs]
        if not np.isfinite(losses).all() or len(set(losses)) != 1:
            raise RuntimeError(f"dryrun_multichip leg {leg}: rank losses {losses}")
    return outs[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
