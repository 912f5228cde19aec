"""``train_from_table``: a training job fed from a LakeSoul table, a closed
loop.

Set-up writes the configuration's token table (seeded documents, then one
upsert wave, so every epoch merges on read) under ``TMPDIR``, loads the
seeded weights into the program's model, and starts the feed:
``scan().auto_shard().batch_size(B).to_torch_iter(transform=masking,
device="cuda")`` into ``make_bert_train_step``.  The first three steps
go through that same feed and step; the reference follows them.  The window
then continues the stream, epoch after epoch, until ``--seconds`` have
passed, and ends in a synchronise.

``train_rows_per_s`` is the table rows consumed by the steps completed in
the window over the whole window.  After it, every row the feed delivered
(window and warm-up) is held against the table's contents worked out from
the seed and the masking worked out again, and the three steps against
``reference/bert_ref.py``.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

import inputs
from counts.bert_flops import bert_step_flops
from harness import log, window_rate
from reference import bert_ref, compare
from tracing import Window, sync

REFERENCE_STEPS = 3


class Feed:
    """The table's batches, epoch after epoch, each through a fresh
    ``to_torch_iter``; every delivered batch is kept (its tensors are the
    step's inputs, already on the card) for the check after the window."""

    def __init__(self, make_iter):
        self.make_iter = make_iter
        self.epoch = 0
        self.it = iter(make_iter(0))
        self.delivered = []  # (epoch, batch)
        self.finished = []  # epochs read to their end

    def next(self) -> dict:
        while True:
            try:
                b = next(self.it)
                break
            except StopIteration:
                self.finished.append(self.epoch)
                self.epoch += 1
                self.it = iter(self.make_iter(self.epoch))
        self.delivered.append((self.epoch, b))
        return b

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


def model_config(cfg: dict):
    from lakesoul_tpu_torch import models as M

    return M.BertConfig(vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
                        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
                        ff=cfg["intermediate_size"], max_len=cfg["max_position_embeddings"],
                        dtype=cfg["precision"]["body"])


def load_weights(model, weights: dict) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the program's leaves are not the configuration's: "
                           f"{sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])


def write_table(L, workdir: str, cfg: dict, base, up_ids, up_tok):
    import pyarrow as pa

    seq = cfg["seq_len"]
    tab = cfg["table"]
    schema = pa.schema([("doc_id", pa.int64()), ("tokens", pa.list_(pa.int32(), seq))])

    def docs(ids, tok):
        return pa.table({"doc_id": ids, "tokens": pa.FixedSizeListArray.from_arrays(
            tok.reshape(-1), seq)}, schema=schema)

    t = L.LakeSoulCatalog(workdir).create_table(
        "c4", schema, primary_keys=["doc_id"], hash_bucket_num=int(tab["hash_bucket_num"]),
        properties={"lakesoul.file_format": tab["file_format"]})
    t.write_arrow(docs(np.arange(len(base), dtype=np.int64), base))
    t.upsert(docs(up_ids, up_tok))
    return t


def check_rows(seed: int, cfg: dict, tokens, delivered, finished) -> int:
    """Rows the feed delivered that are not what the table holds, masked as
    the seed says, plus rows an epoch repeated or, for an epoch read to its
    end, left out."""
    seq, prob, mask_id = cfg["seq_len"], cfg["mlm_probability"], cfg["mask_token_id"]
    bad = 0
    seen: dict[int, list] = {}
    for epoch, b in delivered:
        doc = b["doc_id"].cpu().numpy().astype(np.int64)
        ok = (doc >= 0) & (doc < len(tokens))
        safe = np.where(ok, doc, 0)
        ids, labels, mask = inputs.mlm_inputs(
            tokens[safe], inputs.mask_positions(seed, epoch, safe, seq, prob), mask_id)
        same = (ok & (b["ids"].cpu().numpy() == ids).all(1)
                & (b["labels"].cpu().numpy() == labels).all(1)
                & (b["mask"].cpu().numpy() == mask).all(1))
        bad += int((~same).sum())
        seen.setdefault(epoch, []).append(doc)
    for epoch, docs in seen.items():
        docs = np.concatenate(docs)
        bad += len(docs) - len(np.unique(docs))
        if epoch in finished:
            bad += len(tokens) - len(np.unique(docs))
    return bad


def reference_batches(seed, cfg, tokens, docs_by_step, device):
    seq, prob, mask_id = cfg["seq_len"], cfg["mlm_probability"], cfg["mask_token_id"]
    out = []
    for epoch, doc in docs_by_step:
        ids, labels, mask = inputs.mlm_inputs(
            tokens[doc], inputs.mask_positions(seed, epoch, doc, seq, prob), mask_id)
        out.append(tuple(torch.from_numpy(a).to(device) for a in (ids, labels, mask)))
    return out


def readings(cfg: dict, prog: dict, ref: dict) -> dict:
    """The three numbers of the training bullet, by the worst leaf."""
    moved = compare.moved_leaves(ref["grad_norms"])
    return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": compare.worst_leaf_gap(prog["grad_norms"], ref["grad_norms"])[0],
            "update_gap": compare.worst_leaf_gap(prog["update_norms"], ref["update_norms"],
                                                 moved)[0]}


def half_batch(step):
    """A fault a test plants: the step sees half of its batch."""
    def half(ids, labels, mask):
        n = ids.shape[0] // 2
        return step(ids[:n], labels[:n], mask[:n])
    return half


def run(ctx) -> dict:
    import lakesoul_tpu_torch as L
    from lakesoul_tpu_torch import models as M
    from lakesoul_tpu_torch.obs.stages import stage_seconds

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    seq, batch = cfg["seq_len"], cfg["batch_size"]
    base, up_ids, up_tok = inputs.token_docs(seed, cfg["table"], cfg["vocab_size"], seq)
    workdir = tempfile.mkdtemp(prefix="cellbench_table_")
    try:
        t = time.perf_counter()
        table = write_table(L, workdir, cfg, base, up_ids, up_tok)
        log(f"table written in {time.perf_counter() - t:.2f} s")
        model, opt = M.make_bert_train_state(model_config(cfg), lr=cfg["optimizer"]["lr"],
                                             device=dev)
        weights = inputs.bert_weights(seed, bert_ref.param_shapes(cfg), cfg["initializer_range"],
                                      dev)
        load_weights(model, weights)
        step = M.make_bert_train_step(model, opt, device=dev)
        faults = getattr(ctx, "faults", ())  # planted underneath by the tests only
        if "unchanged" in faults:
            opt.step = lambda *a, **k: None
        if "half_batch" in faults:
            step = half_batch(step)
        prob, mask_id = cfg["mlm_probability"], cfg["mask_token_id"]

        def make_iter(epoch):
            def transform(b):
                doc = np.asarray(b["doc_id"], np.int64)
                ids, labels, mask = inputs.mlm_inputs(
                    np.asarray(b["tokens"]), inputs.mask_positions(seed, epoch, doc, seq, prob),
                    mask_id)
                if "token" in faults:
                    ids[0, 0] = ids[0, 0] % 7 + 4  # never the token it was
                return {"doc_id": doc, "ids": ids, "labels": labels, "mask": mask}

            return table.scan().auto_shard().batch_size(batch).to_torch_iter(
                transform=transform, device=dev, prefetch=int(tr["prefetch"]))

        feed = Feed(make_iter)
        spans = ctx.spans
        prog = {"losses": []}
        beta1 = cfg["optimizer"]["betas"][0]
        for s in range(REFERENCE_STEPS):
            b = feed.next()
            prog["losses"].append(step(b["ids"], b["labels"], b["mask"]))
            if s == 0:
                with torch.no_grad():
                    prog["grad_norms"] = {
                        k: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                        if p in opt.state else 0.0 for k, p in model.named_parameters()}
        with torch.no_grad():
            prog["update_norms"] = {k: float((p - weights[k]).norm())
                                    for k, p in model.named_parameters()}
        prog["losses"] = [float(v) for v in prog["losses"]]
        del weights
        sync(dev)
        setup_s = time.perf_counter() - ctx.t0
        log(f"set-up {setup_s:.2f} s; reference steps' losses {prog['losses']}")

        losses = []
        queue0 = stage_seconds()["queue"]
        with Window(ctx.trace, dev, ctx.spans) as w:
            while True:
                with spans("next"):
                    b = feed.next()
                with spans("step"):
                    losses.append(step(b["ids"], b["labels"], b["mask"]))
                if time.perf_counter() - w.started >= ctx.seconds:
                    break
            w.close()
        queue_s = stage_seconds()["queue"] - queue0
        steps = len(losses)
        rows = steps * batch
        peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        in_window = feed.delivered[REFERENCE_STEPS:]
        labelled = sum(int((b["labels"] >= 0).sum()) for _, b in in_window)
        flops = bert_step_flops(hidden=cfg["hidden_size"], ff=cfg["intermediate_size"],
                                layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"],
                                seq=seq, tokens=rows * seq, labelled=labelled)["total"]
        log(f"window {w.seconds:.3f} s: {steps} steps, {rows / w.seconds:.1f} rows/s")
        feed.close()
        docs_by_step = [(e, b["doc_id"].cpu().numpy().astype(np.int64))
                        for e, b in feed.delivered[:REFERENCE_STEPS]]
        delivered, finished = feed.delivered, list(feed.finished)
        del step, model, opt, feed, losses, b
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t = time.perf_counter()
    tokens = inputs.merged_docs(base, up_ids, up_tok)
    rows_bad = check_rows(seed, cfg, tokens, delivered, finished)
    del delivered
    ref = bert_ref.train(inputs.bert_weights(seed, bert_ref.param_shapes(cfg),
                                             cfg["initializer_range"], dev),
                         reference_batches(seed, cfg, tokens, docs_by_step, dev), cfg,
                         cfg["optimizer"])
    read = readings(cfg, prog, ref)
    log(f"reference {time.perf_counter() - t:.2f} s; its losses {ref['losses']}")
    lim = cfg["limits"]
    checks = {"rows_wrong": (float(rows_bad), 0.0)}
    checks.update({k: (v, float(lim[k])) for k, v in read.items()})
    return {"e2e": {"train_rows_per_s": window_rate(rows, w.started, w.ended),
                    "setup_s": setup_s},
            "window_s": w.seconds, "trace": w.trace, "attempted": steps, "failed": failed,
            "memory_peak_bytes": peak, "checks": checks,
            "counters": {"model_flops": flops, "queue_s": queue_s, "steps": steps}}


# the reference at a lower precision put in the program's place, (body,
# head): the control, each part one step below the precision the
# configuration states for it, and a reading of the head alone lowered
LOWER = (("control", ("fp8", "bfloat16")), ("reading.head_bf16", ("float32", "bfloat16")))


def control(ctx) -> list:
    """For each seed of ``ctx.seeds``, at the cell's own size: the numbers of
    each of ``LOWER`` against the float32 reference, on three batches of
    the table, and of a sound run and of each fault planted in the program,
    a short window each."""
    cfg, dev = ctx.config, ctx.device
    out = []
    for seed in ctx.seeds:
        base, up_ids, up_tok = inputs.token_docs(seed, cfg["table"], cfg["vocab_size"],
                                                 cfg["seq_len"])
        tokens = inputs.merged_docs(base, up_ids, up_tok)
        b = cfg["batch_size"]
        docs = [(0, np.arange(i * b, (i + 1) * b)) for i in range(REFERENCE_STEPS)]
        batches = reference_batches(seed, cfg, tokens, docs, dev)
        w = inputs.bert_weights(seed, bert_ref.param_shapes(cfg), cfg["initializer_range"], dev)
        ref = bert_ref.train(w, batches, cfg, cfg["optimizer"])
        for name, (body, head) in LOWER:
            low = bert_ref.train(w, batches, cfg, cfg["optimizer"], body=body, head=head)
            out.append({"seed": seed, "variant": name, **readings(cfg, low, ref)})
        del w, batches, ref, low
        for name, faults in (("sound", set()), ("unchanged", {"unchanged"}),
                             ("half_batch", {"half_batch"}), ("token", {"token"})):
            c = SimpleNamespace(**{**vars(ctx), "seed": seed, "t0": time.perf_counter(),
                                   "faults": faults})
            r = run(c)
            out.append({"seed": seed, "variant": name, "failed": r["failed"],
                        **{k: v for k, (v, _) in r["checks"].items()}})
    return out
