"""``train_lm_from_table``: a decoder's next-token training job fed from a
LakeSoul token table of packed rows, a closed loop.

Set-up writes the configuration's token table (seeded rows of ``seq_len``
token ids, then one upsert wave, so every epoch merges on read) under
``TMPDIR``, loads the seeded weights and the selection biases that balance
the routing of the table's first batch (``start_biases``) into the
program's model (``configs/moonlight_16b_a3b_ep8.json``:
``make_lm_train_state``), and starts the feed: ``scan().auto_shard().batch_size(B).to_torch_iter(
device="cuda")`` into ``make_lm_train_step``.  The first three steps go
through that same feed and step; the reference follows them.  The window
then continues the stream, epoch after epoch, until ``--seconds`` have
passed, and ends in a synchronise.

``train_rows_per_s`` is the table rows consumed by the steps completed in
the window over the whole window.  After it, every row the feed delivered
(window and warm-up) is held against the table's contents worked out from
the seed, and the three steps against ``reference/moonlight_ref.py``,
computed after the program's model is freed: the losses, the first
gradient and the change of every leaf (the selection biases among them),
and the first step's top-k choices of every MoE layer.  The held experts'
dropped selections, which the program counts on the card, are checked at 0.
"""

from __future__ import annotations

import gc
import shutil
import statistics
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import harness
import inputs
from counts.moonlight_flops import held_expert_flops, moonlight_step_flops
from harness import log, window_rate
from reference import compare, moonlight_ref
from tracing import Window, sync

_TABLE = harness.load_module(Path(__file__).with_name("train_from_table.py"))
Feed, load_weights, write_table = _TABLE.Feed, _TABLE.load_weights, _TABLE.write_table
REFERENCE_STEPS = 3


def model_config(cfg: dict):
    from lakesoul_tpu_torch import models as M

    return M.DeepseekConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], kv_rank=cfg["kv_lora_rank"],
        qk_nope=cfg["qk_nope_head_dim"], qk_rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], ff=cfg["intermediate_size"],
        dense_layers=cfg["first_k_dense_replace"], n_experts=cfg["router_experts"],
        held=(cfg["held_expert_first"], cfg["n_routed_experts"]),
        top_k=cfg["num_experts_per_tok"], expert_ff=cfg["moe_intermediate_size"],
        n_shared=cfg["n_shared_experts"], routed_scaling=cfg["routed_scaling_factor"],
        rms_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        aux_alpha=cfg["aux_loss_alpha"], bias_speed=cfg["bias_update_speed"],
        init_std=cfg["initializer_range"], dtype=cfg["precision"]["body"])


def weights(seed: int, cfg: dict, device) -> dict:
    return inputs.bert_weights(seed, moonlight_ref.param_shapes(cfg), cfg["initializer_range"],
                               device)


def check_rows(tokens, delivered, finished) -> int:
    """Rows the feed delivered that are not what the table holds, plus rows
    an epoch repeated or, for an epoch read to its end, left out."""
    bad = 0
    seen: dict[int, list] = {}
    for epoch, b in delivered:
        doc = b["doc_id"].cpu().numpy().astype(np.int64)
        ok = (doc >= 0) & (doc < len(tokens))
        same = ok & (b["tokens"].cpu().numpy() == tokens[np.where(ok, doc, 0)]).all(1)
        bad += int((~same).sum())
        seen.setdefault(epoch, []).append(doc)
    for epoch, docs in seen.items():
        docs = np.concatenate(docs)
        bad += len(docs) - len(np.unique(docs))
        if epoch in finished:
            bad += len(tokens) - len(np.unique(docs))
    return bad


def start_biases(cfg: dict, tokens, w: dict, device) -> dict:
    """The selection biases the job starts from: those that balance the
    routing of the table's first batch (``moonlight_ref.balanced_biases``),
    as a job past its first steps holds them.  At step 0, with the
    configuration's init, the layers' inputs share one direction and a few
    experts take most of the choices, each seed others."""
    return moonlight_ref.balanced_biases(
        w, torch.from_numpy(tokens[:cfg["batch_size"]]).to(device), cfg)


def bias_gap(cfg: dict, prog: dict, start: dict) -> tuple[float, str]:
    """The selection biases, leaves that take no gradient, against the
    reference's update rule applied, from ``start``, to the program's own
    choices of each step: the distance of each layer's bias from the
    rule's, over the rule's norm or the median layer's, whichever is
    larger, at the worst layer.  The choices themselves are held against
    the reference's by ``route_gap``."""
    want = moonlight_ref.bias_after(prog["selections"], cfg, start)
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = statistics.median(norms.values())
    gaps = {k: float((prog["biases"][k] - v).norm()) / max(norms[k], med, 1e-30)
            for k, v in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(cfg: dict, prog: dict, ref: dict, start: dict) -> dict:
    """The numbers of the training bullet, by the worst leaf (the selection
    biases by ``bias_gap``), and the share of (token, MoE layer) pairs at
    step 1 whose top-k set is not the reference's."""
    moved = compare.moved_leaves(ref["grad_norms"])
    grad = compare.worst_leaf_gap(prog["grad_norms"], ref["grad_norms"])
    change = compare.worst_leaf_gap(prog["update_norms"], ref["update_norms"], moved)
    bias = bias_gap(cfg, prog, start)
    log(f"worst leaves: gradient {grad}, change {change}, selection bias {bias}")
    sel, ref_sel = prog["selections"][0], ref["selections"][0]
    route_gap = 1.0  # a step that did not route the batch's tokens differs in all
    if sel.shape == ref_sel.shape:
        differ = (sel.sort(-1).values != ref_sel.sort(-1).values).any(-1)
        route_gap = float(differ.float().mean())
    return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]), "grad_gap": grad[0],
            "update_gap": max(change[0], bias[0]), "route_gap": route_gap}


def half_batch(step):
    """A fault a test plants: the step sees half of its batch."""
    return lambda tokens: step(tokens[:tokens.shape[0] // 2])


def run(ctx) -> dict:
    import lakesoul_tpu_torch as L
    from lakesoul_tpu_torch import models as M
    from lakesoul_tpu_torch.obs.stages import stage_seconds
    from lakesoul_tpu_torch.parallel.experts import publish_counters

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    seq, batch = cfg["seq_len"], cfg["batch_size"]
    mcfg = model_config(cfg)
    base, up_ids, up_tok = inputs.token_docs(seed, cfg["table"], cfg["vocab_size"], seq)
    tokens = inputs.merged_docs(base, up_ids, up_tok)
    workdir = tempfile.mkdtemp(prefix="cellbench_table_")
    try:
        t = time.perf_counter()
        table = write_table(L, workdir, cfg, base, up_ids, up_tok)
        log(f"table written in {time.perf_counter() - t:.2f} s")
        model, opt = M.make_lm_train_state(mcfg, lr=cfg["optimizer"]["lr"], device=dev)
        w = weights(seed, cfg, dev)
        t = time.perf_counter()
        start = start_biases(cfg, tokens, w, dev)
        log(f"selection biases balanced in {time.perf_counter() - t:.2f} s")
        load_weights(model, w)
        del w
        with torch.no_grad():
            for i, lp in enumerate(model.layers):
                if hasattr(lp, "moe"):
                    lp.moe.selection_bias.copy_(start[i])
        faults = getattr(ctx, "faults", ())  # planted underneath by the tests only
        if "unchanged" in faults:
            opt.step = lambda *a, **k: None
        if "bias" in faults:
            model.update_selection_bias = lambda: None
        step = M.make_lm_train_step(model, opt, device=dev)
        if "half_batch" in faults:
            step = half_batch(step)
        moe = model.moe_layers()

        def make_iter(epoch):
            def transform(b):
                tok = np.asarray(b["tokens"], np.int32)
                if "token" in faults:
                    tok = tok.copy()
                    tok[0, 0] = (tok[0, 0] + 1) % cfg["vocab_size"]  # never the token it was
                return {"doc_id": np.asarray(b["doc_id"], np.int64), "tokens": tok}

            return table.scan().auto_shard().batch_size(batch).to_torch_iter(
                transform=transform, device=dev, prefetch=int(tr["prefetch"]))

        feed = Feed(make_iter)
        spans = ctx.spans
        prog = {"losses": [], "selections": []}
        beta1 = cfg["optimizer"]["betas"][0]
        for s in range(REFERENCE_STEPS):
            prog["losses"].append(step(feed.next()["tokens"]))
            prog["selections"].append(torch.stack([m.last_selection for m in moe]))
            if s == 0:
                with torch.no_grad():
                    prog["grad_norms"] = {
                        k: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                        if p in opt.state else 0.0 for k, p in model.named_parameters()}
        with torch.no_grad():
            w0 = weights(seed, cfg, dev)
            prog["update_norms"] = {k: float((p - w0[k]).norm())
                                    for k, p in model.named_parameters()}
            del w0
            prog["biases"] = {moonlight_ref.bias_name(i): lp.moe.selection_bias.clone()
                              for i, lp in enumerate(model.layers) if hasattr(lp, "moe")}
        prog["losses"] = [float(v) for v in prog["losses"]]
        dropped = publish_counters(moe)["dropped"]
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
                    losses.append(step(b["tokens"]))
                if time.perf_counter() - w.started >= ctx.seconds:
                    break
            w.close()
        queue_s = stage_seconds()["queue"] - queue0
        counted = publish_counters(moe)
        dropped += counted["dropped"]
        steps = len(losses)
        rows = steps * batch
        peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        log(f"window {w.seconds:.3f} s: {steps} steps, {rows / w.seconds:.2f} rows/s; "
            f"held experts' load {counted}")
        feed.close()
        docs_by_step = [b["doc_id"].cpu().numpy().astype(np.int64)
                        for _, b in feed.delivered[:REFERENCE_STEPS]]
        delivered, finished = feed.delivered, list(feed.finished)
        del step, model, opt, feed, losses, b, moe
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t = time.perf_counter()
    rows_bad = check_rows(tokens, delivered, finished)
    del delivered
    ref = moonlight_ref.train(weights(seed, cfg, dev), start,
                              reference_batches(tokens, docs_by_step, dev), cfg, cfg["optimizer"])
    read = readings(cfg, prog, ref, start)
    log(f"reference {time.perf_counter() - t:.2f} s; its losses {ref['losses']}")
    lim = cfg["limits"]
    checks = {"rows_wrong": (float(rows_bad), 0.0)}
    checks.update({k: (v, float(lim[k])) for k, v in read.items()})
    checks["dropped"] = (float(dropped), float(lim["dropped"]))
    return {"e2e": {"train_rows_per_s": window_rate(rows, w.started, w.ended),
                    "setup_s": setup_s},
            "window_s": w.seconds, "trace": w.trace, "attempted": steps, "failed": failed,
            "memory_peak_bytes": peak, "checks": checks,
            "counters": {"model_flops": moonlight_step_flops(cfg, rows=batch)["total"] * steps,
                         "held_expert_flops": held_expert_flops(
                             cfg, slots=counted["routed_slots"], passes=3),
                         "queue_s": queue_s, "steps": steps, **counted}}


def reference_batches(tokens, docs_by_step, device) -> list:
    return [torch.from_numpy(tokens[doc]).to(device) for doc in docs_by_step]


def control(ctx) -> list:
    """For each seed of ``ctx.seeds``, at the cell's own size: the numbers of
    the control (the reference one step below each stated precision) against
    the float32 reference on three batches of the table; and, on the first
    seed, those of a sound run and of each fault planted in the program, a
    short window each."""
    cfg, dev = ctx.config, ctx.device
    out = []
    for n, seed in enumerate(ctx.seeds):
        base, up_ids, up_tok = inputs.token_docs(seed, cfg["table"], cfg["vocab_size"],
                                                 cfg["seq_len"])
        tokens = inputs.merged_docs(base, up_ids, up_tok)
        b = cfg["batch_size"]
        batches = reference_batches(tokens, [np.arange(i * b, (i + 1) * b)
                                             for i in range(REFERENCE_STEPS)], dev)
        w = weights(seed, cfg, dev)
        start = start_biases(cfg, tokens, w, dev)
        ref = moonlight_ref.train(w, start, batches, cfg, cfg["optimizer"])
        low = moonlight_ref.train(w, start, batches, cfg, cfg["optimizer"], precision="control")
        out.append({"seed": seed, "variant": "control", **readings(cfg, low, ref, start)})
        del w, batches, ref, low
        gc.collect()
        if n:
            continue
        for name, faults in (("sound", set()), ("unchanged", {"unchanged"}),
                             ("half_batch", {"half_batch"}), ("token", {"token"}),
                             ("bias", {"bias"})):
            c = SimpleNamespace(**{**vars(ctx), "seed": seed, "t0": time.perf_counter(),
                                   "faults": faults})
            r = run(c)
            out.append({"seed": seed, "variant": name, "failed": r["failed"],
                        **{k: v for k, (v, _) in r["checks"].items()}})
    return out
