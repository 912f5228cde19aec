"""``ann_batch_closed``: one caller in a closed loop, sending batches of
fresh queries to ``AnnPlane.batch_search``, each after the last returned.

Set-up builds the plane (``plane.build``), makes a pool of query batches
on the host from the seed, and warms the path.  The window sends the pool's
batches in turn (the pool is cycled if the window outlasts it) until
``--seconds`` have passed; ``batch_search`` hands its answers back on the
host, so the window ends when the last batch has returned.  ``ann_qps`` is
every query answered over the whole window.

After it, a sample of the window's answers drawn from the seed is held
against ``reference/ann_ref.py``.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

import inputs
import plane as planes
from harness import log, window_rate
from reference import ann_ref
from tracing import Window, sync


def search_params(cfg: dict, nprobe: int):
    from lakesoul_tpu_torch.vector import SearchParams

    s = cfg["search"]
    return SearchParams(top_k=int(s["top_k"]), nprobe=int(nprobe),
                        rerank_depth=int(s["rerank_depth"]))


def planted(ctx, search):
    """Faults planted underneath the timed path (by the tests, and on the
    card to read each fault's numbers): a row of every answer altered where
    it is produced, or half of each batch left unanswered."""
    faults = getattr(ctx, "faults", ())
    if not faults:
        return search

    def broken(queries, params, **kw):
        ids, dists = search(queries, params, **kw)
        if "answer" in faults:  # the last row of every answer is its neighbour's
            ids = [np.concatenate([i[:-1], i[-1:] + 1]) if len(i) else i for i in ids]
        if "half_batch" in faults:
            n = len(ids) // 2
            ids = list(ids[:n]) + [np.zeros(0, np.uint64)] * (len(ids) - n)
            dists = list(dists[:n]) + [np.zeros(0, np.float32)] * (len(dists) - n)
        return ids, dists

    return broken


def answer_failed(ids, dists, top_k: int) -> bool:
    return len(ids) < top_k or not np.isfinite(dists).all()


def judge(ctx, state: dict, ranges, queries, nprobes, answers) -> dict:
    """The reference's readings of the build's state and of a sample of
    answers, each beside its limit.  With ``ctx.control`` the control's
    build and answers stand in the program's place."""
    cfg = ctx.config
    if getattr(ctx, "control", False):
        state = ann_ref.control_state(seed=ctx.seed, cfg=cfg, shard_ranges=ranges,
                                      row_ids=[r["ids"] for r in state["rows"]],
                                      device=ctx.device)
        answers = ann_ref.control_answers(seed=ctx.seed, cfg=cfg, shard_ranges=ranges,
                                          centroids=state["centroids"], queries=queries,
                                          nprobes=nprobes, device=ctx.device)
    read = ann_ref.check(seed=ctx.seed, cfg=cfg, shard_ranges=ranges, state=state,
                         queries=queries, nprobes=nprobes, answers=answers, device=ctx.device)
    log(f"probe_miss {read.pop('probe_miss')!r} (the share of the probed exact top-k missed), "
        f"kmeans_gap_f32 {read.pop('kmeans_gap_f32')!r} (the reference's own k-means with "
        f"float32 products against its float64 one)")
    lim = cfg["limits"]
    return {k: (float(v), float(lim[k])) for k, v in read.items()}


def sample_positions(seed: int, n: int, k: int) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(inputs.derive_seed(seed, "sample")))
    return np.sort(rng.choice(n, min(k, n), replace=False))


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    plane, ranges, centers = (getattr(ctx, "prebuilt", None)
                              or planes.build(ctx.seed, cfg, dev, faults=faults_of(ctx)))
    params = search_params(cfg, tr["nprobe"])
    B, P = int(tr["batch"]), int(tr["pool_batches"])
    pool = inputs.query_rows(ctx.seed, cfg["corpus"], centers, B * P, "batch").cpu().numpy()
    pool = [pool[i * B:(i + 1) * B] for i in range(P)]
    search = planted(ctx, plane.batch_search)
    for i in range(int(tr["warmup_batches"])):
        search(pool[i % P], params)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up {setup_s:.2f} s")

    traced = ctx.spans.wrap(search, "batch_search")
    sent, answers, returned = [], [], []
    with planes.planted(plane, faults_of(ctx)), Window(ctx.trace, dev, ctx.spans) as w:
        while True:
            k = len(sent) % P
            answers.append(traced(pool[k], params))
            sent.append(k)
            returned.append(time.perf_counter())
            if returned[-1] - w.started >= ctx.seconds:
                break
        w.close()
    n_q = len(sent) * B
    peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
    half = len(returned) // 2
    log(f"window {w.seconds:.3f} s: {len(sent)} batches, {n_q / w.seconds:.1f} queries/s; "
        f"first half {half * B / (returned[half - 1] - w.started):.1f}, second half "
        f"{(len(returned) - half) * B / (returned[-1] - returned[half - 1]):.1f}")
    state = planes.plane_state(plane, planes.sample_row_ids(ctx.seed, ranges,
                                                            int(cfg["check_rows_a_shard"])))
    top_k = int(cfg["search"]["top_k"])
    failed = sum(answer_failed(i, d, top_k) for ids, ds in answers for i, d in zip(ids, ds))
    del plane, search, traced
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    pick = sample_positions(ctx.seed, n_q, int(tr["check_sample"]))
    qs = np.stack([pool[sent[p // B]][p % B] for p in pick])
    got = [(answers[p // B][0][p % B], answers[p // B][1][p % B]) for p in pick]
    checks = judge(ctx, state, ranges, qs, np.full(len(pick), int(tr["nprobe"])), got)
    log(f"reference {time.perf_counter() - t:.2f} s")
    return {"e2e": {"ann_qps": window_rate(n_q, w.started, w.ended), "setup_s": setup_s},
            "window_s": w.seconds,
            "trace": w.trace, "attempted": n_q, "failed": int(failed),
            "memory_peak_bytes": peak, "checks": checks,
            "counters": {"window_queries": [pool[k] for k in sent],
                         "window_nprobes": [np.full(B, int(tr["nprobe"])) for _ in sent],
                         "plane": state, "dim": int(cfg["dim"]), "bits": int(cfg["total_bits"])}}


def faults_of(ctx) -> set:
    return set(getattr(ctx, "faults", ()))


# what the numbers read with the program broken, or the control in its
# place: each a short window over the same build, but for the k-means fault,
# which builds again
VARIANTS = (("sound", {}), ("control", {"control": True}), ("answer", {"faults": {"answer"}}),
            ("half_batch", {"faults": {"half_batch"}}), ("scores", {"faults": {"scores"}}),
            ("kmeans_unchanged", {"faults": {"kmeans_unchanged"}}))


def control_runs(ctx, run_fn) -> list:
    """For each seed of ``ctx.seeds``, at the cell's own size and load: the
    numbers of a sound run, of the control (the reference in the program's
    place in float32) and of each fault planted in the program."""
    out = []
    for seed in ctx.seeds:
        built = planes.build(seed, ctx.config, ctx.device)
        for name, over in VARIANTS:
            c = SimpleNamespace(**{**vars(ctx), "seed": seed, "t0": time.perf_counter(),
                                   "faults": set(), **over})
            if "kmeans_unchanged" not in c.faults:
                c.prebuilt = built
            r = run_fn(c)
            out.append({"seed": seed, "variant": name, "failed": r["failed"],
                        **{k: v for k, (v, _) in r["checks"].items()}, **r["e2e"]})
        del built
        gc.collect()
        torch.cuda.empty_cache()
    return out


def control(ctx) -> list:
    return control_runs(ctx, run)
