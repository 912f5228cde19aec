#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``lakesoul_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Drives the port's IVF-RaBitQ ANN serving path on the card and fails if any
phase fails.  Each phase prints one JSON line with its own timing:

1. device  — requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build   — builds every kernel from ``lakesoul_tpu_torch/csrc/`` with nvcc.
3. kernels — holds each kernel against its plain PyTorch version at the
             serving shapes and at ragged edges, every query tile of the
             batch kernel included (rtol 1e-5, atol 1e-4: float32 sums
             taken in another order), and times kernel, plain version, a
             torch.matmul yardstick and the card's bound at batch_search's
             256 queries and the endpoint's 16, and each query tile
             against the others.
4. slice   — builds a 1,000,000 x 512 index (nlist 1024, 1-bit, fht,
             raw vectors kept) from a seeded, L2-normalized mixture of 1024
             gaussians, then batch_search, single search and an AnnEndpoint
             under 16 client threads; recall@10 against an exact oracle on
             the card; the kernel path held against the plain path on the
             CPU; both kernels' launch counts on the main path.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
N_VECTORS, DIM, NLIST = 1_000_000, 512, 1024
N_QUERIES, N_ORACLE, N_HOLD = 1024, 256, 32
RTOL, ATOL = 1e-5, 1e-4
RECALL_FLOOR = 0.5  # the reference's own bar at full probe (tests/test_e2e_glove.py:182)
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 FLOP/s off the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12
KERNEL_SOURCE = "lakesoul_tpu_torch/csrc/packed_dot.cu"
LIBRARY_CALL = "torch.matmul over pre-unpacked f32 bits (yardstick, not used by the port)"
BATCH_CASES = (1, 8, 13, 16, 17, 32, 33, 256)  # packed_dot_batch's nq: every tile, full and ragged
TILE_SWEEP = (8, 16, 32, 256)  # nq at which every query tile is timed


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card for the work (ms) and what bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want) -> float:
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite kernel output")
    require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
            f"kernel disagrees with its plain version (max abs err {(got - want).abs().max().item()})")
    return (got - want).abs().max().item() if got.numel() else 0.0


def phase_kernels(torch, K) -> dict:
    """Each kernel against its plain version; timings at the serving shapes."""
    t0 = time.perf_counter()
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"packed_dot_batch": 0.0, "packed_dot": 0.0}
    cases = 0
    for n in (1_048_576, 1000):
        for d in (512, 100):
            d8 = (d + 7) // 8
            codes = torch.randint(0, 256, (n, d8), dtype=torch.uint8, device=dev, generator=g)
            # queries scaled like the rotated unit-norm queries of the slice;
            # every query tile of the batch kernel, full and ragged
            for nq in BATCH_CASES:
                q = torch.randn(nq, d, device=dev, generator=g) / d**0.5
                e = max_err(torch, K.packed_dot_batch(codes, q), K.packed_dot_batch_torch(codes, q))
                errs["packed_dot_batch"] = max(errs["packed_dot_batch"], e)
                cases += 1
            q1 = torch.randn(d, device=dev, generator=g) / d**0.5
            e = max_err(torch, K.packed_dot(codes, q1), K.packed_dot_torch(codes, q1))
            errs["packed_dot"] = max(errs["packed_dot"], e)
            cases += 1

    # timings at the shapes the serving path gives the kernels: the resident
    # bundle of 1M rows pads to 1,048,576; batch_search runs chunks of 256
    # queries, the endpoint's batches of ~15 pad to 16
    n, d = 1_048_576, DIM
    d8 = d // 8
    codes = torch.randint(0, 256, (n, d8), dtype=torch.uint8, device=dev, generator=g)
    q = torch.randn(256, d, device=dev, generator=g) / d**0.5
    bits = K.unpack_bits(codes, d)

    def batch_timing(nq: int) -> dict:
        qn = q[:nq].contiguous()
        b_ms, b_by = bound(n * d8 + nq * d * 4 + n * nq * 4, 2.0 * n * d * nq)
        return {
            "ms": time_ms(torch, lambda: K.packed_dot_batch(codes, qn), 20),
            "plain_ms": time_ms(torch, lambda: K.packed_dot_batch_torch(codes, qn), 20),
            "library_ms": time_ms(torch, lambda: torch.matmul(bits, qn.T), 20),
            "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d8, nq, d],
        }

    rec = {"packed_dot_batch": {**batch_timing(256), "endpoint_nq16": batch_timing(16)}}
    b_ms, b_by = bound(n * d8 + d * 4 + n * 4, 2.0 * n * d)
    rec["packed_dot"] = {
        "ms": time_ms(torch, lambda: K.packed_dot(codes, q[0]), 200),
        "plain_ms": time_ms(torch, lambda: K.packed_dot_torch(codes, q[0]), 20),
        "library_ms": time_ms(torch, lambda: torch.matmul(bits, q[0]), 100),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d8, d],
    }
    del bits

    # every query tile of the batch kernel at the batch sizes around the
    # choice, each held against the plain version, then timed
    tiles = {}
    for nq in TILE_SWEEP:
        qn = q[:nq].contiguous()
        want = K.packed_dot_batch_torch(codes, qn)
        row = {"picked": K.pick_query_group(nq)}
        for qg in K.QUERY_GROUPS:
            e = max_err(torch, K.packed_dot_batch(codes, qn, query_group=qg), want)
            errs["packed_dot_batch"] = max(errs["packed_dot_batch"], e)
            cases += 1
            row[f"qg{qg}_ms"] = time_ms(torch, lambda: K.packed_dot_batch(codes, qn, query_group=qg), 20)
        tiles[f"nq{nq}"] = row
        del want
    emit("kernels", seconds=time.perf_counter() - t0, cases=cases, max_abs_err=errs,
         timings=rec, batch_tiles=tiles, library_call=LIBRARY_CALL)
    return {"errs": errs, "timings": rec}


def make_data(torch, dev):
    """Seeded mixture of NLIST gaussians on the unit sphere, L2-normalized
    like CLIP embeddings; queries are fresh draws of the same mixture."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    fn = torch.nn.functional.normalize
    centers = fn(torch.randn(NLIST, DIM, device=dev, generator=g), dim=1)
    sigma = 0.75 / DIM**0.5  # noise norm 0.75 around each unit center

    def draw(m):
        comp = torch.randint(0, NLIST, (m,), device=dev, generator=g)
        return fn(centers[comp] + sigma * torch.randn(m, DIM, device=dev, generator=g), dim=1)

    return draw(N_VECTORS), draw(N_QUERIES)


def profile(torch, fn) -> dict:
    """Device time of one call by kernel, from torch.profiler: where the
    time goes, and the share of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows)
    require(device_ms > 0, "the profiler saw no device time")
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c} for ms, k, c in rows[:8]],
    }


def same_topk(ids_a, d_a, ids_b, d_b) -> bool:
    """Equal ids except where distances tie within 1e-5; dists allclose at
    rtol 1e-5 with an absolute floor of 1e-5 of the list's largest distance."""
    d_a, d_b = np.asarray(d_a, np.float64), np.asarray(d_b, np.float64)
    if len(ids_a) != len(ids_b):
        return False
    atol = max(ATOL, RTOL * float(np.abs(d_a).max(initial=0.0)))
    if not np.allclose(d_b, d_a, rtol=RTOL, atol=atol):
        return False
    for i in np.flatnonzero(np.asarray(ids_a) != np.asarray(ids_b)):
        tie = np.abs(d_a - d_a[i]) <= 1e-5 * max(1.0, abs(d_a[i]))
        tie[i] = False
        if not tie.any():
            return False
    return True


def phase_slice(torch, K) -> dict:
    from lakesoul_tpu_torch.vector import AnnEndpoint, IvfRabitqIndex, SearchParams, VectorIndexConfig
    from lakesoul_tpu_torch.vector.oracle import recall_at_k

    t0 = time.perf_counter()
    dev = DEVICE
    x, queries = make_data(torch, dev)
    torch.cuda.synchronize()
    ids = np.arange(N_VECTORS, dtype=np.uint64)
    qs_np = queries.cpu().numpy()
    cfg = VectorIndexConfig("embedding", DIM, nlist=NLIST, total_bits=1, rotator="fht", seed=SEED)
    params = SearchParams(top_k=10, nprobe=32, rerank_depth=100)
    full = SearchParams(top_k=10, nprobe=NLIST, rerank_depth=100)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted: build → search → batch → serve
    K.packed_dot.launches = 0
    K.packed_dot_batch.launches = 0
    t = time.perf_counter()
    index = IvfRabitqIndex.train(x, ids, cfg, keep_raw=True)  # device=None: the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    require(index.num_vectors == N_VECTORS, "index lost vectors")
    for q in qs_np[:4]:  # the non-resident single-query path
        got, _ = index.search(q, params)
        require(len(got) == 10, "non-resident search returned fewer than 10")
    index.enable_device_cache()
    index.batch_search(qs_np[:256], params)  # warm-up: concatenates the resident bundle
    t = time.perf_counter()
    b_ids, b_d = index.batch_search(qs_np, params)
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    f_ids, f_d = index.batch_search(qs_np[:N_ORACLE], full)
    full_s = time.perf_counter() - t
    single_ms = []
    for q in qs_np[:16]:
        t = time.perf_counter()
        s_ids, s_d = index.search(q, params)
        single_ms.append((time.perf_counter() - t) * 1e3)
        require(len(s_ids) == 10, "resident search returned fewer than 10")
    served, errors = {}, []
    with AnnEndpoint(index, params, max_batch=256, max_wait_ms=5) as ep:
        def client(c):
            try:
                for i in range(c * 16, c * 16 + 16):
                    served[i] = ep.search(qs_np[i], timeout=120)
            except Exception as e:  # surfaced below: a failed client fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        serve_s = time.perf_counter() - t
        stats = ep.stats()
    launches = {"packed_dot": K.packed_dot.launches, "packed_dot_batch": K.packed_dot_batch.launches}
    # ---- end of the counted main path

    require(not errors and len(served) == 256, f"serving failed: {errors[:3]}")
    require(all(launches.values()), f"a kernel never ran on the main path: {launches}")
    for i, (ids_i, d_i) in served.items():
        require(same_topk(b_ids[i], b_d[i], ids_i, d_i), f"endpoint result {i} != batch_search")
    require(all(len(r) == 10 and np.isfinite(d).all() for r, d in zip(b_ids, b_d)),
            "batch_search returned short or non-finite results")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof_batch = profile(torch, lambda: index.batch_search(qs_np[:256], params))
    prof_single = profile(torch, lambda: index.search(qs_np[0], params))

    # exact oracle on the card: one gram matmul over N_ORACLE queries
    qo = queries[:N_ORACLE]
    d2 = (qo * qo).sum(1, keepdim=True) - 2.0 * qo @ x.T + (x * x).sum(1)[None, :]
    top = torch.topk(d2, 10, dim=1, largest=False).indices.cpu().numpy()
    del d2
    truth = [set(ids[row].tolist()) for row in top]
    recall = recall_at_k(truth, b_ids[:N_ORACLE])
    recall_full = recall_at_k(truth, f_ids)
    require(recall_full >= RECALL_FLOOR, f"recall@10 at nprobe=nlist {recall_full} < {RECALL_FLOOR}")

    # each kernel on the main path's own inputs against its plain version
    bundle = index._get_device_bundle()
    q_glob = index.quantizer.rotate(queries[:256]).contiguous()
    q_ep = q_glob[:16].contiguous()  # the endpoint's padded batch
    errs = {
        "packed_dot_batch": max(
            max_err(torch, K.packed_dot_batch(bundle["codes"], q_glob),
                    K.packed_dot_batch_torch(bundle["codes"], q_glob)),
            max_err(torch, K.packed_dot_batch(bundle["codes"], q_ep),
                    K.packed_dot_batch_torch(bundle["codes"], q_ep)),
        ),
        "packed_dot": max_err(torch, K.packed_dot(bundle["codes"], q_glob[0]),
                              K.packed_dot_torch(bundle["codes"], q_glob[0])),
    }

    # the kernel path against the plain path: the same index on the CPU
    t = time.perf_counter()
    cpu_index = IvfRabitqIndex.from_state(index.state(), device="cpu")
    cpu_index.enable_device_cache()
    c_ids, c_d = cpu_index.batch_search(qs_np[:N_HOLD], params)
    g_ids, g_d = index.batch_search(qs_np[:N_HOLD], params)
    held = sum(same_topk(c_ids[i], c_d[i], g_ids[i], g_d[i]) for i in range(N_HOLD))
    hold_s = time.perf_counter() - t
    require(held == N_HOLD, f"kernel path != plain path on {N_HOLD - held} of {N_HOLD} queries")

    emit(
        "slice", seconds=time.perf_counter() - t0, vectors=N_VECTORS, dim=DIM, nlist=NLIST,
        build_s=build_s, batch_qps=N_QUERIES / batch_s, batch_s=batch_s,
        batch_qps_full_probe=N_ORACLE / full_s,
        single_search_ms_p50=float(np.median(single_ms)), single_search_ms=single_ms,
        serving_qps=256 / serve_s, serving_p50_s=stats["latency_p50"],
        serving_p99_s=stats["latency_p99"], serving_mean_batch=stats["mean_batch"],
        serving_batches=stats["batches"], recall_at_10_nprobe32=recall,
        recall_at_10_full_probe=recall_full, peak_device_gb=peak_gb,
        launches=launches, main_path_max_abs_err=errs, plain_path_held=f"{held}/{N_HOLD}",
        plain_path_s=hold_s, profile_batch_256=prof_batch, profile_single=prof_single,
    )
    return {"launches": launches, "errs": errs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lakesoul_tpu_torch import _build
    from lakesoul_tpu_torch.vector import kernels as K

    # 1. device: full float32 in every matmul, stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, allow_tf32_matmul=False,
         allow_tf32_cudnn=False)

    # 2. build every kernel from csrc/
    t = time.perf_counter()
    report = _build.build()
    ptxas = [ln.strip() for r in report.values() for ln in r["log"].splitlines() if "Used" in ln]
    emit("build", seconds=time.perf_counter() - t, sources=list(_build.SOURCES),
         built=sorted(report), ptxas=ptxas)

    kernels = phase_kernels(torch, K)
    sl = phase_slice(torch, K)

    names = {"packed_dot_batch": "lakesoul_tpu/vector/kernels.py:158",
             "packed_dot": "lakesoul_tpu/vector/kernels.py:147"}
    record = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": sl["launches"][name],
            "max_abs_err": max(kernels["errs"][name], sl["errs"][name]),
            **kernels["timings"][name],  # ms, plain_ms, bound_ms, bound_by, library_ms, shape
            "library_call": LIBRARY_CALL,
        }
        for name, replaces in names.items()
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
