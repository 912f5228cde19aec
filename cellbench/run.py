"""One run of one cell of the port's benchmark:

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell, its configuration and its
traffic by name (``BENCHMARK.json``, ``configs/``, ``traffic/``), runs the
traffic's loop (``drivers/<kind>.py``) over ``lakesoul_tpu_torch`` on the
card, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, each read by ``metrics/<name>.py``),
``device`` and, with ``--trace 1``, ``breakdown``; last in it ``checks``,
each number the correctness check compared beside its limit.  The same
checks are the last lines of standard error.

Without a card, or with fewer than the cell asks for, it prints no result
and exits 2.  If JAX or the JAX package is loaded when the window has
closed, it prints no result and exits 3.

One more use, for setting the cell up and never run by a check:
``--control`` runs the cell's control in the program's place on each seed
of a comma-separated ``--seed`` and prints its readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

# the benchmark's modules, and the checkout's root, where the program is
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parent.parent)]

import harness  # noqa: E402

T0 = harness.process_start_perf()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    harness.pin_cache_dirs()
    spec = harness.resolve_cell(harness.load_manifest(), args.workload)
    chips = int(spec["cell"]["chips"])

    import lakesoul_tpu_torch  # noqa: F401  the system under test: without it, no run
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"no result: the cell needs {chips} CUDA device(s), this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import tracing

    driver = harness.load_module(spec["driver"])
    seeds = [int(s) for s in str(args.seed).split(",")]
    ctx = SimpleNamespace(seed=seeds[0], seeds=seeds, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", config=spec["config"],
                          traffic=spec["traffic"], cell=spec["cell"], t0=T0,
                          spans=tracing.Spans(bool(args.trace)))
    if args.control:
        for row in driver.control(ctx):
            print(json.dumps({"control": args.workload, **row}), flush=True)
        return 0
    if len(seeds) != 1:
        raise SystemExit("--seed takes one seed outside --control")

    run = driver.run(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    bad = harness.forbidden_loaded()
    if bad:
        harness.log(f"no result: JAX or the JAX package is loaded in this process: {bad}")
        return 3
    correct, line, checks = report(spec, run, bool(args.trace), device)
    for c in checks:
        print(c, file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def report(spec: dict, run: dict, trace: bool, device: dict) -> tuple[bool, str, list]:
    """The rest of a run after its driver: the cell's metrics read (its
    end-to-end ones, or with ``trace`` its per-layer ones by their readers),
    ``correct`` from the checks, and the result line."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = harness.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": harness.finite(v), "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": harness.finite(run["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    device = {**device, "memory_peak_bytes": int(run["memory_peak_bytes"])}
    breakdown = None
    if trace:
        tr = run["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    checks = {"failed": (float(run["failed"]), 0.0), **run["checks"]}
    correct = all(v <= lim for v, lim in checks.values())
    line = harness.result_line(correct=correct, attempted=run["attempted"], failed=run["failed"],
                               metrics=metrics, device=device, checks=checks,
                               breakdown=breakdown)
    return correct, line, harness.check_lines(checks)


if __name__ == "__main__":
    sys.exit(main())
