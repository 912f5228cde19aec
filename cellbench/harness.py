"""The benchmark's yardstick: finding a cell by name, the clocks, the trace
reduction, the import check and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix, whose ``kind`` names the loop in
  ``drivers/<kind>.py``;
- ``metrics/<metric>.py``: one reader, ``read(run) -> float | None``.

So a later change adds a cell, a mix or a metric by adding files and
entries, and never edits a file that is here.  This module imports neither
torch nor the program, so the CPU tests can load it alone.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# top-level module names that no process of the benchmark may hold: the JAX
# package beside the port, and JAX itself.  Compared whole: the port's own
# name, lakesoul_tpu_torch, begins with lakesoul_tpu.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "lakesoul_tpu"})
PROGRAM_PACKAGE = "lakesoul_tpu_torch"


# ---------------------------------------------------------------- clocks
def process_start_perf() -> float:
    """``time.perf_counter()``'s reading at the moment this process started:
    its age from ``/proc/self/stat`` (in clock ticks since boot) against
    ``/proc/uptime``.  Where those cannot be read, now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def window_rate(units: float, started: float, ended: float) -> float:
    """Work done over the WHOLE window, from its start to the moment the
    last unit completed (after the device has synchronised)."""
    if ended <= started:
        raise ValueError("empty window")
    return units / (ended - started)


# ---------------------------------------------------------- the manifest
def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def resolve_cell(manifest: dict, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """A cell by its name: its entry, its configuration's entry and file,
    its traffic file, its driver's path, and the metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf_entry = configs[cell["config"]]
    config = load_json(root_path(bench_dir, conf_entry["file"]))
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    driver = bench_dir / "drivers" / f"{traffic['kind']}.py"
    if not driver.is_file():
        raise FileNotFoundError(f"traffic {cell['traffic']!r} names kind {traffic['kind']!r}, "
                                f"but {driver} does not exist")

    def in_cell(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if in_cell(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"cell": cell, "config_entry": conf_entry, "config": config, "traffic": traffic,
            "driver": driver, "end_to_end": e2e, "per_layer": layer}


def root_path(bench_dir: Path, rel: str) -> Path:
    """A path of ``BENCHMARK.json`` (relative to the checkout's root) under
    the checkout that holds ``bench_dir``."""
    return Path(bench_dir).resolve().parent / rel


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """A module from its file, by path: drivers and metric readers carry dots
    in their names and live outside any package."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        name or f"cellbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR):
    return load_module(Path(bench_dir) / "metrics" / f"{metric}.py").read


# ------------------------------------------------------- the import check
def forbidden_loaded(modules=None) -> list[str]:
    """The top-level names among ``modules`` (default ``sys.modules``) that
    are JAX or the JAX package, each compared WHOLE: ``lakesoul_tpu_torch``
    is the port, ``lakesoul_tpu`` is not."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN_MODULES)


# ------------------------------------------------------------ cache dirs
def pin_cache_dirs(root: Path = ROOT) -> None:
    """Keep every build and kernel cache the program could use inside the
    checkout, at fixed paths, so only a cell's first run there builds.  The
    port builds its CUDA kernels and its native library into its own
    ``lakesoul_tpu_torch/_build/``, which is inside the checkout already."""
    cache = Path(root) / ".cellbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# --------------------------------------------------------- trace reading
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "cellbench.window"
SPAN_PREFIX = "cellbench."
TOP = 10


def merge_intervals(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list) -> dict:
    """What the benchmark reads from a chrome trace of ``torch.profiler``
    over one window: the window (the ``cellbench.window`` span), the union of
    the device's operations inside it, each kernel's device time, the top
    operations, and the idle gaps summed by what the launching thread was
    doing when each began: the innermost ``cellbench.*`` span and the
    innermost operator there.  Times in seconds."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no cellbench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s, t = max(s, w0), min(s + d, w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) / 1e6
    busy = merge_intervals(dev)
    busy_s = sum(e - s for s, e in busy) / 1e6

    # the thread that launches most of the device's work
    launches: dict = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "aunch" in e.get("name", ""):
            launches[e.get("tid")] = launches.get(e.get("tid"), 0) + 1
    tid = max(launches, key=launches.get) if launches else win[0].get("tid")

    def span_list(on_tid):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                      for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and e["name"] != WINDOW_SPAN and e["name"].startswith(SPAN_PREFIX)
                      and (on_tid is None or e.get("tid") == on_tid))

    # the launching thread's own span first; where it has none (autograd's
    # backward launches from a thread of its own), the benchmark's span on
    # any thread
    spans, any_spans = span_list(tid), span_list(None)
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("tid") == tid
                  and e.get("cat") == "cpu_op"))

    span_starts, op_starts = [s for s, _, _ in spans], [s for s, _, _ in ops]
    any_starts = [s for s, _, _ in any_spans]

    def innermost(iv, starts, t, walk=4096):
        # the latest-starting interval that covers t: walk back from the
        # last one that starts by t (bounded: an old enclosing one is rare)
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - walk, -1), -1):
            if iv[j][1] >= t:
                return iv[j][2]
        return None

    def outermost(iv, starts, t, walk=4096):
        # across threads the longest interval that covers t
        i = bisect.bisect_right(starts, t) - 1
        found = None
        for j in range(i, max(i - walk, -1), -1):
            if iv[j][1] >= t:
                found = iv[j][2]
        return found

    gaps: dict[str, float] = {}
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e - s <= 0:
            continue
        span = innermost(spans, span_starts, s) or outermost(any_spans, any_starts, s)
        label = (f"{span or 'no cellbench span'} / "
                 f"{innermost(ops, op_starts, s) or 'python'}")
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s, "kernel_s": by_name,
            "device_ops": [[n[:120], v] for n, v in top_ops],
            "idle_gaps": [[n[:160], v] for n, v in top_gaps]}


def read_trace_file(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


# ---------------------------------------------------------------- output
def finite(x) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"a reading is not finite: {x}")
    return x


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The run's last line: the keys a check reads, and the numbers compared,
    each beside its limit, under ``checks``, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}"
            for k, (v, lim) in checks.items()]


def log(msg: str) -> None:
    print(f"[cellbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
