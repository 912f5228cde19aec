"""Run a function on ``n`` gloo ranks on the CPU, each a process of its own.

``run_ranks("pkg.module:fn", n, args)`` starts ``n`` interpreters, each of
which joins one process group through a ``FileStore`` in a fresh temporary
directory (no TCP port: several such runs may go at once), calls
``fn(*args)`` with ``torch.set_num_threads(1)`` and writes its return value
back; → the ranks' return values in rank order.  A rank that fails, or a
run past its deadline, kills every rank and raises with the error output
of every rank that failed (or, past the deadline, of every rank: each one
still running at 85 % of the deadline printed its threads' stacks): a hung
collective fails its caller, it does not wait forever.

``fn`` runs in the child with the default process group started; it builds
its mesh with ``parallel.mesh.make_mesh(device_type="cpu")``.  Arguments
and results travel as ``torch.save`` files this run wrote.

    python -m lakesoul_tpu_torch.parallel.launch RUN_DIR RANK   # one rank
"""

from __future__ import annotations

import datetime
import faulthandler
import importlib
import os
import subprocess
import sys
import tempfile
import time

import torch

INIT_TIMEOUT_S = 60  # init_process_group(timeout=): a collective waits no longer
DEADLINE_S = 240  # the whole run, spawn included
DUMP_AT = 0.85  # share of the deadline at which a rank still running dumps its stacks
GRACE_S = 5.0  # after a rank fails, how long the others may take to exit


def run_ranks(target: str, n: int, args: tuple = (), *, deadline_s: float = DEADLINE_S,
              sys_path: tuple[str, ...] = ()) -> list:
    """``target`` ("module:function") on ``n`` gloo CPU ranks; → results."""
    with tempfile.TemporaryDirectory(prefix="lakesoul_ranks_") as run_dir:
        # a rank still running near the deadline prints where each thread is
        torch.save({"target": target, "n": n, "args": args, "sys_path": list(sys_path),
                    "dump_at": time.time() + DUMP_AT * deadline_s},
                   os.path.join(run_dir, "spec.pt"))
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join([root, *sys_path, env.get("PYTHONPATH", "")])
        logs = [open(os.path.join(run_dir, f"rank{r}.log"), "w+b") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, "-m", "lakesoul_tpu_torch.parallel.launch",  # lakelint: ignore[raw-process] gloo ranks of one run: each is killed at the deadline and reaped in the finally below
                                   run_dir, str(r)], env=env, stdout=logs[r], stderr=logs[r])
                 for r in range(n)]
        try:
            end = time.monotonic() + deadline_s
            while any(p.poll() is None for p in procs) and time.monotonic() < end:
                if any(p.poll() not in (None, 0) for p in procs):
                    # a rank failed: the others get a moment to fail on their own
                    # (the first failure's peers often die of its closed socket)
                    end = min(end, time.monotonic() + GRACE_S)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            failed = [r for r, c in enumerate(codes) if c not in (0, -9)]
            tails = []
            for r in failed or range(n):
                f = logs[r]
                f.seek(0)
                tails.append(f"--- rank {r} (exit {codes[r]}) ---\n"
                             + f.read()[-4000:].decode(errors="replace"))
            for f in logs:
                f.close()
            what = "failed" if failed else "timed out"
            raise RuntimeError(f"{target} on {n} ranks {what}: exit codes {codes}\n"
                               + "\n".join(tails))
        for f in logs:
            f.close()
        return [torch.load(os.path.join(run_dir, f"out{r}.pt"), weights_only=False)
                for r in range(n)]


def _child(run_dir: str, rank: int) -> None:
    import torch.distributed as dist

    spec = torch.load(os.path.join(run_dir, "spec.pt"), weights_only=False)
    faulthandler.dump_traceback_later(max(1.0, spec["dump_at"] - time.time()))
    sys.path[:0] = spec["sys_path"]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(run_dir, "store"), spec["n"])
    dist.init_process_group("gloo", store=store, rank=rank, world_size=spec["n"],
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        mod, _, fn = spec["target"].partition(":")
        out = getattr(importlib.import_module(mod), fn)(*spec["args"])
        torch.save(out, os.path.join(run_dir, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
