"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes``.  Nothing here
includes PyTorch's headers, so a build takes seconds, not minutes.

The build runs at first use, from the sources in ``csrc/`` only, into
``lakesoul_tpu_torch/_build/`` (listed in ``.gitignore``).  A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.  :func:`build` starts one ``nvcc`` per
source, all together, and waits for them all.

Every library exports ``ls_cuda_error_string`` (``csrc/ls_common.cuh``).
:func:`entry` binds one C entry point once (argument types, the error
string) and returns its launcher, which calls it on the current stream and
raises on the ``cudaError_t`` it returns.  The launcher is the per-launch
host path of every kernel wrapper, so it does as little as it can: it
enters the device's context only when that device is not the current one.

Nothing CUDA-specific happens at import time: the CPU tests import this
module and never call it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch

from lakesoul_tpu_torch.errors import ConfigError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("packed_dot", "ragged_score", "bruteforce")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise ConfigError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of the source, the
    shared headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns ``{name: {"seconds", "log"}}`` with
    the compiler's register / shared-memory report; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)  # lakelint: ignore[raw-process] one-shot nvcc invocation per kernel source, joined by communicate() below; not a managed service process
        running[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if needed.  Callers
    cache what this returns; the lock keeps two threads from building the
    same source at once."""
    with _lock:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
    lib.ls_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ls_cuda_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``, from
    PyTorch's own binding (the one its compiled kernels launch with),
    without building a ``torch.cuda.Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def entry(lib: ctypes.CDLL, name: str, argtypes) -> Callable[..., None]:
    """Bind ``lib.name`` once, taking ``argtypes`` then the stream and
    returning a ``cudaError_t``, and return its launcher
    ``launch(device, *args)``: the call on ``device``'s current stream,
    raising if the launch was refused."""
    fn = getattr(lib, name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(device: torch.device, *args) -> None:
        current = torch.cuda.current_device()
        if device.index is None or device.index == current:
            err = fn(*args, current_stream(current))
        else:
            with torch.cuda.device(device):
                err = fn(*args, current_stream(device.index))
        if err:
            raise RuntimeError(f"{name} launch failed: {lib.ls_cuda_error_string(err).decode()}")

    return launch
