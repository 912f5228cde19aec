"""The port's kernel register: one command re-validates every hand kernel
on the card (the port of ``lakesoul_tpu/tensorplane/smoke.py``'s Pallas
cases, under the reference's case names).

- a **register** of :class:`SmokeCase`\\ s, one for each Pallas kernel of the
  reference.  Each names the reference kernel it ports, by the qname that
  ``lakesoul_tpu.tensorplane.smoke.enumerate_pallas_kernels()`` returns,
  and the port's :class:`KernelPort`\\ s: the wrapper, its plain PyTorch
  version, the wrapper whose ``launches`` counts its launches, and the
  ``extern "C"`` entry point in ``csrc/`` it launches;
- :data:`REFERENCE_KERNELS` — the reference's kernels as a static list
  (the port never imports the reference).  A test holds it against the
  ``pl.pallas_call`` sites that the port's device index enumerates from
  the reference's text (``analysis/rules/device.py``
  ``enumerate_pallas_kernels``), and ``run_smoke`` reports any kernel of
  it that no case covers (``uncovered``);
- :func:`run_smoke` — on the card (``device=None``), each case launches its
  kernels on seeded inputs (the reference's case inputs) and holds them
  against their plain versions on the same inputs: ``pass``, or ``fail``
  with the error.  On the CPU (only when asked, ``device="cpu"``) every
  wrapper takes its plain version, so a case can show only that the plain
  path runs: its status is ``cpu_plain``, never ``pass``.
"""

from __future__ import annotations

import importlib
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from lakesoul_tpu_torch.device import resolve_device

REFERENCE_KERNELS = (
    "lakesoul_tpu/annplane/ragged.py::_ragged_score_kernel",
    "lakesoul_tpu/vector/kernels.py::_bruteforce_kernel",
    "lakesoul_tpu/vector/kernels.py::_packed_dot_batch_kernel",
    "lakesoul_tpu/vector/kernels.py::_packed_dot_kernel",
    "lakesoul_tpu/vector/kernels.py::_packed_scan_kernel",
)

RTOL = ATOL = 2e-4  # the reference's case tolerance (float32 sums in another order)

_K = "lakesoul_tpu_torch.vector.kernels"
_R = "lakesoul_tpu_torch.annplane.ragged"


@dataclass(frozen=True)
class KernelPort:
    """One hand kernel of the port: ``"module:name"`` references."""

    wrapper: str
    plain: str
    counter: str  # the wrapper whose ``launches`` attribute counts this kernel
    entry_point: str  # the extern "C" launcher in ``source``
    source: str


@dataclass(frozen=True)
class SmokeCase:
    """One on-card claim: ``run(device)`` raises on any divergence and
    returns a detail dict for the record.  ``kernels`` are the reference
    kernels it ports; ``ports`` the port's kernels it launches."""

    name: str
    kind: str
    run: Callable[[torch.device], dict]
    kernels: tuple[str, ...]
    ports: tuple[KernelPort, ...]


def resolve(ref: str):
    """``"module:name"`` → the object."""
    module, _, name = ref.partition(":")
    return getattr(importlib.import_module(module), name)


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


def _packed_inputs(n: int = 600, d: int = 64, seed: int = 0):
    rng = _rng(seed)
    codes = rng.integers(0, 256, (n, d // 8)).astype(np.uint8)
    norms = rng.random(n).astype(np.float32) + 0.1
    factors = rng.random(n).astype(np.float32) + 0.5
    q_rot = rng.normal(size=d).astype(np.float32)
    return codes, norms, factors, q_rot


def _estimate_tables(rng, n: int, per_cluster: tuple, nlist: int = 4):
    """Per-row ``code_dot_c`` and cluster ids, and per-cluster (per query)
    probe mask, csq and csum: the estimate modes' extra inputs."""
    code_dot_c = rng.normal(size=n).astype(np.float32)
    cluster_id = rng.integers(0, nlist, n).astype(np.int64)
    probe = rng.random((nlist, *per_cluster)) < 0.6
    csq = rng.random((nlist, *per_cluster)).astype(np.float32)
    csum = rng.normal(size=(nlist, *per_cluster)).astype(np.float32)
    return code_dot_c, cluster_id, probe, csq, csum


def _hold(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu().numpy(), want.cpu().numpy()  # lakelint: ignore[replay-host-roundtrip] verification readback: the kernel's result held against its plain version on the host
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    fin = np.isfinite(want)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _run_packed_scan(dev) -> dict:
    from lakesoul_tpu_torch.vector import kernels as K

    codes, norms, factors, q_rot = _on(dev, *_packed_inputs())
    d = q_rot.shape[0]
    err = _hold(K.packed_scan(codes, norms, factors, q_rot, d=d),
                K.packed_scan_torch(codes, norms, factors, q_rot, d=d))
    return {"rows": len(codes), "d": d, "max_abs_err": err}


def _run_packed_dot(dev) -> dict:
    from lakesoul_tpu_torch.vector import kernels as K

    codes_np, norms_np, factors_np, q_np = _packed_inputs(seed=1)
    codes, norms, factors, q = _on(dev, codes_np, norms_np, factors_np, q_np)
    err = _hold(K.packed_dot(codes, q), K.packed_dot_torch(codes, q))
    tables = _on(dev, *_estimate_tables(_rng(11), len(codes_np), ()))
    args = (codes, q, norms, factors, *tables)
    err_est = _hold(K.packed_estimate(*args, d=q.shape[0]),
                    K.packed_estimate_torch(*args, d=q.shape[0]))
    return {"rows": len(codes), "max_abs_err": max(err, err_est)}


def _run_packed_dot_batch(dev) -> dict:
    from lakesoul_tpu_torch.vector import kernels as K

    codes_np, norms_np, factors_np, _ = _packed_inputs(seed=2)
    d = codes_np.shape[1] * 8
    queries_np = _rng(3).normal(size=(4, d)).astype(np.float32)
    codes, norms, factors, queries = _on(dev, codes_np, norms_np, factors_np, queries_np)
    err = _hold(K.packed_dot_batch(codes, queries), K.packed_dot_batch_torch(codes, queries))
    tables = _on(dev, *_estimate_tables(_rng(12), len(codes_np), (len(queries_np),)))
    args = (codes, queries, norms, factors, *tables)
    err_est = _hold(K.packed_estimate_batch(*args, d=d), K.packed_estimate_batch_torch(*args, d=d))
    return {"rows": len(codes), "queries": len(queries), "max_abs_err": max(err, err_est)}


def _run_bruteforce(dev) -> dict:
    from lakesoul_tpu_torch.vector import kernels as K

    rng = _rng(4)
    vectors, query = _on(dev, rng.normal(size=(700, 32)).astype(np.float32),
                         rng.normal(size=32).astype(np.float32))
    err = _hold(K.bruteforce_distances(vectors, query),
                K.bruteforce_distances_torch(vectors, query))
    return {"rows": 700, "max_abs_err": err}


def _run_ragged(dev) -> dict:
    from lakesoul_tpu_torch.annplane.ragged import TILE, ragged_score, ragged_score_torch

    rng = _rng(5)
    d, ntiles, nq = 32, 3, 2
    codes = rng.normal(size=(ntiles * TILE, d)).astype(np.float32)
    a = rng.random(ntiles * TILE).astype(np.float32)
    b = rng.random(ntiles * TILE).astype(np.float32)
    h = rng.random(ntiles * TILE).astype(np.float32)
    q_glob = rng.normal(size=(nq, d)).astype(np.float32)
    item_q = np.array([0, 0, 1, 1, 1], np.int32)
    item_tile = np.array([0, 2, 0, 1, 2], np.int32)
    csq = rng.random(len(item_q)).astype(np.float32)
    csum = rng.random(len(item_q)).astype(np.float32)
    on_dev = _on(dev, q_glob, codes, a, b, h)
    got = ragged_score(item_q, item_tile, csq, csum, *on_dev)
    want = ragged_score_torch(*_on(dev, item_q, item_tile, csq, csum), *on_dev)
    return {"items": len(item_q), "tile": TILE, "max_abs_err": _hold(got, want)}


def _port(wrapper: str, plain: str, entry_point: str, source: str, counter: str = "",
          module: str = _K) -> KernelPort:
    return KernelPort(f"{module}:{wrapper}", f"{module}:{plain}",
                      f"{module}:{counter or wrapper}", entry_point,
                      f"lakesoul_tpu_torch/csrc/{source}")


def smoke_cases() -> list[SmokeCase]:
    return [
        SmokeCase(
            "vector.packed_scan", "kernel", _run_packed_scan,
            kernels=("lakesoul_tpu/vector/kernels.py::_packed_scan_kernel",),
            ports=(_port("packed_scan", "packed_scan_torch", "ls_packed_scan",
                         "packed_dot.cu"),),
        ),
        SmokeCase(
            "vector.packed_dot", "kernel", _run_packed_dot,
            kernels=("lakesoul_tpu/vector/kernels.py::_packed_dot_kernel",),
            ports=(_port("packed_dot", "packed_dot_torch", "ls_packed_dot", "packed_dot.cu"),
                   _port("packed_estimate", "packed_estimate_torch", "ls_packed_estimate",
                         "packed_dot.cu", counter="packed_dot")),
        ),
        SmokeCase(
            "vector.packed_dot_batch", "kernel", _run_packed_dot_batch,
            kernels=("lakesoul_tpu/vector/kernels.py::_packed_dot_batch_kernel",),
            ports=(_port("packed_dot_batch", "packed_dot_batch_torch", "ls_packed_dot_batch",
                         "packed_dot.cu"),
                   _port("packed_estimate_batch", "packed_estimate_batch_torch",
                         "ls_packed_estimate_batch", "packed_dot.cu",
                         counter="packed_dot_batch")),
        ),
        SmokeCase(
            "vector.bruteforce", "kernel", _run_bruteforce,
            kernels=("lakesoul_tpu/vector/kernels.py::_bruteforce_kernel",),
            ports=(_port("bruteforce_distances", "bruteforce_distances_torch",
                         "ls_bruteforce_distances", "bruteforce.cu"),),
        ),
        SmokeCase(
            "annplane.ragged_score", "kernel", _run_ragged,
            kernels=("lakesoul_tpu/annplane/ragged.py::_ragged_score_kernel",),
            ports=(_port("ragged_score", "ragged_score_torch", "ls_ragged_score",
                         "ragged_score.cu", module=_R),),
        ),
    ]


def run_smoke(*, device=None) -> dict:
    """Run the register and return the report.  ``device=None`` is the
    card (raises without one); ``"cpu"`` runs the plain versions only.

    On the card a case passes only if its kernels agree with their plain
    versions and every counter it names grew (each launch counted).
    ``report["ok"]`` is False when a case failed or a reference kernel is
    not covered; on the CPU ``untested_on_card`` names every case."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cases = smoke_cases()
    results = []
    failed = False
    for case in cases:
        entry = {"name": case.name, "kind": case.kind, "kernels": list(case.kernels),
                 "entry_points": [p.entry_point for p in case.ports]}
        counters = {p.counter: resolve(p.counter) for p in case.ports}
        need = Counter(p.counter for p in case.ports)  # one launch per entry point at least
        before = {name: w.launches for name, w in counters.items()}
        t0 = time.perf_counter()
        try:
            detail = case.run(dev)
            launched = {name: w.launches - before[name] for name, w in counters.items()}
            if on_card and any(launched[name] < n for name, n in need.items()):
                raise AssertionError(f"a kernel was not launched: {launched}")
            entry["status"] = "pass" if on_card else "cpu_plain"
            entry["detail"] = {**detail, "launches": launched}
        except Exception as e:  # record, keep going: one bad kernel must not hide the rest
            entry["status"] = "fail"
            entry["error"] = f"{type(e).__name__}: {e}"
            failed = True
        entry["seconds"] = time.perf_counter() - t0
        results.append(entry)

    covered = sorted({k for c in cases for k in c.kernels})
    uncovered = sorted(set(REFERENCE_KERNELS) - set(covered))
    return {
        "device": str(dev),
        "on_card": on_card,
        "cases": results,
        "kernel_enumeration": {"enumerated": list(REFERENCE_KERNELS), "covered": covered,
                               "uncovered": uncovered},
        "untested_on_card": [e["name"] for e in results] if not on_card else [],
        "ok": not failed and not uncovered,
    }
