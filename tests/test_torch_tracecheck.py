"""tracecheck in the port (``lakesoul_tpu_torch/analysis/tracecheck.py``),
case for case the reference's ``tests/test_tracecheck.py``.  The port has
no jit: the detector counts the distinct ``(shape, dtype)`` / ``repr``
signatures each hot function (the hand-kernel wrappers and the search,
k-means and estimator bodies around them) sees per top-level call, under
the same budget, and counts kernel-library builds — at most one ``nvcc``
build per source per process.  It must trip the budget on shape thrash,
stay silent on stable and pow2-bucketed shapes, count a changed scalar
argument, leave nested calls uncounted, instrument and restore the hot
modules exactly (a wrapper's ``launches`` stays one count), and record a
rebuilt library."""

from __future__ import annotations

import os
import stat
import types

import numpy as np
import pytest
import torch

from lakesoul_tpu_torch.analysis import tracecheck


@pytest.fixture()
def armed():
    tracecheck.reset()
    tracecheck.enable()
    yield
    tracecheck.disable()
    tracecheck.reset()


def _fixture_module(**fns):
    mod = types.ModuleType("tracecheck_fixture")
    for name, fn in fns.items():
        setattr(mod, name, fn)
        tracecheck.instrument(mod, name)
    return mod


def test_shape_thrash_trips_budget(armed):
    mod = _fixture_module(f=lambda x: x * 2)
    label = "tracecheck_fixture.f"
    tracecheck.set_budget(label, 3)
    for n in range(1, 7):  # 6 distinct shapes against a budget of 3
        mod.f(torch.ones(n))
    violations = tracecheck.violations()
    assert len(violations) == 1
    v = violations[0]
    assert v.kind == "retrace-budget"
    assert v.function == label
    assert v.count == 6 and v.budget == 3
    # the violation names the thrashing shapes so the fix is obvious
    assert "float32[1]" in v.render() and "float32[6]" in v.render()


def test_stable_and_bucketed_shapes_stay_clean(armed):
    mod = _fixture_module(g=lambda x: x + 1)
    tracecheck.set_budget("tracecheck_fixture.g", 2)
    for _ in range(10):
        mod.g(np.ones(8, np.float32))  # same signature every time
    mod.g(np.ones(16, np.float32))  # one pow2 bucket up: still within budget
    assert tracecheck.violations() == []
    assert tracecheck.signature_counts()["tracecheck_fixture.g"] == 2


def test_static_arg_change_counts_as_retrace(armed):
    mod = _fixture_module(h=lambda x, *, k: x[:k])
    tracecheck.set_budget("tracecheck_fixture.h", 2)
    for k in range(1, 5):
        mod.h(torch.ones(8), k=k)  # every k is a new signature
    (v,) = tracecheck.violations()
    assert v.count == 4


def test_nested_calls_not_counted(armed):
    """The counterpart of the reference's trace-time inner calls: a hot
    function called while another counted call runs on the same thread is
    part of that call."""
    mod = types.ModuleType("tracecheck_fixture")
    mod.inner = lambda x: x * 3
    mod.outer = lambda x: mod.inner(x) + 1
    tracecheck.instrument(mod, "inner")
    tracecheck.instrument(mod, "outer")
    mod.outer(torch.ones(4))
    counts = tracecheck.signature_counts()
    assert counts == {"tracecheck_fixture.outer": 1}
    mod.inner(torch.ones(4))  # called alone it is a top-level call
    assert tracecheck.signature_counts()["tracecheck_fixture.inner"] == 1


def test_hot_module_instrumented_and_restored():
    import lakesoul_tpu_torch.vector.kernels as kernels

    orig = kernels.packed_scan
    before = orig.launches
    tracecheck.reset()
    tracecheck.enable()
    try:
        assert isinstance(kernels.packed_scan, tracecheck._CountedFn)
        rng = np.random.default_rng(0)
        codes = torch.from_numpy(rng.integers(0, 255, (100, 8), dtype=np.uint8))
        ones = torch.ones(100)
        out = kernels.packed_scan(codes, ones, ones, torch.ones(64), d=64)
        assert out.shape == (100,)
        assert any("packed_scan" in k for k in tracecheck.signature_counts())
        # the proxy forwards attribute writes: a wrapper's launch count
        # stays on the wrapper
        kernels.packed_scan.launches += 1
        assert orig.launches == before + 1
    finally:
        tracecheck.disable()
        tracecheck.reset()
        orig.launches = before
    assert kernels.packed_scan is orig  # restored exactly


def test_build_patch_restored_and_attribute_passthrough():
    from lakesoul_tpu_torch import _build
    from lakesoul_tpu_torch.annplane import ragged
    from lakesoul_tpu_torch.vector import kmeans

    real_build, real_load, real_kmeans = _build.build, _build.load, kmeans.kmeans
    tracecheck.reset()
    tracecheck.enable()
    try:
        assert _build.build is not real_build and _build.load is not real_load
        # introspection surfaces keep working on the proxy
        assert ragged.ragged_score.__name__ == "ragged_score"
        assert ragged.ragged_score.__wrapped__ is not None
        assert kmeans.kmeans.__doc__ == real_kmeans.__doc__
    finally:
        tracecheck.disable()
        tracecheck.reset()
    assert (_build.build, _build.load, kmeans.kmeans) == (real_build, real_load, real_kmeans)


def test_watch_scopes_violations():
    tracecheck.reset()
    with tracecheck.watch() as w:
        mod = _fixture_module(f=lambda x: x)
        tracecheck.set_budget("tracecheck_fixture.f", 1)
        mod.f(np.ones(2, np.float32))
        mod.f(np.ones(3, np.float32))
    assert len(w.violations) == 1
    assert not tracecheck.enabled()
    tracecheck.reset()


def test_env_gate():
    assert tracecheck.env_requested() in (True, False)
    # analysis.arm only arms when LAKESOUL_TRACECHECK=1; the detector itself
    # never auto-enables on import
    assert not tracecheck.enabled() or tracecheck.env_requested()


# ---------------------------------------------------- the port's additions


def test_bucketed_batch_search_stays_within_budget(armed):
    """The contract the detector guards, on the real search path: queries
    of every batch size from 1 to 40 reach the resident batch body in pow2
    buckets (8, 16, 32, 64), within the default budget."""
    from lakesoul_tpu_torch.vector import IvfRabitqIndex, SearchParams, VectorIndexConfig

    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 32)).astype(np.float32)
    idx = IvfRabitqIndex.train(x, np.arange(600), VectorIndexConfig("v", 32, nlist=4),
                               device="cpu")
    idx.enable_device_cache()
    for nq in range(1, 41):
        idx.batch_search(x[:nq], SearchParams(top_k=3, nprobe=2, rerank_depth=50))
    counts = tracecheck.signature_counts()
    body = "lakesoul_tpu_torch.vector.kernels._fused_search_resident_batch"
    assert 1 <= counts[body] <= 4, counts
    assert tracecheck.violations() == [], "\n".join(v.render() for v in tracecheck.violations())


def _fake_nvcc(tmp_path) -> str:
    """An ``nvcc`` stand-in that writes an empty library to its ``-o``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = -o ]; then : > "$2"; fi\n'
                    "  shift\ndone\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(bin_dir)


def test_one_build_per_source_and_a_rebuild_is_recorded(armed, tmp_path, monkeypatch):
    from lakesoul_tpu_torch import _build

    monkeypatch.setenv("PATH", _fake_nvcc(tmp_path) + os.pathsep + os.environ["PATH"])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build()  # every source once, as chip_smoke.py builds them
    _build.build(["packed_dot"])  # present: no compile
    assert tracecheck.build_counts() == {name: 1 for name in _build.SOURCES}
    assert tracecheck.violations() == []
    _build.library_path("bruteforce").unlink()  # the library is lost
    _build.build(["bruteforce"])
    (v,) = tracecheck.violations()
    assert v.kind == "kernel-rebuild" and v.function == "csrc/bruteforce.cu" and v.count == 2
    assert "compiled 2 times" in v.render()
