"""The port's storage-core units against the reference's on seeded inputs:
Spark Murmur3 hashing (with the native library and without it), the
materialized merge and the streaming merge's windows, the LSF format both
ways, and the native library's build under concurrent first use."""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import lakesoul_tpu.io.lsf as ref_lsf
import lakesoul_tpu.io.merge as ref_merge
import lakesoul_tpu.io.streaming_merge as ref_smerge
import lakesoul_tpu.utils.spark_hash as ref_hash
import lakesoul_tpu_torch.io.lsf as port_lsf
import lakesoul_tpu_torch.io.merge as port_merge
import lakesoul_tpu_torch.io.streaming_merge as port_smerge
import lakesoul_tpu_torch.utils.spark_hash as port_hash
from lakesoul_tpu_torch import native as port_native

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _columns(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 3001
    i32 = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    i64 = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    strs = [
        None if i % 17 == 0 else "".join(chr(97 + c) for c in rng.integers(0, 26, i % 23))
        for i in range(n)
    ]
    return {
        "int32": pa.array(i32),
        "int64": pa.array(i64, mask=rng.random(n) < 0.05),
        "string": pa.array(strs, pa.string()),
    }


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["int32", "int64", "string"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spark_hash_equals_reference(monkeypatch, native, kind, seed):
    if native == "numpy":
        monkeypatch.setenv("LAKESOUL_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("LAKESOUL_TPU_DISABLE_NATIVE", raising=False)
        assert port_native.available()
    assert port_native.available() == (native == "native")
    cols = _columns(seed)
    col = cols[kind]
    assert np.array_equal(port_hash.hash_array(col), ref_hash.hash_array(col))
    chained = [col, cols["int64"], cols["string"]]
    got = port_hash.hash_columns(chained)
    assert np.array_equal(got, ref_hash.hash_columns(chained))
    assert np.array_equal(port_hash.bucket_ids(got, 8), ref_hash.bucket_ids(got, 8))


def _runs(seed: int, key: str) -> list:
    rng = np.random.default_rng(seed)
    runs = []
    for i in range(4):
        n = 400
        ids = rng.choice(600, n, replace=False).astype(np.int64)
        t = pa.table({
            "id": ids if key == "int" else pa.array([f"k{x:04d}" for x in ids]),
            "b": rng.integers(0, 3, n).astype(np.int64),
            "s": rng.integers(0, 100, n).astype(np.int64),
            "last": pa.array([None if x % 3 == 0 else float(x) for x in range(n)]),
            "tag": [f"f{i}"] * n,
        })
        order = pc.sort_indices(t, sort_keys=[("id", "ascending"), ("b", "ascending")])
        runs.append(t.take(order))
    return runs


MERGE_CASES = {
    "int_pk": (["id"], None),
    "string_pk": (["id"], None),
    "composite_ops": (["id", "b"], {"s": "SumAll", "last": "UseLastNotNull", "tag": "JoinedAllByComma"}),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("native", ["native", "numpy"])
def test_merge_sorted_tables_equals_reference(monkeypatch, case, native):
    if native == "numpy":
        monkeypatch.setenv("LAKESOUL_TPU_DISABLE_NATIVE", "1")
    pks, ops = MERGE_CASES[case]
    runs = _runs(3, "string" if case == "string_pk" else "int")
    want = ref_merge.merge_sorted_tables(runs, pks, merge_operators=ops)
    got = port_merge.merge_sorted_tables(runs, pks, merge_operators=ops)
    assert got.equals(want)
    assert len(got) < sum(len(r) for r in runs)


@pytest.mark.parametrize("batch_rows", [7, 64])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_streaming_merge_windows_equal_reference(tmp_path, case, batch_rows):
    pks, ops = MERGE_CASES[case]
    files = []
    for i, run in enumerate(_runs(5, "string" if case == "string_pk" else "int")):
        p = str(tmp_path / f"run_{i}_0000.parquet")
        pq.write_table(run, p, row_group_size=64)
        files.append(p)
    want = list(ref_smerge.iter_merged_windows(files, pks, merge_operators=ops,
                                               stream_batch_rows=batch_rows))
    got = list(port_smerge.iter_merged_windows(files, pks, merge_operators=ops,
                                               stream_batch_rows=batch_rows))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.equals(w)


def _lsf_table(seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = 2500
    return pa.table({
        "id": np.arange(n, dtype=np.int64) * 3 + 5,
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "name": [f"n{i % 97}" for i in range(n)],
        "vec": pa.FixedSizeListArray.from_arrays(
            pa.array(rng.normal(size=n * 4).astype(np.float32)), 4),
    })


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lsf_round_trip_both_ways(tmp_path, writer):
    table = _lsf_table(11)
    path = str(tmp_path / "t.lsf")
    (port_lsf if writer == "port" else ref_lsf).write_lsf_table(table, path)
    with port_lsf.LsfFile(path) as f:
        got_port = f.read()
    with ref_lsf.LsfFile(path) as f:
        got_ref = f.read()
    assert got_port.equals(table)
    assert got_ref.equals(table)
    with port_lsf.LsfFile(path) as f:
        sub = f.read(columns=["id", "vec"])
    assert sub.equals(table.select(["id", "vec"]))


_BUILD_CHILD = textwrap.dedent(
    """
    import sys, time
    start = float(sys.argv[1])
    from lakesoul_tpu_torch import native
    while time.time() < start:
        time.sleep(0.001)
    print("AVAILABLE" if native.available() else "MISSING", native.library_path())
    """
)


def test_native_build_race_every_process_sees_the_library(tmp_path):
    """Six processes load the port's native library together on an empty
    build directory: each sees a whole library (the compiler writes a
    temporary name that is renamed onto the final path), and no temporary
    file is left behind.  The reference builds straight onto its final path
    and loses this race (``lakesoul_tpu/native/__init__.py:25-39``)."""
    build = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "LAKESOUL_TPU_DISABLE_NATIVE"}
    env["LAKESOUL_TPU_TORCH_BUILD_DIR"] = str(build)
    env["PYTHONPATH"] = str(ROOT)
    start = time.time() + 3.0
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(start)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o.strip() for o, _ in outs]
    assert all(line.startswith("AVAILABLE ") for line in lines), lines
    assert len({line.split()[1] for line in lines}) == 1
    assert [p.name for p in build.iterdir()] == [pathlib.Path(lines[0].split()[1]).name]
    assert pathlib.Path(lines[0].split()[1]).parent == build
