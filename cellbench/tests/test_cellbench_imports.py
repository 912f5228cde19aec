"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
package's benchmarks, each compared by its whole top-level name (the port,
lakesoul_tpu_torch, begins with lakesoul_tpu); the reference imports
nothing of the port.  And a run without a card, or without the program,
prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "lakesoul_tpu", "benchmarks"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert harness.PROGRAM_PACKAGE not in top_level_imports(path)


def test_the_runtime_check_compares_whole_top_level_names():
    assert harness.forbidden_loaded({"lakesoul_tpu_torch": 1, "lakesoul_tpu_torch.vector": 1,
                                     "jaxtyping": 1, "torch": 1}) == []
    assert harness.forbidden_loaded({"lakesoul_tpu.vector.index": 1}) == ["lakesoul_tpu"]
    assert harness.forbidden_loaded({"jaxlib.xla_client": 1, "flax": 1}) == ["flax", "jaxlib"]


def run_cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "cellbench/run.py", "--workload", "bert_mlm_table",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_prints_no_result():
    r = run_cli(BENCH.parent)
    assert r.returncode == 2 and r.stdout == ""
    assert "no result" in r.stderr


def test_with_only_the_benchmark_and_no_program_the_run_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    r = run_cli(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["cellbench"]
