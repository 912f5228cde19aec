"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from conftest import BENCH

ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and MANIFEST["run_seconds"] == int(
        MANIFEST["run_seconds"])


def test_paths_and_command():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if word.endswith(".py"):
            assert any(word.startswith(p.rstrip("/") + "/") for p in MANIFEST["paths"])
            assert (ROOT / word).is_file()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_well_formed_and_unique(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))


def test_metric_fields():
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_moves_names_an_end_to_end_metric_the_same_cells_report():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E, m
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(cell, E2E[m["moves"]]), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(w["name"], m) for m in MANIFEST["per_layer"]), w["name"]


def test_cells_configs_and_their_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        kind = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        assert (BENCH / "drivers" / f"{kind}.py").is_file()
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in MANIFEST["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden_size|intermediate|head|latent)", k), k


def test_every_per_layer_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
