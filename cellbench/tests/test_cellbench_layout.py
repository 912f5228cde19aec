"""A configuration, a traffic mix and a per-layer metric are found by name
from files added beside the ones that are there, with entries added to
BENCHMARK.json: no file of the benchmark is edited."""

import filecmp
import json
import shutil

import harness
from conftest import BENCH
from conftest import manifest as with_held_cells


def test_a_new_cell_config_traffic_and_reader_come_from_added_files_alone(tmp_path):
    bench = tmp_path / "cellbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    manifest = with_held_cells()

    conf = json.loads((bench / "configs" / "ann_plane_10m_128d_4bit.json").read_text())
    conf.update(name="ann_plane_1m_512d_1bit", rows=1_000_000, dim=512, total_bits=1)
    (bench / "configs" / "ann_plane_1m_512d_1bit.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "batch_1024_np48.json").read_text())
    traffic.update(batch=256, nprobe=32)
    (bench / "traffic" / "batch_256_np32.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "probe_pairs.slice.py").write_text(
        "def read(run):\n    return run['counters'].get('pairs')\n")

    manifest["configs"].append({"name": "ann_plane_1m_512d_1bit", "source": conf["source"],
                                "file": "cellbench/configs/ann_plane_1m_512d_1bit.json",
                                "reduced": conf["reduced"], "why": "a 1-bit slice"})
    manifest["workloads"].append({"name": "ann_slice_batch", "config": "ann_plane_1m_512d_1bit",
                                  "traffic": "batch_256_np32", "chips": 1, "why": "batches"})
    next(m for m in manifest["end_to_end"] if m["name"] == "ann_qps")["workloads"].append(
        "ann_slice_batch")
    manifest["per_layer"].append({"name": "probe_pairs.slice", "unit": "pairs",
                                  "better": "lower", "source": "program_counter",
                                  "layer": "ANN plane host path", "moves": "ann_qps",
                                  "workloads": ["ann_slice_batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    spec = harness.resolve_cell(harness.load_manifest(tmp_path), "ann_slice_batch", bench)
    assert spec["config"]["dim"] == 512 and spec["traffic"]["batch"] == 256
    assert spec["driver"] == bench / "drivers" / "ann_batch_closed.py"
    assert sorted(m["name"] for m in spec["end_to_end"]) == ["ann_qps", "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["probe_pairs.slice"]
    assert harness.metric_reader("probe_pairs.slice", bench)({"counters": {"pairs": 7}}) == 7
    # the cells that were there are found as before, and no file was edited
    old = harness.resolve_cell(harness.load_manifest(tmp_path), "ann_plane_batch", bench)
    assert "probe_pairs.slice" not in [m["name"] for m in old["per_layer"]]
    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    assert filecmp.cmp(bench / "harness.py", BENCH / "harness.py", shallow=False)
