"""The benchmark's own tests: ``python -m pytest cellbench/tests -q`` from the
checkout's root.  They run on the CPU at small sizes; a test that needs the
card carries the ``chip`` marker and skips, deciding inside the test."""

import copy
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skips without one")


def load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def manifest() -> dict:
    """BENCHMARK.json with the entries of the cells held out of it
    (``held_out/*.json``), whose harness the tests keep running."""
    out = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for held in sorted((BENCH / "held_out").glob("*.json")):
        entries = json.loads(held.read_text())
        for kind in ("configs", "workloads", "end_to_end", "per_layer"):
            out[kind] += entries[kind]
    return out


def tiny_bert() -> dict:
    cfg = copy.deepcopy(load("configs/bert_base_mlm_c4.json"))
    cfg.update(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=64, seq_len=32, batch_size=8)
    cfg["table"].update(rows=64, hash_bucket_num=2)
    return cfg


def tiny_ann() -> dict:
    cfg = copy.deepcopy(load("configs/ann_plane_10m_128d_4bit.json"))
    cfg.update(rows=24_000, dim=32, nlist=16, shard_budget_bytes=312 * 10_000,
               train_sample_rows=2_000)
    cfg["search"].update(nprobe=6, rerank_depth=16)
    cfg["corpus"].update(centers=64, chunk_rows=5_000)
    # at this size the 4-bit shortlist misses a row now and then, which the
    # cell's size never does: its own limits, a row missed or a distance
    # not the row's reading far above them
    cfg["limits"].update(topk_gap=0.5)
    cfg["check_rows_a_shard"] = 256
    return cfg


TINY_TRAFFIC = {
    "table_epochs": {},
    "batch_1024_np48": {"batch": 64, "nprobe": 6, "pool_batches": 4, "warmup_batches": 1,
                        "check_sample": 48},
}


def tiny_ctx(cell: str, *, seed: int = 2**31 + 17, seconds: float = 1.0, trace: bool = False,
             faults=(), config=None):
    """A run of ``cell`` on the CPU at a small size, for ``driver.run``."""
    import tracing

    w = {c["name"]: c for c in manifest()["workloads"]}[cell]
    traffic = {**load(f"traffic/{w['traffic']}.json"), **TINY_TRAFFIC[w["traffic"]]}
    if config is None:
        config = tiny_bert() if w["config"].startswith("bert") else tiny_ann()
    return SimpleNamespace(seed=seed, seeds=[seed], seconds=seconds, trace=trace, device="cpu",
                           config=config, traffic=traffic, cell=w, t0=time.perf_counter(),
                           spans=tracing.Spans(trace), faults=set(faults))


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
