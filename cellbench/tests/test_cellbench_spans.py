"""The program's spans inside the training step, read on the card: a short
traced run of ``bert_mlm_table`` reports its eight per-layer metrics, the
step's parts and the gaps between steps fill the window, the gaps are no
more than the card's idle time, and the head's share holds at least the
float32 GEMMs of the head that the trace's breakdown shows.  Run on the card
with ``python -m pytest cellbench/tests -m chip``; here it skips."""

import json
import re
import subprocess
import sys

import pytest

from conftest import BENCH

SEED = 3_000_000_019
PARTS = ("step_forward_share.bert", "step_backward_share.bert", "step_optimizer_share.bert",
         "step_gap_share.bert")
# the float32 GEMMs' kernels: cuBLAS's SIMT sgemm and its f32 xmma
F32_GEMM = re.compile(r"sgemm|gemm_f32f32")


@pytest.mark.chip
def test_a_traced_run_splits_the_step_on_the_card(chip):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "bert_mlm_table", "--seed",
         str(SEED), "--seconds", "10", "--trace", "1"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) == {"step_mfu.bert", "loader_wait_share.bert", "device_idle_share.bert",
                      "head_share.bert", *PARTS}, sorted(m)
    assert 97.0 <= sum(m[k] for k in PARTS) <= 101.0, m
    assert m["step_gap_share.bert"] <= m["device_idle_share.bert"] + 0.3, m
    f32 = sorted((s for k, s in line["breakdown"]["device_ops"] if F32_GEMM.search(k)),
                 reverse=True)[:3]
    assert m["head_share.bert"] >= 100.0 * sum(f32) / line["device"]["window_s"], (m, f32)
