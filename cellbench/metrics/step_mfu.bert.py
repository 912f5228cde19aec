"""``step_mfu.bert``: the model FLOPs of the steps the window completed
(``counts/bert_flops.py``: the tied head only at the labelled positions)
over the window and the card's dense bf16 peak, in percent."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "counts" / "peaks.json").read_text())


def read(run):
    flops = run["counters"].get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / run["window_s"] / float(PEAKS["bf16_flop_s"])
