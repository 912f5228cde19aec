"""``expert_gemm_roofline.moonlight``: the held experts' product FLOPs of the
window, forward and backward (``counts/moonlight_flops.py``
``held_expert_flops`` at the routed slots the program counted on the card,
``lakesoul_moe_routed_slots_total``, × 3), over the device time of
``moe.experts`` + ``moe.experts.backward`` (the grouped SwiGLU products,
the gathers and the combine; the backward recomputes the forward's
products, which the count leaves out) at the card's dense bf16 peak, in
percent.  Read only when the program timed one ``train.step`` for each
step the window completed."""

import json
from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))
PEAKS = json.loads((Path(__file__).resolve().parent.parent / "counts" / "peaks.json").read_text())
NAMES = ("moe.experts", "moe.experts.backward")


def read(run):
    flops = run["counters"].get("held_expert_flops")
    steps = SPANS.sums(SPANS.DEVICE).get(SPANS.STEP)
    if not flops or steps is None or steps[1] != run["counters"].get("steps"):
        return None
    got = SPANS.sums(SPANS.DEVICE)
    if not all(n in got for n in NAMES):
        return None
    seconds = sum(got[n][0] for n in NAMES)
    return 100.0 * flops / seconds / float(PEAKS["bf16_flop_s"])
