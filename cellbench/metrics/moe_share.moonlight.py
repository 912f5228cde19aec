"""``moe_share.moonlight``: the device time of the program's expert blocks,
forward (``moe``: the router, the top-6, the grouping, the held experts'
products, the shared experts, the combine) and backward (``moe.backward``:
from the block output's gradient to its normed input's), as a share of the
window, in percent (read as ``step_forward_share.bert`` reads the
forward)."""

from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))


def read(run):
    return SPANS.share(run, ("moe", "moe.backward"))
