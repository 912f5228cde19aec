"""``step_optimizer_share.bert``: the device time of the program's span
``train.optimizer`` over the window's steps, as a share of the window, in
percent (read as ``step_forward_share.bert`` reads the forward)."""

from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))


def read(run):
    return SPANS.share(run, ("train.optimizer",))
