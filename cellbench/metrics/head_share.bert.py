"""``head_share.bert``: the device time of the MLM head, its forward (the
program's span ``bert.head``: layer norm, the float32 tied product and bias,
the cross-entropy) and its backward (``bert.head.backward``: from the loss's
gradient to the encoder output's), as a share of the window, in percent
(read as ``step_forward_share.bert`` reads the forward)."""

from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))


def read(run):
    return SPANS.share(run, ("bert.head", "bert.head.backward"))
