"""``attention_share.moonlight``: the device time of the program's MLA, its
forward (``lm.attention``: the projections, RoPE, the causal attention, the
output projection, in every layer) and its backward
(``lm.attention.backward``: from the output's gradient to the normed
input's), as a share of the window, in percent (read as
``step_forward_share.bert`` reads the forward: only when the program timed
one ``train.step`` for each step the window completed)."""

from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))


def read(run):
    return SPANS.share(run, ("lm.attention", "lm.attention.backward"))
