"""``step_gap_share.bert``: the card's time between the window's steps, from
the end event of one ``train.step`` span to the start event of the next
(``lakesoul_span_device_gap_seconds{name="train.step"}``), as a share of
the window, in percent (read as ``step_forward_share.bert`` reads the
forward)."""

from pathlib import Path

import harness

SPANS = harness.load_module(Path(__file__).with_name("step_forward_share.bert.py"))


def read(run):
    return SPANS.share(run, (SPANS.STEP,), family=SPANS.GAP)
