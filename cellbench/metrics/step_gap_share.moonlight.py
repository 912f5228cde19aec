"""``step_gap_share.moonlight``: the card's time between the window's steps,
from the end event of one ``train.step`` span to the start event of the
next, as a share of the window, in percent (``step_gap_share.bert``'s
reader, read in this cell)."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("step_gap_share.bert.py")).read
