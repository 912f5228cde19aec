"""``step_mfu.moonlight``: the model FLOPs of the steps the window completed
(``counts/moonlight_flops.py``: the routed experts at the dropless mean of
0.75 held slots a token, attention on the causal half) over the window and
the card's dense bf16 peak, in percent (read as ``step_mfu.bert``)."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("step_mfu.bert.py")).read
