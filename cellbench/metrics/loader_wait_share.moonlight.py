"""``loader_wait_share.moonlight``: the time the step waited on the loader
in the window, the change of ``lakesoul_scan_stage_seconds{stage="queue"}``
over it, as a share of the window, in percent (``loader_wait_share.bert``'s
reader, read in this cell)."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("loader_wait_share.bert.py")).read
