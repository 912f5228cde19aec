"""``device_idle_share.moonlight``: the device's idle share of the traced
window, 1 − (the union of the device's operations / the window), in percent
(``device_idle_share.bert``'s reader, read in this cell)."""

from pathlib import Path

import harness

read = harness.load_module(Path(__file__).with_name("device_idle_share.bert.py")).read
