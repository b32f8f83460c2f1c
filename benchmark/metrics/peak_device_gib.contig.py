"""peak_device_gib, in the cells whose end-to-end metric besides setup_s is
card_s_per_gbase: the reader of peak_device_gib.py, unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("peak_device_gib", bench=_BENCH)
