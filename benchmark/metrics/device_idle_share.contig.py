"""device_idle_share, in the cells whose end-to-end metric besides setup_s is
card_s_per_gbase: the reader of device_idle_share.py, unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("device_idle_share", bench=_BENCH)
