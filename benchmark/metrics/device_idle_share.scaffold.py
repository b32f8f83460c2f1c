"""device_idle_share, in the scaffold cell: the reader of device_idle_share.py,
unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("device_idle_share", bench=_BENCH)
