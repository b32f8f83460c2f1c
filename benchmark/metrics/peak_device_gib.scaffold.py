"""peak_device_gib, in the scaffold cell: the reader of peak_device_gib.py,
unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("peak_device_gib", bench=_BENCH)
