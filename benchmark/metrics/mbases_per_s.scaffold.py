"""mbases_per_s, in the scaffold cell, whose end-to-end metric besides
setup_s is card_s_per_gbase: the reader of mbases_per_s.py, unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("mbases_per_s", bench=_BENCH)
