"""span_s.parse, in the cells whose end-to-end metric besides setup_s is
card_s_per_gbase: the reader of span_s.parse.py, unchanged."""

import os

from benchmark import harness

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = harness.metric_reader("span_s.parse", bench=_BENCH)
