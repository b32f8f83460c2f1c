"""clean_lowqual: every record and the .stat against the cleaner in
torch (reference/clean.py) on the stage's input; the records kept for
clean_adapter's check."""

import argparse

from benchmark.checks import clean_result, input_records
from benchmark.reference import clean as ref_clean


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="clean_lowqual")
    ap.add_argument("-e", type=float, default=0.001)
    ap.add_argument("-q", type=int, default=33)
    ap.add_argument("-r", type=int, default=75)
    for x in ("input", "output", "stat"):
        ap.add_argument(x)
    a, _ = ap.parse_known_args(argv)
    records, stat = ref_clean.lowqual(input_records(a.input, run, state),
                                      a.e, a.r, a.q, run.device)
    return clean_result("lowqual", a.output, a.stat, records, stat, state)
