"""clean_adapter: every record and the .stat against the cleaner in
torch (reference/clean.py) on the stage's input, a cell input file or
what clean_lowqual's check made."""

import argparse

from benchmark.checks import clean_result, input_records
from benchmark.reference import clean as ref_clean


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="clean_adapter")
    ap.add_argument("-a", default="Both-adapter")
    ap.add_argument("-s", type=int, default=12)
    ap.add_argument("-r", type=int, default=75)
    for x in ("input", "output", "stat"):
        ap.add_argument(x)
    a, _ = ap.parse_known_args(argv)
    records, stat = ref_clean.adapter(input_records(a.input, run, state),
                                      ref_clean.DEFAULT_ADAPTERS[a.a], a.s,
                                      a.r, run.device)
    return clean_result("adapter", a.output, a.stat, records, stat, state)
