"""Seconds a pass spends building map_pair's contig index: the span
scaffold.index (the windows, the radix sort, the runs; it ends on an idle
device) on the command thread, both rounds, median over the passes
(program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("scaffold.index",))
