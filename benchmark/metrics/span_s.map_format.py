"""Seconds a pass spends in map_pair's per-pair loop: the span
map_pair.format (routing each pair and writing its lines in memory) on the
command thread, both rounds, median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("map_pair.format",))
