"""Seconds a pass spends mapping reads to the contig index: the span
scaffold.map (each mate's batches uploaded, the seed and extension on the
device, the results copied back) on the command thread, every mate of
both rounds, median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("scaffold.map",))
