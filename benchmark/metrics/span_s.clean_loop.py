"""Seconds a pass spends in the cleaners' host loops over read positions
with their torch ops: the spans lowqual.scan and adapter.align (one a
chunk, the results copied back included) on the command thread, median
over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("lowqual.scan", "adapter.align"))
