"""Seconds a pass spends decoding map_pair's FASTQ files: the span
map_pair.parse (read1 decoded on the command thread, read2 on a helper
thread at once, both waited for) on the command thread, both rounds,
median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("map_pair.parse",))
