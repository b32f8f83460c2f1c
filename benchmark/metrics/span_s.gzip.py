"""Seconds a pass spends compressing its .gz outputs: the spans io.gzip
(zlib level 1 and the write) on the command thread, median over the
passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("io.gzip",))
