"""Seconds a pass spends writing kmerfreq's table: the span
kmerfreq.table_write (the 1-bit bitmap, its .cz and .cz.len, the spectrum
and the .stat) on the command thread, median over the passes
(program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("kmerfreq.table_write",))
