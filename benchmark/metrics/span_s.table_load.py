"""Seconds a pass spends putting the k-mer table in place for correction:
the spans correct.table_load (the .cz read and the reverse-complement
expand) and correct.table_upload (the table to the device) on the
command thread, median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(
        ctx, ("correct.table_load", "correct.table_upload"))
