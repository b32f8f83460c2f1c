"""Seconds a pass spends reading and parsing its FASTQ files: the spans
io.parse (the file read, gunzip and the native parser) and, in the
contig stage, contig.parse_wait (the command thread waiting on the parse
that a helper thread runs), on the command thread, median over the
passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("io.parse", "contig.parse_wait"))
