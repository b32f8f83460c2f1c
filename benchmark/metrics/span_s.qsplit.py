"""Seconds a pass spends on kmerfreq's -q split: the spans
kmerfreq.qsplit (split_reads_by_quality on the host, a file each) on the
command thread, median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("kmerfreq.qsplit",))
