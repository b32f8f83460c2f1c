"""Seconds a pass spends in debruijn_contig's readout: the span
contig.readout (the exact readout's layout and native replay, or the
doubling readout, and the run log's last lines) on the command thread,
median over the passes (program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(ctx, ("contig.readout",))
