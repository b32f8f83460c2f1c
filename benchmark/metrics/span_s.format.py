"""Seconds a pass spends formatting output records on the host: the spans
correct.format, lowqual.format and adapter.format (the loop over reads
that builds each record) on the command thread, median over the passes
(program_spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds(
        ctx, ("correct.format", "lowqual.format", "adapter.format"))
