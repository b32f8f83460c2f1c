"""Median over the passes of the host-clock span around debruijn_contig
(ingest, pruning and readout, ending on an idle device)."""


def read(ctx):
    return ctx.span_median("contig")
