"""Median over the passes of the host-clock span around the correct stage
(every file it runs on, each command ending on an idle device)."""


def read(ctx):
    return ctx.span_median("correct")
