"""Rows the device corrector hands back to the host engine
(``correct.device.counts["fallback"]``) over the reads corrected, the
median over the passes: the correction layer's wasted device work."""

import statistics


def read(ctx):
    if ctx.span_median("correct") is None:
        return None
    return statistics.median(p["counters"]["correct.fallback"]
                             / ctx.inputs["reads"] for p in ctx.passes)
