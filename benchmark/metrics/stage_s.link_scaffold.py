"""Seconds a pass spends in link_scaffold: the host-clock spans of every
stage whose span is link_scaffold.<library> (both rounds) summed a pass,
median over the passes."""

import statistics


def read(ctx):
    per = [[s for name, s in p["spans"].items()
            if name.split(".")[0] == "link_scaffold"] for p in ctx.passes]
    return statistics.median([sum(x) for x in per]) if any(per) else None
