"""Seconds a pass spends in map_pair: the host-clock spans of every stage
whose span is map_pair.<library> (both rounds, each command ending on an
idle device) summed a pass, median over the passes."""

import statistics


def read(ctx):
    per = [[s for name, s in p["spans"].items()
            if name.split(".")[0] == "map_pair"] for p in ctx.passes]
    return statistics.median([sum(x) for x in per]) if any(per) else None
