"""Input megabases of the cell's library times the passes completed, over
the passes' summed wall (host clock, each pass ending on an idle device)."""


def read(ctx):
    wall = sum(p["wall"] for p in ctx.passes)
    return ctx.inputs["bases"] * len(ctx.passes) / wall / 1e6
