"""Seconds of the card's own work a gigabase of the cell's input costs:
the profiler's summed durations of the kernels, sets and copies within
the card over the window, over the input gigabases times the passes.

Copies to and from host memory are left out: their time in the trace is
set by the host's staging copy of pageable memory, which swings with the
host as the passes' wall does; device_idle_share counts them."""

HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = sum(s for name, s in ctx.trace["kernel_s"].items()
                if not name.startswith(HOST_COPIES))
    gbases = ctx.inputs["bases"] * len(ctx.passes) / 1e9
    if spent <= 0 or gbases <= 0:
        return None
    return spent / gbases
