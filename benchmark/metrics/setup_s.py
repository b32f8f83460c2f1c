"""Seconds from process start to the first timed pass: imports, the
card's context, making and writing the inputs, the warm-up pass."""


def read(ctx):
    return ctx.setup_s
