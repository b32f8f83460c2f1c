"""1 - the union of the device's activity intervals (kernels, copies,
sets) over the traced window's wall."""


def read(ctx):
    return 1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]
