"""The chop's share of its bytes bound: the least time its work needs at
the card's published bandwidth (each input base read once, each window's
outputs written once; trace.kmer_work) over the profiler's summed
chop_kernel time in the traced passes, in percent."""

from benchmark import trace


def read(ctx):
    spent = trace.kernel_seconds(ctx.trace["kernel_s"], trace.CHOP)
    need = ctx.work.get("chop_bytes", 0) * len(ctx.passes)
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / trace.PEAK_BYTES_S / spent
