"""The radix sort's share of its bytes bound: the least time one sort of
every window's 8-byte key needs at the card's published bandwidth (read
once, written once; trace.kmer_work) over the profiler's summed time of
hist_kernel, scan_kernel and onesweep_kernel in the traced passes, in
percent."""

from benchmark import trace


def read(ctx):
    spent = trace.kernel_seconds(ctx.trace["kernel_s"], trace.SORT)
    need = ctx.work.get("sort_bytes", 0) * len(ctx.passes)
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / trace.PEAK_BYTES_S / spent
