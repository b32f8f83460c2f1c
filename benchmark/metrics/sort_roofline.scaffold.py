"""The radix sort's share of its bytes bound in the scaffold cell, where
it sorts map_pair's contig index, once a round: the least time those
sorts need at the card's published bandwidth over the profiler's summed
time of hist_kernel, scan_kernel and onesweep_kernel in the traced
passes, in percent.  A sort reads every window's 8-byte key once and
writes it once, and writes its 8-byte position once (24 B a window).
The windows are the ``windows`` counts of the scaffold.index spans that
open in the passes (set-up's sorts, of the reads, fall outside the
window, and sort_roofline.py's read-window count does not apply).  No
value where the program records no such count."""

from benchmark import trace

BYTES_A_WINDOW = 24


def windows(passes: list, records: list, dropped: int) -> int | None:
    """The windows of the scaffold.index spans that open in ``passes``;
    None where the recorder dropped a record a pass may hold."""
    if not passes:
        return None
    bounds = [(p["start"] * 1e9, (p["start"] + p["wall"]) * 1e9)
              for p in passes]
    if dropped and (not records or bounds[-1][1] >= records[-1].start):
        return None
    return sum(r.counts.get("windows", 0) for r in records
               if r.name == "scaffold.index"
               and any(lo <= r.start <= hi for lo, hi in bounds))


def read(ctx):
    if not ctx.trace:
        return None
    try:
        from dbg_assembly_tpu_torch import spans
    except ImportError:
        return None
    n = windows(ctx.passes, spans.records(), spans.dropped())
    spent = trace.kernel_seconds(ctx.trace["kernel_s"], trace.SORT)
    if not n or spent <= 0:
        return None
    return 100.0 * n * BYTES_A_WINDOW / trace.PEAK_BYTES_S / spent
