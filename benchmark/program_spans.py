"""Per-layer metrics read from the port's span recorder
(dbg_assembly_tpu_torch/spans.py): the seconds a pass spends inside named
spans, on the thread that ran its commands, the median over the passes.

A pass is [start, start + wall] of ``ctx.passes`` on time.perf_counter,
the recorder's clock and the one the device trace is put on.  A record
belongs to the pass it starts in.  Where one named span holds another
(an io.parse inside contig.schedule's recount, say), only the outer one
counts.  No value where the recorder dropped a record in a pass, where
none of the spans occurred, or where the program has no recorder.
"""

from __future__ import annotations

import statistics


def pass_seconds(passes: list, records: list, dropped: int,
                 names) -> float | None:
    """The median over ``passes`` of each pass's summed seconds in the
    spans called ``names`` on its command thread.  records: the
    recorder's records in their order (a record's parent is its index
    there); dropped: its count of dropped records."""
    names = set(names)
    per_pass = []
    found = False
    for p in passes:
        lo = p["start"] * 1e9
        hi = (p["start"] + p["wall"]) * 1e9
        # records fill in the order they open; once full, every span
        # opened after the last one kept is dropped
        if dropped and (not records or hi >= records[-1].start):
            return None
        inside = [r for r in records
                  if lo <= r.start <= hi and r.end is not None]
        threads = {r.thread for r in inside if r.name.startswith("cmd.")}
        total = 0
        for r in inside:
            if r.thread in threads and r.name in names \
                    and not _under(r, records, names):
                total += r.end - r.start
                found = True
        per_pass.append(total / 1e9)
    return statistics.median(per_pass) if found else None


def _under(r, records: list, names: set) -> bool:
    """Whether a span of ``names`` holds r."""
    i = r.parent
    while 0 <= i < len(records):
        if records[i].name in names:
            return True
        i = records[i].parent
    return False


def seconds(ctx, names) -> float | None:
    try:
        from dbg_assembly_tpu_torch import spans
    except ImportError:
        return None
    return pass_seconds(ctx.passes, spans.records(), spans.dropped(),
                        names)
