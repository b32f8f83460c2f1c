"""The traced run's arithmetic: device activity from torch.profiler, its
union and gaps, the kernels' time by name, and the least time the chop's
and the sort's work needs at the card's published bandwidth.

Busy time is the union of the device's activity intervals (kernels,
copies, sets), so overlapping work on two streams counts once; the idle
share is 1 - busy / the traced window's wall.  The bound of a kernel
counts the bytes that the cell's inputs need, whatever implements them:
each input base read once and each window's outputs written once for the
chop, each window's 8-byte key read once and written once for one sort.
"""

from __future__ import annotations

import argparse
import re
import time

import torch

# NVIDIA H100 SXM, the published HBM3 bandwidth (bytes a second)
PEAK_BYTES_S = 3.35e12

CHOP = re.compile(r"(^|[\s:])chop_kernel\b")
SORT = re.compile(r"(^|[\s:])(hist_kernel|scan_kernel|onesweep_kernel)\b")


def union(intervals: list) -> list:
    """Merged, sorted (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(merged: list, start: float, end: float) -> list:
    """(start, end) of the idle stretches of [start, end] between merged
    busy intervals."""
    out = []
    t = start
    for s, e in merged:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return [g for g in out if g[1] > g[0]]


def label(t: float, passes: list) -> str:
    """The stage whose host-clock span holds time t."""
    for p in passes:
        s = p["start"]
        for name, dur in p["spans_at"]:
            if s <= t <= s + dur:
                return name
            s += dur
    return "between stages"


def summarise(events: list, window: tuple, passes: list) -> dict:
    """events: (name, start_s, end_s) on the host clock; window: (start,
    end).  Returns busy_s, window_s, kernel seconds by name and the
    breakdown."""
    w0, w1 = window
    merged = union([(s, e) for _, s, e in events])
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(merged, w0, w1), key=lambda g: g[0] - g[1])[:10]
    return {"busy_s": busy, "window_s": w1 - w0, "kernel_s": by_name,
            "breakdown": {
                "device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[_gap_label(s, e, passes), e - s]
                              for s, e in idle]}}


def _gap_label(start: float, end: float, passes: list) -> str:
    """The stage the host was in over a gap: one name, or "a..b" where
    the gap runs from one stage into the next."""
    a, b = label(start, passes), label(end, passes)
    return a if a == b else f"{a}..{b}"


def kernel_seconds(kernel_s: dict, pattern: re.Pattern) -> float:
    return sum(s for name, s in kernel_s.items() if pattern.search(name))


class Tracer:
    """torch.profiler over the window, the device's activity only."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, window_s: float, passes: list) -> dict:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        results = self.prof.profiler.kineto_results
        base = results.trace_start_ns()
        events = []
        for e in results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if e.name() == "Activity Buffer Request" or e.duration_ns() <= 0:
                continue
            s = self.t0 + (e.start_ns() - base) / 1e9
            events.append((e.name(), s, s + e.duration_ns() / 1e9))
        if not events:
            raise RuntimeError("the profiler recorded no device activity")
        return summarise(events, (self.t0, self.t0 + window_s), passes)


def kmer_work(inputs: dict, argvs: list, device) -> dict:
    """Bytes the k-mer stages of a pass need: for the chop, every base it
    reads once and every window's outputs written once (8 B, and the two
    edge codes in ingest); for the sort, every window's 8 B key read and
    written once.  Counted from the cell's reads and each stage's k (and
    kmerfreq's -q: its windows are those clear of low-quality bases)."""
    chop = sort = 0
    for argv in argvs:
        if argv[0] not in ("kmerfreq", "debruijn_contig"):
            continue
        ap = argparse.ArgumentParser()
        ap.add_argument("-k", type=int, default=17 if argv[0] == "kmerfreq"
                        else 31)
        ap.add_argument("-q", type=int, default=0)
        ap.add_argument("-r", type=int, default=250)
        a, _ = ap.parse_known_args(argv[1:])
        edges = argv[0] == "debruijn_contig"
        q = a.q if argv[0] == "kmerfreq" else 0
        for seq, qual in zip(inputs["seqs"], inputs["quals"]):
            bases, wins = window_counts(seq, qual, a.k, q,
                                        a.r if edges else None, device)
            chop += bases + wins * (10 if edges else 8)
            sort += wins * 16
    return {"chop_bytes": chop, "sort_bytes": sort}


def window_counts(seq: torch.Tensor, qual: torch.Tensor, k: int, q: int,
                  max_len: int | None, device) -> tuple[int, int]:
    """(bases read, windows) of [N, L] reads at k: with q > 0 the bases of
    the runs of quality >= q that hold a window, and those runs' windows;
    reads cut to max_len first."""
    if max_len is not None:
        seq, qual = seq[:, :max_len], qual[:, :max_len]
    N, L = seq.shape
    if q <= 0:
        return N * L, N * max(L - k + 1, 0)
    good = (qual.to(device).long() - 33) >= q
    idx = torch.arange(L, device=device).expand(N, L)
    last_bad = torch.cummax(torch.where(good, -1, idx), dim=1).values
    nxt = torch.nn.functional.pad(good[:, 1:], (0, 1), value=False)
    lengths = (idx - last_bad)[good & ~nxt]          # each run, at its end
    lengths = lengths[lengths >= k]
    return int(lengths.sum()), int((lengths - k + 1).sum())
