"""clean_lowqual: quality-block read trimming, on the device.

Counterpart of dbg_assembly_tpu/clean/lowqual.py.  Reference semantics
(clean_illumina/clean_lowqual.cpp):
  * Qual2Err[q + shift] = 10^(-q/10) for q in 0..99, every other byte 0.0
    (:219-222);
  * 'N' bases get the shift byte as their quality, an error probability of
    1.0 (:90-93), and the changed quality is written out;
  * the whole read's error is the sequential sum of its bases' errors
    (:89-95); a read with error <= cutoff * length passes untouched (:102);
  * otherwise a greedy breakpoint scan (:116-148): (err, len) accumulate
    from the last breakpoint; where accum_err > cutoff * accum_len the
    current base (1-based j + 1) is a breakpoint, the block strictly between
    breakpoints [last_break + 1, j] a candidate, and the accumulators reset;
    the longest block (strict >) wins, a final block to the read's end
    included (:139-148);
  * reads shorter than min_len after trimming are emptied but still written
    (:168-176), with the header annotations "    RQ: <pct>%",
    "  TrimLowQual" and "  FilterShort" (:97,151,172).

The JAX package runs the recurrence as one lax.scan over the read positions
with the reads as lanes.  Here it is a host loop over the positions, each
step a few elementwise torch ops on [N] tensors on the device: the same
left-to-right float64 sums, so the strict '>' comparisons decide alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, spans
from ..io import fastq, stat as statio

# reads a device batch: the scan holds the batch's qualities ([N, L] uint8)
# and a dozen [N] vectors on the device
DEFAULT_CHUNK = 1 << 20

# what the scan did since the last reset_counts(): device batches and
# host-loop steps (one a read position a batch)
counts = {"chunks": 0, "steps": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def qual2err_table(quality_shift: int = 33) -> np.ndarray:
    t = np.zeros(256, dtype=np.float64)
    for q in range(100):
        t[q + quality_shift] = 10.0 ** (-q / 10.0)
    return t


def _lowqual_scan(quals: torch.Tensor, lengths: torch.Tensor,
                  err_cutoff: float, quality_shift: int = 33):
    """The greedy breakpoint scan on the device of ``quals``.

    quals: [N, L] uint8 ASCII qualities with the N positions already set to
    the shift byte; lengths [N].  Returns (total_err [N] float64,
    best_start [N] int32 1-based, best_len [N] int32) of the longest clean
    block, the final block included."""
    dev = quals.device
    table = torch.from_numpy(qual2err_table(quality_shift)).to(dev)
    N, L = quals.shape
    jlen = lengths.to(device=dev, dtype=torch.int32)
    cols = quals.t().contiguous()                    # [L, N]: a step's row

    accum_err = torch.zeros(N, dtype=torch.float64, device=dev)
    total_err = torch.zeros(N, dtype=torch.float64, device=dev)
    accum_len, breakpos_last, best_len, best_start = (
        torch.zeros(N, dtype=torch.int32, device=dev) for _ in range(4))
    for j in range(L):                               # 0-based position
        e = table[cols[j].to(torch.int64)]
        in_read = j < jlen
        total_err = torch.where(in_read, total_err + e, total_err)
        accum_err2 = accum_err + e
        accum_len2 = accum_len + 1
        is_break = in_read & (accum_err2
                              > err_cutoff * accum_len2.to(torch.float64))
        # C++ 1-based: breakpos = j+1, block = [breakpos_last+1, breakpos-1]
        start_in_block = breakpos_last + 1
        length_block = j - start_in_block + 1
        better = is_break & (length_block > best_len)
        best_len = torch.where(better, length_block, best_len)
        best_start = torch.where(better, start_in_block, best_start)
        accum_err = torch.where(is_break, 0.0,
                                torch.where(in_read, accum_err2, accum_err))
        accum_len = torch.where(is_break, 0,
                                torch.where(in_read, accum_len2, accum_len))
        breakpos_last = torch.where(is_break, j + 1, breakpos_last)
    counts["steps"] += L

    # final block: breakpos = len+1 -> [breakpos_last+1, len]
    start_in_block = breakpos_last + 1
    length_block = jlen - start_in_block + 1
    better = length_block > best_len
    best_len = torch.where(better, length_block, best_len)
    best_start = torch.where(better, start_in_block, best_start)
    return total_err, best_start, best_len


@dataclass
class LowqualResult:
    keep_start: np.ndarray       # [N] 0-based trim start (0 if untrimmed)
    keep_len_pre: np.ndarray     # [N] length after trim, BEFORE short filter
    final_len: np.ndarray        # [N] length after short filter (0 if dropped)
    total_err: np.ndarray        # [N] f64 whole-read error sum
    trimmed: np.ndarray          # [N] bool TrimLowQual applied
    short: np.ndarray            # [N] bool FilterShort applied


def clean_lowqual_arrays(quals_in: np.ndarray, seq_ascii: np.ndarray,
                         lengths: np.ndarray, err_cutoff: float,
                         min_read_len: int, quality_shift: int = 33,
                         device="cuda", chunk: int = DEFAULT_CHUNK):
    """Trimming decisions for a batch, the scan on ``device`` ``chunk``
    reads at a time.  Returns (LowqualResult, quals_out) where quals_out
    has the 'N' positions set to the shift byte."""
    dev = resolve_device(device)
    N_mask = (seq_ascii == ord("N")) & \
        (np.arange(quals_in.shape[1])[None, :] < lengths[:, None])
    quals = np.where(N_mask, np.uint8(quality_shift), quals_in)

    n = len(lengths)
    total_err = np.zeros(n, np.float64)
    best_start = np.zeros(n, np.int64)
    best_len = np.zeros(n, np.int64)
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        with spans.span("lowqual.scan", chunks=1, reads=end - off):
            te, bs, bl = _lowqual_scan(
                torch.from_numpy(np.ascontiguousarray(quals[off:end])).to(dev),
                torch.from_numpy(np.ascontiguousarray(lengths[off:end])),
                err_cutoff, quality_shift)
            total_err[off:end] = te.cpu().numpy()
            best_start[off:end] = bs.cpu().numpy()
            best_len[off:end] = bl.cpu().numpy()
        counts["chunks"] += 1

    lengths = lengths.astype(np.int64)
    needs_trim = total_err > err_cutoff * lengths
    valid = (best_start >= 1) & (best_start <= lengths)
    keep_start = np.where(needs_trim & valid, best_start - 1, 0)
    keep_len_pre = np.where(needs_trim,
                            np.where(valid, best_len, 0), lengths)
    keep_len_pre = np.maximum(keep_len_pre, 0)
    short = keep_len_pre < min_read_len
    final_len = np.where(short, 0, keep_len_pre)
    return LowqualResult(keep_start, keep_len_pre, final_len, total_err,
                         needs_trim, short), quals


def run_file(in_path: str, out_path: str, stat_path: str,
             err_cutoff: float = 0.001, min_read_len: int = 75,
             quality_shift: int = 33, device="cuda") -> dict:
    """clean_lowqual <in> <out> <stat>: the trimmed reads as one-line
    FASTQ (gzip, compared on its decompressed bytes) and the .stat."""
    dev = resolve_device(device)
    batch = fastq.read_batch(in_path, fmt="fq", strict_n=True,
                             keep_heads=True, keep_ascii=True)
    seq = batch.seqs_ascii
    res, quals = clean_lowqual_arrays(batch.quals, seq, batch.lengths,
                                      err_cutoff, min_read_len, quality_shift,
                                      dev)
    lengths = batch.lengths.astype(np.int64)
    n = batch.n_reads

    raw_reads = n
    raw_bases = int(lengths.sum())
    lowqual_reads = int(res.trimmed.sum())
    lowqual_bases = int((lengths - res.keep_len_pre)[res.trimmed].sum())
    short_reads = int(res.short.sum())
    short_bases = int(res.keep_len_pre[res.short].sum())
    clean_reads = int((res.final_len > 0).sum())
    clean_bases = int(res.final_len.sum())

    out = bytearray()
    with spans.span("lowqual.format", records=n):
        for i in range(n):
            head = batch.heads[i]
            L = int(lengths[i])
            rq = statio.fmt_lexical(res.total_err[i] / L * 100) if L \
                else "nan"
            head = head + b"    RQ: " + rq.encode() + b"%"
            if res.trimmed[i]:
                head += b"  TrimLowQual"
            if res.short[i]:
                head += b"  FilterShort"
            s = int(res.keep_start[i])
            l_ = int(res.final_len[i])
            out += head + b"\n" + seq[i, s:s + l_].tobytes() + b"\n+\n" \
                + quals[i, s:s + l_].tobytes() + b"\n"
    fastq.gz_write_bytes(out_path, bytes(out))

    statio.write_clean_lowqual_stat(stat_path, raw_reads, raw_bases,
                                    lowqual_reads, lowqual_bases,
                                    short_reads, short_bases,
                                    clean_reads, clean_bases)
    return dict(raw_reads=raw_reads, raw_bases=raw_bases,
                clean_reads=clean_reads, clean_bases=clean_bases)
