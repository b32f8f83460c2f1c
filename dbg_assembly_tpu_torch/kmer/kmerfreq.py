"""kmerfreq: the k-mer frequency table producer.

Counterpart of dbg_assembly_tpu/kmer/kmerfreq.py, counting on ``device``.
Outputs, in the formats the reference's consumers read:

  <lib>.kmer.freq.cz / .cz.len   1-bit-per-kmer table: bit set at the
                                 canonical index iff count > low_freq_cutoff
                                 (main_parallel_senior.cpp:273-329; strict
                                 '>' per main.cpp:202); or, with
                                 table_format "8bit", one count byte a
                                 k-mer saturated at 255 (4^k bytes of host
                                 memory: 16 GiB at k = 17)
  <lib>.kmer.freq.stat           spectrum table (format of test/
                                 01.clean_correct/clean_reads.lib.kmer.freq.
                                 stat), counters capped at 65535.
"""

from __future__ import annotations

import numpy as np

from .. import spans
from ..io import cz as czio
from ..io import fastq, stat as statio
from ..io.lib import read_file_list
from . import count as kc


def split_reads_by_quality(codes: np.ndarray, lengths: np.ndarray,
                           quals: np.ndarray, ksize: int, cutoff: int,
                           shift: int = 33):
    """kmerfreq `-q` quality masking: every k-mer window covering a base
    whose Phred quality (ascii - shift) is below `cutoff` is excluded, by
    splitting each read at those bases into its maximal reliable segments
    of >= ksize bases (test/01.clean_correct/work.sh:31 runs `-q 10`).
    Returns (codes2 [R, Lmax2] uint8, lengths2 [R] int32)."""
    N, L = codes.shape
    pos = np.arange(L)[None, :]
    inlen = pos < lengths[:, None]
    good = inlen & ((quals.astype(np.int32) - shift) >= cutoff)
    if good.sum() == inlen.sum():
        return codes, lengths
    prev = np.zeros_like(good)
    prev[:, 1:] = good[:, :-1]
    starts2d = good & ~prev
    flat_good = good.ravel()
    rid = np.cumsum(starts2d.ravel()) - 1          # run id at good slots
    n_runs = int(starts2d.sum())
    if n_runs == 0:
        return (np.zeros((0, ksize), np.uint8), np.zeros(0, np.int32))
    run_len = np.bincount(rid[flat_good], minlength=n_runs)
    run_start = np.flatnonzero(starts2d.ravel())
    keep = run_len >= ksize
    run_len = run_len[keep]
    run_start = run_start[keep]
    if len(run_len) == 0:
        return (np.zeros((0, ksize), np.uint8), np.zeros(0, np.int32))
    Lmax = int(run_len.max())
    flat_codes = codes.ravel()
    idx = np.minimum(run_start[:, None] + np.arange(Lmax)[None, :],
                     len(flat_codes) - 1)
    return flat_codes[idx], run_len.astype(np.int32)


def run(lib_path: str, ksize: int = 17, low_freq_cutoff: int = 1,
        fmt: str | None = None, out_prefix: str | None = None,
        batch_reads: int = 200_000, table_format: str = "1bit",
        qual_cutoff: int = 0, qual_shift: int = 33, device="cuda") -> dict:
    """Count every file of the .lib list on ``device`` and write the .cz
    and .stat files.  table_format "1bit": the high/low table
    (correct_error_reads reads it); "8bit": one saturated count byte a
    k-mer index, laid out on the host (correct_error reads it,
    correct_error/main.cpp:161-220).  qual_cutoff > 0 turns on `-q`
    masking for FASTQ inputs."""
    if table_format not in ("1bit", "8bit"):
        raise ValueError(f"table_format must be '1bit' or '8bit', not "
                         f"{table_format!r}")
    prefix = out_prefix or (lib_path + ".kmer.freq")
    counter = kc.KmerCounter(ksize, batch_reads=batch_reads, device=device)
    for path in read_file_list(lib_path):
        batch = fastq.read_batch(path, fmt=fmt, keep_heads=False)
        codes, lens = batch.codes, batch.lengths
        if qual_cutoff > 0 and batch.quals.any():
            with spans.span("kmerfreq.qsplit", reads=len(lens)):
                codes, lens = split_reads_by_quality(
                    codes, lens, batch.quals, ksize, qual_cutoff, qual_shift)
                spans.add(segments=len(lens))
        if len(codes):
            windows = int(np.maximum(lens.astype(np.int64) - ksize + 1,
                                     0).sum())
            with spans.span("kmerfreq.count", windows=windows):
                counter.add(codes, lens)
    with spans.span("kmerfreq.finalize"):
        uniq, counts, total = counter.finalize()

    with spans.span("kmerfreq.table_write"):
        if table_format == "8bit":
            freqs = np.zeros(1 << (2 * ksize), dtype=np.uint8)
            freqs[uniq.astype(np.int64)] = np.minimum(counts, 255)
            czio.write_cz_bytes(prefix + ".cz", freqs)
            bitmap = None
        else:
            bitmap = kc.freq_bitmap(uniq, counts, ksize, low_freq_cutoff)
            czio.write_cz_bits(prefix + ".cz", bitmap)

        spec = kc.spectrum(counts, max_freq=65535)
        statio.write_kmerfreq_stat(prefix + ".stat", ksize, 65535,
                                   int(total), len(uniq), 1 << (2 * ksize),
                                   spec)
    return {"cz": prefix + ".cz", "stat": prefix + ".stat",
            "species": len(uniq), "individuals": int(total),
            "bitmap": bitmap}
