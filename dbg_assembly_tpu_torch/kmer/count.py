"""K-mer counting: chop -> sort -> run-length encode, per batch.

Counterpart of dbg_assembly_tpu/kmer/count.py.  Per batch the device
  1. chops [N, L] codes into canonical int64 k-mers (ops.chop: the CUDA
     kernel on a CUDA tensor, its plain twin on a CPU tensor), SENTINEL at
     invalid windows;
  2. sorts the flat vector (ops.sort: the CUDA radix sort on a CUDA
     tensor, its plain twin on a CPU tensor; stable);
  3. run-length encodes it: run starts where x[i] != x[i-1], run lengths
     from the distances between starts.
Batches merge on the device (merge_counted); the host sees numpy uint64 only
at KmerCounter.finalize.  The spectrum and the 1-bit table follow the
external kmerfreq tool's outputs (correct_error/main.cpp:161-220,
main_parallel_senior.cpp:334-408).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna, resolve_device
from ..ops import sort as radix
from ..ops.chop import SENTINEL, chop


def chop_canonical(codes: torch.Tensor, lengths: torch.Tensor, ksize: int,
                   sort: bool = True):
    """[N, L] codes + [N] lengths -> (flat canonical k-mers [N*P], n_valid)
    with SENTINEL at the invalid windows.  sort=True (the default, as in
    JAX's chop_canonical, dbg_assembly_tpu/kmer/count.py:37) sorts the
    vector, the sentinels to the end; sort=False returns it row-major, as
    the chop wrote it, and launches no sort."""
    kmers, _, _ = chop(codes, lengths, ksize)
    flat = kmers.reshape(-1)
    if sort:
        # 2k + 1 bits: the sentinel's low bits order it after every k-mer
        flat, _ = radix.sort(flat, 2 * ksize + 1)
    return flat, _n_valid(lengths, ksize, kmers.shape[1])


def _n_valid(lengths: torch.Tensor, ksize: int, P: int) -> int:
    return int((lengths.to(torch.int64) - ksize + 1).clamp(0, P).sum())


def _run_starts(sorted_keys: torch.Tensor, n_valid: int):
    """Run starts of a sorted vector whose first n_valid entries are the
    valid keys.  Returns (first [n] bool, starts [M] int64, run_len [M])."""
    n = sorted_keys.shape[0]
    first = torch.zeros(n, dtype=torch.bool, device=sorted_keys.device)
    if n_valid:
        first[0] = True
        first[1:n_valid] = sorted_keys[1:n_valid] != sorted_keys[:n_valid - 1]
    starts = torch.nonzero(first).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([n_valid])])
    return first, starts, ends - starts


def count_unique_fast(codes: torch.Tensor, lengths: torch.Tensor,
                      ksize: int):
    """Chop + one sort + run-length encode, with the runs left at their
    sorted positions (as dbg_assembly_tpu count_unique_fast returns them).
    Returns (uniq_masked [N*P] int64 with SENTINEL off run starts,
    counts_masked [N*P] int32 with 0 there, n_unique, n_valid)."""
    flat, n_valid = chop_canonical(codes, lengths, ksize)
    first, starts, run_len = _run_starts(flat, n_valid)
    uniq = torch.where(first, flat, SENTINEL)
    counts = torch.zeros(flat.shape[0], dtype=torch.int32,
                         device=flat.device)
    counts[starts] = run_len.to(torch.int32)
    return uniq, counts, int(starts.shape[0]), n_valid


def count_spectrum_fast(codes: torch.Tensor, lengths: torch.Tensor,
                        ksize: int, max_freq: int = 255):
    """Chop + one sort + the spectrum (stats.spectrum_sorted, with its
    last-run rule).  Returns (spectrum [max_freq + 1] int64, n_unique,
    n_valid)."""
    from .stats import spectrum_sorted
    flat, n_valid = chop_canonical(codes, lengths, ksize)
    spectrum, n_unique = spectrum_sorted(flat, max_freq)
    return spectrum, n_unique, n_valid


def run_length(sorted_kmers: torch.Tensor):
    """Run-length encode a sorted vector (SENTINEL last), JAX's padded
    contract.  Returns (unique [n] int64, counts [n] int64, n_unique) with
    the runs ascending in the first n_unique entries and SENTINEL / 0
    after them."""
    n_valid = int((sorted_kmers != SENTINEL).sum())
    _, starts, run_len = _run_starts(sorted_kmers, n_valid)
    M = starts.shape[0]
    uniq = torch.full_like(sorted_kmers, SENTINEL)
    counts = torch.zeros(sorted_kmers.shape[0], dtype=torch.int64,
                         device=sorted_kmers.device)
    uniq[:M] = sorted_kmers[starts]
    counts[:M] = run_len
    return uniq, counts, M


def count_stats(sorted_kmers: torch.Tensor, max_freq: int = 65535):
    """Spectrum, species count and valid count of a sorted vector
    (SENTINEL last), from exact run lengths: the end of the vector ends a
    run.  Returns (spectrum [max_freq + 1] int64, bin 0 == 0, n_unique,
    n_valid)."""
    n_valid = int((sorted_kmers != SENTINEL).sum())
    _, starts, run_len = _run_starts(sorted_kmers, n_valid)
    spectrum = torch.bincount(run_len.clamp(max=max_freq),
                              minlength=max_freq + 1)
    return spectrum, int(starts.shape[0]), n_valid


def count_batch(codes: torch.Tensor, lengths: torch.Tensor, ksize: int):
    """Count the canonical k-mers of one batch on the tensors' device.
    Returns (unique int64 [M] ascending, counts int64 [M], n_valid)."""
    flat, n_valid = chop_canonical(codes, lengths, ksize)
    _, starts, run_len = _run_starts(flat, n_valid)
    return flat[starts], run_len, n_valid


def merge_counted(parts: list[tuple[torch.Tensor, torch.Tensor]],
                  ksize: int = 31):
    """Merge per-batch (unique, counts) runs of k-mers (< 2^2k, no
    sentinel) into one, on their device."""
    if len(parts) == 1:
        return parts
    ks = torch.cat([p[0] for p in parts])
    cs = torch.cat([p[1] for p in parts])
    ks, order = radix.sort(ks, 2 * ksize, return_index=True)
    first, starts, _ = _run_starts(ks, ks.shape[0])
    seg = torch.cumsum(first, 0) - 1
    csum = torch.zeros(starts.shape[0], dtype=cs.dtype, device=cs.device)
    csum.index_add_(0, seg, cs[order])
    return [(ks[starts], csum)]


class KmerCounter:
    """Streaming canonical k-mer counter over read batches on ``device``.

    Each batch of ``batch_reads`` reads is counted on the device and the
    per-batch runs are merged there; finalize() returns numpy arrays."""

    def __init__(self, ksize: int, batch_reads: int = 200_000,
                 device="cuda"):
        if not 1 <= ksize <= 31:
            raise ValueError(f"k={ksize} outside 1..31")
        self.ksize = ksize
        self.batch_reads = batch_reads
        self.device = resolve_device(device)
        self.parts: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.total_kmers = 0

    def add(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        for off in range(0, len(codes), self.batch_reads):
            cb = torch.from_numpy(np.ascontiguousarray(
                codes[off:off + self.batch_reads], np.uint8))
            lb = torch.from_numpy(np.ascontiguousarray(
                lengths[off:off + self.batch_reads], np.int32))
            u, c, t = count_batch(cb.to(self.device), lb.to(self.device),
                                  self.ksize)
            self.parts.append((u, c))
            self.total_kmers += t
            if len(self.parts) >= 8:
                self.parts = merge_counted(self.parts, self.ksize)

    def finalize(self):
        """Returns (unique_sorted uint64, counts int64, total_kmers)."""
        if not self.parts:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64), 0
        self.parts = merge_counted(self.parts, self.ksize)
        u, c = self.parts[0]
        return (u.cpu().numpy().view(np.uint64), c.cpu().numpy(),
                self.total_kmers)


def spectrum(counts: np.ndarray, max_freq: int = 65535) -> np.ndarray:
    """Histogram of species counts, saturated at max_freq (kmerfreq caps its
    16-bit counters at 65535 — clean_reads.lib.kmer.freq.stat:2)."""
    capped = np.minimum(counts, max_freq)
    return np.bincount(capped.astype(np.int64), minlength=max_freq + 1)


def freq_bitmap(unique: np.ndarray, counts: np.ndarray, ksize: int,
                low_freq_cutoff: int = 1) -> np.ndarray:
    """Dense 1-bit-per-kmer table over all 4^k indices: bit set at the
    canonical index iff count > low_freq_cutoff (main_parallel_senior.cpp:
    310-329; strict '>' per main.cpp:202)."""
    bitmap = np.zeros((1 << (2 * ksize)) // 8, dtype=np.uint8)
    bitmap_set(bitmap, unique[counts > low_freq_cutoff].astype(np.uint64))
    return bitmap


def expand_bitmap_rc(bitmap: np.ndarray, ksize: int) -> np.ndarray:
    """OR the reverse-complement bits into a copy of the table (the
    consumer-side step, main_parallel_senior.cpp:310-329).  Host numpy,
    over the nonzero bytes only: the table is sparse, so they are found
    from its nonzero 64-bit words (4^k/8 bytes, a multiple of 8 for k >= 2)
    rather than by a scan of every byte."""
    if bitmap.size % 8 == 0:
        nzw = np.flatnonzero(bitmap.view(np.uint64))
        sub = np.flatnonzero(bitmap.reshape(-1, 8)[nzw])      # ascending
        nz = nzw[sub // 8] * 8 + sub % 8
    else:
        nz = np.flatnonzero(bitmap)
    if len(nz) == 0:
        return bitmap.copy()
    bits = np.unpackbits(bitmap[nz][:, None], axis=1)       # [n, 8] MSB-first
    rows, cols = np.nonzero(bits)
    idx = (nz[rows].astype(np.uint64) << np.uint64(3)) + cols.astype(np.uint64)
    rc = dna.revcomp_kbit(idx, ksize)
    out = bitmap.copy()
    bitmap_set(out, rc)
    return out


def bitmap_set(bitmap: np.ndarray, idx: np.ndarray) -> None:
    """Set the bits of uint64 indices ``idx`` in a byte table, in place:
    bit 7 - idx % 8 of byte idx / 8, MSB-first (the layout get_freq reads,
    correct_error/seqKmer.cpp:102-106).  The one writer of the layout."""
    np.bitwise_or.at(bitmap, (idx // 8).astype(np.int64),
                     (np.uint8(1) << (7 - (idx % 8)).astype(np.uint8)))


def bitmap_get(bitmap: np.ndarray, idx) -> np.ndarray:
    """Query bits (vectorized get_freq, correct_error/seqKmer.cpp:102-106)."""
    idx = np.asarray(idx, dtype=np.uint64)
    return (bitmap[(idx // 8).astype(np.int64)] >>
            (7 - (idx % 8)).astype(np.uint8)) & 1
