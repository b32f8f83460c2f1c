"""Counting statistics over a sorted k-mer vector: histograms and the
k-mer spectrum.

Counterpart of dbg_assembly_tpu/kmer/stats.py, with its contract and not
its XLA workarounds: run boundaries come from neighbour differences
(count._run_starts) and the histogram is a masked ``bincount``, where
JAX's blocked scans and chunked compare-reduce avoid the scatters and
long scans that are slow on a TPU.  Torch ops on the device of the
input.

Spectrum bin f = the number of k-mer species whose count, saturated at
max_freq, equals f; bin 0 is always 0 (kmerfreq's 255-cap table as
correct_error/main.cpp:187-215 reads it).
"""

from __future__ import annotations

import torch

from ..ops.chop import SENTINEL
from .count import _run_starts


def histogram_small(v: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """int64 counts of the values of ``v`` in [0, nbins); values outside
    are dropped."""
    v = torch.as_tensor(v).to(torch.int64)
    inside = (v >= 0) & (v < nbins)
    # out-of-range values land in an extra bin that is cut off
    return torch.bincount(torch.where(inside, v, nbins),
                          minlength=nbins + 1)[:nbins]


def histogram256(v: torch.Tensor) -> torch.Tensor:
    return histogram_small(v, 256)


def spectrum_sorted(sorted_kmers: torch.Tensor, max_freq: int = 255):
    """Spectrum and species count of a sorted k-mer vector (SENTINEL last).
    Returns (spectrum [max_freq + 1] int64 with spectrum[0] == 0,
    n_unique).

    A run's count is its length capped at max_freq.  As in the JAX
    package, the end of the vector is no run boundary: a last run with no
    SENTINEL after it lands in bin max_freq, whatever its length (JAX's
    window search returns its "none found" there,
    dbg_assembly_tpu/kmer/stats.py:163)."""
    n_valid = int((sorted_kmers != SENTINEL).sum())
    _, _, run_len = _run_starts(sorted_kmers, n_valid)
    capped = run_len.clamp(max=max_freq)
    if n_valid == sorted_kmers.shape[0] and n_valid:
        capped[-1] = max_freq
    return histogram_small(capped, max_freq + 1), int(run_len.shape[0])
