"""L0 sequence and k-mer primitives: 2-bit codes and packed k-mers.

Counterpart of dbg_assembly_tpu/dna.py.  Base codes are A=0 C=1 G=2 T=3 and
4 for N/pad (DBG_contig/seqKmer.cpp:9-24); the k-mer alphabet maps N to 0.
A packed k-mer holds 2 bits per base, leftmost base highest.

``rolling_kmers``, ``revcomp_kbit`` and ``canonical`` take a torch tensor
(computed in int64: 2k <= 62 bits, so every k-mer is >= 0) or a numpy array
(computed in uint64, for host callers).
"""

from __future__ import annotations

import numpy as np
import torch

_KMER_LUT = np.zeros(256, dtype=np.uint8)          # N and unknown -> 0 (A)
for _ch, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
                ("T", 3), ("t", 3)):
    _KMER_LUT[ord(_ch)] = _v

_STRICT_LUT = np.full(256, 4, dtype=np.uint8)      # N and unknown -> 4
for _ch, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
                ("T", 3), ("t", 3)):
    _STRICT_LUT[ord(_ch)] = _v

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)      # code -> ASCII
C_BASES = np.frombuffer(b"TGCAN", dtype=np.uint8)    # code -> complement


def ascii_to_codes(buf: np.ndarray, strict_n: bool = False) -> np.ndarray:
    """Map ASCII bytes to 2-bit codes (uint8).  strict_n: N->4 else N->0."""
    lut = _STRICT_LUT if strict_n else _KMER_LUT
    return lut[buf]


def codes_to_ascii(codes: np.ndarray) -> np.ndarray:
    """2-bit codes to ASCII bases; 4 and above read as N."""
    return BASES[np.minimum(codes, 4)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array along the last axis (N=4 fixed)."""
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[..., ::-1]


def bit2seq(kbit: int, ksize: int) -> str:
    """Unpack one packed k-mer to an ACGT string (parity seqKmer.cpp:45-52)."""
    kbit = int(kbit)
    return "".join("ACGT"[(kbit >> (2 * (ksize - 1 - i))) & 3]
                   for i in range(ksize))


def seq2bit(codes: np.ndarray, ksize: int | None = None) -> np.ndarray:
    """Pack a code array [..., k] into uint64 k-mers (parity
    seqKmer.cpp:34-41).  ksize is accepted and unused, as in JAX's
    (dbg_assembly_tpu/dna.py:89): k is the last axis."""
    c = np.asarray(codes, dtype=np.uint64)
    out = np.zeros(c.shape[:-1], dtype=np.uint64)
    for i in range(c.shape[-1]):
        out = (out << np.uint64(2)) | c[..., i]
    return out


def rolling_kmers(codes, ksize: int):
    """All k-mers of each sequence: [..., L] codes -> [..., L-k+1].

    The shift-or recurrence of DBGgraph.cpp:64-74 over the window axis, on
    raw codes: a code 4 leaks its bit into the windows that hold it (those
    are masked by every caller).  int64 for a tensor, uint64 for numpy."""
    P = codes.shape[-1] - ksize + 1
    if isinstance(codes, torch.Tensor):
        c = codes.to(torch.int64)
        out = torch.zeros(c.shape[:-1] + (P,), dtype=torch.int64,
                          device=c.device)
        for i in range(ksize):
            out = (out << 2) | c[..., i:i + P]
        return out
    c = np.asarray(codes, dtype=np.uint64)
    out = np.zeros(c.shape[:-1] + (P,), dtype=np.uint64)
    for i in range(ksize):
        out = (out << np.uint64(2)) | c[..., i:i + P]
    return out


def revcomp_kbit(kbit, ksize: int):
    """Reverse complement of packed k-mers (parity seqKmer.cpp:89-97): the
    low 2k bits, reversed by base and complemented.

    A tensor goes base by base (k steps on non-negative int64: the
    bit-parallel form's ``~`` and ``>>`` would sign-extend); numpy keeps the
    bit-parallel uint64 cascade."""
    if isinstance(kbit, torch.Tensor):
        x = kbit.to(torch.int64)
        out = torch.zeros_like(x)
        for _ in range(ksize):
            out = (out << 2) | (3 - (x & 3))
            x = x >> 2
        return out
    k = ~np.asarray(kbit, dtype=np.uint64)
    for m, s in ((0x3333333333333333, 2), (0x0F0F0F0F0F0F0F0F, 4),
                 (0x00FF00FF00FF00FF, 8), (0x0000FFFF0000FFFF, 16),
                 (0x00000000FFFFFFFF, 32)):
        m, s = np.uint64(m), np.uint64(s)
        k = ((k & m) << s) | ((k & ~m) >> s)
    return k >> np.uint64(64 - 2 * ksize)


def canonical(kbit, ksize: int):
    """(elementwise min(kbit, revcomp(kbit)), revcomp(kbit))."""
    rc = revcomp_kbit(kbit, ksize)
    if isinstance(kbit, torch.Tensor):
        return torch.minimum(kbit.to(torch.int64), rc), rc
    return np.minimum(kbit, rc), rc


def next_kmer_rightward(kbit, base, ksize: int):
    """(kbit << 2 | base) & mask, parity contig.h:127-130 (numpy uint64)."""
    mask = np.uint64((1 << (2 * ksize)) - 1)
    return ((np.asarray(kbit, np.uint64) << np.uint64(2))
            | np.asarray(base, np.uint64)) & mask


def next_kmer_leftward(kbit, base, ksize: int):
    """(kbit >> 2) + (base << 2(k-1)), parity contig.h:119-123 (numpy
    uint64)."""
    return ((np.asarray(kbit, np.uint64) >> np.uint64(2))
            + (np.asarray(base, np.uint64) << np.uint64(2 * (ksize - 1))))
