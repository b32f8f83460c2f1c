"""simulate_lowfreq_kmer: k-size selection research tool, on the host.

Counterpart of dbg_assembly_tpu/utils/simulate_lowfreq.py (numpy through
the port's dna.py).

Parity: correct_error/simulate_lowfreq_kmer.cpp:71-260.  Builds a 1-bit
reference k-mer table from a genome (forward + reverse complement bits),
deterministically mutates one base every `skip` bp (base -> (code+1) mod 4),
and reports the distribution of low-frequency (absent-from-reference) k-mers
produced per mutation.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import dna
from ..io.stat import fmt_g6
from ..kmer.count import bitmap_get, bitmap_set


def read_fasta_seqs(path: str):
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        seq = []
        started = False
        for line in f:
            line = line.rstrip(b"\n")
            if line[:1] == b">":
                if started and seq:
                    yield b"".join(seq)
                started = True
                seq = []
            else:
                seq.append(line.replace(b" ", b""))
        if started:
            yield b"".join(seq)


def run(genome_fa: str, ksize: int = 17, skip: int = 100, out=None):
    """The report goes to ``out``, by default the sys.stdout of the call
    (the JAX package binds the one of its import)."""
    out = sys.stdout if out is None else out
    total = (1 << (2 * ksize)) - 1
    bitmap = np.zeros(total // 8 + 1, dtype=np.uint8)

    genome_bp = 0
    kmer_total = 0
    seqs = []
    for seq in read_fasta_seqs(genome_fa):
        seqs.append(seq)
        genome_bp += len(seq)
        kmer_total += len(seq) - ksize + 1
        codes = dna.ascii_to_codes(np.frombuffer(seq, np.uint8))
        km = dna.rolling_kmers(codes, ksize)
        rc = dna.revcomp_kbit(km, ksize)
        for idx in (km, rc):
            bitmap_set(bitmap, idx)
    # the reference scans idx in [0, 4^k-1) — the all-T k-mer is excluded
    # from the species count (simulate_lowfreq_kmer.cpp loop bound quirk)
    species = int(np.unpackbits(bitmap[:(total + 1) // 8]).sum())
    if bitmap_get(bitmap, total):
        species -= 1

    out.write(f"The Genome size is:  {genome_bp}\n")
    out.write(f"Kmer total number:   {kmer_total}\n")
    out.write(f"Kmer species number: {species}\n\n")

    frag_len = 2 * ksize - 1
    freq_nums = np.zeros(ksize + 1, dtype=np.int64)
    for seq in seqs:
        codes = dna.ascii_to_codes(np.frombuffer(seq, np.uint8))
        starts = np.arange(0, len(seq) - frag_len + 1, skip)
        if len(starts) == 0:
            continue
        frags = codes[starts[:, None] + np.arange(frag_len)[None, :]].copy()
        # mutate the middle base: (code + 1) mod 4 (the reference computes
        # alphabet[base]+1 with N->0, wrapping 4->0)
        mid = ksize - 1
        frags[:, mid] = (frags[:, mid] + 1) % 4
        km = dna.rolling_kmers(frags, ksize)                # [n, ksize]
        nlow = (bitmap_get(bitmap, km) == 0).sum(axis=1)
        freq_nums += np.bincount(nlow, minlength=ksize + 1)

    total_group = int(freq_nums.sum())
    total_low = int((np.arange(ksize + 1) * freq_nums).sum())
    i = np.arange(ksize + 1)
    ratio = i / ksize
    g100 = int(freq_nums[ksize])
    g80 = int(freq_nums[ratio >= 0.8].sum())
    g50 = int(freq_nums[ratio >= 0.5].sum())
    g20 = int(freq_nums[ratio >= 0.2].sum())
    g1 = int(freq_nums[1:].sum())

    out.write(f"\nKmer size: {ksize}\n")
    out.write("\nRatio of low-freq kmers in all kmers by muation : "
              f"{fmt_g6(total_low / (total_group * ksize))}\n")
    out.write("\nRatio of mutations with 100% low-freq kmers:  "
              f"{fmt_g6(g100 / total_group)}\n")
    out.write("\nRatio of mutations with >=80% low-freq kmers: "
              f"{fmt_g6(g80 / total_group)}\n")
    out.write("\nRatio of mutations with >=50% low-freq kmers: "
              f"{fmt_g6(g50 / total_group)}\n")
    out.write("\nRatio of mutations with >=20% low-freq kmers: "
              f"{fmt_g6(g20 / total_group)}\n")
    out.write("\nRatio of mutations with >= 1 low-freq kmers:  "
              f"{fmt_g6(g1 / total_group)}\n")

