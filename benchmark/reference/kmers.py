"""Plain PyTorch k-mer counting: the reference for kmerfreq's table and
spectrum, and the source of the table the correction reference reads.

Semantics of the upstream's kmerfreq as its consumers read it
(fanagislab/DBG_assembly, correct_error/main_parallel_senior.cpp:273-408,
test/01.clean_correct/work.sh:31): bases A, C, G, T are 0..3 and N is A;
a k-mer packs its first base into the high bits; it is counted under
min(k-mer, reverse complement); with ``-q q`` a window that covers a base
of Phred quality below q is not counted; the 1-bit table has bit
(7 - i % 8) of byte i // 8 set iff canonical k-mer i was counted more than
``-m`` times; the spectrum saturates counts at 65535.  Nothing here reads
what the program wrote, and nothing imports it.
"""

from __future__ import annotations

import torch

CODE = torch.zeros(256, dtype=torch.uint8)
for _c, _v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    CODE[_c] = _v
MAX_FREQ = 65535


def windows(seq_ascii: torch.Tensor, k: int, quals: torch.Tensor | None,
            q_cutoff: int, q_shift: int = 33):
    """Forward 2-bit k-mers [N, L-k+1] int64 of ASCII reads, and which
    windows count: all of them, or with q_cutoff > 0 those whose k bases
    all have quality >= q_cutoff."""
    codes = CODE.to(seq_ascii.device)[seq_ascii.long()].long()
    N, L = codes.shape
    P = L - k + 1
    fwd = torch.zeros((N, P), dtype=torch.int64, device=codes.device)
    for i in range(k):
        fwd = (fwd << 2) | codes[:, i:i + P]
    if q_cutoff <= 0:
        return fwd, torch.ones((N, P), dtype=torch.bool, device=codes.device)
    bad = ((quals.long() - q_shift) < q_cutoff).to(torch.int32)
    run = torch.nn.functional.pad(bad.cumsum(1), (1, 0))
    return fwd, (run[:, k:] - run[:, :P]) == 0


def revcomp(kmers: torch.Tensor, k: int) -> torch.Tensor:
    x = kmers.clone()
    out = torch.zeros_like(x)
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x = x >> 2
    return out


def canonical_kmers(seq_ascii, quals, k: int, q_cutoff: int,
                    rows: int = 65536) -> torch.Tensor:
    """Every counted window's canonical k-mer, flat, in blocks of rows."""
    parts = []
    for off in range(0, seq_ascii.shape[0], rows):
        s = seq_ascii[off:off + rows]
        q = quals[off:off + rows] if quals is not None else None
        fwd, ok = windows(s, k, q, q_cutoff)
        fwd = fwd[ok]
        parts.append(torch.minimum(fwd, revcomp(fwd, k)))
    return torch.cat(parts)


def count(files: list, k: int, q_cutoff: int, device):
    """(unique canonical k-mers, their counts, total counted) over the
    [N, L] ASCII reads and qualities of every file."""
    kmers = torch.cat([canonical_kmers(s.to(device), q.to(device), k,
                                       q_cutoff)
                       for s, q in files])
    uniq, counts = torch.unique(kmers, return_counts=True)
    return uniq, counts, int(kmers.numel())


def bitmap(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """The dense 1-bit table, [4^k / 8] uint8, of the given distinct
    k-mers."""
    kmers = torch.unique(kmers)                         # sorted, distinct
    byte, inverse = torch.unique_consecutive(kmers >> 3,
                                             return_inverse=True)
    bits = torch.zeros(byte.numel(), dtype=torch.int32, device=kmers.device)
    bits.index_add_(0, inverse, (1 << (7 - (kmers & 7))).to(torch.int32))
    table = torch.zeros((1 << (2 * k)) // 8, dtype=torch.uint8,
                        device=kmers.device)
    table[byte] = bits.to(torch.uint8)
    return table


def spectrum(counts: torch.Tensor) -> list:
    return torch.bincount(counts.clamp_max(MAX_FREQ),
                          minlength=MAX_FREQ + 1).tolist()


def _g(x: float) -> str:
    return "%g" % x


def stat_text(k: int, total: int, species: int, spec: list) -> str:
    """The spectrum file, in the format of the upstream's
    test/01.clean_correct/clean_reads.lib.kmer.freq.stat."""
    lines = [f"#Kmer size: {k}", f"#Maximum Kmer frequency: {MAX_FREQ}",
             f"#Kmer indivdual number: {total}",
             f"#Kmer species number: {species}",
             f"#Theoretic space of Kmer species: {1 << (2 * k)}  "
             f"occupied ratio: {_g(species / (1 << (2 * k)))}", "",
             "#Kmer_Frequency\tKmer_Species_Number\tKmer_Species_Ratio\t"
             "Kmer_Species_accumulate_Ratio\tKmer_Individual_Number\t"
             "Kmer_Individual_Ratio\tKmer_Individual_accumulate_ratio"]
    acc_sp = acc_ind = 0
    for freq in range(1, MAX_FREQ + 1):
        n_sp = spec[freq]
        n_ind = n_sp * freq
        acc_sp += n_sp
        acc_ind += n_ind
        lines.append(f"{freq}\t{n_sp}\t{_g(n_sp / species)}\t"
                     f"{_g(acc_sp / species)}\t{n_ind}\t"
                     f"{_g(n_ind / total)}\t{_g(acc_ind / total)}")
    return "\n".join(lines) + "\n"
