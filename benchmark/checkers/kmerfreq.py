"""kmerfreq: the packed table of the k-mers seen more than -m times
(``<lib>.kmer.freq.cz``, every byte) and the spectrum (``.stat``, every
line), against k-mers counted by ``torch.unique`` from the cell's reads.
Leaves the high k-mers in ``state["high_kmers"]`` for the correction's
check."""

import argparse
import zlib

import numpy as np
import torch

from benchmark.checks import lines_differ
from benchmark.reference import kmers as ref_kmers

CZ_BLOCK_BYTES = 1 << 20       # 8M k-mers a compressed block of the table


def read_cz(path: str, k: int) -> np.ndarray:
    """A .cz table (blocks listed in <path>.len) as 4^k / 8 bytes."""
    out = np.zeros((1 << (2 * k)) // 8, np.uint8)
    with open(path + ".len") as f:
        sizes = [int(x) for x in f.read().split()]
    off = 0
    with open(path, "rb") as f:
        for s in sizes:
            raw = zlib.decompress(f.read(s))
            out[off:off + len(raw)] = np.frombuffer(raw, np.uint8)
            off += CZ_BLOCK_BYTES
    return out


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="kmerfreq")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=1)
    ap.add_argument("-q", type=int, default=0)
    ap.add_argument("lib")
    a, _ = ap.parse_known_args(argv)
    dev = run.device
    uniq, counts, total = ref_kmers.count(
        list(zip(run.inputs["seqs"], run.inputs["quals"])), a.k, a.q, dev)
    high = uniq[counts > a.m]
    state["high_kmers"] = (a.k, high)
    want_stat = ref_kmers.stat_text(a.k, total, uniq.numel(),
                                    ref_kmers.spectrum(counts))
    del uniq, counts
    want = ref_kmers.bitmap(high, a.k)
    got = torch.from_numpy(read_cz(a.lib + ".kmer.freq.cz", a.k)).to(dev)
    table_differ = int((got != want).sum())
    del got, want
    stat_differ = lines_differ(a.lib + ".kmer.freq.stat",
                               want_stat.encode())
    return {"table_bytes_differ": (table_differ, 0),
            "spectrum_lines_differ": (stat_differ, 0)}
