"""One-line FASTQ/FASTA (optionally gzipped) to padded code batches.

Counterpart of dbg_assembly_tpu/io/fastq.py, through the same native
single-pass parser (native/fastq_engine.cpp).  A whole file decodes into

    ReadBatch.codes      [N, Lmax] uint8   2-bit codes, N -> 0 (pad = 4)
    ReadBatch.quals      [N, Lmax] uint8   raw ASCII qualities (pad = 0)
    ReadBatch.lengths    [N]       int32
    ReadBatch.heads      list[bytes]       raw header lines (keep_heads)
    ReadBatch.seqs_ascii [N, Lmax] uint8   raw sequence bytes, pad 0
                                           (keep_ascii)

Record selection follows the reference: a record starts only at a line
beginning with '@' ('>' for FASTA), which consumes the next 3 (1) lines
(DBGgraph.cpp:246-258).
"""

from __future__ import annotations

import gzip
import os
import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import native


@dataclass
class ReadBatch:
    codes: np.ndarray          # [N, Lmax] uint8, 0..3 bases, 4 = pad (and N if strict)
    quals: np.ndarray          # [N, Lmax] uint8 raw ASCII (0 = pad / absent)
    lengths: np.ndarray        # [N] int32
    heads: list = field(default_factory=list)
    seqs_ascii: np.ndarray | None = None   # [N, Lmax] uint8 raw bytes (0 pad)

    @property
    def n_reads(self) -> int:
        return int(self.codes.shape[0])


def _read_maybe_gz(path: str) -> bytes:
    with open(path, "rb") as f:
        magic = f.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(path, "rb") as f:
        return f.read()


def read_batch(path: str, fmt: str | None = None, strict_n: bool = False,
               max_len: int | None = None, keep_heads: bool = False,
               keep_ascii: bool = False) -> ReadBatch:
    """Load a whole one-line FASTQ/FASTA(.gz) file into a padded batch in
    the k-mer alphabet.  fmt "fq"/"fa"; None guesses from the name; the
    first byte decides.  strict_n maps N to 4 instead of 0; max_len cuts
    the rows.  Headers are kept only on request (the JAX package keeps
    them by default): the counting and contig stages never read them."""
    if fmt is None:
        base = path[:-3] if path.endswith(".gz") else path
        fmt = "fa" if base.endswith((".fa", ".fasta")) \
            or ".fa." in os.path.basename(path) else "fq"
    data = _read_maybe_gz(path)
    if data[:1] == b">":
        fmt = "fa"
    elif data[:1] == b"@":
        fmt = "fq"
    codes, quals, lengths, hoff, hlen, aarr = native.fastq_parse(
        data, fq=(fmt == "fq"), strict_n=strict_n, max_len=max_len,
        keep_ascii=keep_ascii)
    heads = [data[o:o + n] for o, n in zip(hoff.tolist(), hlen.tolist())] \
        if keep_heads else []
    return ReadBatch(codes=codes, quals=quals, lengths=lengths, heads=heads,
                     seqs_ascii=aarr)


def gz_write_bytes(path: str, data: bytes, level: int = 1) -> None:
    """One-shot gzip write, level 1 by default: the port's .gz artifacts
    are compared and consumed on their decompressed bytes, so the level
    only trades size for time."""
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    with open(path, "wb") as f:
        f.write(co.compress(data))
        f.write(co.flush())


def write_fastq_gz(path: str, heads: list, seqs: list, quals: list,
                   level: int = 6) -> None:
    """One-line FASTQ records; the '+' separator line is bare, as the
    reference writers' (clean_lowqual.cpp:298, clean_adapter.cpp:414)."""
    out = bytearray()
    for h, s, q in zip(heads, seqs, quals):
        out += h + b"\n" + s + b"\n+\n" + q + b"\n"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(out))


def write_fasta_gz(path: str, heads: list, seqs: list, level: int = 6) -> None:
    """One-line FASTA records."""
    out = bytearray()
    for h, s in zip(heads, seqs):
        out += h + b"\n" + s + b"\n"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(out))
