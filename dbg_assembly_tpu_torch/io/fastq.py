"""One-line FASTQ/FASTA (optionally gzipped) to padded code batches.

Counterpart of dbg_assembly_tpu/io/fastq.py, with its two parsers: the
native single-pass parser (native/fastq_engine.cpp) and, under
DBG_PY_FASTQ=1 as in the JAX package, the per-record Python loop.  A whole file decodes into

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
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import dna, native, spans
from . import pool

GZ_CHUNK = 1 << 20     # source bytes a deflate chunk of a .gz output
_WINDOW = 1 << 15      # deflate's window: the input a chunk is primed with


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

    @property
    def n_bases(self) -> int:
        return int(self.lengths.sum())


def _open_maybe_gz(path: str, mode: str = "rb"):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def _records_from_lines(lines: list[bytes], fmt: str):
    """Yield (head, seq, qual | None) with the reference's guard-and-skip:
    a record starts only at a lead line and takes the next 3 (1) lines; a
    record cut short at the end is dropped."""
    lead = b"@" if fmt == "fq" else b">"
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.startswith(lead):
            if fmt == "fq":
                if i + 3 >= n:
                    break
                yield line, lines[i + 1], lines[i + 3]
                i += 4
            else:
                if i + 1 >= n:
                    break
                yield line, lines[i + 1], None
                i += 2
        else:
            i += 1


def _parse_py(data: bytes, fmt: str, strict_n: bool, max_len: int | None,
              keep_heads: bool, keep_ascii: bool) -> ReadBatch:
    """The JAX package's per-record parser (io/fastq.py:108-135)."""
    heads, seqs, quals = [], [], []
    for h, s, q in _records_from_lines(data.split(b"\n"), fmt):
        heads.append(h)
        seqs.append(s)
        quals.append(q if q is not None else b"")
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    Lmax = int(lens.max()) if n else 0
    if max_len is not None:
        Lmax = min(Lmax, max_len) if n else 0
    codes = np.full((n, Lmax), 4, dtype=np.uint8)
    qarr = np.zeros((n, Lmax), dtype=np.uint8)
    aarr = np.zeros((n, Lmax), dtype=np.uint8) if keep_ascii else None
    for i, (s, q) in enumerate(zip(seqs, quals)):
        L = min(len(s), Lmax)
        sb = np.frombuffer(s, dtype=np.uint8, count=L)
        codes[i, :L] = dna.ascii_to_codes(sb, strict_n=strict_n)
        if aarr is not None:
            aarr[i, :L] = sb
        if q:
            ql = min(len(q), L)
            qarr[i, :ql] = np.frombuffer(q, dtype=np.uint8, count=ql)
    return ReadBatch(codes=codes, quals=qarr,
                     lengths=np.minimum(lens, Lmax).astype(np.int32),
                     heads=heads if keep_heads else [], seqs_ascii=aarr)


def read_batch(path: str, fmt: str | None = None, strict_n: bool = False,
               max_len: int | None = None, keep_heads: bool = True,
               keep_ascii: bool = False) -> ReadBatch:
    """Load a whole one-line FASTQ/FASTA(.gz) file into a padded batch in
    the k-mer alphabet.  fmt "fq"/"fa"; None guesses from the name; the
    first byte decides.  strict_n maps N to 4 instead of 0; max_len cuts
    the rows.  Headers are kept by default, as JAX's read_batch keeps them
    (dbg_assembly_tpu/io/fastq.py:76); keep_heads=False gives heads=[]
    and saves their copies (the counting and contig stages pass it, as
    JAX's callers do).  DBG_PY_FASTQ=1 parses with the Python loop (the
    same arrays)."""
    if fmt is None:
        base = path[:-3] if path.endswith(".gz") else path
        fmt = "fa" if base.endswith((".fa", ".fasta")) \
            or ".fa." in os.path.basename(path) else "fq"
    with spans.span("io.parse"):
        with _open_maybe_gz(path) as f:
            data = f.read()
        if data[:1] == b">":
            fmt = "fa"
        elif data[:1] == b"@":
            fmt = "fq"
        if os.environ.get("DBG_PY_FASTQ") == "1":
            batch = _parse_py(data, fmt, strict_n, max_len, keep_heads,
                              keep_ascii)
        else:
            codes, quals, lengths, hoff, hlen, aarr = native.fastq_parse(
                data, fq=(fmt == "fq"), strict_n=strict_n, max_len=max_len,
                keep_ascii=keep_ascii)
            heads = [data[o:o + n] for o, n in zip(hoff.tolist(),
                                                   hlen.tolist())] \
                if keep_heads else []
            batch = ReadBatch(codes=codes, quals=quals, lengths=lengths,
                              heads=heads, seqs_ascii=aarr)
        spans.add(bytes=len(data), reads=batch.n_reads)
    return batch


def gz_write_bytes(path: str, data: bytes, level: int = 1) -> None:
    """One gzip member at ``level`` (1 by default): the port's .gz
    artifacts are compared and consumed on their decompressed bytes, so
    the level only trades size for time.

    The input is deflated in source chunks of GZ_CHUNK on the host pool
    (io/pool.py), as pigz does: each chunk a raw deflate stream primed
    with up to 32 KiB of the input before it, ended by a full flush (the last by the stream's end), written in order
    between zlib's own header and a trailer of the whole input's CRC-32
    and length.  The bytes depend on the input and the level alone,
    whatever the worker count; an input of one chunk or less runs in this
    thread and gives exactly the bytes of one zlib gzip stream."""
    n = len(data)
    view = memoryview(data)
    offs = range(0, n or 1, GZ_CHUNK)
    workers = pool.workers(len(offs))

    def deflate(off):
        zdict = {"zdict": view[max(0, off - _WINDOW):off]} if off else {}
        co = zlib.compressobj(level, zlib.DEFLATED, -15, **zdict)
        end = off + GZ_CHUNK
        return co.compress(view[off:end]) + co.flush(
            zlib.Z_FINISH if end >= n else zlib.Z_FULL_FLUSH)

    with spans.span("io.gzip", bytes_in=n, chunks=len(offs),
                    workers=workers):
        with open(path, "wb") as f:
            # the header zlib writes for this level
            f.write(zlib.compressobj(level, zlib.DEFLATED, 31).flush()[:10])
            crc = 0
            for comp, off in zip(pool.in_order(deflate, offs, workers), offs):
                f.write(comp)
                crc = zlib.crc32(view[off:off + GZ_CHUNK], crc)
            f.write(struct.pack("<II", crc, n & 0xFFFFFFFF))
            spans.add(bytes_out=f.tell())


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
