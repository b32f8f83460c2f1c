""".cz / .cz.len k-mer frequency tables (counterpart of
dbg_assembly_tpu/io/cz.py).

The 1-bit table is a dense bit array over all 4^k k-mer indices, bit
(7 - idx%8) of byte idx/8 set iff the canonical k-mer idx is above the
low-frequency cutoff, zlib-compressed in source blocks of 8M k-mers = 1 MiB,
plus a text file of each compressed block's byte size
(main_parallel_senior.cpp:71,285-295).  The 8-bit table holds one saturated
count a k-mer in source blocks of 8 MiB (correct_error/main.cpp:48,190-215).

Each block is its own zlib stream, so both directions run the blocks on
the host pool (io/pool.py): one worker a core the process may run on, at
most one a block.  The bytes written are those of a serial loop, whatever
the worker count.
"""

from __future__ import annotations

import itertools
import zlib

import numpy as np

from .. import spans
from . import pool

SRC_BLOCK_KMERS = 8 * 1024 * 1024      # 8M k-mers per compression block


def _write_blocks(path: str, table: np.ndarray, block_bytes: int,
                  level: int) -> None:
    """Deflate ``table`` in source blocks of block_bytes into ``path`` and
    list each compressed block's size in ``path``.len."""
    table = np.ascontiguousarray(table)
    offs = range(0, len(table), block_bytes)
    workers = pool.workers(len(offs))

    def deflate(off):
        return zlib.compress(memoryview(table[off:off + block_bytes]), level)

    sizes = []
    with spans.span("io.cz_write", bytes=len(table), blocks=len(offs),
                    workers=workers):
        with open(path, "wb") as f:
            for comp in pool.in_order(deflate, offs, workers):
                f.write(comp)
                sizes.append(len(comp))
        with open(path + ".len", "w") as f:
            for s in sizes:
                f.write(f"{s}\n")


def write_cz_bits(path: str, bitmap: np.ndarray, level: int = 1) -> None:
    """bitmap: uint8 array of 4^k/8 bytes.  zlib level 1 by default, as the
    JAX package writes it (the consumers read any level)."""
    _write_blocks(path, bitmap, SRC_BLOCK_KMERS // 8, level)


def write_cz_bytes(path: str, freqs: np.ndarray, level: int = 1) -> None:
    """The 8-bit table: freqs, one count a k-mer saturated at 255 (uint8,
    4^k bytes), in source blocks of 8 MiB (correct_error/main.cpp:48,
    190-194)."""
    _write_blocks(path, freqs, SRC_BLOCK_KMERS, level)


def _read_blocks(path: str, out: np.ndarray, block_bytes: int) -> np.ndarray:
    """Inflate each block listed in ``path``.len into ``out`` at
    block_bytes strides."""
    with spans.span("io.cz_read", bytes=len(out)):
        with open(path + ".len") as f:
            sizes = [int(x) for x in f.read().split()]
        with open(path, "rb") as f:
            data = memoryview(f.read())
        ends = list(itertools.accumulate(sizes))
        starts = [0] + ends[:-1]
        workers = pool.workers(len(sizes))
        spans.add(blocks=len(sizes), workers=workers)

        def inflate(i):
            raw = zlib.decompress(data[starts[i]:ends[i]],
                                  bufsize=block_bytes)
            off = i * block_bytes
            out[off:off + len(raw)] = np.frombuffer(raw, dtype=np.uint8)

        for _ in pool.in_order(inflate, range(len(sizes)), workers):
            pass
    return out


def read_cz_bits(path: str, ksize: int) -> np.ndarray:
    """The 1-bit table as 4^k/8 bytes (main_parallel_senior.cpp:285-295)."""
    return _read_blocks(path, np.zeros((1 << (2 * ksize)) // 8, np.uint8),
                        SRC_BLOCK_KMERS // 8)


def read_cz_bytes(path: str, ksize: int) -> np.ndarray:
    """The 8-bit table, one count a k-mer saturated at 255, in source
    blocks of 8 MiB (correct_error/main.cpp:48,190-215)."""
    return _read_blocks(path, np.zeros(1 << (2 * ksize), np.uint8),
                        SRC_BLOCK_KMERS)
