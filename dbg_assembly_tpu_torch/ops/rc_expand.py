"""Reverse-complement expand of the 1-bit k-mer table: the CUDA kernel
(csrc/rc_expand.cu) and its plain twin.

``rc_expand`` ORs into the table, for every set bit i, the bit of the
reverse complement of i: the consumer-side step of the 1-bit table
(main_parallel_senior.cpp:310-329), which the JAX package and the host
paths take in numpy (kmer/count.py ``expand_bitmap_rc``).  The table is
correct/device.py ``bitmap_device``'s: 4^k/32 int32 words, bit p of word w
being table bit 32w + (p ^ 7) (``_word_bit``).

On a CUDA tensor the kernel expands the words in place (no second buffer
of 4^k/8 bytes on the card) and ``rc_expand`` returns them.  On a CPU
tensor ``rc_expand_plain`` returns a new tensor and leaves ``words`` as it
was: on the CPU ``bitmap_device`` shares memory with the numpy array the
table was read into.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import dna
from . import build

MAX_K = 31

# kernel launches since import (or since the caller last reset it)
launches = 0


def _check(words: torch.Tensor, ksize: int) -> None:
    if not 3 <= ksize <= MAX_K:
        raise ValueError(f"k={ksize} outside 3..{MAX_K} (the table must be "
                         "whole 32-bit words)")
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError(f"words must be [n] int32, got {words.dtype} "
                        f"{tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.numel() != 1 << (2 * ksize - 5):
        raise ValueError(f"{words.numel()} words, but a k={ksize} table "
                         f"has 4^k/32 = {1 << (2 * ksize - 5)}")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C signature set once."""
    lib = build.load("rc_expand")
    lib.rc_expand_launch.restype = ctypes.c_int
    lib.rc_expand_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]
    return lib


def rc_expand(words: torch.Tensor, ksize: int) -> torch.Tensor:
    """The table with its reverse-complement bits set: ``words`` itself,
    expanded in place, on the card; a new tensor on the CPU."""
    global launches
    _check(words, ksize)
    if words.device.type == "cpu":
        return rc_expand_plain(words, ksize)
    if words.device.type != "cuda":
        raise ValueError(f"rc_expand runs on cuda or cpu, not "
                         f"{words.device}")
    err = build.launch(_lib().rc_expand_launch, words.get_device(),
                       words.data_ptr(), words.numel(), ksize)
    if err != 0:
        raise RuntimeError(f"rc_expand kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return words


def rc_expand_plain(words: torch.Tensor, ksize: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on the words' device,
    out of place: the set bits of the nonzero words as indices, their
    reverse complements, the distinct target bits summed into a mask a
    target word (distinct bits sum to their OR), ORed into a copy.

    ``rc_expand`` runs it for CPU tensors only; on the card it is the
    reference the kernel is checked and timed against."""
    _check(words, ksize)
    out = words.clone()
    nz = torch.nonzero(words).flatten()
    if nz.numel() == 0:
        return out
    pos = torch.arange(32, dtype=torch.int32, device=words.device)
    rows, p = torch.nonzero((words[nz, None] >> pos) & 1, as_tuple=True)
    rc = torch.unique(dna.revcomp_kbit(nz[rows] * 32 + (p ^ 7), ksize))
    target, inv = torch.unique_consecutive(rc >> 5, return_inverse=True)
    mask = torch.zeros(target.numel(), dtype=torch.int64,
                       device=words.device).index_add_(
        0, inv, 1 << ((rc & 31) ^ 7))
    # the mask's bit 31 as int32's sign bit
    out[target] |= torch.where(mask >= 1 << 31, mask - (1 << 32),
                               mask).to(torch.int32)
    return out
