"""Canonical k-mer chop: the CUDA kernel (csrc/chop.cu) and its plain twin.

``chop`` is the one chop of counting and graph ingest.  On a CUDA tensor it
launches the kernel (and raises if the launch fails); on a CPU tensor it runs
``chop_plain``, the same function in plain PyTorch ops.  It replaces the TPU
kernel chop_canonical_pallas (dbg_assembly_tpu/ops/pallas_chop.py:81) and
graph._chop_with_edges (dbg_assembly_tpu/contig/graph.py:48).

Outputs, for codes [N, L] uint8 and lengths [N] int32, P = L - k + 1:
  kmers [N, P] int64   canonical k-mer (fwd when fwd <= rc), SENTINEL at
                       windows j >= len - k + 1;
  left, right [N, P] uint8 (edges=True only)  strand-adjusted neighbour
                       codes 0..3, 4 at a read edge and at invalid windows.
Codes inside a read are 0..3 (the k-mer alphabet maps N to 0); a larger code
there is read as its low two bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SENTINEL = torch.iinfo(torch.int64).max
MAX_K = 31
# shared memory a block of the kernel takes at most (the default limit,
# about four blocks an SM) and the most rows a tile takes (64 measured best
# at the main path's shapes on the H100, PERF.md section 6)
SMEM_BUDGET = 48 * 1024
MAX_TILE_ROWS = 64

# kernel launches since import (or since the caller last reset it)
launches = 0


def _round16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(rows: int, pw: int, L: int, ksize: int) -> int:
    """Dynamic shared memory of one block for a tiling (csrc/chop.cu
    Layout): two code buffers, two lengths buffers and the packed codes."""
    span = rows * L if pw == L - ksize + 1 else pw + ksize + 1
    raw = _round16(span + 15) + 16
    return 2 * raw + 2 * _round16(4 * rows) + _round16(raw // 4 + 16)


@functools.cache
def tile_plan(L: int, ksize: int) -> tuple[int, int]:
    """(rows, pw) of the kernel's tiles for rows of L codes.  pw = P: tile t
    is rows [t * rows, (t + 1) * rows) (a multiple of 16 rows where 16 fit).
    pw < P: rows too long for one block's shared memory; tile t is windows
    [s * pw, (s + 1) * pw) of row t // S, s = t % S, S = ceil(P / pw)
    segments a row (pw a multiple of 16)."""
    P = L - ksize + 1
    if P < 1:
        raise ValueError(f"no windows: L={L}, k={ksize}")
    rows = 0
    while (rows < MAX_TILE_ROWS
           and smem_bytes(rows + 1, P, L, ksize) <= SMEM_BUDGET):
        rows += 1
    if rows >= 16:
        return rows // 16 * 16, P
    if rows >= 1:
        return rows, P
    pw = 16
    while smem_bytes(1, pw + 16, L, ksize) <= SMEM_BUDGET:
        pw += 16
    return 1, pw


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C signatures set once."""
    lib = build.load("chop")
    lib.chop_launch.restype = ctypes.c_int
    lib.chop_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.chop_smem_bytes.restype = ctypes.c_int
    lib.chop_smem_bytes.argtypes = [ctypes.c_int] * 4
    return lib


def _check(codes: torch.Tensor, lengths: torch.Tensor, ksize: int) -> int:
    if not 1 <= ksize <= MAX_K:
        raise ValueError(f"k={ksize} outside 1..{MAX_K} (2k bits must fit "
                         "a non-negative int64)")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be [N, L] uint8, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != codes.shape[:1]:
        raise TypeError(f"lengths must be [N] int32, got {lengths.dtype} "
                        f"{tuple(lengths.shape)}")
    if lengths.device != codes.device:
        raise ValueError(f"codes on {codes.device}, lengths on "
                         f"{lengths.device}")
    return max(codes.shape[1] - ksize + 1, 0)


def chop(codes: torch.Tensor, lengths: torch.Tensor, ksize: int,
         edges: bool = False):
    """Returns (kmers, left, right); left/right are None unless edges."""
    global launches
    P = _check(codes, lengths, ksize)
    if codes.device.type == "cpu":
        return chop_plain(codes, lengths, ksize, edges)
    if codes.device.type != "cuda":
        raise ValueError(f"chop runs on cuda or cpu, not {codes.device}")
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    N, L = codes.shape
    kmers = torch.empty((N, P), dtype=torch.int64, device=codes.device)
    left = right = None
    if edges:
        left = torch.empty((N, P), dtype=torch.uint8, device=codes.device)
        right = torch.empty((N, P), dtype=torch.uint8, device=codes.device)
    if N == 0 or P == 0:
        return kmers, left, right
    rows, pw = tile_plan(L, ksize)
    err = build.launch(
        _lib().chop_launch, codes.get_device(), codes.data_ptr(),
        lengths.data_ptr(), N, L, ksize, rows, pw, kmers.data_ptr(),
        left.data_ptr() if edges else None,
        right.data_ptr() if edges else None, int(edges))
    if err != 0:
        raise RuntimeError(f"chop kernel launch failed: CUDA error {err}")
    launches += 1
    return kmers, left, right


def chop_plain(codes: torch.Tensor, lengths: torch.Tensor, ksize: int,
               edges: bool = False):
    """The kernel's function in plain PyTorch ops, on the tensors' device.

    ``chop`` runs it for CPU tensors only; on the card it is the reference
    the kernel is checked and timed against."""
    P = _check(codes, lengths, ksize)
    N = codes.shape[0]
    dev = codes.device
    c = codes.to(torch.int64) & 3
    fwd = torch.zeros((N, P), dtype=torch.int64, device=dev)
    rc = torch.zeros((N, P), dtype=torch.int64, device=dev)
    top = 2 * (ksize - 1)
    for i in range(ksize):
        ci = c[:, i:i + P]
        fwd = (fwd << 2) | ci
        rc = (rc >> 2) | ((3 - ci) << top)
    use_fwd = fwd <= rc
    pos = torch.arange(P, device=dev)[None, :]
    jlen = lengths.to(torch.int64)[:, None]
    valid = pos < jlen - ksize + 1
    kmers = torch.where(valid, torch.where(use_fwd, fwd, rc), SENTINEL)
    if not edges:
        return kmers, None, None
    four = torch.tensor(4, dtype=torch.int64, device=dev)
    # left neighbour of window j is base j-1, right neighbour base j+k; a
    # base past the row (a read longer than L) reads as code 0, as in
    # graph._chop_with_edges
    zeros = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    lshift = torch.cat([zeros, c[:, :max(P - 1, 0)]], dim=1)[:, :P]
    rshift = torch.cat([c[:, ksize:ksize + P], zeros], dim=1)[:, :P]
    has_left = pos > 0
    has_right = pos < jlen - ksize
    left = torch.where(use_fwd, torch.where(has_left, lshift, four),
                       torch.where(has_right, 3 - rshift, four))
    right = torch.where(use_fwd, torch.where(has_right, rshift, four),
                        torch.where(has_left, 3 - lshift, four))
    left = torch.where(valid, left, four).to(torch.uint8)
    right = torch.where(valid, right, four).to(torch.uint8)
    return kmers, left, right
