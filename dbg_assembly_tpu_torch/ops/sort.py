"""Stable key sort: the CUDA one-sweep radix sort (csrc/radix_sort.cu) and
its plain twin.

``sort`` is every key sort of counting and graph ingest.  On a CUDA tensor
it launches the kernel (and raises if a launch fails); on a CPU tensor it
runs ``sort_plain``, the same function in plain PyTorch ops.  It replaces
the TPU kernel sort_u64_via_pallas / sort_pairs
(dbg_assembly_tpu/ops/pallas_sort.py:236 / :194), which computes the
ascending order of u64 keys; this sort is stable and can also return the
permutation.

Contract, for keys [n] contiguous int64:
  * every key is in [0, 2^key_bits) or is the sentinel INT64_MAX
    (ops.chop.SENTINEL);
  * the keys are ordered by their low ``key_bits`` bits (1..63), ties in
    input order.  Callers whose keys can hold the sentinel pass
    key_bits = 2k + 1, so that it sorts after every k-mer (< 2^2k);
  * returns (sorted keys, index or None): index [n] int64 with
    sorted == keys[index], what torch.sort(keys, stable=True).indices gives
    for keys within the contract;
  * the input is not modified.
"""

from __future__ import annotations

import ctypes
import functools

import torch

DIGIT_BITS = 8

# kernel launches since import (or since the caller last reset it)
launches = 0


def _check(keys: torch.Tensor, key_bits: int) -> None:
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits={key_bits} outside 1..63")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError(f"keys must be [n] int64, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C signatures set once."""
    from . import build
    lib = build.load("radix_sort")
    lib.radix_sort_tile.restype = ctypes.c_int
    lib.radix_sort_tile.argtypes = []
    lib.radix_sort_scratch_bytes.restype = ctypes.c_longlong
    lib.radix_sort_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.radix_sort_launch.restype = ctypes.c_int
    lib.radix_sort_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int, *[ctypes.c_void_p] * 6]
    return lib


def tile() -> int:
    """Keys per tile of the kernel's one-sweep passes (needs the build)."""
    return _lib().radix_sort_tile()


def passes(key_bits: int) -> int:
    """Radix passes the kernel makes (8-bit digits)."""
    return -(-key_bits // DIGIT_BITS)


def sort(keys: torch.Tensor, key_bits: int, return_index: bool = False):
    """Stable ascending sort by the low key_bits bits.  Returns
    (sorted keys, index or None)."""
    global launches
    _check(keys, key_bits)
    if keys.device.type == "cpu":
        return sort_plain(keys, key_bits, return_index)
    if keys.device.type != "cuda":
        raise ValueError(f"sort runs on cuda or cpu, not {keys.device}")
    n = keys.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} keys exceed the kernel's 32-bit offsets")
    dev = keys.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev)
                if return_index else None)
    lib = _lib()
    kbuf = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    ibuf = ([torch.empty(n, dtype=torch.int64, device=dev)
             for _ in range(2)] if return_index else [None, None])
    scratch = torch.empty(lib.radix_sort_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.radix_sort_launch(
            keys.data_ptr(), n, key_bits, kbuf[0].data_ptr(),
            kbuf[1].data_ptr(), ibuf[0].data_ptr() if return_index else None,
            ibuf[1].data_ptr() if return_index else None, scratch.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"radix sort kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    out = (passes(key_bits) - 1) & 1
    return kbuf[out], ibuf[out]


def sort_plain(keys: torch.Tensor, key_bits: int, return_index: bool = False):
    """The kernel's function in plain PyTorch ops, on the keys' device.

    ``sort`` runs it for CPU tensors only; on the card it is the reference
    the kernel is checked and timed against."""
    _check(keys, key_bits)
    order = torch.sort(keys & ((1 << key_bits) - 1), stable=True).indices
    return keys[order], (order if return_index else None)
