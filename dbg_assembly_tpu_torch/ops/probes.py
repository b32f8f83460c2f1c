"""The triage probes: seven tiny CUDA kernels (csrc/probe_<name>.cu), their
plain twins and their inputs.

Each probe is the counterpart of one compiler probe of the JAX package's
Mosaic triage (tools/mosaic_triage.py): the same function on the same input,
made as that file makes it.  ``tools/triage.py`` runs them.  A wrapper
launches its kernel for a CUDA tensor (and raises if the launch fails) and
runs the plain version for a CPU tensor; it returns a tuple of outputs.

uint32 data crosses as int32 tensors holding the same bits: torch's uint32
tensors refuse ``+``, ``<<``, ``>>``, ``minimum`` and ``arange`` on the CPU,
so the plain versions compute in int64 masked to 32 bits, the kernels read
the bits as unsigned, and results compare as numpy uint32 (``to_numpy``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from . import build

_M32 = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int

# the C entry point's arguments after the input pointer, before the stream
_SIGS = {"copy_f32": (_P, _I), "copy_u32": (_P, _I), "shift_u32": (_P, _I),
         "two_out_u32": (_P, _P, _I), "grid_block": (_P, _I, _I),
         "bitonic_stage": (_P, _I), "fori_sort_net": (_P, _I, _I)}

# kernel launches per probe since import (or since the caller last reset it)
launches = dict.fromkeys(_SIGS, 0)


def to_torch(x: np.ndarray) -> torch.Tensor:
    """A probe input as a CPU tensor: float32 as is, uint32 as int32 bits."""
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def to_numpy(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """A probe output as numpy, in the dtype of the expectation `like`."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


@functools.cache
def _entry(name: str):
    fn = getattr(build.load("probe_" + name), f"probe_{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, *_SIGS[name], _P]
    return fn


def _on_card(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Checks x; True for a CUDA tensor (launch), False for a CPU one."""
    if x.dtype != dtype or x.dim() != 2:
        raise TypeError(f"expected a 2-D {dtype} tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    on_card = x.is_cuda
    if not (on_card or x.is_cpu):
        raise ValueError(f"probes run on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("probe input must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} elements exceed the kernels' int")
    return on_card


def _launch(name: str, x: torch.Tensor, outs: tuple, *ints: int) -> tuple:
    """Launches probe `name` on the current stream of x's card
    (build.launch); raises if the launch fails."""
    err = build.launch(_entry(name), x.get_device(), x.data_ptr(),
                       *[o.data_ptr() for o in outs], *ints)
    if err != 0:
        raise RuntimeError(f"probe {name} kernel launch failed: CUDA error "
                           f"{err}")
    launches[name] += 1
    return outs


def _u(x: torch.Tensor) -> torch.Tensor:
    """The uint32 values of an int32 bit view, as int64."""
    return x.to(torch.int64) & _M32


def _bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values, taken mod 2^32, back to an int32 bit view."""
    return (((v & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


# ------------------------------------------------------------ copy_f32
def copy_f32_plain(x):
    return (x * 2.0,)


def copy_f32(x):
    """x * 2.0, float32."""
    if not _on_card(x, torch.float32):
        return copy_f32_plain(x)
    return _launch("copy_f32", x, (torch.empty_like(x),), x.numel())


# ------------------------------------------------------------ copy_u32
def copy_u32_plain(x):
    return (_bits(_u(x) + 7),)


def copy_u32(x):
    """x + 7, uint32 (wrapping), on int32 bits."""
    if not _on_card(x, torch.int32):
        return copy_u32_plain(x)
    return _launch("copy_u32", x, (torch.empty_like(x),), x.numel())


# ------------------------------------------------------------ shift_u32
def shift_u32_plain(x):
    v = _u(x)
    return (_bits(((v << 2) | (v >> 30)) ^ v),)


def shift_u32(x):
    """((v << 2) | (v >> 30)) ^ v, uint32, on int32 bits."""
    if not _on_card(x, torch.int32):
        return shift_u32_plain(x)
    return _launch("shift_u32", x, (torch.empty_like(x),), x.numel())


# ------------------------------------------------------------ two_out_u32
def two_out_u32_plain(x):
    v = _u(x)
    return _bits(v + 1), _bits(v * 3)


def two_out_u32(x):
    """(x + 1, x * 3), uint32 (wrapping), on int32 bits."""
    if not _on_card(x, torch.int32):
        return two_out_u32_plain(x)
    return _launch("two_out_u32", x,
                   (torch.empty_like(x), torch.empty_like(x)), x.numel())


# ------------------------------------------------------------ grid_block
def grid_block_plain(x):
    return (x + 1.0,)


def grid_block(x):
    """x + 1.0, float32, one block per 8-row tile (rows % 8 == 0,
    cols <= 1024)."""
    if not _on_card(x, torch.float32):
        return grid_block_plain(x)
    rows, cols = x.shape
    if rows % 8 or cols > 1024:
        raise ValueError(f"grid_block takes rows % 8 == 0 and cols <= 1024, "
                         f"got {tuple(x.shape)}")
    return _launch("grid_block", x, (torch.empty_like(x),), rows, cols)


# ------------------------------------------------------------ bitonic_stage
def bitonic_stage_plain(x):
    v = _u(x)
    a, b = v[:x.shape[0] // 2], v[x.shape[0] // 2:]
    return (_bits(torch.cat([torch.minimum(a, b), torch.maximum(a, b)])),)


def bitonic_stage(x):
    """One compare-exchange, uint32 on int32 bits: the top half of the rows
    gets min(top, bottom), the bottom half max (an even row count)."""
    if not _on_card(x, torch.int32):
        return bitonic_stage_plain(x)
    if x.shape[0] % 2:
        raise ValueError(f"bitonic_stage takes an even row count, got "
                         f"{tuple(x.shape)}")
    return _launch("bitonic_stage", x, (torch.empty_like(x),), x.numel() // 2)


# ------------------------------------------------------------ fori_sort_net
def fori_sort_net_plain(x):
    return (_bits(torch.sort(_u(x), dim=1).values),)


def fori_sort_net(x):
    """Each row sorted ascending as uint32, on int32 bits (row width a power
    of two, 2..1024)."""
    if not _on_card(x, torch.int32):
        return fori_sort_net_plain(x)
    rows, w = x.shape
    if not (2 <= w <= 1024 and w & (w - 1) == 0):
        raise ValueError(f"fori_sort_net takes a power-of-two row width in "
                         f"2..1024, got {tuple(x.shape)}")
    return _launch("fori_sort_net", x, (torch.empty_like(x),), rows, w)


# ------------------------------------------------------------ the registry
def _arange_u32(rows: int, cols: int) -> np.ndarray:
    return np.arange(rows * cols, dtype=np.uint32).reshape(rows, cols)


def _random_u32(seed: int, rows: int, cols: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(rows, cols),
                                                dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class Probe:
    replaces: str                              # the TPU probe, file:line
    make_input: Callable[[], np.ndarray]       # as that probe makes it
    kernel: Callable                           # wrapper: tensor -> tuple
    plain: Callable                            # plain twin: tensor -> tuple
    expect: Callable[[np.ndarray], tuple]      # numpy, as that probe asserts


_T = "tools/mosaic_triage.py"
PROBES = {
    "copy_f32": Probe(
        f"{_T}:34",
        lambda: np.arange(8 * 128, dtype=np.float32).reshape(8, 128),
        copy_f32, copy_f32_plain, lambda x: (x * 2.0,)),
    "copy_u32": Probe(
        f"{_T}:54", lambda: _arange_u32(8, 128), copy_u32, copy_u32_plain,
        lambda x: (x + np.uint32(7),)),
    "shift_u32": Probe(
        f"{_T}:74", lambda: _arange_u32(8, 128), shift_u32, shift_u32_plain,
        lambda x: (((x << 2) | (x >> 30)) ^ x,)),
    "two_out_u32": Probe(
        f"{_T}:98", lambda: _arange_u32(8, 128), two_out_u32,
        two_out_u32_plain, lambda x: (x + np.uint32(1), x * np.uint32(3))),
    "grid_block": Probe(
        f"{_T}:122",
        lambda: np.arange(64 * 256, dtype=np.float32).reshape(64, 256),
        grid_block, grid_block_plain, lambda x: (x + np.float32(1.0),)),
    "bitonic_stage": Probe(
        f"{_T}:146", lambda: _random_u32(0, 16, 128), bitonic_stage,
        bitonic_stage_plain,
        lambda x: (np.concatenate([np.minimum(*np.split(x, 2)),
                                   np.maximum(*np.split(x, 2))]),)),
    "fori_sort_net": Probe(
        f"{_T}:175", lambda: _random_u32(1, 8, 128), fori_sort_net,
        fori_sort_net_plain, lambda x: (np.sort(x, axis=1),)),
}
