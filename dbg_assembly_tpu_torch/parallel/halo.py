"""Sequence-axis sharding with a (k-1)-base halo exchange.

Counterpart of dbg_assembly_tpu/parallel/halo.py.  The reference never
splits a sequence (its longest unit is one read, DBGgraph.cpp:63); here a
few long sequences (multi-megabase contigs re-indexed for scaffolding, long
reads) are sharded along the BASE axis over the mesh's slots, and the
windows that straddle a tile boundary are completed by fetching the next
tile's first k-1 bases from the ring neighbour (``ppermute``).

The chop kernel needs no mode of its own: tile i of width T, extended by
the halo, is chopped with the lengths clamp(len - i*T, 0, T + k - 1), so
its window p is valid exactly when i*T + p <= len - k, JAX's mask.  The
chopped k-mers come out sharded on the same axis and feed the owner-routed
counter of count_sharded.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chop import chop
from . import mesh as meshmod
from .count_sharded import _count_routed


def _halo_extend(mesh, tiles, ksize: int):
    """Each tile with the ring-next slot's first k-1 columns appended."""
    T = tiles[0].shape[1]
    if T < ksize - 1:
        raise ValueError(
            f"per-device tile of {T} bases is narrower than the k-1="
            f"{ksize - 1} halo; a window could straddle >2 tiles.  Pad "
            "sequences so L/n_devices >= k-1 (pad_seqs_for_mesh does).")
    D = mesh.n
    halo = meshmod.ppermute(mesh, [t[:, :ksize - 1] for t in tiles],
                            [((j + 1) % D, j) for j in range(D)])
    return [torch.cat([t, h], dim=1) for t, h in zip(tiles, halo)]


def _tile_lengths(lengths: torch.Tensor, i: int, T: int, ksize: int):
    return (lengths.to(torch.int64) - i * T).clamp(0, T + ksize - 1).to(
        torch.int32)


def _shard_bases(mesh, codes, lengths):
    """codes [B, L] cut into D tiles along the base axis (L divisible by
    D), tile i on slot i's device; lengths on every slot."""
    codes = torch.as_tensor(np.ascontiguousarray(codes))
    lengths = torch.as_tensor(np.ascontiguousarray(lengths, np.int32))
    if codes.shape[1] % mesh.n:
        raise ValueError(f"sequence axis {codes.shape[1]} does not divide "
                         f"into {mesh.n} tiles; pad_seqs_for_mesh first")
    tiles = [t.contiguous().to(d) for t, d in
             zip(codes.tensor_split(mesh.n, dim=1), mesh.devices)]
    return tiles, [lengths.to(d) for d in mesh.devices]


def _chop_tiles(mesh, codes, lengths, ksize: int):
    """Per slot: (canonical k-mers [B, T] of the tile's windows, SENTINEL
    where invalid; the slot's valid windows)."""
    tiles, lens = _shard_bases(mesh, codes, lengths)
    T = tiles[0].shape[1]
    out = []
    for i, (ext, ln) in enumerate(zip(_halo_extend(mesh, tiles, ksize),
                                      lens)):
        tl = _tile_lengths(ln, i, T, ksize)
        kmers, _, _ = chop(ext, tl, ksize)
        out.append((kmers, int((tl.to(torch.int64) - ksize + 1)
                               .clamp(0, T).sum())))
    return out


def halo_chop(codes, lengths, *, ksize: int, mesh):
    """Canonical k-mer chop of base-axis-sharded sequences.

    codes   [B, L] 2-bit codes, L divisible by the mesh size;
    lengths [B] true sequence lengths.
    Returns per slot the [B, T] int64 canonical k-mers of its tile, T =
    L / D: slot i's (b, p) is the k-mer starting at base i*T + p of
    sequence b, SENTINEL where i*T + p > lengths[b] - k."""
    return [k for k, _ in _chop_tiles(mesh, codes, lengths, ksize)]


def count_halo_sharded(codes, lengths, *, ksize: int, mesh, capacity: int):
    """Distributed counting of base-axis-sharded long sequences: halo chop,
    owner routing by all_to_all, sort and run-length reduce per owner.
    Mirrors count_sharded.count_step, which shards over READS; this
    shards over the BASES of few long sequences.  Returns what count_step
    returns."""
    chopped = _chop_tiles(mesh, codes, lengths, ksize)
    return _count_routed(mesh, [k.reshape(-1) for k, _ in chopped],
                         [n for _, n in chopped], ksize, capacity)


def pad_seqs_for_mesh(seqs: list[np.ndarray], n_dev: int,
                      ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length code vectors into [B, L] with L a multiple of
    n_dev (padding base 0 = 'A'; masked out by ``lengths``)."""
    lengths = np.array([len(s) for s in seqs], np.int32)
    # each tile must hold >= k-1 bases so one ring-neighbour halo completes
    # every straddling window
    L = int(max(lengths.max(), ksize, n_dev * (ksize - 1)))
    L = -(-L // n_dev) * n_dev
    out = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths
