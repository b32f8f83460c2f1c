"""The correction k-mer table sharded over the slots of a mesh.

Counterpart of dbg_assembly_tpu/correct/sharded.py (SURVEY P4).  The
reference loads the whole 1-bit table into one host's RAM
(correct_error/main.cpp:163-173: 2 GiB at k = 17) and every thread probes
it.  Here the table's words are cut into D slots of whole 32-bit words
(zero padding), slot d holding the canonical-index range [d*4^k/D,
(d+1)*4^k/D) on its device, and every probe is a collective: the queries
go to every slot, each answers the indices it owns (zero elsewhere), and
the sum of the answers returns to the asker.  The traffic is the queries
and the answers; the table never moves.

The device engine (correct/device.py) reads the table only through
``words[word_index]``, so a ``SlotTable``, whose indexing is that
collective gather for the reads of one slot, runs the engine unchanged: a
one-word probe reads one word, which lies on one slot.  JAX keeps the
slots' beam loops in lockstep (``global_any``) because a collective inside
them must be entered by every device; one controller lets each slot's loop
stop on its own, and since inactive lanes are no-ops the outputs are the
single-device engine's either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as meshmod
from . import device as dev


def shard_bitmap(mesh, bitmap: np.ndarray) -> list[torch.Tensor]:
    """The packed 1-bit table as D equal slots of little-endian 32-bit
    words (int32 tensors, device.bitmap_device's layout), slot d on its
    device.  Padding bytes are zero (absent k-mers), and canonical k-mer
    indices never reach them."""
    pad = (-len(bitmap)) % (4 * mesh.n)
    if pad:
        bitmap = np.concatenate([bitmap, np.zeros(pad, np.uint8)])
    words = np.ascontiguousarray(bitmap).view("<i4")
    return [torch.from_numpy(w).to(d) for w, d in
            zip(np.split(words, mesh.n), mesh.devices)]


def _words_here(shard: torch.Tensor, base: int, widx: torch.Tensor):
    """The words a slot owns among widx (table words base..base+W), zero
    at the others."""
    W = shard.shape[0]
    local = widx - base
    mine = (local >= 0) & (local < W)
    return torch.where(mine, shard[local.clamp(0, W - 1)], 0)


class SlotTable:
    """The sharded table as slot ``slot``'s reads see it: ``self[widx]``
    gathers table words (int32, any index shape) by a collective over
    every slot, on the slot's device."""

    def __init__(self, mesh, shards: list[torch.Tensor], slot: int):
        self.mesh = mesh
        self.shards = shards
        self.slot = slot
        self.device = mesh.devices[slot]

    def __getitem__(self, widx: torch.Tensor) -> torch.Tensor:
        W = self.shards[0].shape[0]
        qs = meshmod.broadcast(self.mesh, widx, self.slot)
        return meshmod.reduce(
            self.mesh, [_words_here(sh, t * W, q) for t, (sh, q) in
                        enumerate(zip(self.shards, qs))], self.slot)


def probe_collective(mesh, shards: list[torch.Tensor],
                     idx: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every slot's k-mer indices (int64, any shape) probed at once, as
    JAX's probe_collective inside shard_map: the queries all_gathered,
    each slot answering the bits it owns, psum_scatter returning each
    slot its own.  Returns per slot bool of its idx's shape, the bits
    device._probe returns against the whole table."""
    W = shards[0].shape[0]
    flat = [i.reshape(-1) for i in idx]
    allq = meshmod.all_gather(mesh, flat)
    bits = []
    for t, (sh, q) in enumerate(zip(shards, allq)):
        # a word this slot does not own reads as 0: no bit
        w = _words_here(sh, t * W, q >> 5)
        bits.append(dev._word_bit(w, q))
    out = meshmod.psum_scatter(mesh, bits, [f.shape[0] for f in flat])
    return [o.bool().reshape(i.shape) for o, i in zip(out, idx)]


def _shard_rows(mesh, ascii_np, codes_np, lengths_np):
    """The read batch padded to a multiple of D rows (codes 4, length 0)
    and cut into D contiguous blocks, one a slot."""
    d = mesh.n
    pad = (-len(lengths_np)) % d
    if pad:
        ascii_np = np.concatenate(
            [ascii_np, np.zeros((pad, ascii_np.shape[1]), ascii_np.dtype)])
        codes_np = np.concatenate(
            [codes_np, np.full((pad, codes_np.shape[1]), 4, codes_np.dtype)])
        lengths_np = np.concatenate(
            [lengths_np, np.zeros(pad, lengths_np.dtype)])
    return zip(np.split(ascii_np, d), np.split(codes_np, d),
               np.split(np.asarray(lengths_np, np.int32), d))


def correct_batch_sharded(mesh, ascii_np, codes_np, lengths_np, shards,
                          params):
    """The whole 5-phase device corrector with the reads data-parallel over
    the slots and the table sharded: stage A, the phase-4 gap waves and
    phase 5 (correct.cpp:146-334), every table probe a collective.  Equal
    to device.correct_batch_device on the same batch.  Returns numpy (one,
    multi, deleted, trim_left, trim_right, ascii_mod, fallback)."""
    n = len(lengths_np)
    outs = [dev.correct_batch_device(a, c, ln, SlotTable(mesh, shards, s),
                                     params)
            for s, (a, c, ln) in enumerate(_shard_rows(
                mesh, ascii_np, codes_np, lengths_np))]
    return tuple(np.concatenate(o)[:n] for o in zip(*outs))


def stage_a_sharded(mesh, ascii_np, codes_np, lengths_np, shards, *, k: int,
                    m: int, max_change: int):
    """Stage A of the device corrector with the reads data-parallel over
    the slots and the table sharded, never replicated.  Returns numpy
    outputs trimmed to the batch, equal to device._stage_a's."""
    n = len(lengths_np)
    outs = []
    for s, (a, c, ln) in enumerate(_shard_rows(mesh, ascii_np, codes_np,
                                               lengths_np)):
        d = mesh.devices[s]
        res = dev._stage_a(torch.from_numpy(a).to(d),
                           torch.from_numpy(c).to(d),
                           torch.from_numpy(ln).to(d),
                           SlotTable(mesh, shards, s), k=k, m=m,
                           max_change=max_change)
        outs.append([t.cpu().numpy() for t in res])
    return tuple(np.concatenate(o)[:n] for o in zip(*outs))
