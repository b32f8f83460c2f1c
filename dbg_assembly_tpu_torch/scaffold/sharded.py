"""Read mapping data-parallel over the slots of a mesh, the contig index
copied to each slot.

Counterpart of dbg_assembly_tpu/scaffold/sharded.py.  The reference maps
reads on one thread (map_pair.cpp:152-354) or a round-robin pthread pool
(map_reads.cpp:408-519); the torch mapper (scaffold/index.py) already maps
a batch at a time, and this shards the read batch over the slots.  The
index is replicated: at reference scales it is small next to a card's
memory (E. coli: about 4.4 M k-mers).  The same outputs as the
single-device mapper.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.mesh import blocks
from . import index as six


def replicate(mesh, ix: six.ContigIndex) -> list[six.ContigIndex]:
    """The index's arrays copied once to each slot's device (the same
    tensors where they are there already).  A python engine's numpy index
    goes to the slots as tensors, as JAX's sharded mapper puts an array
    index on its devices (scaffold/sharded.py:55-76)."""
    if ix.engine == "native":
        # the native engine keeps its arrays inside the C++ engine
        raise ValueError("map_reads_sharded needs the torch engine's or "
                         "the python engine's index")

    def tensor(a):
        if ix.engine == "python":
            return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64
                                    else a)
        return a

    return [six.ContigIndex(
        *(tensor(getattr(ix, f)).to(dev) for f in ("kmers", "ids", "pos",
                                                   "direct", "uniq")),
        ix.ksize, *(tensor(getattr(ix, f)).to(dev)
                    for f in ("concat", "offsets", "lengths")))
        for dev in mesh.devices]


def map_reads_sharded(mesh, ix, codes, ascii_seq, lengths,
                      seed_kmer_num: int, min_identity: float,
                      search_start=1) -> six.MapResult:
    """index.map_reads with the read batch cut into D contiguous blocks,
    block d mapped on slot d with that slot's copy of the index; the
    results concatenated in read order.  ix: a ContigIndex, or the
    replicas of one (replicate) to map several batches with."""
    replicas = replicate(mesh, ix) if isinstance(ix, six.ContigIndex) \
        else ix
    n = len(lengths)
    ss = np.asarray(search_start)
    if ss.ndim == 0:
        ss = np.full(n, int(ss), np.int64)
    parts = [six.map_reads(rep, codes[b], ascii_seq[b], lengths[b],
                           seed_kmer_num, min_identity, ss[b])
             for b, rep in zip(blocks(n, mesh.n), replicas)]
    return six.MapResult(*(np.concatenate([getattr(p, f.name) for p in parts])
                           for f in dataclasses.fields(six.MapResult)))
