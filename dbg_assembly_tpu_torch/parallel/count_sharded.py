"""Distributed k-mer counting and graph ingest: owner-sharded tables with
all_to_all routing.

Counterpart of dbg_assembly_tpu/parallel/count_sharded.py, the reference's
key-space sharded hash update (``kmer % threadNum == threadId``,
DBGgraph.cpp:148-150) over the shard slots of a ``mesh.Mesh``.  Per slot:
  1. chop: the chop kernel (ops/chop.py) on the slot's rows, counting mode
     for count_step, edge mode for graph_ingest_step;
  2. route: owner = k-mer mod D (the port's k-mers are int64 >= 0, so this
     is JAX's uint64 mod), no owner for invalid windows; a stable bucketing
     by owner (the radix sort with the index, on the owners' few bits)
     keeps the first ``capacity`` k-mers of each (source, owner) segment,
     as JAX's fixed buffers do, and counts the rest as dropped;
  3. all_to_all: arrivals concatenated in source order, ragged;
  4. owner reduce: the radix sort with the index, then runs (counting, as
     kmer/count.py) or the 2x4 edge counters, counts and the smallest
     stream position (ingest, as contig/graph.py).
Global statistics are the psums of JAX's, returned as Python ints.  Where
JAX returns [D, n] rows masked at their sorted positions (a TPU gather
workaround), the port returns each slot's compact records.

The mesh is a ``mesh.Mesh`` (every slot in this process) or a
``ranks.RankMesh`` (slots spread over processes: the per-slot lists hold
this process's slots, and the exchange and the sums go over
torch.distributed).
"""

from __future__ import annotations

import torch

from ..contig.graph import _chop_with_edges, _node_records
from ..kmer.count import _run_starts
from ..ops import sort as radix
from ..ops.chop import SENTINEL, chop


def _n_valid(lengths: torch.Tensor, ksize: int, P: int) -> int:
    return int((lengths.to(torch.int64) - ksize + 1).clamp(0, P).sum())


def _bucketize(mesh, flat: torch.Tensor, capacity: int, *payload):
    """Stable bucketing of one slot's flat k-mers by owner.  Returns
    (bufs[t] = [keys, *payload] for owner t: the segment's first
    ``capacity`` entries in input order, dropped: how many were not
    kept)."""
    D = mesh.n
    owner = torch.where(flat == SENTINEL, D, flat % D)
    # owners 0..D (D: no owner) in D.bit_length() bits; stable
    so, order = radix.sort(owner, D.bit_length(), return_index=True)
    cnt = torch.bincount(so, minlength=D + 1)[:D].tolist()
    cols = [flat[order]] + [p[order] for p in payload]
    bufs, start, dropped = [], 0, 0
    for t in range(D):
        take = min(cnt[t], capacity)
        bufs.append([c[start:start + take] for c in cols])
        dropped += cnt[t] - take
        start += cnt[t]
    return bufs, dropped


def _exchange(mesh, bufs):
    """all_to_all of every column of the per-slot buckets: returns one
    list of per-owner arrivals a column."""
    n_cols = len(bufs[0][0])
    return [mesh.all_to_all([[b[t][c] for t in range(mesh.n)] for b in bufs])
            for c in range(n_cols)]


def _count_routed(mesh, flats, n_valids, ksize: int, capacity: int):
    """Route each slot's flat k-mers (SENTINEL at invalid windows) to their
    owners and run-length count them there: count_step's tail, shared with
    halo.count_halo_sharded."""
    routed = [_bucketize(mesh, f, capacity) for f in flats]
    recv, = _exchange(mesh, [b for b, _ in routed])
    uniq, counts, n_unique = [], [], []
    for keys in recv:
        sk, _ = radix.sort(keys, 2 * ksize)
        _, starts, run_len = _run_starts(sk, sk.shape[0])
        uniq.append(sk[starts])
        counts.append(run_len)
        n_unique.append(int(starts.shape[0]))
    return uniq, counts, n_unique, _stats(mesh, n_valids, n_unique, routed)


def count_step(codes, lengths, *, ksize: int, mesh, capacity: int):
    """One distributed counting step over reads sharded on the batch axis
    (codes, lengths: per-slot lists, mesh.shard_batch).

    Returns per slot (uniq int64 ascending, counts int64, n_unique) and a
    dict of global ints: total_kmers (valid windows), unique_kmers,
    dropped (k-mers past a segment's capacity: the counts are then
    inexact)."""
    flats, n_valids = [], []
    for c, ln in zip(codes, lengths):
        kmers, _, _ = chop(c, ln, ksize)
        flats.append(kmers.reshape(-1))
        n_valids.append(_n_valid(ln, ksize, kmers.shape[1]))
    return _count_routed(mesh, flats, n_valids, ksize, capacity)


def graph_ingest_step(codes, lengths, base_index: int = 0, *, ksize: int,
                      mesh, capacity: int):
    """Distributed de Bruijn graph ingest, the multi-slot version of the
    contig stage's node-table build.  Each slot chops canonical k-mers with
    their strand-adjusted neighbour codes (DBGgraph.cpp:76-89), routes the
    k-mer, its codes and its stream position to the owner, which
    segment-sums the eight edge counters and takes the run's smallest
    position.  Window j of global slot d's row block has the position
    base_index + d * n_local + j, so the merged table equals the
    single-device builder's, the insertion-order field included: arrivals
    keep source order and every sort is stable, so a run's head holds the
    smallest.

    Returns per slot (uniq int64 ascending, lcnt [M, 4] int32, rcnt [M, 4]
    int32 (unclipped), first_idx int64, counts int32, n_unique) and the
    global ints of count_step."""
    flats, n_valids = [], []
    for d, (c, ln) in enumerate(zip(codes, lengths), mesh.first_slot):
        kmers, left, right = _chop_with_edges(c, ln, ksize)
        n_local = kmers.numel()
        pos = base_index + d * n_local + torch.arange(
            n_local, dtype=torch.int64, device=kmers.device)
        flats.append((kmers.reshape(-1), left.reshape(-1),
                      right.reshape(-1), pos))
        n_valids.append(_n_valid(ln, ksize, kmers.shape[1]))
    routed = [_bucketize(mesh, f[0], capacity, *f[1:]) for f in flats]
    r_keys, r_left, r_right, r_pos = _exchange(mesh, [b for b, _ in routed])
    out = [[] for _ in range(6)]
    for keys, left, right, pos in zip(r_keys, r_left, r_right, r_pos):
        sk, order = radix.sort(keys, 2 * ksize, return_index=True)
        uniq, lcnt, rcnt, head, counts = _node_records(sk, order, left,
                                                       right)
        for lst, v in zip(out, (uniq, lcnt, rcnt, pos[head], counts,
                                int(uniq.shape[0]))):
            lst.append(v)
    return (*out, _stats(mesh, n_valids, out[5], routed))


def _stats(mesh, n_valids, n_unique, routed) -> dict:
    """The step's global ints (JAX's psums): summed over this process's
    slots, then over the mesh's processes."""
    total, unique, dropped = mesh.sum_ints(
        sum(n_valids), sum(n_unique), sum(d for _, d in routed))
    return {"total_kmers": total, "unique_kmers": unique, "dropped": dropped}


def default_capacity(n_reads: int, read_len: int, ksize: int,
                     n_dev: int, slack: float = 1.25) -> int:
    """Bucket capacity of one (source, owner) segment for a balanced route.

    The expected load of a segment is kmers/slot/n_dev with a 25% slack,
    JAX's rule.  Canonical k-mers are far from uniform mod n_dev (at
    n_dev = 4 the owner is the last base of the smaller strand), so a
    real library's batch can overflow this; the exact wrappers below
    double on overflow, as JAX's do."""
    per_dev = -(-n_reads // n_dev) * max(read_len - ksize + 1, 1)
    return int(per_dev / n_dev * slack) + 64


def _run_exact(step_fn, codes, lengths, *, ksize, mesh, capacity,
               max_doublings, stats_index):
    """Retry on overflow, shared by the exact wrappers.

    The reference degrades by IGNORING input once its hash fills
    (DBGgraph.cpp:337-351, policy in main.cpp:66-70) and at least alerts;
    silent undercounting is worse than either, so a step whose dropped
    count is nonzero is run again at double the capacity until exact."""
    for attempt in range(max_doublings + 1):
        out = step_fn(codes, lengths, ksize=ksize, mesh=mesh,
                      capacity=capacity)
        stats = out[stats_index]
        dropped = stats["dropped"]
        stats["capacity"] = capacity
        stats["capacity_doublings"] = attempt
        if dropped == 0:
            return out
        capacity *= 2
    raise RuntimeError(
        f"k-mer route still overflowing after {max_doublings} capacity "
        f"doublings (capacity={capacity}, dropped={dropped}); input is "
        "pathologically skewed — shard by hashed key instead of raw mod")


def _rows(codes, mesh) -> tuple[int, int]:
    """(rows over every slot of the mesh, row width) of per-slot code
    blocks: JAX's global batch shape, whatever process holds the rows."""
    rows, = mesh.sum_ints(sum(c.shape[0] for c in codes))
    return rows, codes[0].shape[1]


def count_step_exact(codes, lengths, *, ksize: int, mesh,
                     capacity: int | None = None, max_doublings: int = 6):
    """count_step that never undercounts; stats also carries the final
    'capacity' and the 'capacity_doublings' it took."""
    if capacity is None:
        capacity = default_capacity(*_rows(codes, mesh), ksize, mesh.n)
    return _run_exact(count_step, codes, lengths, ksize=ksize, mesh=mesh,
                      capacity=capacity, max_doublings=max_doublings,
                      stats_index=3)


def graph_ingest_step_exact(codes, lengths, base_index: int = 0, *,
                            ksize: int, mesh, capacity: int | None = None,
                            max_doublings: int = 6):
    """graph_ingest_step that never drops (see count_step_exact)."""
    if capacity is None:
        capacity = default_capacity(*_rows(codes, mesh), ksize, mesh.n)

    def step(codes, lengths, **kw):
        return graph_ingest_step(codes, lengths, base_index, **kw)

    return _run_exact(step, codes, lengths, ksize=ksize, mesh=mesh,
                      capacity=capacity, max_doublings=max_doublings,
                      stats_index=6)
