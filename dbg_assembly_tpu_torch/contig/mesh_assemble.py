"""Mesh-sharded contig stage: pruning and pointer doubling over a node table
sharded by k-mer owner.

Counterpart of dbg_assembly_tpu/contig/mesh_assemble.py.  The reference
prunes and reads contigs out by serial hash-pointer chasing on one host
(DBG_contig/contig.cpp:832-896); the single-device doubling readout
(pointer_doubling.py) replaced the walks with bulk programs, and this
module runs those bulk programs over the slots of a ``parallel.mesh.Mesh``:

  * table residency: the sorted node table sharded by owner (kmer mod D,
    the rule of the distributed ingest), each slot holding its sorted rows
    and their global row ids;
  * table search (the bulk exist_kmerset, kmerSet.cpp:280-302): the query
    batch is all_gathered, every slot answers the k-mers it owns (a local
    searchsorted), and psum_scatter returns each slot its answers; the
    table never moves;
  * link pass (calculate_kmer_links, contig.cpp:107-205): local counter
    math on every slot, the depth histogram psummed;
  * chain resolution: pointer doubling over the successor array cut into
    blocks, each round all_gathering the jump tables.

The host keeps the mutable flag mirrors (deleted, linear), replays the
pruning decisions and assembles the sequences, as in JAX.  MeshGraph
changes only HOW the bulk steps run, never a decision, so the files equal
the single-device doubling readout's, byte for byte.  Slots are ragged
(no pad rows, no padded queries): JAX pads both for XLA's static shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as meshmod
from .graph import NodeTable
from .pointer_doubling import _Graph
from .refassemble import AssembleParams


def _search_sharded(mesh, km_sh, gid_sh, queries):
    """Collective table search: per-slot query blocks (int64 k-mers) ->
    per-slot global row ids, -1 where absent.  km_sh/gid_sh: each slot's
    sorted k-mers and their rows in the sorted table."""
    allq = meshmod.all_gather(mesh, queries)
    ans = []
    for km, gid, q in zip(km_sh, gid_sh, allq):
        if km.shape[0] == 0:
            ans.append(torch.zeros_like(q))
            continue
        idx = torch.searchsorted(km, q).clamp_(max=km.shape[0] - 1)
        ans.append(torch.where(km[idx] == q, gid[idx] + 1, 0))
    out = meshmod.psum_scatter(mesh, ans, [q.shape[0] for q in queries])
    return [o - 1 for o in out]


def _links_sharded(mesh, lcnt_sh, rcnt_sh, cut: int):
    """calculate_kmer_links' counter math on every slot: per slot (l_num,
    r_num, l_base, r_base), and the psummed 256-bin depth histogram."""

    def one_side(c):
        q = c > cut
        num = q.sum(1).clamp(max=3).to(torch.int32)
        # the first maximum, as the native pass's strict '>' scan
        base = torch.where(q, c, 0).argmax(1).to(torch.int32)
        return num, base

    per, hists = [], []
    for lc, rc in zip(lcnt_sh, rcnt_sh):
        l_num, l_base = one_side(lc)
        r_num, r_base = one_side(rc)
        per.append((l_num, r_num, l_base, r_base))
        hists.append(torch.bincount(lc.reshape(-1), minlength=256)
                     + torch.bincount(rc.reshape(-1), minlength=256))
    return per, meshmod.psum(mesh, hists)[0]


def _resolve_sharded(mesh, succ, n_real: int, rounds: int):
    """Pointer doubling over a successor array cut into per-slot blocks
    (STOP encoded as n_real).  Each round all_gathers the (e, r) jump
    tables and advances the local block: dense collectives only.  Returns
    per slot (end, dist, cyclic) as pointer_doubling._resolve_chains."""
    offs = np.cumsum([0] + [s.shape[0] for s in succ])
    e, r = [], []
    for s, off in zip(succ, offs):
        stop = s >= n_real
        mine = off + torch.arange(s.shape[0], dtype=torch.int64,
                                  device=s.device)
        e.append(torch.where(stop, mine, s))
        r.append((~stop).to(torch.int64))
    for _ in range(rounds):
        eg = meshmod.all_gather(mesh, e)
        rg = meshmod.all_gather(mesh, r)
        r = [ri + g[ei] for ri, ei, g in zip(r, e, rg)]
        e = [g[ei] for ei, g in zip(e, eg)]
    sg = meshmod.all_gather(mesh, succ)
    cyclic = [g[ei.clamp(max=n_real - 1)] < n_real for ei, g in zip(e, sg)]
    return e, [ri + 1 for ri in r], cyclic


def _split(mesh, a: np.ndarray):
    """a cut into D contiguous blocks, block d on slot d's device."""
    return [torch.from_numpy(np.ascontiguousarray(a[b])).to(d) for b, d in
            zip(meshmod.blocks(len(a), mesh.n), mesh.devices)]


def _join(parts) -> np.ndarray:
    return np.concatenate([p.cpu().numpy() for p in parts])


class MeshGraph(_Graph):
    """_Graph whose O(M) bulk steps run on the slots of a mesh.

    Overrides _search (the sharded collective table search), _links_bulk
    (the sharded counter pass) and resolve_chains (sharded pointer
    doubling).  Every pruning and readout decision is inherited, so the
    outputs equal the single-device doubling path's."""

    def __init__(self, table: NodeTable, params: AssembleParams, mesh):
        super().__init__(table, params, mesh.devices[0])
        self.mesh = mesh
        D = mesh.n
        kmers = self.kmers                      # [M] sorted (incl. poly-A)
        owner = (kmers % np.uint64(D)).astype(np.int64)
        order = np.argsort(owner, kind="stable")   # per owner, still sorted
        bounds = np.cumsum([0] + np.bincount(owner, minlength=D).tolist())
        self._gid = [order[bounds[d]:bounds[d + 1]] for d in range(D)]
        self._km_sh, self._gid_sh, self._lcnt_sh, self._rcnt_sh = (
            [torch.from_numpy(np.ascontiguousarray(src[rows])).to(dev)
             for rows, dev in zip(self._gid, mesh.devices)]
            for src in (kmers.view(np.int64), np.arange(self.M),
                        self.lcnt, self.rcnt))

    def _search(self, nf: np.ndarray) -> np.ndarray:
        if len(nf) == 0:
            return np.zeros(0, np.int64)
        q = _split(self.mesh, np.asarray(nf, np.uint64).view(np.int64))
        return _join(_search_sharded(self.mesh, self._km_sh, self._gid_sh,
                                     q))

    def _links_bulk(self):
        per, hist = _links_sharded(self.mesh, self._lcnt_sh, self._rcnt_sh,
                                   int(self.p.kmer_freq_cutoff))
        out = [np.zeros(self.M, np.int32) for _ in range(4)]
        for rows, vals in zip(self._gid, per):
            for o, v in zip(out, vals):
                o[rows] = v.cpu().numpy()
        return (*out, hist.cpu().numpy())

    def resolve_chains(self, succ: np.ndarray):
        n_real = len(succ)
        rounds = int(np.ceil(np.log2(max(n_real, 2)))) + 1
        e, dist, cyc = _resolve_sharded(self.mesh, _split(self.mesh, succ),
                                        n_real, rounds)
        return _join(e), _join(dist), _join(cyc)


def assemble_doubling_mesh(table: NodeTable, params: AssembleParams,
                           prefix: str, mesh):
    """assemble_doubling with the bulk steps on the slots of ``mesh``
    (links -> tips -> low edges -> bubbles -> doubling readout, phase order
    per contig.cpp:54-102): the same artifacts as the single-device
    doubling readout."""
    from . import pointer_doubling as pd
    g = MeshGraph(table, params, mesh)
    g.calc_links()
    g.write_kmer_freq(prefix + ".contig.kmer.freq")
    if params.is_remove_tip:
        pd.remove_tips(g, prefix + ".contig.tip.fa")
    if params.is_remove_lowedge:
        pd.remove_lowedges(g, prefix + ".contig.lowedge.fa")
    if params.is_remove_bubble:
        pd.remove_bubbles(g, prefix + ".contig.bubble.fa")
    pd.read_out_contigs(g, prefix)
    return g.stats
