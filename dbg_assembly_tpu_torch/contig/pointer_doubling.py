"""The scalable contig readout: bulk pruning + pointer-doubling chains.

Counterpart of dbg_assembly_tpu/contig/pointer_doubling.py
(``debruijn_contig --readout doubling``).  The reference prunes tips,
low-coverage edges and bubbles in sequential passes (DBG_contig/
contig.cpp:281-776) and reads contigs out by chasing hash pointers one node
at a time (contig.cpp:832-896).  Here:

  * links (contig.cpp:107-205): one native pass over the counters;
  * pruning: every candidate's walk advances in lockstep batches (host
    numpy), and decisions finalize in conflict-free rounds, so each one sees
    the state the reference's slot-order replay would have seen;
  * readout: the successor function over the 2M directed states (state 2i
    = node i walking canonical-rightward, 2i+1 leftward) is built and every
    maximal chain resolved by pointer doubling, as torch programs on the
    assembler's device (_succ_resolve, _resolve_chains); the host then
    assembles each chain's sequence and depth bytes.  Cycles and hairpins
    fall back to the exact serial walker.

Each record is byte-identical to the exact readout's; only the file order of
length ties can differ.  Pruning state is host numpy as in the JAX package;
the device holds the node table only while chains resolve.  Each step is a
span contig.doubling.<step> (dbg_assembly_tpu_torch/spans.py); DBG_PD_PROFILE
set prints a "[pd]" line a stage step and a "[ro]" line a readout step with
its seconds, from the step's span, as the JAX package prints its own.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import dna, native, resolve_device, spans
from ..dna import bit2seq
from ..io import stat as statio
from .graph import NodeTable
from .refassemble import (AssembleParams, AssembleStats,
                          compare_two_seq_simple, global_aligning)

BASES = np.frombuffer(b"ACGTN", np.uint8)
C_BASES = np.frombuffer(b"TGCAN", np.uint8)
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _revcomp_bytes(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def _adjust_depth_bytes(d: np.ndarray) -> np.ndarray:
    """Depth chars avoid '\\n' (10) and '>' (62): contig.cpp:849-851."""
    return np.where((d == 10) | (d == 62), d - 1, d).astype(np.uint8)


_RO = "    [ro]"
_PD = "  [pd]"


@contextlib.contextmanager
def _step(tag: str, name: str):
    """One step of the doubling readout as the span contig.doubling.<name>
    (spaces as '_'); DBG_PD_PROFILE set prints "<tag> <name> <seconds>s"
    from the span as it closes."""
    with spans.span("contig.doubling." + name.replace(" ", "_")) as s:
        yield
    if os.environ.get("DBG_PD_PROFILE"):
        print(f"{tag} {name:18s} {s.seconds:7.2f}s", flush=True)


# =========================================================================
# graph state: vectorized primitives over the sorted node table
# =========================================================================

class _Graph:
    """Mutable pruning state over a NodeTable (host numpy).  Node ids index
    the sorted k-mer array (locate = searchsorted, the bulk analog of
    exist_kmerset, kmerSet.cpp:280-302); iteration priority is the emulated
    reference slot order.  ``device`` is where the readout resolves
    chains."""

    def __init__(self, table: NodeTable, params: AssembleParams,
                 device="cuda"):
        self.p = params
        self.k = params.ksize
        self.device = resolve_device(device)
        self.mask = np.uint64((1 << (2 * self.k)) - 1)
        kmers = table.kmers
        first_idx = table.first_idx.astype(np.int64)
        pre = 0 if (kmers == np.uint64(0)).any() else 1
        if pre:
            # the reference unconditionally appends a (possibly empty)
            # poly-A node (DBGgraph.cpp:417-418); table stays sorted
            kmers = np.concatenate([[np.uint64(0)], kmers])
            first_idx = np.concatenate([[np.int64(2 ** 62)], first_idx])
        self.M = M = len(kmers)
        M1 = M + 1                           # + sentinel row (reads zeros)
        self.kmers = kmers                   # [M] sorted ascending
        self.lcnt = np.zeros((M1, 4), np.int32)
        self.rcnt = np.zeros((M1, 4), np.int32)
        np.minimum(table.lcnt, 255, out=self.lcnt[pre:pre + len(table.lcnt)],
                   casting="unsafe")
        np.minimum(table.rcnt, 255, out=self.rcnt[pre:pre + len(table.rcnt)],
                   casting="unsafe")
        self.deleted = np.zeros(M1, bool)
        self.l_num = np.zeros(M1, np.int32)
        self.r_num = np.zeros(M1, np.int32)
        self.l_base = np.zeros(M1, np.int32)
        self.r_base = np.zeros(M1, np.int32)
        self.linear = np.zeros(M1, bool)
        self.stats = AssembleStats()

        # reference slot-iteration order: insertion in first-occurrence
        # stream order, poly-A key 0 last, jenkins64 linear probing
        init = int(params.init_hash_size * 1_000_000_000)
        size = 3 if init < 3 else native.find_next_prime(init)
        self.stats.hash_size = size
        is_polyA = kmers == np.uint64(0)
        normal = np.flatnonzero(~is_polyA)
        order = normal[native.radix_argsort_u64(first_idx[normal])]
        if len(order) > int(size * params.load_factor):
            raise RuntimeError("node table exceeds hash capacity — raise "
                               "init_hash_size")
        slots, disp, conflicts = native.hash_layout_disp(kmers[order], size)
        self.stats.hash_conflicts = conflicts
        if table.counts is not None:
            counts = table.counts
            if len(counts) != M:
                counts = np.concatenate([[np.int32(0)], counts])
            self.stats.hash_conflicts_occ = int(
                (disp * counts[order].astype(np.int64)).sum())
        slot_of = np.full(M, -1, np.int64)
        slot_of[order] = slots
        occupied = np.zeros(size, bool)
        occupied[slots] = True
        pa = int(np.flatnonzero(is_polyA)[0])
        hc = int(native.jenkins64(np.uint64(0)) % np.uint64(size))
        while occupied[hc]:
            self.stats.hash_conflicts_occ += 1
            hc = 0 if hc + 1 == size else hc + 1
        slot_of[pa] = hc
        self.prio = native.slot_rank(slot_of, size)   # node -> slot rank

    def locate(self, nf: np.ndarray) -> np.ndarray:
        """Canonical k-mer values -> node ids (M = missing or deleted).
        MeshGraph (mesh_assemble.py) runs _search as a sharded collective
        program; the mutable deleted mask applies here."""
        nf = np.asarray(nf, np.uint64)
        idx = self._search(nf)
        found = (idx >= 0) & ~self.deleted[np.maximum(idx, 0)]
        return np.where(found, idx, self.M).astype(np.int64)

    def _search(self, nf: np.ndarray) -> np.ndarray:
        """Static-table search: k-mer values -> sorted-table index or -1."""
        idx = np.minimum(np.searchsorted(self.kmers, nf), self.M - 1)
        return np.where(self.kmers[idx] == nf, idx, -1).astype(np.int64)

    def resolve_chains(self, succ: np.ndarray):
        """_resolve_chains on self.device, as numpy (e, dist, cyclic);
        MeshGraph runs it sharded."""
        out = _resolve_chains(torch.from_numpy(succ).to(self.device))
        return tuple(t.cpu().numpy() for t in out)

    def calc_links(self):
        """calculate_kmer_links (contig.cpp:107-205) in one bulk pass
        (_links_bulk; MeshGraph runs it sharded); also snapshots the tip
        and branch candidates in slot order, as the reference collects
        them during this scan."""
        M = self.M
        (self.l_num[:M], self.r_num[:M], self.l_base[:M], self.r_base[:M],
         self.depth_stat) = self._links_bulk()
        self.linear[:M] = (self.l_num[:M] == 1) & (self.r_num[:M] == 1)
        no_links = (self.l_num[:M] == 0) & (self.r_num[:M] == 0)
        self.deleted[:M] |= no_links
        st = self.stats
        st.total_nodes = M
        st.deleted_lowfreq = int(no_links.sum())
        st.linear_nodes = int(self.linear[:M].sum())
        so = np.empty(M, np.int64)          # inverse of the rank permutation
        so[self.prio] = np.arange(M, dtype=np.int64)
        self.tip_nodes = so[(self.l_num[so] + self.r_num[so]) == 1]
        self.branch_nodes = so[(self.l_num[so] > 1) | (self.r_num[so] > 1)]
        st.tip_candidates = len(self.tip_nodes)
        st.branch_candidates = len(self.branch_nodes)

    def _links_bulk(self):
        """The O(M) counter pass: link counts (capped at 3), max-depth
        bases and the 256-bin depth histogram, one native pass."""
        M = self.M
        return native.links_pass(self.lcnt[:M], self.rcnt[:M],
                                 self.p.kmer_freq_cutoff)

    def write_kmer_freq(self, path: str):
        with open(path, "w") as f:
            f.write("Kmer_depth\tAppear_times\n")
            for i in range(1, 256):
                f.write(f"{i}\t{self.depth_stat[i]}\n")

    # ------------------------------------------------------- walk steps
    def next_ids(self, ids: np.ndarray, dirs: np.ndarray,
                 bases: np.ndarray):
        """One walk step from (node, direction) via the given base:
        returns (next_canonical, next_dir) — contig.cpp:801-807."""
        km = self.kmers[np.minimum(ids, self.M - 1)]
        b = bases.astype(np.uint64)
        right = dirs == 1
        nk = np.where(right,
                      ((km << np.uint64(2)) | b) & self.mask,
                      (km >> np.uint64(2))
                      + (b << np.uint64(2 * (self.k - 1))))
        rc = dna.revcomp_kbit(nk, self.k)
        flip = nk >= rc
        nf = np.where(flip, rc, nk)
        ndir = np.where(flip, -dirs, dirs)
        return nf, ndir

    def walk_batch(self, start: np.ndarray, dirs: np.ndarray, cutoff: int):
        """Vectorized get_linear_path (contig.cpp:779-827): every
        candidate's walk advances in lockstep, over the still-walking rows.

        Returns dict with path_len [n], path_depth [n], visited [n,cutoff]
        (node ids, M-padded), chars [n,cutoff] (ASCII), last [n],
        mark_branch [n], arrive [n] (walk direction on arrival at last)."""
        n = len(start)
        path_len = np.zeros(n, np.int64)
        path_depth = np.zeros(n, np.int64)
        visited = np.full((n, max(cutoff, 1)), self.M, np.int64)
        chars = np.zeros((n, max(cutoff, 1)), np.uint8)
        last = np.full(n, self.M, np.int64)
        arrive = np.zeros(n, np.int64)
        act_rows = np.arange(n)
        idx = start.astype(np.int64).copy()
        cur = dirs.astype(np.int64).copy()
        orig_all = dirs.astype(np.int64)
        for step in range(cutoff):
            if len(act_rows) == 0:
                break
            right = cur == 1
            b = np.where(right, self.r_base[idx], self.l_base[idx])
            cnt = np.where(right, self.rcnt[idx, b], self.lcnt[idx, b])
            path_len[act_rows] += 1
            path_depth[act_rows] += cnt
            visited[act_rows, step] = idx
            same = cur == orig_all[act_rows]
            chars[act_rows, step] = np.where(same, BASES[b], C_BASES[b])
            nf, ndir = self.next_ids(idx, cur, b)
            nxt = self.locate(nf)
            stop = (~self.linear[nxt]) | (nxt == self.M) | \
                   (path_len[act_rows] >= cutoff)
            srows = act_rows[stop]
            last[srows] = nxt[stop]
            arrive[srows] = ndir[stop]
            keep = ~stop
            act_rows = act_rows[keep]
            idx = nxt[keep]
            cur = ndir[keep]
        mark_branch = (last != self.M) & (self.l_num[last] > 0) & \
                      (self.r_num[last] > 0)
        return dict(path_len=path_len, path_depth=path_depth,
                    visited=visited, chars=chars, last=last,
                    mark_branch=mark_branch, arrive=arrive)

    def recalc(self, ids: np.ndarray):
        """Vectorized recalculate_kmer_links (contig.cpp:210-277): for the
        given nodes, re-validate neighbours, zero dangling counters, refresh
        num/base/linear."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[ids < self.M]
        if len(ids) == 0:
            return
        cut = self.p.kmer_freq_cutoff
        km = self.kmers[ids]
        for side in ("l", "r"):
            cntarr = self.lcnt if side == "l" else self.rcnt
            cnt = cntarr[ids]                                  # [n, 4]
            b = np.arange(4, dtype=np.uint64)[None, :]
            if side == "l":
                nk = (km[:, None] >> np.uint64(2)) + \
                     (b << np.uint64(2 * (self.k - 1)))
            else:
                nk = ((km[:, None] << np.uint64(2)) | b) & self.mask
            rc = dna.revcomp_kbit(nk, self.k)
            nf = np.minimum(nk, rc)
            ex = self.locate(nf.reshape(-1)).reshape(nf.shape) != self.M
            qual = cnt > cut
            dangling = qual & ~ex
            cnt = np.where(dangling, 0, cnt)
            cntarr[ids] = cnt
            alive = qual & ex
            num = np.minimum(alive.sum(1), 3)
            base = np.argmax(np.where(alive, cnt, 0), axis=1)
            if side == "l":
                self.l_num[ids] = num
                self.l_base[ids] = np.where(num > 0, base, 0)
            else:
                self.r_num[ids] = num
                self.r_base[ids] = np.where(num > 0, base, 0)
        self.linear[ids] = (self.l_num[ids] == 1) & (self.r_num[ids] == 1)
        self.linear[self.M] = False


# =========================================================================
# conflict rounds
# =========================================================================

def _rounds(g: _Graph, pending, evaluate, apply):
    """Finalize candidates in conflict-free rounds.

    pending: candidate node ids in reference iteration priority.
    evaluate(ids) -> (reads, writes, records): per candidate, the node ids
    its decision READ, the ids it would WRITE (empty if it would not act),
    and a cached record for apply.  apply(id, record) finalizes (mutating
    g) and returns its ACTUAL write set, which may exceed the estimate when
    a node's own earlier branch changed its later branches' walks, so
    applied writes are re-checked against every later candidate's reads.
    A candidate defers when its reads intersect any earlier-priority
    candidate's (estimated or actual) writes; each finalized decision thus
    saw exactly the state the reference's sequential replay would have."""
    pending = list(int(x) for x in pending)
    while pending:
        ids = np.asarray(pending, np.int64)
        reads, writes, records = evaluate(ids)
        est_writer: dict[int, int] = {}
        for pos, ws in enumerate(writes):
            for v in ws:
                if v not in est_writer:
                    est_writer[v] = pos
        applied_writes: set[int] = set()
        next_pending = []
        for pos in range(len(ids)):
            rd = reads[pos]
            clean = all(est_writer.get(v, pos) >= pos for v in rd) and \
                not any(v in applied_writes for v in rd)
            if clean:
                actual = apply(int(ids[pos]), records[pos])
                if actual:
                    applied_writes.update(int(v) for v in actual)
            else:
                next_pending.append(int(ids[pos]))
        if len(next_pending) == len(pending):
            raise RuntimeError("conflict rounds made no progress")
        pending = next_pending


# =========================================================================
# pruning phases
# =========================================================================

def remove_tips(g: _Graph, out_path: str):
    """remove_error_tips (contig.cpp:281-355) as one batched walk per
    round.  Matches the reference quirk of NOT skipping candidates already
    deleted by an earlier tip (their stale links are walked as-is)."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)

    def evaluate(ids):
        dirs = np.where(g.l_num[ids] == 1, -1, 1)
        w = g.walk_batch(ids, dirs, p.tip_len_cutoff)
        reads, writes, records = [], [], []
        for i in range(len(ids)):
            ln = int(w["path_len"][i])
            dep = int(w["path_depth"][i])
            vec = w["visited"][i, :ln]
            last = int(w["last"][i])
            qualify = (dep <= p.tip_depth_cutoff * ln
                       and ln <= p.tip_len_cutoff)
            rd = [int(ids[i])] + vec.tolist() + [last]
            reads.append(rd)
            writes.append(vec.tolist() + [last] if qualify else [])
            records.append((int(dirs[i]), ln, dep, vec.copy(),
                            w["chars"][i, :ln].tobytes(), last,
                            bool(w["mark_branch"][i]), qualify))
        return reads, writes, records

    def apply(idx, rec):
        walk, ln, dep, vec, tip_str, last, is_branch, qualify = rec
        if not qualify:
            return []
        state["num"] += 1
        state["length"] += ln
        g.deleted[vec] = True
        g.recalc(np.asarray([last]))
        mark = "branch" if is_branch else "break"
        kmer_str = bit2seq(int(g.kmers[idx]), g.k)
        s = tip_str.decode()
        out = kmer_str + s if walk == 1 else s[::-1] + kmer_str
        lkm_last = int(g.kmers[last]) if last < g.M else 0
        if walk == 1:
            lkm, lmark = int(g.kmers[idx]), "break"
            rkm, rmark = lkm_last, mark
        else:
            rkm, rmark = int(g.kmers[idx]), "break"
            lkm, lmark = lkm_last, mark
        avg = dep / ln
        lines.append(
            f">tip_{state['num']}\tlength: {ln + g.k}"
            f"\tavgDepth: {statio.fmt_g6(avg)}\tLeftEndKmer: {lkm} {lmark}"
            f"\tRightEndKmer: {rkm} {rmark}\n{out}\n")
        return vec.tolist() + [last]

    _rounds(g, g.tip_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.tips_removed = state["num"]
    g.stats.tip_len_removed = state["length"]


def _branch_bases(cnt_row, cut):
    out_b, out_d = [], []
    for j in range(4):
        d = int(cnt_row[j])
        if d > cut:
            out_b.append(j)
            out_d.append(d)
    return out_b, out_d


def remove_lowedges(g: _Graph, out_path: str):
    """remove_lowCov_edges (contig.cpp:601-776).  Evaluation batches every
    (branch node, side, base) lane into one lockstep walk; finalization
    re-derives each clean node's branches serially (r side then l side,
    fresh per-side base lists) exactly like the reference, which matters
    only when an earlier branch of the SAME node deleted state."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)
    cut = p.kmer_freq_cutoff

    def evaluate(ids):
        lane_node, lane_dir, lane_base, lane_cand = [], [], [], []
        for side_dir, cnt_all, num_all in (
                (1, g.rcnt, g.r_num), (-1, g.lcnt, g.l_num)):
            has = num_all[ids] >= 2
            mask = (cnt_all[ids] > cut) & has[:, None]        # [n,4]
            ci, bj = np.nonzero(mask)
            lane_cand.append(ci)
            lane_node.append(ids[ci])
            lane_dir.append(np.full(len(ci), side_dir, np.int64))
            lane_base.append(bj.astype(np.int64))
        lane_cand = np.concatenate(lane_cand)
        lane_node = np.concatenate(lane_node)
        lane_dir = np.concatenate(lane_dir)
        lane_base = np.concatenate(lane_base)
        if len(lane_node):
            nf, nd = g.next_ids(lane_node, lane_dir, lane_base)
            i1 = g.locate(nf)
            lin = g.linear[i1]
            wsel = np.flatnonzero(lin)
            w = g.walk_batch(i1[wsel], nd[wsel], p.lowedge_len_cutoff) \
                if len(wsel) else None
        else:
            i1 = np.zeros(0, np.int64)
            lin = np.zeros(0, bool)
            wsel = np.zeros(0, np.int64)
            w = None
        wpos = np.full(len(lane_node), -1, np.int64)
        wpos[wsel] = np.arange(len(wsel))

        reads = [[int(i)] for i in ids]
        writes = [[] for _ in ids]
        for li in range(len(lane_node)):
            c = int(lane_cand[li])
            ii = int(i1[li])
            if ii < g.M:
                reads[c].append(ii)
            if not lin[li]:
                continue
            k = int(wpos[li])
            ln = int(w["path_len"][k]) + 1
            dep = int(w["path_depth"][k]) + \
                int((g.rcnt if lane_dir[li] == 1 else g.lcnt)[
                    lane_node[li], lane_base[li]])
            last = int(w["last"][k])
            vec = w["visited"][k, :ln - 1]
            reads[c].extend(vec.tolist())
            reads[c].append(last)
            if (ln <= p.lowedge_len_cutoff
                    and dep <= p.lowedge_depth_cutoff * ln
                    and not g.linear[last]):
                writes[c].extend(vec.tolist())
                writes[c].extend([last, int(ids[c])])
        records = [bool(w_) for w_ in writes]     # True -> may act
        return reads, writes, records

    def apply(idx, may_act):
        if not may_act:
            return []
        actual = []
        for side in ("r", "l"):
            num = g.r_num[idx] if side == "r" else g.l_num[idx]
            if num < 2:
                continue
            cnt_row = (g.rcnt if side == "r" else g.lcnt)[idx]
            vb, vd = _branch_bases(cnt_row, cut)
            for j, b in enumerate(vb):
                nf, ndir = g.next_ids(
                    np.asarray([idx]),
                    np.asarray([1 if side == "r" else -1]),
                    np.asarray([b]))
                i1 = int(g.locate(nf)[0])
                if not g.linear[i1]:
                    continue
                w = g.walk_batch(np.asarray([i1]), ndir,
                                 p.lowedge_len_cutoff)
                ln = int(w["path_len"][0]) + 1
                dep = int(w["path_depth"][0]) + vd[j]
                last = int(w["last"][0])
                if not (ln <= p.lowedge_len_cutoff
                        and dep <= p.lowedge_depth_cutoff * ln
                        and not g.linear[last]):
                    continue
                state["num"] += 1
                state["length"] += ln
                vec = w["visited"][0, :ln - 1]
                g.deleted[vec] = True
                g.recalc(np.asarray([last, idx]))
                actual.extend(vec.tolist())
                actual.extend([last, idx])
                estr = w["chars"][0, :ln - 1].tobytes().decode()
                k1 = bit2seq(int(g.kmers[i1]), g.k)
                out1 = k1 + estr if int(ndir[0]) == 1 else estr[::-1] + k1
                avg = dep / ln
                mark = "branch" if w["mark_branch"][0] else "break"
                lk = int(g.kmers[last]) if last < g.M else 0
                if side == "r":
                    lines.append(
                        f">lowedge_{state['num']}\tlength: {ln + g.k}"
                        f"\tavgDepth: {statio.fmt_g6(avg)}"
                        f"\tLeftEndKmer: {int(g.kmers[idx])} branch"
                        f"\tRightEndKmer: {lk} {mark}\n{out1}\n")
                else:
                    # divergent spacing in the reference's leftward branch
                    # (contig.cpp:763) — reproduced deliberately
                    lines.append(
                        f">lowedge_{state['num']}    length:{ln + g.k}"
                        f"    avgDepth:{statio.fmt_g6(avg)}"
                        f"\tLeftEndKmer: {lk} {mark}"
                        f"\tRightEndKmer: {int(g.kmers[idx])} branch"
                        f"\n{out1}\n")
        return actual

    _rounds(g, g.branch_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.lowedges_removed = state["num"]
    g.stats.lowedge_len_removed = state["length"]


def remove_bubbles(g: _Graph, out_path: str):
    """remove_hetero_bubbles (contig.cpp:375-582): both branch walks of
    every bubble-shaped node advance in one lockstep batch; sequence
    compare (SNP hamming / INDEL Needleman-Wunsch) runs at finalization
    from the cached walks (valid by the conflict-round guarantee)."""
    p = g.p
    lines = []
    state = dict(num=0, length=0)
    cut = p.kmer_freq_cutoff

    def evaluate(ids):
        n = len(ids)
        l_num, r_num = g.l_num[ids], g.r_num[ids]
        shape_l = (l_num == 2) & (r_num == 1)
        shape_r = (l_num == 1) & (r_num == 2)
        is_b = shape_l | shape_r
        walkdir = np.where(shape_l, -1, 1).astype(np.int64)
        cnt = np.where(shape_l[:, None], g.lcnt[ids], g.rcnt[ids])
        q = cnt > cut
        b1 = np.argmax(q, axis=1)
        b2 = np.argmax(q & (np.arange(4)[None, :] > b1[:, None]), axis=1)
        d1 = cnt[np.arange(n), b1]
        d2 = cnt[np.arange(n), b2]
        sel = np.flatnonzero(is_b)
        lane_node = np.repeat(ids[sel], 2)
        lane_dir = np.repeat(walkdir[sel], 2)
        lane_base = np.stack([b1[sel], b2[sel]], 1).reshape(-1)
        if len(lane_node):
            nf, nd = g.next_ids(lane_node, lane_dir, lane_base)
            i12 = g.locate(nf)
            lin2 = g.linear[i12].reshape(-1, 2)
            ok = lin2.all(1)
            wsel = np.flatnonzero(np.repeat(ok, 2))
            w = g.walk_batch(i12[wsel], nd[wsel], p.bubble_len_cutoff) \
                if len(wsel) else None
        else:
            i12 = np.zeros(0, np.int64)
            ok = np.zeros(0, bool)
            wsel = np.zeros(0, np.int64)
            w = None
        wpos = np.full(len(lane_node), -1, np.int64)
        wpos[wsel] = np.arange(len(wsel))

        reads = [[int(i)] for i in ids]
        writes = [[] for _ in ids]
        records = [None] * n
        for s_i, c in enumerate(sel):
            c = int(c)
            la = 2 * s_i
            ii = i12[la:la + 2]
            reads[c].extend(int(x) for x in ii if x < g.M)
            if not ok[s_i]:
                continue
            k1, k2 = int(wpos[la]), int(wpos[la + 1])
            rec = dict(
                walk=int(walkdir[c]),
                vd=(int(d1[c]), int(d2[c])),
                i12=(int(ii[0]), int(ii[1])),
                nd=(int(nd[la]), int(nd[la + 1])),
                lens=(int(w["path_len"][k1]), int(w["path_len"][k2])),
                deps=(int(w["path_depth"][k1]), int(w["path_depth"][k2])),
                lasts=(int(w["last"][k1]), int(w["last"][k2])),
                marks=(bool(w["mark_branch"][k1]),
                       bool(w["mark_branch"][k2])),
                vecs=(w["visited"][k1, :int(w["path_len"][k1])].copy(),
                      w["visited"][k2, :int(w["path_len"][k2])].copy()),
                strs=(w["chars"][k1, :int(w["path_len"][k1])].tobytes(),
                      w["chars"][k2, :int(w["path_len"][k2])].tobytes()))
            records[c] = rec
            for v in (0, 1):
                reads[c].extend(rec["vecs"][v].tolist())
            reads[c].extend(rec["lasts"])
            if rec["lasts"][0] == rec["lasts"][1]:
                # may delete either path + recalc last/idx
                writes[c].extend(rec["vecs"][0].tolist())
                writes[c].extend(rec["vecs"][1].tolist())
                writes[c].extend([rec["lasts"][0], int(ids[c])])
        return reads, writes, records

    def apply(idx, rec):
        if rec is None or rec["lasts"][0] != rec["lasts"][1]:
            return []
        walk = rec["walk"]
        len1, len2 = rec["lens"]
        dep1, dep2 = rec["deps"]
        last1 = rec["lasts"][0]
        avg1, avg2 = dep1 / len1, dep2 / len2
        w1, w2 = rec["nd"]
        ks1 = bit2seq(int(g.kmers[rec["i12"][0]]), g.k)
        s1 = rec["strs"][0].decode()
        bs1 = ks1 + s1 if w1 == 1 else s1[::-1] + ks1
        ks2 = bit2seq(int(g.kmers[rec["i12"][1]]), g.k)
        s2 = rec["strs"][1].decode()
        bs2 = ks2 + s2 if w2 == 1 else s2[::-1] + ks2
        if w1 != w2:
            bs1 = _revcomp_bytes(bs1.encode()).decode()
        len1 += 1
        len2 += 1
        dep1 += rec["vd"][0]
        dep2 += rec["vd"][1]
        diff_rate = 0.0
        btype = ""
        if len1 == len2:
            diff_rate = compare_two_seq_simple(bs1, bs2) / len1
            btype = "SNP"
        if len1 != len2 or diff_rate > p.bubble_base_diff_rate:
            bs1, bs2 = global_aligning(bs1, bs2)
            diff_rate = compare_two_seq_simple(bs1, bs2) / len1
            btype = "INDEL"
        if not (diff_rate < p.bubble_base_diff_rate
                and abs(len1 - len2) < p.bubble_len_cutoff
                * p.bubble_len_diff_rate
                and len1 <= p.bubble_len_cutoff
                and len2 <= p.bubble_len_cutoff):
            return []
        pick = 0 if avg1 < avg2 else 1
        ln = (len1, len2)[pick]
        vec = rec["vecs"][pick]
        g.deleted[vec] = True
        g.recalc(np.asarray([last1, idx]))
        state["num"] += 1
        state["length"] += ln
        mark1 = "branch" if rec["marks"][0] else "break"
        lkm_last = int(g.kmers[last1]) if last1 < g.M else 0
        if walk == 1:
            lkm, lmark = int(g.kmers[idx]), "branch"
            rkm, rmark = lkm_last, mark1
        else:
            rkm, rmark = int(g.kmers[idx]), "branch"
            lkm, lmark = lkm_last, mark1
        lines.append(
            f">bubble_{state['num']}\ttype: {btype}\tlength1: {len1 + g.k}"
            f"\tavgDepth1: {statio.fmt_g6(avg1)}\tlength2: {len2 + g.k}"
            f"\tavgDepth2: {statio.fmt_g6(avg2)}\tremoved: {pick + 1}"
            f"\tLeftEndKmer: {lkm} {lmark}"
            f"\tRightEndKmer: {rkm} {rmark}\n{bs1}\n{bs2}\n")
        return vec.tolist() + [last1, idx]

    _rounds(g, g.branch_nodes, evaluate, apply)
    with open(out_path, "w") as f:
        f.writelines(lines)
    g.stats.bubbles_removed = state["num"]
    g.stats.bubble_len_removed = state["length"]


# =========================================================================
# pointer-doubling readout (device programs)
# =========================================================================

def _succ_resolve(kmers: torch.Tensor, l_base: torch.Tensor,
                  r_base: torch.Tensor, alive: torch.Tensor, k: int):
    """Successor build + pointer doubling over the 2M interleaved directed
    states (state 2i = node i rightward, 2i+1 leftward), on the tensors'
    device.  kmers: [M] int64 ascending (every k-mer < 2^62, so the int64
    view of the uint64 table keeps its order); l_base/r_base: [M] int;
    alive: [M] bool.  A state's successor is the state its step reaches if
    both nodes are alive, else STOP = 2M.  Returns (succ, e, dist, cyclic)
    as _resolve_chains defines them."""
    M = kmers.shape[0]
    STOP = 2 * M
    low = (1 << (2 * k - 2)) - 1         # bits that survive a left shift

    def step(base, right: bool):
        b = base.to(torch.int64)
        if right:
            nk = ((kmers & low) << 2) | b
        else:
            nk = (kmers >> 2) | (b << (2 * (k - 1)))
        rc = dna.revcomp_kbit(nk, k)
        flip = nk >= rc
        nf = torch.where(flip, rc, nk)
        left_after = flip if right else ~flip
        idx = torch.searchsorted(kmers, nf, side="left")
        idxc = idx.clamp(max=M - 1)
        ok = alive & (kmers[idxc] == nf) & alive[idxc]
        return torch.where(ok, 2 * idxc + left_after.to(torch.int64), STOP)

    succ = torch.stack([step(r_base, True), step(l_base, False)],
                       dim=1).reshape(-1)
    e, dist, cyclic = _resolve_chains(succ)
    return succ, e, dist, cyclic


def contig_stage_step(kmers: torch.Tensor, lcnt: torch.Tensor,
                      rcnt: torch.Tensor, *, k: int, cut: int):
    """The contig stage's device work over a sorted node table, as one
    program on the tensors' device: the links (calculate_kmer_links,
    contig.cpp:107-205), the successor over the 2M directed states and
    pointer-doubling chain resolution.

    kmers: [M] int64 ascending, SENTINEL rows inert (their counters must
    be 0); lcnt, rcnt: [M, 4].  State i = node i walking canonical-
    rightward, M + i = leftward.  Returns (l_num, r_num int32, linear bool,
    e, dist int64, cyclic bool) over [M], [M], [M], [2M], [2M], [2M].

    The doubling runs ceil(log2(max(2M, 2))) + 1 rounds with no early exit,
    as JAX's: a state on a cycle never reaches a fixed point, so its e and
    dist are what that many rounds leave."""
    M = kmers.shape[0]
    lq, rq = lcnt > cut, rcnt > cut
    l_num = lq.sum(dim=1).clamp(max=3).to(torch.int32)
    r_num = rq.sum(dim=1).clamp(max=3).to(torch.int32)
    # torch.argmax returns the first of tied maxima, as jnp.argmax
    l_base = torch.argmax(torch.where(lq, lcnt, 0), dim=1)
    r_base = torch.argmax(torch.where(rq, rcnt, 0), dim=1)
    linear = (l_num == 1) & (r_num == 1)

    mask = (1 << (2 * k)) - 1
    km2 = torch.cat([kmers, kmers])
    base = torch.cat([r_base, l_base])
    right = torch.arange(2 * M, device=kmers.device) < M
    nk = torch.where(right, ((km2 << 2) | base) & mask,
                     (km2 >> 2) | (base << (2 * (k - 1))))
    rc = dna.revcomp_kbit(nk, k)
    flip = nk >= rc
    nf = torch.where(flip, rc, nk)
    ndir_left = flip ^ ~right          # walking leftward after the step
    idxc = torch.searchsorted(kmers, nf).clamp(max=max(M - 1, 0))
    ok = torch.cat([linear, linear]) & (kmers[idxc] == nf) & linear[idxc]
    n = 2 * M
    succ = torch.where(ok, idxc + torch.where(ndir_left, M, 0), n)
    stop = succ >= n
    e = torch.where(stop, torch.arange(n, device=kmers.device), succ)
    r = (~stop).to(torch.int64)
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        e, r = e[e], r + r[e]
    cyclic = torch.cat([succ, succ.new_tensor([n])])[e] < n
    return l_num, r_num, linear, e, r + 1, cyclic


def _resolve_chains(succ: torch.Tensor):
    """Jump-pointer doubling over a successor function, on its device.

    succ: [n] int64, STOP encoded as n.  Returns (e [n] = the state at the
    end of each state's chain, dist [n] = states from s to e inclusive,
    cyclic [n] bool).  Stops at the fixed point, after at most
    ceil(log2(max(n, 2))) + 1 rounds: states on or leading into a cycle
    never reach one (e keeps rotating), so the cap is what ends them; they
    are flagged cyclic and their e/dist carry no meaning."""
    n = succ.shape[0]
    stop = succ >= n
    e = torch.where(stop, torch.arange(n, dtype=succ.dtype,
                                       device=succ.device), succ)
    r = (~stop).to(torch.int64)
    rounds = int(np.ceil(np.log2(max(n, 2)))) + 1
    for _ in range(rounds):
        e2 = e[e]
        r = r + r[e]
        moved = bool((e2 != e).any())
        e = e2
        if not moved:
            break
    succ_p = torch.cat([succ, succ.new_tensor([n])])
    cyclic = succ_p[e] < n
    return e, r + 1, cyclic


# =========================================================================
# readout (host)
# =========================================================================

def _serial_get_linear_seq(g: _Graph, idx: int, walk: int):
    """Exact serial get_linear_seq (contig.cpp:832-896) over _Graph state,
    DELETING traversed nodes — used only for the rare cycle/hairpin chains
    whose output depends on delete order."""
    original = walk
    seq_len = 0
    seq_depth = 0
    chars = bytearray()
    depths = bytearray()
    is_repeat = "Unknown"
    while True:
        seq_len += 1
        if walk == 1:
            b = int(g.r_base[idx])
            d = int(g.rcnt[idx, b])
        else:
            b = int(g.l_base[idx])
            d = int(g.lcnt[idx, b])
        seq_depth += d
        if d in (10, 62):
            d -= 1
        depths.append(d)
        chars.append(int(BASES[b]) if walk == original else int(C_BASES[b]))
        nf, nd = g.next_ids(np.asarray([idx]), np.asarray([walk]),
                            np.asarray([b]))
        walk = int(nd[0])
        nxt = int(g.locate(nf)[0])
        if (not g.linear[nxt]) or nxt == g.M:
            mark = "break" if (nxt == g.M or g.l_num[nxt] == 0
                               or g.r_num[nxt] == 0) else "branch"
            if mark == "branch":
                is_repeat = "Repeat" if (
                    (walk == 1 and g.r_num[nxt] > 1)
                    or (walk == -1 and g.l_num[nxt] > 1)) else "Unique"
            return (seq_len, seq_depth, bytes(chars), nxt, mark,
                    bytes(depths), is_repeat)
        g.deleted[nxt] = True
        idx = nxt


def _boundary_info(g: _Graph, nxt: int, arrive_dir: int):
    """(end kmer value, mark, repeat tag) for a walk stopping at nxt."""
    if nxt >= g.M:
        return 0, "break", "Unknown"
    if g.l_num[nxt] == 0 or g.r_num[nxt] == 0:
        return int(g.kmers[nxt]), "break", "Unknown"
    rep = "Repeat" if ((arrive_dir == 1 and g.r_num[nxt] > 1)
                       or (arrive_dir == -1 and g.l_num[nxt] > 1)) \
        else "Unique"
    return int(g.kmers[nxt]), "branch", rep


def resolve_on_device(g: _Graph, alive: np.ndarray):
    """Run _succ_resolve over the graph on g.device and copy (succ, e,
    dist, cyclic) back as numpy."""
    M = g.M
    dev = g.device
    out = _succ_resolve(
        torch.from_numpy(g.kmers.view(np.int64)).to(dev),
        torch.from_numpy(g.l_base[:M]).to(dev),
        torch.from_numpy(g.r_base[:M]).to(dev),
        torch.from_numpy(alive).to(dev), g.k)
    return tuple(t.cpu().numpy() for t in out)


def read_out_contigs(g: _Graph, prefix: str):
    """read_out_contig (contig.cpp:900-1046) via chain decomposition.

    Every surviving linear node belongs to exactly one maximal chain; the
    successor function over the 2M directed states is built and its chains
    resolved on the device, and sequences/depth strings assemble with bulk
    scatters on the host.  Each chain is emitted in the frame the
    reference's serial readout would use — seed = first chain member in
    slot order, k average-depth bytes at the seed's k-mer position,
    strand = the seed's canonical frame — so every record is
    byte-identical to the serial path's; only file ORDER can differ
    (length-sort ties).  Cycles and hairpin (self-reverse) chains fall
    back to the exact serial walker in slot order."""
    p = g.p
    M = g.M
    k = g.k
    with _step(_RO, "succ_resolve"):
        alive = (~g.deleted[:M]) & g.linear[:M]

        n_states = 2 * M
        STOP = n_states
        node = np.repeat(np.arange(M, dtype=np.int64), 2)
        sdir = np.tile(np.array([1, -1], np.int64), M)
        base = np.where(sdir == 1, g.r_base[node], g.l_base[node])
        depth = np.where(sdir == 1, g.rcnt[node, base],
                         g.lcnt[node, base]).astype(np.int64)
        # e and dist are meaningful on non-cyclic states only; everything
        # below reads them there alone
        if type(g) is _Graph:
            succ, e, dist, cyclic = resolve_on_device(g, alive)
        else:
            # a subclass (MeshGraph) builds the successor through its own
            # locate and resolves the chains with its own resolve_chains
            nf, ndir = g.next_ids(node, sdir, base)
            nxt = g.locate(nf)
            ok = alive[node] & (nxt != M) & g.linear[np.minimum(nxt, M)]
            succ = np.where(ok, 2 * nxt + (ndir == -1),
                            STOP).astype(np.int64)
            e, dist, cyclic = g.resolve_chains(succ)

    def states_next(s: np.ndarray):
        """(next node ids, arriving directions) of directed states."""
        right = s % 2 == 0
        nid = s >> 1
        b = np.where(right, g.r_base[nid], g.l_base[nid]).astype(np.int64)
        nf1, nd1 = g.next_ids(nid, np.where(right, 1, -1), b)
        return g.locate(nf1), nd1

    with _step(_RO, "heads"):
        is_state = alive[node]
        # head = alive state, neither it nor its reverse cyclic, reverse
        # has no successor; fallback = nodes of cyclic alive states
        head_states, fb_arr = native.collect_heads(
            alive.astype(np.uint8), succ, cyclic.astype(np.uint8))
        mate = e[head_states] ^ 1
        hairpin = mate == head_states
        fallback_nodes = set(fb_arr.tolist())
        for h in head_states[hairpin]:
            s = int(h)
            # hairpin chain: collect its nodes for serial fallback
            while s != STOP:
                fallback_nodes.add(int(node[s]))
                s = int(succ[s])
        head_states = head_states[(head_states <= mate) & ~hairpin]

    recs = []   # (seq bytes, depth bytes, header str after id)

    if len(head_states):
        with _step(_RO, "body scatters"):
            n_chains = len(head_states)
            L_chain = dist[head_states]
            head_dir = sdir[head_states]
            # chain id of every state via its end state
            cid_of_end = native._huge_empty(n_states, np.int64)
            cid_of_end.fill(-1)
            cid_of_end[e[head_states]] = np.arange(n_chains)
            st_ids = np.flatnonzero(is_state & ~cyclic)
            cid = cid_of_end[e[st_ids]]
            selm = cid >= 0
            st_ids = st_ids[selm]
            cid = cid[selm]
            pos = L_chain[cid] - dist[st_ids]
            # chars/depths in CHAIN orientation (original=+1 convention:
            # BASES when the state walks canonical-rightward, C_BASES else)
            b = base[st_ids]
            rel = np.where(sdir[st_ids] == 1, b, 3 - b).astype(np.int64)
            dep = depth[st_ids]

            off = np.zeros(n_chains + 1, np.int64)
            np.cumsum(L_chain, out=off[1:])
            body_codes = native._huge_empty(off[-1], np.int64)
            body_codes.fill(0)
            body_deps = native._huge_empty(off[-1], np.int64)
            body_deps.fill(0)
            body_codes[off[cid] + pos] = rel
            body_deps[off[cid] + pos] = dep

        with _step(_RO, "seed argmin"):
            # reference seed of each chain = the member node first in slot
            # order (read_out_contig scan order, contig.cpp:930): the k
            # average-depth bytes sit at the seed's k-mer position and the
            # output strand is the seed's canonical frame.  prio is unique
            # per node and each node appears once per chain, so the
            # first-lowest-index tie rule matches a stable lexsort pick.
            am = native.seg_argmin(cid, g.prio[node[st_ids]], n_chains)
            seed_state = st_ids[am]                        # [n_chains]
            seed_pos = pos[am]

        with _step(_RO, "chain loop"):
            hrev = head_states ^ 1
            # left-boundary char/depth in chain orientation: rev(head) emits
            # BASES in ITS walk frame; complement when the head itself walks
            # canonical-leftward
            lb = base[hrev]
            bchar = np.where(head_dir == 1, BASES[lb], C_BASES[lb])
            bdep = depth[hrev]
            head_node = node[head_states]
            # header boundary info: left = rev(head) stop, right = end stop;
            # no node is deleted while the chains are written
            ln_ids, ln_dirs = states_next(head_states ^ 1)
            rn_ids, rn_dirs = states_next(e[head_states])
            for c in range(n_chains):
                L = int(L_chain[c])
                o = int(off[c])
                codes = body_codes[o:o + L]
                deps = body_deps[o:o + L]
                total_dep = int(deps.sum()) + int(bdep[c])
                avg = total_dep / (L + 1)
                kmer_str = bit2seq(int(g.kmers[head_node[c]]), k).encode()
                if head_dir[c] != 1:
                    kmer_str = _revcomp_bytes(kmer_str)
                chain_chars = BASES[codes].tobytes()
                seq = bytes([int(bchar[c])]) + kmer_str + chain_chars
                dv = int(avg) & 0xFF
                if dv in (10, 62):
                    dv -= 1
                mid = bytes([dv] * k)
                # edge-depth bytes in chain orientation: left boundary +
                # one per state; avg block inserted at the seed position
                # (edge counters are symmetric by construction — each
                # adjacency event increments both end nodes' counters,
                # DBGgraph.cpp:93-96)
                eflat = np.concatenate([[int(bdep[c])], deps])
                eadj = _adjust_depth_bytes(eflat).tobytes()
                q = int(seed_pos[c])
                dbytes = eadj[:q + 1] + mid + eadj[q + 1:]
                lkm, lmark, lrep = _boundary_info(g, int(ln_ids[c]),
                                                  int(ln_dirs[c]))
                rkm, rmark, rrep = _boundary_info(g, int(rn_ids[c]),
                                                  int(rn_dirs[c]))
                if sdir[seed_state[c]] != 1:
                    # the seed walks canonical-leftward on this chain: the
                    # reference emits the reverse-complement frame
                    seq = _revcomp_bytes(seq)
                    dbytes = dbytes[::-1]
                    lkm, lmark, lrep, rkm, rmark, rrep = \
                        rkm, rmark, rrep, lkm, lmark, lrep
                ctype = "RepeatNode" if (lrep == "Repeat"
                                         and rrep == "Repeat") else ""
                header = (f"\tlength: {len(seq)}"
                          f"\tavgDepth: {statio.fmt_lexical(avg)}"
                          f"\tLeftEndKmer: {lkm} {lmark}-{lrep}"
                          f"\tRightEndKmer: {rkm} {rmark}-{rrep}"
                          f"\t{ctype}\n")
                recs.append((seq, dbytes, header))

    with _step(_RO, "write files"):
        # ---- cycles + hairpins: exact serial walker in slot order
        if fallback_nodes:
            fb = np.asarray(sorted(fallback_nodes), np.int64)
            fb = fb[np.argsort(g.prio[fb], kind="stable")]
            for i in fb:
                i = int(i)
                if g.deleted[i] or not g.linear[i]:
                    continue
                kmer_str = bit2seq(int(g.kmers[i]), k).encode()
                (rlen, rdep, rstr, rlast, rmark, rdepths,
                 rrep) = _serial_get_linear_seq(g, i, 1)
                (llen, ldep, lstr, llast, lmark, ldepths,
                 lrep) = _serial_get_linear_seq(g, i, -1)
                ctype = "RepeatNode" if (lrep == "Repeat"
                                         and rrep == "Repeat") else ""
                g.deleted[i] = True
                seq = lstr[::-1] + kmer_str + rstr
                avg = (ldep + rdep) / (llen + rlen)
                dv = int(avg) & 0xFF
                if dv in (10, 62):
                    dv -= 1
                dbytes = ldepths[::-1] + bytes([dv] * k) + rdepths
                lkm = int(g.kmers[llast]) if llast < g.M else 0
                rkm = int(g.kmers[rlast]) if rlast < g.M else 0
                header = (f"\tlength: {len(seq)}"
                          f"\tavgDepth: {statio.fmt_lexical(avg)}"
                          f"\tLeftEndKmer: {lkm} {lmark}-{lrep}"
                          f"\tRightEndKmer: {rkm} {rmark}-{rrep}"
                          f"\t{ctype}\n")
                recs.append((seq, dbytes, header))

        # ---- length-sorted output with odd ids (contig.cpp:1014-1046)
        lens = np.array([len(r[0]) for r in recs], dtype=np.uint64)
        perm = native.gcc44_sort_perm_desc(lens) if len(recs) else []
        st = g.stats
        with open(prefix + ".contig.seq.fa", "w") as ctg_f, \
                open(prefix + ".contig.seq.depth", "wb") as ctg_d, \
                open(prefix + ".contig.small.fa", "w") as small_f, \
                open(prefix + ".contig.small.depth", "wb") as small_d:
            contig_id = 1
            for pi in perm:
                seq, dbytes, header = recs[int(pi)]
                name = f">ctg_{contig_id}"
                if len(seq) >= p.contig_len_cutoff:
                    ctg_f.write(name + header + seq.decode() + "\n")
                    ctg_d.write(name.encode() + b"\n" + dbytes + b"\n")
                    st.contig_num += 1
                    st.contig_len += len(seq)
                else:
                    small_f.write(name + header + seq.decode() + "\n")
                    small_d.write(name.encode() + b"\n" + dbytes + b"\n")
                    st.small_num += 1
                    st.small_len += len(seq)
                contig_id += 2
    return st


# =========================================================================
# entry point
# =========================================================================

def assemble_doubling(table: NodeTable, params: AssembleParams, prefix: str,
                      device="cuda") -> AssembleStats:
    """Full scalable assembly: links -> tips -> lowedges -> bubbles ->
    pointer-doubling readout (phase order per contig.cpp:54-102), chains
    resolved on ``device``.  Writes the same eight artifacts as the exact
    readout."""
    with _step(_PD, "graph init"):
        g = _Graph(table, params, device)
    with _step(_PD, "calc_links"):
        g.calc_links()
    with _step(_PD, "kmer.freq"):
        g.write_kmer_freq(prefix + ".contig.kmer.freq")
    if params.is_remove_tip:
        with _step(_PD, "tips"):
            remove_tips(g, prefix + ".contig.tip.fa")
    if params.is_remove_lowedge:
        with _step(_PD, "lowedges"):
            remove_lowedges(g, prefix + ".contig.lowedge.fa")
    if params.is_remove_bubble:
        with _step(_PD, "bubbles"):
            remove_bubbles(g, prefix + ".contig.bubble.fa")
    with _step(_PD, "readout"):
        read_out_contigs(g, prefix)
    return g.stats
