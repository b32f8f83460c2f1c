"""Order-exact graph pruning + contig readout over a NodeTable (host).

Counterpart of dbg_assembly_tpu/contig/refassemble.py, in numpy plus the
shared native engine.  The reference's tip/low-edge/bubble removal and
contig extraction (DBG_contig/contig.cpp) are sequential and depend on the
order of its hash slots.  This module rebuilds that order — first-occurrence
insertion into the reference's hash (native hash_layout_*), the poly-A/T
node inserted last (DBGgraph.cpp:152-164,417-418), and the enlargement
schedule of an undersized table (kmerSet.cpp:132-189) — and hands the node
table in slot order to native/assemble_engine.cpp, which replays the
pruning and readout and writes the eight *.contig.* files.  The bubble
comparison of the doubling readout (global_aligning,
compare_two_seq_simple) lives here too, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from .graph import NodeTable


@dataclass
class AssembleParams:
    ksize: int = 31
    kmer_freq_cutoff: int = 2          # -D
    init_hash_size: float = 1.0        # -i (units of 1e9 slots)
    load_factor: float = 0.7           # -l
    is_remove_tip: bool = True
    tip_len_cutoff: int = 100
    tip_depth_cutoff: float = 3.0
    is_remove_lowedge: bool = True
    lowedge_len_cutoff: int = 100
    lowedge_depth_cutoff: float = 3.0
    is_remove_bubble: bool = True
    bubble_len_cutoff: int = 100
    bubble_len_diff_rate: float = 0.1
    bubble_base_diff_rate: float = 0.1
    contig_len_cutoff: int = 125       # -M
    max_doublings: int = 10            # -e (DBGgraph.cpp:18)
    buffer_reads: int = 10_000         # -b (enlargement check granularity)


def global_aligning(seq_i: str, seq_j: str):
    """Needleman-Wunsch, match +3 / mismatch -5 / gap -5, tie preference
    subs >= gap_i >= gap_j (DBG_contig/global_aligning.cpp:20-35,98-182).
    Returns the two aligned strings, '-' at gaps."""
    gap = -5
    n, m = len(seq_i), len(seq_j)
    score = np.zeros((n + 1, m + 1), dtype=np.int64)
    direct = np.zeros((n + 1, m + 1), dtype=np.int8)
    score[0, 1:] = gap * np.arange(1, m + 1)
    direct[0, 1:] = 1
    score[1:, 0] = gap * np.arange(1, n + 1)
    direct[1:, 0] = 2
    si = np.frombuffer(seq_i.encode(), np.uint8)
    sj = np.frombuffer(seq_j.encode(), np.uint8)
    sub = np.where(si[:, None] == sj[None, :], 3, -5)
    for i in range(1, n + 1):
        srow = score[i - 1]
        subs = srow[:-1] + sub[i - 1]
        row = score[i]
        drow = direct[i]
        for j in range(1, m + 1):
            s = subs[j - 1]
            gi = row[j - 1] + gap
            gj = srow[j] + gap
            if s >= gi and s >= gj:
                row[j] = s
                drow[j] = 0
            elif gi > s and gi >= gj:
                row[j] = gi
                drow[j] = 1
            else:
                row[j] = gj
                drow[j] = 2
    ai, aj = [], []
    pi, pj = n, m
    while pi > 0 or pj > 0:
        d = direct[pi, pj]
        if d == 0:
            ai.append(seq_i[pi - 1])
            aj.append(seq_j[pj - 1])
            pi -= 1
            pj -= 1
        elif d == 1:
            ai.append("-")
            aj.append(seq_j[pj - 1])
            pj -= 1
        else:
            ai.append(seq_i[pi - 1])
            aj.append("-")
            pi -= 1
    return "".join(reversed(ai)), "".join(reversed(aj))


def compare_two_seq_simple(s1: str, s2: str) -> int:
    """Mismatches between two aligned strings, gaps not counted."""
    return sum(1 for a, b in zip(s1, s2) if a != b and a != "-" and b != "-")


def _cap(size: int, load: float) -> int:
    """max = (uint64)(size * load_factor) with C FLOAT math
    (kmerSet.cpp:113/149: load_factor is a 32-bit float member)."""
    return int(np.float32(size) * np.float32(load))


def initial_hash_size(params: AssembleParams) -> int:
    init = int(params.init_hash_size * 1_000_000_000)
    return 3 if init < 3 else native.find_next_prime(init)


@dataclass
class HashSchedule:
    """Enlargement/degrade plan derived from the first-occurrence read
    ordinals (emulates the between-buffer checks of DBGgraph.cpp:337-351
    and enlarge_kmerset_parallel, kmerSet.cpp:132-189)."""
    sizes: list          # hash size per epoch (len == n_enlarge + 1)
    ends: list           # node count at which each enlargement fires
    enlarge_reads: list  # global read ordinal of each enlargement boundary
    alerts: list         # (global boundary ordinal, Total_reads_num then)
    ingest_ranges: list | None   # [(start, end)] per file; None = no degrade


def compute_hash_schedule(first_read: np.ndarray, file_starts: list,
                          total_fed: int, params: AssembleParams):
    """Walk the reference's per-buffer capacity checks.  first_read: the
    first-occurrence global read ordinal of every NORMAL node (poly-A
    bypasses the hash during ingest, DBGgraph.cpp:152-164).  A check fires
    only after a FULL buffer (ReadsNum == BufferNum; a file's partial last
    buffer breaks the loop before the check)."""
    p = params
    size = initial_hash_size(p)
    cap = _cap(size, p.load_factor)
    b = p.buffer_reads
    fr = np.sort(first_read)
    bounds = list(file_starts) + [total_fed]
    sizes = [size]
    ends: list = []
    enlarge_reads: list = []
    alerts: list = []
    ranges: list = []
    t = 0
    stopped = False
    ingested = 0
    for fi in range(len(file_starts)):
        s, e = bounds[fi], bounds[fi + 1]
        if stopped:
            take = min(b, e - s)
            ranges.append((s, s + take))
            ingested += take
            if e - s >= b:          # full buffer -> the check fires again
                alerts.append((s + b, ingested))
            continue
        i = 1
        while s + i * b <= e:
            q = s + i * b
            c = int(np.searchsorted(fr, q))
            if c > cap:
                if t < p.max_doublings:
                    ns = size
                    while True:     # kmerSet.cpp:137 do-while, float math
                        ns = native.find_next_prime(ns * 2)
                        if not (np.float32(ns) * np.float32(p.load_factor)
                                < np.float32(c + 1)):
                            break
                    sizes.append(ns)
                    ends.append(c)
                    enlarge_reads.append(q)
                    size = ns
                    cap = _cap(size, p.load_factor)
                    t += 1
                else:
                    stopped = True
                    ranges.append((s, q))
                    ingested += q - s
                    alerts.append((q, ingested))
                    break
            i += 1
        if not stopped:
            ranges.append((s, e))
            ingested += e - s
    return HashSchedule(sizes, ends, enlarge_reads, alerts,
                        ranges if stopped else None)


@dataclass
class AssembleStats:
    total_nodes: int = 0
    deleted_lowfreq: int = 0
    linear_nodes: int = 0
    tip_candidates: int = 0
    branch_candidates: int = 0
    tips_removed: int = 0
    tip_len_removed: int = 0
    lowedges_removed: int = 0
    lowedge_len_removed: int = 0
    bubbles_removed: int = 0
    bubble_len_removed: int = 0
    contig_num: int = 0
    contig_len: int = 0
    small_num: int = 0
    small_len: int = 0
    hash_size: int = 0
    hash_conflicts: int = 0         # insert-time probe displacements
    hash_conflicts_occ: int = 0     # per-OCCURRENCE displacements: what the
    # reference's count_conflict accumulates in the ingest CAS loop
    # (DBGgraph.cpp:200) plus the final poly-A insert (DBGgraph.cpp:418)


class RefAssembler:
    """Replays the reference's pruning and readout over a NodeTable, in
    native/assemble_engine.cpp (single instance use)."""

    def __init__(self, table: NodeTable, params: AssembleParams,
                 schedule: HashSchedule | None = None, epoch_occ=None):
        """schedule/epoch_occ: hash-enlargement emulation (pipeline.run
        computes them when the node count exceeds the initial capacity);
        epoch_occ[e] = per-table-row occurrence counts with read ordinal
        below epoch boundary e (for the count_conflict parity)."""
        self.p = params
        self.stats = AssembleStats()
        self._build_hash(table, schedule, epoch_occ)

    def _build_hash(self, table: NodeTable, schedule=None, epoch_occ=None):
        p = self.p
        size = schedule.sizes[-1] if schedule is not None \
            else initial_hash_size(p)
        self.size = size
        self.stats.hash_size = size

        kmers = table.kmers
        lcnt = np.minimum(table.lcnt, 255).astype(np.int32)
        rcnt = np.minimum(table.rcnt, 255).astype(np.int32)
        first_idx = table.first_idx
        if not (kmers == 0).any():
            # the reference unconditionally appends a (possibly empty)
            # poly-A node (build_debruijn_graph, DBGgraph.cpp:417-418)
            kmers = np.concatenate([[np.uint64(0)], kmers])
            lcnt = np.concatenate([np.zeros((1, 4), np.int32), lcnt])
            rcnt = np.concatenate([np.zeros((1, 4), np.int32), rcnt])
            first_idx = np.concatenate([[np.int64(2 ** 62)], first_idx])
        M = len(kmers)
        is_polyA = kmers == 0
        normal = np.flatnonzero(~is_polyA)
        # first_idx values are distinct; the native radix argsort is stable
        order = normal[native.radix_argsort_u64(first_idx[normal])]
        if schedule is None and len(order) > _cap(size, p.load_factor):
            raise RuntimeError(
                f"node table ({len(order)}) exceeds hash capacity "
                f"({size}*{p.load_factor}) and no enlargement schedule "
                "was provided (pipeline.run computes one)")
        if len(order) >= size:
            raise RuntimeError(
                f"node table ({len(order)}) would overfill the final hash "
                f"({size}) — the reference would probe forever here")
        counts = table.counts
        if counts is not None and len(counts) != M:
            counts = np.concatenate([[np.int32(0)], counts])
        if schedule is not None and len(schedule.sizes) > 1:
            slots, conflicts, snaps = native.hash_layout_epochs(
                kmers[order], schedule.sizes, schedule.ends)
            self.stats.hash_conflicts = conflicts
            if counts is not None and epoch_occ is not None:
                # occurrences in epoch e probe the epoch-e layout: the
                # buffer whose completion triggers enlargement is inserted
                # (and probed) BEFORE the redistribution
                occ_cum = [np.zeros(M, np.int64)]
                for o in epoch_occ:
                    if len(o) != M:   # poly-A row prepended above
                        o = np.concatenate([[np.int64(0)], o])
                    occ_cum.append(o.astype(np.int64))
                occ_cum.append(counts.astype(np.int64))
                total = 0
                for e in range(len(schedule.sizes)):
                    sz = schedule.sizes[e]
                    sl = snaps[e]
                    ins = sl >= 0
                    home = (native.jenkins64(kmers[order][ins])
                            % np.uint64(sz)).astype(np.int64)
                    disp = (sl[ins] - home) % sz
                    d_occ = (occ_cum[e + 1][order][ins]
                             - occ_cum[e][order][ins])
                    total += int((disp * d_occ).sum())
                self.stats.hash_conflicts_occ = total
        else:
            # per-occurrence conflicts: every occurrence probes the full
            # insert-time displacement of its species (the slot path is
            # frozen at insert); poly-A k-mers bypass the hash
            slots, disp, conflicts = native.hash_layout_disp(kmers[order],
                                                             size)
            self.stats.hash_conflicts = conflicts
            if counts is not None:
                self.stats.hash_conflicts_occ = int(
                    (disp * counts[order].astype(np.int64)).sum())

        # node arrays indexed by node id 0..M-1 (+ sentinel row M of zeros)
        self.kmer = np.concatenate([kmers, [np.uint64(0)]])
        self.lcnt = np.concatenate([lcnt, np.zeros((1, 4), np.int32)])
        self.rcnt = np.concatenate([rcnt, np.zeros((1, 4), np.int32)])
        self.slot_of = np.full(M + 1, -1, np.int64)
        self.slot_of[order] = slots

        # poly-A node: inserted LAST regardless of first occurrence
        # (add_node_to_kmerset probing from jenkins(0)%size)
        occupied = np.zeros(size, bool)
        occupied[slots] = True
        pa = int(np.flatnonzero(is_polyA)[0])
        hc = int(native.jenkins64(np.uint64(0)) % np.uint64(size))
        while occupied[hc]:
            self.stats.hash_conflicts_occ += 1
            hc = 0 if hc + 1 == size else hc + 1
        self.slot_of[pa] = hc
        self.n_nodes = len(self.kmer) - 1     # excludes sentinel

        # slot order for iteration (ascending slot): slots are distinct,
        # so inverting by dense scatter replaces an argsort
        occ_node = np.full(size, -1, np.int64)
        occ_node[self.slot_of[:self.n_nodes]] = np.arange(self.n_nodes)
        self.slot_order = occ_node[occ_node >= 0]

    def run(self, prefix: str) -> AssembleStats:
        """Prune and read out in the native engine; writes the eight
        *.contig.* files under ``prefix``."""
        lcnt = np.ascontiguousarray(self.lcnt, np.int32)
        rcnt = np.ascontiguousarray(self.rcnt, np.int32)
        s = native.assemble_run(self.kmer, lcnt, rcnt, self.n_nodes,
                                self.slot_of[:self.n_nodes], self.size,
                                self.slot_order, prefix, self.p)
        st = self.stats
        (st.total_nodes, st.deleted_lowfreq, st.linear_nodes,
         st.tip_candidates, st.branch_candidates, st.tips_removed,
         st.tip_len_removed, st.lowedges_removed, st.lowedge_len_removed,
         st.bubbles_removed, st.bubble_len_removed, st.contig_num,
         st.contig_len, st.small_num, st.small_len) = (int(x) for x in s)
        return st
