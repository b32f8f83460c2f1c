"""Plain reference of debruijn_contig: the node table in PyTorch, then a
frozen copy of the port's Python replay of the upstream's pruning and
readout, with numpy in place of the native helpers it called.

Semantics of the upstream's DBG_contig (fanagislab/DBG_assembly,
DBG_contig/DBGgraph.cpp, kmerSet.cpp, contig.cpp):
  * ingest: reads cut to -r bases, reads shorter than k skipped, N read as
    A; each window's canonical k-mer gets its strand-adjusted left and
    right neighbour codes counted in 8-bit saturating counters;
  * the hash: jenkins64 % size with linear probing, nodes inserted in
    first-occurrence order, the poly-A node last (DBGgraph.cpp:152-164,
    417-418); every later pass visits nodes in slot order;
  * links (counters > -D), tips, low-coverage edges, bubbles (with the
    Needleman-Wunsch of global_aligning.cpp), then the readout, records
    sorted by length with GCC 4.4's std::sort (the shipped binaries' tie
    order), odd ids, split at -M.
The replay is the port's own readable specification, copied here so that
no change to the program moves the yardstick; it imports nothing of the
program and calls no native code.  It covers tables that fit the initial
hash (-i x load factor); the enlargement schedule is not reproduced.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BASES = "ACGTN"
C_BASES = "TGCAN"
CODE = torch.zeros(256, dtype=torch.uint8)
for _c, _v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    CODE[_c] = _v
M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _g6(x: float) -> str:
    return "%g" % x


def _lexical(x: float) -> str:
    return "%.17g" % x


def bit2seq(kbit: int, ksize: int) -> str:
    kbit = int(kbit)
    return "".join("ACGT"[(kbit >> (2 * (ksize - 1 - i))) & 3]
                   for i in range(ksize))


_RC_STEPS = ((0x3333333333333333, 2), (0x0F0F0F0F0F0F0F0F, 4),
             (0x00FF00FF00FF00FF, 8), (0x0000FFFF0000FFFF, 16),
             (0x00000000FFFFFFFF, 32))
_ALL64 = (1 << 64) - 1


def revcomp_int(kbit: int, k: int) -> int:
    """Reverse complement of one packed k-mer (seqKmer.cpp:89-97): the
    bases of the low 2k bits complemented and swapped end to end."""
    x = ~kbit & _ALL64
    for m, s in _RC_STEPS:
        x = ((x & m) << s) | ((x >> s) & m)
    return (x & _ALL64) >> (64 - 2 * k)


# ------------------------------------------------------------ node table
def node_table(seqs: list, k: int, max_read_len: int, device,
               rows: int = 65536):
    """(kmers uint64 ascending, lcnt, rcnt [M, 4] int32 saturated at 255,
    first [M] int64 first-occurrence order) of every window of the [N, L]
    ASCII reads of each file, in file order."""
    keys, lefts, rights, order = [], [], [], []
    base = 0
    for seq in seqs:
        seq = seq[:, :max_read_len]
        N, L = seq.shape
        P = L - k + 1
        if P <= 0:
            continue
        for off in range(0, N, rows):
            c = CODE.to(device)[seq[off:off + rows].to(device).long()].long()
            n = c.shape[0]
            fwd = torch.zeros((n, P), dtype=torch.int64, device=device)
            rc = torch.zeros_like(fwd)
            for i in range(k):
                ci = c[:, i:i + P]
                fwd = (fwd << 2) | ci
                rc = (rc >> 2) | ((3 - ci) << (2 * (k - 1)))
            use_fwd = fwd <= rc
            four = torch.full((n, 1), 4, dtype=torch.int64, device=device)
            prev = torch.cat([four, c[:, :P - 1]], dim=1)       # base j-1
            nxt = torch.cat([c[:, k:k + P - 1], four], dim=1)  # base j+k
            left = torch.where(use_fwd, prev,
                               torch.where(nxt == 4, 4, 3 - nxt))
            right = torch.where(use_fwd, nxt,
                                torch.where(prev == 4, 4, 3 - prev))
            keys.append(torch.where(use_fwd, fwd, rc).flatten())
            lefts.append(left.to(torch.uint8).flatten())
            rights.append(right.to(torch.uint8).flatten())
            order.append(base + off * P
                         + torch.arange(n * P, device=device))
        base += N * P
    keys = torch.cat(keys)
    sk, perm = torch.sort(keys, stable=True)
    del keys
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    starts = torch.nonzero(first).squeeze(1)
    seg = torch.cumsum(first, 0) - 1
    M = starts.numel()
    cnts = []
    for side in (lefts, rights):
        key = seg * 5 + torch.cat(side)[perm].long()
        cnts.append(torch.bincount(key, minlength=M * 5).view(M, 5)[:, :4]
                    .clamp_max(255).to(torch.int32).cpu().numpy())
    return (sk[starts].cpu().numpy().view(np.uint64), cnts[0], cnts[1],
            torch.cat(order)[perm[starts]].cpu().numpy())


# ---------------------------------------------------------------- the hash
def jenkins64(x: np.ndarray) -> np.ndarray:
    """The upstream's 64-bit integer hash (kmerSet.cpp), on uint64."""
    x = np.asarray(x, np.uint64).copy()
    with np.errstate(over="ignore"):
        x += (x << np.uint64(32)) ^ M64
        x ^= x >> np.uint64(22)
        x += (x << np.uint64(13)) ^ M64
        x ^= x >> np.uint64(8)
        x += x << np.uint64(3)
        x ^= x >> np.uint64(15)
        x += (x << np.uint64(27)) ^ M64
        x ^= x >> np.uint64(31)
    return x


def _is_prime(num: int) -> bool:
    """kmerSet.cpp:72-82: a strict bound at the float square root."""
    if num < 4:
        return True
    if num % 2 == 0:
        return False
    top = int(np.sqrt(np.float32(num)))
    for i in range(3, top, 2):
        if num % i == 0:
            return False
    return True


def find_next_prime(num: int) -> int:
    if num % 2 == 0:
        num += 1
    while not _is_prime(num):
        num += 2
    return num


def _runs(home: np.ndarray):
    """Keys sorted by home slot, and the slot each takes in that order
    without wrapping: the slots taken do not depend on the insertion
    order, only which key takes which does."""
    by_home = np.argsort(home, kind="stable")
    ar = np.arange(len(home), dtype=np.int64)
    return by_home, ar + np.maximum.accumulate(home[by_home] - ar)


def _layout(home: np.ndarray, size: int) -> np.ndarray:
    """Linear probing with no run of taken slots across the table's end:
    a key only ever probes slots of its own run, so the runs are replayed
    in turns, each turn placing the next key (in insertion order) of
    every run."""
    n = len(home)
    by_home, pos = _runs(home)
    if n and pos[-1] >= size:
        raise ValueError("a run of taken slots crosses the table's end")
    run_start = np.ones(n, bool)
    run_start[1:] = pos[1:] != pos[:-1] + 1
    run = np.empty(n, np.int64)
    run[by_home] = np.cumsum(run_start) - 1
    ar = np.arange(n, dtype=np.int64)
    by_run = np.lexsort((ar, run))
    first = np.ones(n, bool)
    first[1:] = run[by_run][1:] != run[by_run][:-1]
    starts = np.flatnonzero(first)
    rank = np.empty(n, np.int64)
    rank[by_run] = ar - np.repeat(starts, np.diff(np.append(starts, n)))
    slots = np.full(n, -1, np.int64)
    taken = np.zeros(size, bool)
    turns = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[turns], np.arange((rank.max() if n
                                                     else 0) + 2))
    for t in range(len(bounds) - 1):
        keys = turns[bounds[t]:bounds[t + 1]]
        cand = home[keys]
        while len(keys):
            free = ~taken[cand]
            slots[keys[free]] = cand[free]
            taken[cand[free]] = True
            keys, cand = keys[~free], cand[~free] + 1
    return slots


def hash_layout(kmers_in_order: np.ndarray, size: int) -> np.ndarray:
    """The slot of each key under linear probing (jenkins64 % size, +1 a
    probe, wrapping), keys inserted in the given order.  Where a run would
    cross the end, the table is turned so that a slot that stays free
    ends it: the keys that overflow the end fill the first free slots from
    0, so the free slot after those is free at the end too."""
    home = (jenkins64(kmers_in_order) % np.uint64(size)).astype(np.int64)
    _, pos = _runs(home)
    over = int((pos >= size).sum())
    if not over:
        return _layout(home, size)
    taken = np.zeros(size, bool)
    taken[pos[pos < size]] = True
    shift = int(np.flatnonzero(~taken)[over]) + 1
    return (_layout((home - shift) % size, size) + shift) % size


def gcc44_sort_perm_desc(lens: np.ndarray) -> list:
    """The permutation GCC 4.4's std::sort gives records compared by
    descending length (introsort, threshold 16, final insertion sort,
    heapsort past the depth limit), ties and all."""
    v = [(int(x), i) for i, x in enumerate(lens.tolist())]

    def cmp(a, b):
        return b[0] < a[0]

    def median(a, b, c):
        if cmp(a, b):
            if cmp(b, c):
                return b
            return c if cmp(a, c) else a
        if cmp(a, c):
            return a
        return c if cmp(b, c) else b

    def partition(first, last, pivot):
        while True:
            while cmp(v[first], pivot):
                first += 1
            last -= 1
            while cmp(pivot, v[last]):
                last -= 1
            if not first < last:
                return first
            v[first], v[last] = v[last], v[first]
            first += 1

    def linear_insert(last, val):
        nxt = last - 1
        while cmp(val, v[nxt]):
            v[last] = v[nxt]
            last = nxt
            nxt -= 1
        v[last] = val

    def insertion_sort(first, last):
        if first == last:
            return
        for i in range(first + 1, last):
            if cmp(v[i], v[first]):
                val = v[i]
                v[first + 1:i + 1] = v[first:i]
                v[first] = val
            else:
                linear_insert(i, v[i])

    def adjust_heap(first, hole, length, val):
        top = hole
        second = 2 * hole + 2
        while second < length:
            if cmp(v[first + second], v[first + second - 1]):
                second -= 1
            v[first + hole] = v[first + second]
            hole = second
            second = 2 * (second + 1)
        if second == length:
            v[first + hole] = v[first + second - 1]
            hole = second - 1
        parent = (hole - 1) // 2
        while hole > top and cmp(v[first + parent], val):
            v[first + hole] = v[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        v[first + hole] = val

    def heap_sort(first, last):
        length = last - first
        if length >= 2:
            parent = (length - 2) // 2
            while True:
                adjust_heap(first, parent, length, v[first + parent])
                if parent == 0:
                    break
                parent -= 1
        while last - first > 1:
            last -= 1
            val = v[last]
            v[last] = v[first]
            adjust_heap(first, 0, last - first, val)

    def introsort(first, last, depth):
        while last - first > 16:
            if depth == 0:
                heap_sort(first, last)
                return
            depth -= 1
            pivot = median(v[first], v[first + (last - first) // 2],
                           v[last - 1])
            cut = partition(first, last, pivot)
            introsort(cut, last, depth)
            last = cut

    n = len(v)
    if n:
        introsort(0, n, 2 * (n.bit_length() - 1))
        if n > 16:
            insertion_sort(0, 16)
            for i in range(16, n):
                linear_insert(i, v[i])
        else:
            insertion_sort(0, n)
    return [i for _, i in v]


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


class Assembler:
    """The pruning and readout over a node table, in slot order."""

    def __init__(self, kmers, lcnt, rcnt, first, params: AssembleParams):
        p = self.p = params
        self.k = p.ksize
        self.mask = (1 << (2 * self.k)) - 1
        init = int(p.init_hash_size * 1_000_000_000)
        size = 3 if init < 3 else find_next_prime(init)
        cap = int(np.float32(size) * np.float32(p.load_factor))
        if not (kmers == 0).any():
            # the upstream appends a (possibly empty) poly-A node
            kmers = np.concatenate([[np.uint64(0)], kmers])
            lcnt = np.concatenate([np.zeros((1, 4), np.int32), lcnt])
            rcnt = np.concatenate([np.zeros((1, 4), np.int32), rcnt])
            first = np.concatenate([[np.int64(2 ** 62)], first])
        M = len(kmers)
        is_polyA = kmers == 0
        normal = np.flatnonzero(~is_polyA)
        order = normal[np.argsort(first[normal], kind="stable")]
        if len(order) > cap:
            raise ValueError(f"{len(order)} nodes exceed the initial hash "
                             f"({size} x {p.load_factor}); the reference "
                             "does not replay its enlargement")
        slots = hash_layout(kmers[order], size)
        self.kmer = np.concatenate([kmers, [np.uint64(0)]])
        self.lcnt = np.concatenate([lcnt, np.zeros((1, 4), np.int32)])
        self.rcnt = np.concatenate([rcnt, np.zeros((1, 4), np.int32)])
        slot_of = np.full(M + 1, -1, np.int64)
        slot_of[order] = slots
        taken = np.zeros(size, bool)
        taken[slots] = True
        pa = int(np.flatnonzero(is_polyA)[0])
        hc = int(jenkins64(np.zeros(1, np.uint64))[0] % np.uint64(size))
        while taken[hc]:
            hc = 0 if hc + 1 == size else hc + 1
        slot_of[pa] = hc
        self.polyA_id = pa
        self.n_nodes = M
        self.SENT_ID = M
        self._lookup = None
        n1 = M + 1
        self.deleted = np.zeros(n1, bool)
        self.l_num = np.zeros(n1, np.int8)
        self.l_base = np.zeros(n1, np.int8)
        self.r_num = np.zeros(n1, np.int8)
        self.r_base = np.zeros(n1, np.int8)
        self.linear = np.zeros(n1, bool)
        self.in_tip = np.zeros(n1, bool)
        self.in_bubble = np.zeros(n1, bool)
        self.in_lowedge = np.zeros(n1, bool)
        self.in_repeat = np.zeros(n1, bool)
        occ = np.full(size, -1, np.int64)
        occ[slot_of[:M]] = np.arange(M)
        self.slot_order = occ[occ >= 0]
        self.stats = AssembleStats()

    @property
    def lookup(self) -> dict:
        """k-mer -> node id (exist_kmerset) of the nodes live at first use
        (after the link pass; a deleted node never comes back); poly-A's
        key 0 maps to the poly-A node."""
        if self._lookup is None:
            live = np.flatnonzero(~self.deleted[:self.n_nodes])
            self._lookup = dict(zip(self.kmer[live].tolist(), live.tolist()))
            self._lookup[0] = self.polyA_id
        return self._lookup

    def exist(self, kmer: int) -> int:
        """Node id of a live k-mer, else the sentinel id."""
        nid = self.lookup.get(kmer, self.SENT_ID)
        if nid != self.SENT_ID and self.deleted[nid]:
            return self.SENT_ID
        return nid

    # --------------------------------------------------------------- klinks
    def calculate_kmer_links(self):
        """Parity: contig.cpp:107-205, in bulk."""
        cut = self.p.kmer_freq_cutoff
        n = self.n_nodes
        l = self.lcnt[:n]
        r = self.rcnt[:n]
        lq = l > cut
        rq = r > cut
        self.l_num[:n] = np.minimum(lq.sum(1), 3)
        self.r_num[:n] = np.minimum(rq.sum(1), 3)
        self.l_base[:n] = np.argmax(np.where(lq, l, 0), axis=1)
        self.r_base[:n] = np.argmax(np.where(rq, r, 0), axis=1)
        self.linear[:n] = (self.l_num[:n] == 1) & (self.r_num[:n] == 1)
        no_links = (self.l_num[:n] == 0) & (self.r_num[:n] == 0)
        self.deleted[:n] |= no_links

        # depth histogram over all 8 counters of every node
        self.depth_stat = (np.bincount(l.reshape(-1), minlength=256)
                           + np.bincount(r.reshape(-1), minlength=256))

        st = self.stats
        st.total_nodes = n
        st.deleted_lowfreq = int(no_links.sum())
        st.linear_nodes = int(self.linear[:n].sum())
        so = self.slot_order
        self.tip_nodes = so[(self.l_num[so] + self.r_num[so]) == 1]
        self.branch_nodes = so[(self.l_num[so] > 1) | (self.r_num[so] > 1)]
        st.tip_candidates = len(self.tip_nodes)
        st.branch_candidates = len(self.branch_nodes)

    def write_kmer_freq(self, path: str):
        with open(path, "w") as f:
            f.write("Kmer_depth\tAppear_times\n")
            for i in range(1, 256):
                f.write(f"{i}\t{self.depth_stat[i]}\n")

    def _neighbor(self, km: int, base: int, right: bool) -> int:
        """The k-mer one step right (base appended) or left (prepended)."""
        if right:
            return ((km << 2) | base) & self.mask
        return (km >> 2) + (base << (2 * (self.k - 1)))

    def recalculate_kmer_links(self, idx: int):
        """Parity: contig.cpp:210-277 (re-validate the neighbours, clear
        the counters of the dangling ones)."""
        if idx == self.SENT_ID:
            return
        cut = self.p.kmer_freq_cutoff
        k = self.k
        km = int(self.kmer[idx])
        self.linear[idx] = False
        for right, cnt, num, base in (
                (False, self.lcnt, self.l_num, self.l_base),
                (True, self.rcnt, self.r_num, self.r_base)):
            num[idx] = 0
            base[idx] = 0
            maxd = 0
            for j in range(4):
                d = int(cnt[idx, j])
                if d > cut:
                    nk = self._neighbor(km, j, right)
                    rc = revcomp_int(nk, k)
                    if self.exist(nk if nk < rc else rc) != self.SENT_ID:
                        if num[idx] < 3:
                            num[idx] += 1
                        if maxd < d:
                            maxd = d
                            base[idx] = j
                    else:
                        cnt[idx, j] = 0
        if self.l_num[idx] == 1 and self.r_num[idx] == 1:
            self.linear[idx] = True

    # ---------------------------------------------------------------- walks
    def _step(self, idx: int, walk_direct: int, original: int):
        """One step of a linear walk from idx: (next k-mer, edge depth,
        the emitted base)."""
        km = int(self.kmer[idx])
        if walk_direct == 1:
            b = int(self.r_base[idx])
            ch = BASES[b] if original == 1 else C_BASES[b]
            return self._neighbor(km, b, True), int(self.rcnt[idx, b]), ch
        b = int(self.l_base[idx])
        ch = C_BASES[b] if original == 1 else BASES[b]
        return self._neighbor(km, b, False), int(self.lcnt[idx, b]), ch

    def _end_mark(self, nxt: int) -> str:
        if nxt == self.SENT_ID or self.l_num[nxt] == 0 \
                or self.r_num[nxt] == 0:
            return "break"
        return "branch"

    def get_linear_path(self, idx: int, walk_direct: int, len_cutoff: int):
        """Parity: contig.cpp:779-827.  Returns (length, depth, visited
        ids, emitted bases, last id, end mark)."""
        k = self.k
        original = walk_direct
        path_len = 0
        path_depth = 0
        vec = []
        chars = []
        while True:
            path_len += 1
            vec.append(idx)
            nk, d, ch = self._step(idx, walk_direct, original)
            path_depth += d
            chars.append(ch)
            rc = revcomp_int(nk, k)
            if nk < rc:
                nf = nk
            else:
                nf = rc
                walk_direct = -walk_direct
            nxt = self.exist(nf)
            if (not self.linear[nxt]) or nxt == self.SENT_ID \
                    or path_len >= len_cutoff:
                return (path_len, path_depth, vec, "".join(chars), nxt,
                        self._end_mark(nxt))
            idx = nxt

    def get_linear_seq(self, idx: int, walk_direct: int):
        """Parity: contig.cpp:832-896 (deletes the nodes it passes).
        Returns (length, depth, emitted bases, last id, end mark, depth
        bytes, repeat tag)."""
        k = self.k
        original = walk_direct
        seq_len = 0
        seq_depth = 0
        chars = []
        depths = bytearray()
        while True:
            seq_len += 1
            nk, d, ch = self._step(idx, walk_direct, original)
            seq_depth += d
            depths.append(d - 1 if d in (10, 62) else d)
            chars.append(ch)
            rc = revcomp_int(nk, k)
            if nk < rc:
                nf = nk
            else:
                nf = rc
                walk_direct = -walk_direct
            nxt = self.exist(nf)
            if (not self.linear[nxt]) or nxt == self.SENT_ID:
                mark = self._end_mark(nxt)
                is_repeat = "Unknown"
                if mark == "branch":
                    is_repeat = "Repeat" if (
                        (walk_direct == 1 and self.r_num[nxt] > 1)
                        or (walk_direct == -1 and self.l_num[nxt] > 1)) \
                        else "Unique"
                return (seq_len, seq_depth, "".join(chars), nxt, mark,
                        bytes(depths), is_repeat)
            self.deleted[nxt] = True
            idx = nxt

    # ----------------------------------------------------------------- tips
    def remove_error_tips(self, out_path: str):
        """Parity: contig.cpp:281-357."""
        p = self.p
        lines = []
        total_num = 0
        total_len = 0
        for idx in self.tip_nodes.tolist():
            walk = -1 if self.l_num[idx] == 1 else 1
            (tip_len, tip_depth, vec, tip_str, last,
             mark) = self.get_linear_path(idx, walk, p.tip_len_cutoff)
            avg = tip_depth / tip_len
            if avg <= p.tip_depth_cutoff and tip_len <= p.tip_len_cutoff:
                total_num += 1
                total_len += tip_len
                self.deleted[vec] = True
                self.recalculate_kmer_links(last)
                self.in_tip[last] = True
                if walk == 1:
                    lkm, lmark = int(self.kmer[idx]), "break"
                    rkm, rmark = int(self.kmer[last]), mark
                else:
                    rkm, rmark = int(self.kmer[idx]), "break"
                    lkm, lmark = int(self.kmer[last]), mark
                kmer_str = bit2seq(int(self.kmer[idx]), self.k)
                out = kmer_str + tip_str if walk == 1 \
                    else tip_str[::-1] + kmer_str
                lines.append(
                    f">tip_{total_num}\tlength: {tip_len + self.k}"
                    f"\tavgDepth: {_g6(avg)}"
                    f"\tLeftEndKmer: {lkm} {lmark}"
                    f"\tRightEndKmer: {rkm} {rmark}\n{out}\n")
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.tips_removed = total_num
        self.stats.tip_len_removed = total_len

    # ------------------------------------------------------------- lowedges
    def _branch_bases(self, cnt_row) -> tuple[list[int], list[int]]:
        """The bases of a side's counters above the cutoff, and their
        depths."""
        cut = self.p.kmer_freq_cutoff
        bases, depths = [], []
        for j in range(4):
            d = int(cnt_row[j])
            if d > cut:
                bases.append(j)
                depths.append(d)
        return bases, depths

    def remove_lowCov_edges(self, out_path: str):
        """Parity: contig.cpp:640-775, right side first."""
        p = self.p
        k = self.k
        lines = []
        num = 0
        tot_len = 0
        for idx in self.branch_nodes.tolist():
            for right in (True, False):
                if (self.r_num if right else self.l_num)[idx] < 2:
                    continue
                vb, vd = self._branch_bases(
                    (self.rcnt if right else self.lcnt)[idx])
                for j in range(len(vb)):
                    nk = self._neighbor(int(self.kmer[idx]), vb[j], right)
                    rc = revcomp_int(nk, k)
                    if nk < rc:
                        nf, w1 = nk, 1 if right else -1
                    else:
                        nf, w1 = rc, -1 if right else 1
                    idx1 = self.exist(nf)
                    if not self.linear[idx1]:
                        continue
                    (elen, edep, vec, estr, last,
                     mark) = self.get_linear_path(idx1, w1,
                                                  p.lowedge_len_cutoff)
                    elen += 1
                    edep += vd[j]
                    avg = edep / elen
                    if elen <= p.lowedge_len_cutoff and \
                            avg <= p.lowedge_depth_cutoff and \
                            not self.linear[last]:
                        num += 1
                        tot_len += elen
                        self.deleted[vec] = True
                        self.recalculate_kmer_links(last)
                        self.recalculate_kmer_links(idx)
                        self.in_lowedge[idx] = True
                        self.in_lowedge[last] = True
                        kmer_str1 = bit2seq(int(self.kmer[idx1]), k)
                        out1 = kmer_str1 + estr if w1 == 1 \
                            else estr[::-1] + kmer_str1
                        if right:
                            lines.append(
                                f">lowedge_{num}\tlength: {elen + k}"
                                f"\tavgDepth: {_g6(avg)}"
                                f"\tLeftEndKmer: {int(self.kmer[idx])} "
                                f"branch\tRightEndKmer: "
                                f"{int(self.kmer[last])} {mark}\n{out1}\n")
                        else:
                            # the reference's leftward header spacing
                            # (contig.cpp:763), kept
                            lines.append(
                                f">lowedge_{num}    length:{elen + k}"
                                f"    avgDepth:{_g6(avg)}"
                                f"\tLeftEndKmer: {int(self.kmer[last])} "
                                f"{mark}\tRightEndKmer: "
                                f"{int(self.kmer[idx])} branch\n{out1}\n")
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.lowedges_removed = num
        self.stats.lowedge_len_removed = tot_len

    # -------------------------------------------------------------- bubbles
    def remove_hetero_bubbles(self, out_path: str):
        """Parity: contig.cpp:361-636."""
        p = self.p
        k = self.k
        lines = []
        num = 0
        tot_len = 0
        comp = str.maketrans("ACGTN", "TGCAN")
        for idx in self.branch_nodes.tolist():
            if self.l_num[idx] == 2 and self.r_num[idx] == 1:
                walk = -1
                vb, vd = self._branch_bases(self.lcnt[idx])
            elif self.l_num[idx] == 1 and self.r_num[idx] == 2:
                walk = 1
                vb, vd = self._branch_bases(self.rcnt[idx])
            else:
                continue
            km = int(self.kmer[idx])
            ends = []
            for b in vb[:2]:
                nk = self._neighbor(km, b, walk == 1)
                rc = revcomp_int(nk, k)
                ends.append((nk, walk) if nk < rc else (rc, -walk))
            (nf1, w1), (nf2, w2) = ends
            idx1 = self.exist(nf1)
            idx2 = self.exist(nf2)
            if not self.linear[idx1] or not self.linear[idx2]:
                continue
            (len1, dep1, vec1, str1, last1,
             mark1) = self.get_linear_path(idx1, w1, p.bubble_len_cutoff)
            (len2, dep2, vec2, str2, last2,
             mark2) = self.get_linear_path(idx2, w2, p.bubble_len_cutoff)
            avg1 = dep1 / len1
            avg2 = dep2 / len2
            if last1 != last2:
                if avg1 > p.lowedge_depth_cutoff and \
                        avg2 > p.lowedge_depth_cutoff:
                    self.in_repeat[idx] = True
                continue
            ks1 = bit2seq(int(self.kmer[idx1]), k)
            bs1 = ks1 + str1 if w1 == 1 else str1[::-1] + ks1
            ks2 = bit2seq(int(self.kmer[idx2]), k)
            bs2 = ks2 + str2 if w2 == 1 else str2[::-1] + ks2
            if w1 != w2:
                bs1 = bs1[::-1].translate(comp)
            len1 += 1
            len2 += 1
            dep1 += vd[0]
            dep2 += vd[1]
            diff_rate = 0.0
            btype = ""
            if len1 == len2:
                diff_rate = compare_two_seq_simple(bs1, bs2) / len1
                btype = "SNP"
            if len1 != len2 or diff_rate > p.bubble_base_diff_rate:
                bs1, bs2 = global_aligning(bs1, bs2)
                diff_rate = compare_two_seq_simple(bs1, bs2) / len1
                btype = "INDEL"
            if diff_rate < p.bubble_base_diff_rate and \
                    abs(len1 - len2) < p.bubble_len_cutoff * \
                    p.bubble_len_diff_rate and \
                    len1 <= p.bubble_len_cutoff and \
                    len2 <= p.bubble_len_cutoff:
                if avg1 < avg2:
                    vec, last, ln, removed = vec1, last1, len1, 1
                else:
                    vec, last, ln, removed = vec2, last2, len2, 2
                self.deleted[vec] = True
                self.recalculate_kmer_links(last)
                self.recalculate_kmer_links(idx)
                num += 1
                tot_len += ln
                if walk == 1:
                    lkm, lmark = int(self.kmer[idx]), "branch"
                    rkm, rmark = int(self.kmer[last1]), mark1
                else:
                    rkm, rmark = int(self.kmer[idx]), "branch"
                    lkm, lmark = int(self.kmer[last1]), mark1
                lines.append(
                    f">bubble_{num}\ttype: {btype}\tlength1: {len1 + k}"
                    f"\tavgDepth1: {_g6(avg1)}\tlength2: {len2 + k}"
                    f"\tavgDepth2: {_g6(avg2)}\tremoved: {removed}"
                    f"\tLeftEndKmer: {lkm} {lmark}"
                    f"\tRightEndKmer: {rkm} {rmark}\n{bs1}\n{bs2}\n")
                self.in_bubble[idx] = True
                self.in_bubble[last1] = True
        with open(out_path, "w") as f:
            f.writelines(lines)
        self.stats.bubbles_removed = num
        self.stats.bubble_len_removed = tot_len

    # -------------------------------------------------------------- readout
    def read_out_contig(self, prefix: str):
        """Parity: contig.cpp:900-1046: every live linear node in slot order
        seeds a contig; records sorted by length (GCC 4.4's std::sort),
        odd ids, split at contig_len_cutoff."""
        p = self.p
        k = self.k
        recs = []       # (len, header after the id, depth bytes)
        for i in self.slot_order.tolist():
            if self.deleted[i] or not self.linear[i]:
                continue
            kmer_str = bit2seq(int(self.kmer[i]), k)
            (rlen, rdep, rstr, rlast, rmark, rdepths,
             rrep) = self.get_linear_seq(i, 1)
            (llen, ldep, lstr, llast, lmark, ldepths,
             lrep) = self.get_linear_seq(i, -1)
            ctype = "RepeatNode" if (lrep == "Repeat" and rrep == "Repeat") \
                else ""
            self.deleted[i] = True
            contig_str = lstr[::-1] + kmer_str + rstr
            contig_len = llen + k + rlen
            contig_depth = (ldep + rdep) / (llen + rlen)
            dv = int(contig_depth) & 0xFF
            if dv in (10, 62):
                dv -= 1
            depth_bytes = ldepths[::-1] + bytes([dv] * k) + rdepths
            header = (f"\tlength: {contig_len}"
                      f"\tavgDepth: {_lexical(contig_depth)}"
                      f"\tLeftEndKmer: {int(self.kmer[llast])} "
                      f"{lmark}-{lrep}"
                      f"\tRightEndKmer: {int(self.kmer[rlast])} "
                      f"{rmark}-{rrep}\t{ctype}\n{contig_str}\n")
            recs.append((len(contig_str), header, depth_bytes))

        lens = np.array([r[0] for r in recs], dtype=np.uint64)
        perm = gcc44_sort_perm_desc(lens) if len(recs) else []
        st = self.stats
        with open(prefix + ".contig.seq.fa", "w") as ctg_f, \
                open(prefix + ".contig.seq.depth", "wb") as ctg_d, \
                open(prefix + ".contig.small.fa", "w") as small_f, \
                open(prefix + ".contig.small.depth", "wb") as small_d:
            contig_id = 1
            for pi in perm:
                ln, header, depth_bytes = recs[int(pi)]
                name = f">ctg_{contig_id}"
                if ln >= p.contig_len_cutoff:
                    ctg_f.write(name + header)
                    ctg_d.write(name.encode() + b"\n" + depth_bytes + b"\n")
                    st.contig_num += 1
                    st.contig_len += ln
                else:
                    small_f.write(name + header)
                    small_d.write(name.encode() + b"\n" + depth_bytes
                                  + b"\n")
                    st.small_num += 1
                    st.small_len += ln
                contig_id += 2

    def run(self, prefix: str) -> AssembleStats:
        """The replay in Python, phase by phase (contig.cpp:54-102)."""
        p = self.p
        self.calculate_kmer_links()
        self.write_kmer_freq(prefix + ".contig.kmer.freq")
        if p.is_remove_tip:
            self.remove_error_tips(prefix + ".contig.tip.fa")
            self.tip_nodes = np.zeros(0, np.int64)
        if p.is_remove_lowedge:
            self.remove_lowCov_edges(prefix + ".contig.lowedge.fa")
        if p.is_remove_bubble:
            self.remove_hetero_bubbles(prefix + ".contig.bubble.fa")
            self.branch_nodes = np.zeros(0, np.int64)
        self.read_out_contig(prefix)
        return self.stats
