"""Contig link graph for the scaffold readouts (link_scaffold, link_contig,
link_supertig).

Counterpart of dbg_assembly_tpu/scaffold/link.py.  Parity:
link_scaffold/link_func.cpp + link_scaffold.cpp.  The contig graph is small
(10^3-10^6 nodes), so this stage runs on the host with the reference's
exact semantics:

  * strand-doubled contig slots: "ctg_N" at odd slot N, its RC twin at N+1;
    each node carries only 3'-direction out-links (link_func.h:130-137);
  * per-node link lists in insertion order; removing a link zeroes the entry
    in place (traversal order preserved, link_func.cpp:430-473,671-694);
  * PE/MP parsers with F/R-combination gap arithmetic and the
    (-Insert/2, Insert] acceptance window (link_func.cpp:226-426);
  * low-freq pruning, interleaving-link removal, repeat-node removal, link
    cleanup (link_func.cpp:477-785);
  * scaffold readout: 3' chain walk both ways via RC twins, N-gap filling
    with max(gap,1), length-sorted odd scf ids (GCC 4.4 tie order),
    .pos.tab block table and repeat singlet outputs
    (link_scaffold.cpp:300-463,242-275).

Integer divisions (gap averages, -Insert/2) use C-style truncation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def c_div(a: int, b: int) -> int:
    """C++ integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def ctg_str2id(s: bytes) -> int:
    """Parity: ctgStr2Id (link_func.h:130-132) — atoi of chars after the
    4-char prefix."""
    tail = s[4:]
    num = b""
    for c in tail:
        ch = bytes([c])
        if ch.isdigit() or (ch in b"+-" and not num):
            num += ch
        else:
            break
    try:
        return int(num)
    except ValueError:
        return 0


def get_pair_id(i: int) -> int:
    return i - 1 if i % 2 == 0 else i + 1


def rev_comp(seq: bytes) -> bytes:
    """Parity: link_scaffold seqKmer reverse_complement — N preserved."""
    comp = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")
    return seq.translate(comp)[::-1]


def read_contig_file(path: str):
    """Parity: link_func.cpp:99-136 — strand-doubled vectors with empty RC
    slots; returns (contig_seqs, contig_ids) aligned at odd indices."""
    seqs = [b""]
    ids = [b""]
    cur = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line[:1] == b">":
                toks = [t for t in line.replace(b">", b" ")
                        .replace(b"\t", b" ").split(b" ") if t]
                ids.append(toks[0] if toks else b"")
                ids.append(b"")
                if sum(len(c) for c in cur) > 0:
                    seqs.append(b"".join(cur))
                    seqs.append(b"")
                cur = []
            else:
                cur.append(line)
    if sum(len(c) for c in cur) > 0:
        seqs.append(b"".join(cur))
        seqs.append(b"")
    return seqs, ids


@dataclass
class LinkGraph:
    n: int
    links: list = field(default_factory=list)   # per node: [id, freq, size]
    link: np.ndarray = None                     # 3' outgoing counts (<=255)
    inlink: np.ndarray = None                   # 5' incoming counts (<=255)
    deleted: np.ndarray = None
    counters: dict = field(default_factory=dict)

    @classmethod
    def create(cls, n: int):
        g = cls(n=n)
        g.links = [None] * n
        g.link = np.zeros(n, np.int32)
        g.inlink = np.zeros(n, np.int32)
        g.deleted = np.zeros(n, bool)
        g.counters = dict(FR=0, RF=0, FF=0, RR=0, wrong=0, lowfreq=0,
                          deleted=0, interleave=0)
        return g

    def add(self, src: int, dst: int, gap: int):
        """Parity: add_data_into_link (link_func.cpp:430-473)."""
        lst = self.links[src]
        if lst is None:
            self.links[src] = [[dst, 1, gap]]
            return
        for e in lst:
            if e[0] == dst:
                if e[1] < 1023:
                    e[1] += 1
                    e[2] += gap
                return
        lst.append([dst, 1, gap])

    # ------------------------------------------------------------- cleaning
    def remove_lowfreq_and_stat(self, pair_num_cut: int):
        """Parity: remove_lowfreq_link_and_stat (link_func.cpp:477-511)."""
        for i in range(self.n):
            lst = self.links[i]
            if lst is None:
                continue
            link_num = 0
            for e in lst:
                if e[1] < pair_num_cut:
                    e[0] = 0
                    e[1] = 0
                    e[2] = 0
                    self.counters["lowfreq"] += 1
                else:
                    link_num += 1
                    if self.inlink[e[0]] < 255:
                        self.inlink[e[0]] += 1
            self.link[i] = link_num if link_num < 255 else 255

    def linked_ids(self, src: int):
        """Parity: get_all_linked_ids (link_func.cpp:698-710)."""
        ids, gaps = [], []
        lst = self.links[src]
        if lst:
            for e in lst:
                if e[1] > 0:
                    ids.append(e[0])
                    gaps.append(c_div(e[2], e[1]))
        return ids, gaps

    def next_linked(self, src: int):
        """Parity: get_next_linked_id (link_func.cpp:826-840).
        Returns (next_id, gap) with next_id 0 when none."""
        lst = self.links[src]
        if lst:
            for e in lst:
                if e[1] > 0:
                    return e[0], c_div(e[2], e[1])
        return 0, 0

    def delete_link(self, src: int, dst: int):
        """Parity: delete_linked_id (link_func.cpp:671-694)."""
        lst = self.links[src]
        if lst:
            for e in lst:
                if e[1] > 0 and e[0] == dst:
                    e[0] = 0
                    e[1] = 0
                    e[2] = 0
                    if self.link[src] > 0:
                        self.link[src] -= 1
                    if self.inlink[dst] > 0:
                        self.inlink[dst] -= 1
                    return

    def remove_interleaving(self, contig_seqs):
        """Parity: remove_interleaving_links (link_func.cpp:543-581)."""
        for i in range(1, self.n):
            if self.deleted[i] or self.link[i] != 2:
                continue
            ids, gaps = self.linked_ids(i)
            for a, b in ((0, 1), (1, 0)):
                if self.link[ids[a]] == 1 and self.inlink[ids[a]] == 1:
                    mid = ids[a] if ids[a] % 2 == 1 else ids[a] - 1
                    judge = gaps[b] * 2
                    end_node, end_gap = self.next_linked(ids[a])
                    if end_node == ids[b] and gaps[a] < judge \
                            and end_gap < judge \
                            and len(contig_seqs[mid]) < judge:
                        self.delete_link(i, end_node)
                        self.counters["interleave"] += 1

    def strong_remove_interleaving(self):
        """Parity: strong_remove_interleaving_links (link_func.cpp:587-666)
        — 2-rank BFS variant designed for PacBio scaffolding (unspecific
        mapping yields missing hits).  Dead code in the reference program
        (call commented out at link_supertig.cpp:209) but part of the
        component surface.

        For every live node with 2..3 out-links: collect each direct
        successor's descendants to rank 2; any direct successor that also
        appears as a descendant (of any successor, itself included) gets
        its direct link from the start node removed, in ascending target
        order (std::map iteration)."""
        RANK_NUM = 2
        for i in range(1, self.n):
            if self.deleted[i] or not (2 <= self.link[i] <= 3):
                continue
            ids, _ = self.linked_ids(i)
            children = []
            for j in ids:
                vec = []
                cur = [j]
                for _ in range(RANK_NUM):
                    nxt = []
                    for node in cur:
                        lk, _ = self.linked_ids(node)
                        nxt.extend(lk)
                        vec.extend(lk)
                    cur = nxt
                children.append(vec)
            targets = set()
            for vec in children:
                for t in ids:
                    if t in vec:
                        targets.add(t)
            for t in sorted(targets):
                self.delete_link(i, t)
                self.counters["interleave"] += 1

    def remove_repeat_nodes(self):
        """Parity: remove_repeat_nodes (link_func.cpp:713-726)."""
        repeat = []
        for i in range(1, self.n):
            if not self.deleted[i] and (self.inlink[i] >= 2
                                        or self.link[i] >= 2):
                repeat.append(i)
                self.deleted[i] = True
                p = get_pair_id(i)
                self.deleted[p] = True
                repeat.append(p)
        return repeat

    def remove_small_nodes(self, contig_seqs, insert_size: int):
        """Parity: remove_small_nodes (link_func.cpp:729-743) — present in
        the reference but commented out of link_scaffold's main flow."""
        small = []
        for i in range(1, self.n):
            if (not self.deleted[i]) and i % 2 == 1 \
                    and len(contig_seqs[i]) < insert_size // 2:
                small.append(i)
                self.deleted[i] = True
                p = get_pair_id(i)
                self.deleted[p] = True
                small.append(p)
        return small

    def remove_links_from_deleted(self):
        """Parity: remove_links_from_deleted_nodes (link_func.cpp:747-785)."""
        for i in range(self.n):
            lst = self.links[i]
            if lst is None:
                continue
            for e in lst:
                src, dst = i, e[0]
                if self.deleted[src] or self.deleted[dst]:
                    e[0] = 0
                    e[1] = 0
                    e[2] = 0
                    self.counters["deleted"] += 1
                    if self.link[src] > 0:
                        self.link[src] -= 1
                    if self.inlink[dst] > 0:
                        self.inlink[dst] -= 1

    def display(self, path: str):
        """Parity: display_data_in_link (link_func.cpp:515-537)."""
        with open(path, "w") as f:
            f.write("ctg_id\tincoming_link_num\toutgoing_link_num\t"
                    "linked_id,pair_num,sum_size,avg_size;\n")
            for i in range(1, self.n):
                f.write(f"{i}\t{int(self.inlink[i])}\t{int(self.link[i])}")
                lst = self.links[i]
                if lst:
                    for e in lst:
                        if e[1] > 0:
                            f.write(f"\t{e[0]},{e[1]},{e[2]},"
                                    f"{c_div(e[2], e[1])}")
                f.write("\n")

    def get_linear_seq(self, start: int):
        """Parity: get_linear_seq (link_func.cpp:799-822).
        Returns flat [gap, id, gap, id, ...] and marks visited deleted."""
        out = []
        nxt = start
        while True:
            nxt, gap = self.next_linked(nxt)
            if not self.deleted[nxt]:
                out.append(gap)
                out.append(nxt)
            else:
                break
            self.deleted[nxt] = True
            self.deleted[get_pair_id(nxt)] = True
            if self.link[nxt] != 1:
                break
        return out


def parse_read_ends_map_file(path: str, g: LinkGraph):
    """Parity: parse_read_ends_map_file (link_func.cpp:141-220) — gap from
    read coordinates, no acceptance window (single-read two-part links)."""
    import gzip
    with gzip.open(path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            v = [t for t in line.replace(b"\t", b" ").rstrip(b"\n")
                 .split(b" ") if t]
            if len(v) < 19:
                continue
            d1, d2 = v[8], v[18]
            c1, c2 = v[4], v[14]
            gap = int(v[12]) - int(v[3]) - 1
            if d1 == b"F" and d2 == b"F":
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                g.counters["FF"] += 1
            elif d1 == b"R" and d2 == b"R":
                a2 = ctg_str2id(c1); a1 = a2 + 1
                a4 = ctg_str2id(c2); a3 = a4 + 1
                g.counters["RR"] += 1
            elif d1 == b"F" and d2 == b"R":
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a4 = ctg_str2id(c2); a3 = a4 + 1
                g.counters["FR"] += 1
            elif d1 == b"R" and d2 == b"F":
                a2 = ctg_str2id(c1); a1 = a2 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                g.counters["RF"] += 1
            else:
                g.counters["wrong"] += 1
                continue
            g.add(a1, a3, gap)
            g.add(a4, a2, gap)


def parse_pair_map_file(path: str, g: LinkGraph, contig_seqs,
                        insert_size: int, is_mate: bool):
    """Parity: parse_pair_ends_map_file (link_func.cpp:226-324) and
    parse_mate_pairs_map_file (:329-426)."""
    import gzip
    lo = -c_div(insert_size, 2)
    with gzip.open(path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            v = [t for t in line.replace(b"\t", b" ").rstrip(b"\n")
                 .split(b" ") if t]
            if len(v) < 19:
                continue
            d1, d2 = v[8], v[18]
            c1, c2 = v[4], v[14]
            c1s, c1e = int(v[6]), int(v[7])
            c2s, c2e = int(v[16]), int(v[17])
            I = insert_size

            def L(i):
                return len(contig_seqs[i])

            if not is_mate:
                if d1 == b"F" and d2 == b"R":
                    a1 = ctg_str2id(c1); a2 = a1 + 1
                    a3 = ctg_str2id(c2); a4 = a3 + 1
                    gap = I - (L(a1) - c1s) - c2e
                    g.counters["FR"] += 1
                elif d1 == b"R" and d2 == b"F":
                    a1 = ctg_str2id(c2); a2 = a1 + 1
                    a3 = ctg_str2id(c1); a4 = a3 + 1
                    gap = I - (L(a1) - c2s) - c1e
                    g.counters["RF"] += 1
                elif d1 == b"F" and d2 == b"F":
                    a1 = ctg_str2id(c1); a2 = a1 + 1
                    a4 = ctg_str2id(c2); a3 = a4 + 1
                    gap = I - (L(a1) - c1s) - (L(a4) - c2s)
                    g.counters["FF"] += 1
                elif d1 == b"R" and d2 == b"R":
                    a2 = ctg_str2id(c1); a1 = a2 + 1
                    a3 = ctg_str2id(c2); a4 = a3 + 1
                    ctg1_start = L(a2) - c1e
                    gap = I - (L(a2) - ctg1_start) - c2e
                    g.counters["RR"] += 1
                else:
                    g.counters["wrong"] += 1
                    continue
            else:
                if d1 == b"F" and d2 == b"R":
                    a1 = ctg_str2id(c2); a2 = a1 + 1
                    a3 = ctg_str2id(c1); a4 = a3 + 1
                    gap = I - (L(a1) - c2s) - c1e
                    g.counters["FR"] += 1
                elif d1 == b"R" and d2 == b"F":
                    a1 = ctg_str2id(c1); a2 = a1 + 1
                    a3 = ctg_str2id(c2); a4 = a3 + 1
                    gap = I - (L(a1) - c1s) - c2e
                    g.counters["RF"] += 1
                elif d1 == b"F" and d2 == b"F":
                    a2 = ctg_str2id(c1); a1 = a2 + 1
                    a3 = ctg_str2id(c2); a4 = a3 + 1
                    ctg1_start = L(a2) - c1e
                    gap = I - (L(a2) - ctg1_start) - c2e
                    g.counters["FF"] += 1
                elif d1 == b"R" and d2 == b"R":
                    a1 = ctg_str2id(c1); a2 = a1 + 1
                    a4 = ctg_str2id(c2); a3 = a4 + 1
                    gap = I - (L(a1) - c1s) - (L(a4) - c2s)
                    g.counters["RR"] += 1
                else:
                    g.counters["wrong"] += 1
                    continue
            if lo < gap <= I:
                g.add(a1, a3, gap)
                g.add(a4, a2, gap)
