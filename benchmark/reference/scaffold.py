"""Plain reference of map_pair and link_scaffold: the contig index and the
seed-and-extend mapper written in PyTorch from the upstream's semantics,
then a frozen copy of the port's link graph and scaffold readout.

Neither half is independent of the port's reading of the upstream: the
mapper takes the same steps as the port's device kernel (the first seed
by an argmax over the windows, no check that the two seed k-mers agree
on strand), and the link graph is the port's, copied.  What replays no
tool is reference/guarantees_scaffold.py: map_lines_misaligned recounts
every mapped mate against its contig, and scaffold_gaps_unsupported
recomputes every gap and orientation of a scaffold from the 2ctg lines.

map_pair (fanagislab/DBG_assembly, link_scaffold/map_pair.cpp:50-354,
map_func.cpp:81-324, kmerSet.cpp:168-210), as its outputs show it:
  * contigs: the FASTA's records by their first header token, a record
    with no sequence dropped but the last; a contig shorter than -l keeps
    its slot with no k-mer; a contig is cut at its N runs and every window
    of k bases inside one piece is a k-mer;
  * a k-mer is held under min(k-mer, reverse complement), "forward" where
    the k-mer is the smaller; the first window inserted (contig order,
    then position) keeps the payload (contig, position, strand), and the
    k-mer is unique where no other window has it;
  * a read's seed is its first position i (i <= length - k - S) whose
    k-mer and the k-mer S later are both in the index, both unique, on
    one contig, exactly S apart there; the read's strand is the seed
    k-mer's against the contig's;
  * the seed extends without gaps to the first end of read or contig on
    either side; identity is 1 - mismatches / aligned length, the
    mismatches counted outside the seed span, the ratio in float32 and
    the difference in double, stored as float; a mate maps where the
    identity, promoted to double, is not below -i;
  * pairs whose mates are both at least -r long are routed: both mapped
    to different contigs (.2ctg), to one contig (.1ctg), one mapped
    (.gap, the mapped mate's line), none; the .stat counts them.
Reads are read as the benchmark made them (N as A, as the upstream's
k-mer packing reads it); nothing here imports the program or reads what
it wrote.

link_scaffold (link_scaffold.cpp:89-463, link_func.cpp:99-840): the
port's LinkGraph and readout (scaffold/link.py, scaffold/scaffold.py),
copied here so that no change to the program moves the yardstick, on
bytes in memory; GCC 4.4's sort is reference/contig.py's.
"""

from __future__ import annotations

import numpy as np
import torch

from .contig import gcc44_sort_perm_desc
from .kmers import CODE, revcomp

HEADER_PAIR = (b"#read_id\tread_length\talign_read_start\talign_read_end\t"
               b"contig_id\tcontig_length\talign_contig_start\t"
               b"align_contig_end\talign_direct\talign_identity%\tread_id\t"
               b"read_length\talign2_read_start\talign2_read_end\t"
               b"contig2_id\tcontig2_length\talign2_contig_start\t"
               b"align2_contig_end\talign2_direct\talign2_identity%\n")
HEADER_ONE = (b"#read_id\tread_length\talign_read_start\talign_read_end\t"
              b"contig_id\tcontig_length\talign_contig_start\t"
              b"align_contig_end\talign_direct\talign_identity%\n")
COMPLEMENT = torch.arange(256, dtype=torch.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    COMPLEMENT[_a] = _b
IS_N = torch.zeros(256, dtype=torch.bool)
IS_N[ord("N")] = IS_N[ord("n")] = True


# ------------------------------------------------------------ map_pair
def fasta_records(data: bytes) -> list:
    """(id, sequence) of each record map_pair reads: the header's first
    token; lines joined; a record with no sequence dropped unless last."""
    out = []
    chunks = data.split(b"\n>")
    if not data.startswith(b">"):
        chunks = chunks[1:]
    if chunks:
        chunks[0] = chunks[0][1:]
    for i, chunk in enumerate(chunks):
        head, _, body = chunk.partition(b"\n")
        seq = body.replace(b"\n", b"")
        toks = head.split()
        if seq or i == len(chunks) - 1:
            out.append((toks[0] if toks else b"", seq))
    return out


def _kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Forward 2-bit k-mers of each window of the last axis, int64."""
    P = codes.shape[-1] - k + 1
    out = torch.zeros(codes.shape[:-1] + (P,), dtype=torch.int64,
                      device=codes.device)
    for i in range(k):
        out = (out << 2) | codes[..., i:i + P]
    return out


class Index:
    """The unique-k-mer index of the contigs: sorted canonical k-mers, the
    first inserted window's payload each, whether the k-mer is unique."""

    def __init__(self, seqs: list, k: int, min_len: int, device):
        self.k = k
        self.seqs = [s if len(s) >= min_len else b"" for s in seqs]
        lens = [len(s) for s in self.seqs]
        self.lengths = torch.tensor(lens, dtype=torch.int64, device=device)
        self.starts = torch.tensor([0] + lens, dtype=torch.int64,
                                   device=device).cumsum(0)[:-1]
        joined = bytearray(b"".join(self.seqs)) or bytearray(b"\0")
        self.bases = torch.frombuffer(joined, dtype=torch.uint8).to(device)
        # every window of the contigs laid end to end, kept where it lies
        # inside one contig and holds no N
        e = torch.zeros(0, dtype=torch.int64, device=device)
        keys, cid, pos, fwd = e, e, e, e.bool()
        if sum(lens) >= k:
            row = self.bases.long()
            km = _kmers(CODE.to(device)[row].long(), k)
            n_in = torch.nn.functional.pad(
                IS_N.to(device)[row].to(torch.int32).cumsum(0), (1, 0))
            owner = torch.repeat_interleave(
                torch.arange(len(lens), device=device), self.lengths)
            at = torch.nonzero(((n_in[k:] - n_in[:-k]) == 0)
                               & (owner[:1 - k or None] == owner[k - 1:]))[:, 0]
            rc = revcomp(km, k)
            keys = torch.minimum(km, rc)[at]
            fwd = (km < rc)[at]
            cid = owner[at]
            pos = at - self.starts[cid]
        # windows in contig order, then position: the stable sort keeps the
        # first inserted first in each run
        sorted_keys, order = torch.sort(keys, stable=True)
        self.keys, counts = torch.unique_consecutive(sorted_keys,
                                                     return_counts=True)
        first = order[torch.cumsum(counts, 0) - counts]
        self.unique = counts == 1
        self.cid = cid[first]
        self.pos = pos[first]
        self.fwd = fwd[first]

    def find(self, q: torch.Tensor):
        """(found, unique, contig, position, forward) of each k-mer."""
        if self.keys.numel() == 0:
            z = torch.zeros_like(q)
            return z.bool(), z.bool(), z, z, z.bool()
        at = torch.searchsorted(self.keys, q).clamp_(max=self.keys.numel()
                                                     - 1)
        return (self.keys[at] == q, self.unique[at], self.cid[at],
                self.pos[at], self.fwd[at])


def map_block(ix: Index, seqs: torch.Tensor, lengths: torch.Tensor, S: int,
              min_identity: float) -> dict:
    """Map each read of a block, [B, L] ASCII (pad past its length) and
    [B] lengths: numpy arrays of mapped, contig, the read's and the
    contig's 1-based spans, forward, identity (float32)."""
    dev = seqs.device
    k = ix.k
    B, L = seqs.shape
    P = L - k + 1
    none = {"mapped": np.zeros(B, bool)}
    if P <= S or B == 0:
        return none
    km = _kmers(CODE.to(dev)[seqs.long()].long(), k)
    rc = revcomp(km, k)
    found, uniq, cid, pos, cfwd = (x.reshape(B, P) for x in ix.find(
        torch.minimum(km, rc).reshape(-1)))
    good = found & uniq
    i = torch.arange(P - S, device=dev)
    seed_ok = (good[:, :-S] & good[:, S:] & (cid[:, :-S] == cid[:, S:])
               & ((pos[:, S:] - pos[:, :-S]).abs() == S)
               & (i[None, :] <= (lengths[:, None] - k - S)))
    has = seed_ok.any(1)
    s = seed_ok.to(torch.int8).argmax(1)
    rows = torch.arange(B, device=dev)
    c = cid[rows, s]
    p1, p2 = pos[rows, s], pos[rows, s + S]
    forward = (km[rows, s] < rc[rows, s]) == cfwd[rows, s]
    Lr = lengths.long()
    # the seed on the read as it lies along the contig, 0-based, end
    # exclusive; and on the contig
    r0 = torch.where(forward, s, Lr - s - S - k)
    r1 = r0 + S + k
    c0 = torch.where(forward, p1, p2)
    c1 = torch.where(forward, p2, p1) + k
    clen = ix.lengths[c]
    left = torch.minimum(r0, c0)
    right = torch.minimum(Lr - r1, clen - c1)
    a0, a1 = r0 - left, r1 + right
    t = torch.arange(L, device=dev)[None, :]
    # the read along the contig: itself, or its reverse complement
    back = (Lr[:, None] - 1 - t).clamp(min=0)
    along = torch.where(forward[:, None], seqs,
                        COMPLEMENT.to(dev)[seqs.gather(1, back).long()])
    at = (ix.starts[c] + c0 - left)[:, None] + (t - a0[:, None])
    ctg = ix.bases[at.clamp(0, ix.bases.numel() - 1)]
    counted = ((t >= a0[:, None]) & (t < a1[:, None])
               & ((t < r0[:, None]) | (t >= r1[:, None])))
    mism = ((along != ctg) & counted).sum(1)
    ratio = mism.to(torch.float32) / (a1 - a0).to(torch.float32)
    identity = (1.0 - ratio.to(torch.float64)).to(torch.float32)
    mapped = has & (identity.to(torch.float64) >= min_identity)
    out = {"mapped": mapped, "contig": c,
           "read_start": torch.where(forward, a0 + 1, Lr - a1 + 1),
           "read_end": torch.where(forward, a1, Lr - a0),
           "contig_start": c0 - left + 1, "contig_end": c1 + right,
           "forward": forward, "identity": identity}
    return {key: v.cpu().numpy() for key, v in out.items()}


def map_reads(ix: Index, seqs: torch.Tensor, lengths: torch.Tensor, S: int,
              min_identity: float, block: int) -> dict:
    """map_block over blocks of ``block`` reads, its columns joined; a
    read of a block that maps nothing gets zeros."""
    dev = ix.keys.device
    parts = [map_block(ix, seqs[o:o + block].to(dev),
                       lengths[o:o + block].to(dev), S, min_identity)
             for o in range(0, seqs.shape[0], block)]
    kinds = {"mapped": bool, "contig": np.int64, "read_start": np.int64,
             "read_end": np.int64, "contig_start": np.int64,
             "contig_end": np.int64, "forward": bool,
             "identity": np.float32}
    return {key: np.concatenate(
        [p.get(key, np.zeros(p["mapped"].shape[0], kind)).astype(kind)
         for p in parts] or [np.zeros(0, kind)]) for key, kind in kinds.items()}


def _lines(rid: list, rlen: np.ndarray, r: dict, at: np.ndarray,
           names: list, lens: list) -> list:
    """The line of each mate ``at`` of map_reads' columns: read id, read
    length, spans, contig, direction and identity % (the float32
    identity times float32 100, printed %g)."""
    ident = (r["identity"][at].astype(np.float32) * np.float32(100)).tolist()
    c = r["contig"][at].tolist()
    return [b"%s\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%s\t%g%%" % (
        rid[i], n, rs, re, names[ci], lens[ci], cs, ce,
        b"F" if f else b"R", x) for i, n, rs, re, ci, cs, ce, f, x in zip(
            at.tolist(), rlen[at].tolist(), r["read_start"][at].tolist(),
            r["read_end"][at].tolist(), c, r["contig_start"][at].tolist(),
            r["contig_end"][at].tolist(), r["forward"][at].tolist(), ident)]


def stat_text(total: int, diff: int, same: int, gap: int, none: int) -> str:
    def pct(a):
        return "%g" % (a / total * 100 if total else float("nan"))
    return (f"\ttotal_read_pair_num: {total}\n"
            f"\tmap_ctg_diff_num: {diff}  {pct(diff)}%\n"
            f"\tmap_ctg_same_num: {same}  {pct(same)}%\n"
            f"\tmap_ctg_gap_num: {gap}  {pct(gap)}%\n"
            f"\tmap_no_no_num: {none}  {pct(none)}%\n")


def map_pair(fasta: bytes, reads: tuple, ids: tuple, k: int, S: int,
             min_len: int, min_read_len: int, min_identity: float, device,
             block: int = 65536) -> dict:
    """One pair of files through map_pair: reads ([N, L] ASCII, [N]
    lengths) and read ids of each mate.  Returns the decompressed bytes of
    .2ctg, .1ctg and .gap, the .stat text, and the counts."""
    recs = fasta_records(fasta)
    ix = Index([s for _, s in recs], k, min_len, device)
    names = [i for i, _ in recs]
    lens = [len(s) for s in ix.seqs]
    n = min(reads[0][0].shape[0], reads[1][0].shape[0])
    m1, m2 = (map_reads(ix, seq[:n], ln[:n], S, min_identity, block)
              for seq, ln in reads)
    del ix
    l1, l2 = (np.asarray(ln[:n].cpu().numpy(), np.int64) for _, ln in reads)
    # the pairs whose mates are both at least -r long, routed by their
    # mates' hits; each file's lines in pair order
    routed = (l1 >= min_read_len) & (l2 >= min_read_len)
    hit1, hit2 = routed & m1["mapped"], routed & m2["mapped"]
    both = hit1 & hit2
    same = both & (m1["contig"] == m2["contig"])
    diff = both & ~same
    gap = hit1 ^ hit2
    one = np.nonzero(same)[0], np.nonzero(diff)[0]
    pair_lines = {}
    for suf, at in zip(("1ctg", "2ctg"), one):
        pair_lines[suf] = [a + b"\t" + b + b"\n" for a, b in zip(
            _lines(ids[0], l1, m1, at, names, lens),
            _lines(ids[1], l2, m2, at, names, lens))]
    # .gap: the mapped mate's line, in pair order
    g = np.nonzero(gap)[0]
    gap_lines = [None] * len(g)
    for hit, m, rid, ln in ((hit1, m1, ids[0], l1), (hit2, m2, ids[1], l2)):
        sel = hit[g]
        for j, line in zip(np.nonzero(sel)[0].tolist(),
                           _lines(rid, ln, m, g[sel], names, lens)):
            gap_lines[j] = line + b"\n"
    counts = dict(total=int(routed.sum()), diff=len(one[1]),
                  same=len(one[0]), gap=len(g),
                  none=int((routed & ~m1["mapped"] & ~m2["mapped"]).sum()))
    return {"2ctg": HEADER_PAIR + b"".join(pair_lines["2ctg"]),
            "1ctg": HEADER_ONE + b"".join(pair_lines["1ctg"]),
            "gap": HEADER_ONE + b"".join(gap_lines),
            "stat": stat_text(**counts), "counts": counts}


# ------------------------------------------------ link_scaffold (frozen)
def c_div(a: int, b: int) -> int:
    """C++ integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def ctg_str2id(s: bytes) -> int:
    """atoi of the characters after the 4-character prefix
    (link_func.h:130-132)."""
    num = b""
    for c in s[4:]:
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
    return seq.translate(bytes.maketrans(b"ACGTacgtNn",
                                         b"TGCAtgcaNn"))[::-1]


def read_contig_file(data: bytes):
    """link_func.cpp:99-136: strand-doubled (sequences, ids), the reverse
    complement slots empty."""
    seqs, ids, cur = [b""], [b""], []
    for line in data.split(b"\n")[:-1] if data.endswith(b"\n") \
            else data.split(b"\n"):
        if line[:1] == b">":
            toks = [t for t in line.replace(b">", b" ")
                    .replace(b"\t", b" ").split(b" ") if t]
            ids += [toks[0] if toks else b"", b""]
            if sum(len(c) for c in cur) > 0:
                seqs += [b"".join(cur), b""]
            cur = []
        else:
            cur.append(line)
    if sum(len(c) for c in cur) > 0:
        seqs += [b"".join(cur), b""]
    return seqs, ids


class LinkGraph:
    def __init__(self, n: int):
        self.n = n
        self.links = [None] * n
        self.link = np.zeros(n, np.int32)
        self.inlink = np.zeros(n, np.int32)
        self.deleted = np.zeros(n, bool)
        self.counters = dict(FR=0, RF=0, FF=0, RR=0, wrong=0, lowfreq=0,
                             deleted=0, interleave=0)

    def add(self, src: int, dst: int, gap: int):
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

    def remove_lowfreq_and_stat(self, cut: int):
        for i in range(self.n):
            lst = self.links[i]
            if lst is None:
                continue
            num = 0
            for e in lst:
                if e[1] < cut:
                    e[0] = e[1] = e[2] = 0
                    self.counters["lowfreq"] += 1
                else:
                    num += 1
                    if self.inlink[e[0]] < 255:
                        self.inlink[e[0]] += 1
            self.link[i] = num if num < 255 else 255

    def linked_ids(self, src: int):
        ids, gaps = [], []
        for e in self.links[src] or ():
            if e[1] > 0:
                ids.append(e[0])
                gaps.append(c_div(e[2], e[1]))
        return ids, gaps

    def next_linked(self, src: int):
        for e in self.links[src] or ():
            if e[1] > 0:
                return e[0], c_div(e[2], e[1])
        return 0, 0

    def delete_link(self, src: int, dst: int):
        for e in self.links[src] or ():
            if e[1] > 0 and e[0] == dst:
                e[0] = e[1] = e[2] = 0
                if self.link[src] > 0:
                    self.link[src] -= 1
                if self.inlink[dst] > 0:
                    self.inlink[dst] -= 1
                return

    def remove_interleaving(self, seqs):
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
                            and end_gap < judge and len(seqs[mid]) < judge:
                        self.delete_link(i, end_node)
                        self.counters["interleave"] += 1

    def remove_repeat_nodes(self):
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

    def remove_links_from_deleted(self):
        for i in range(self.n):
            for e in self.links[i] or ():
                src, dst = i, e[0]
                if self.deleted[src] or self.deleted[dst]:
                    e[0] = e[1] = e[2] = 0
                    self.counters["deleted"] += 1
                    if self.link[src] > 0:
                        self.link[src] -= 1
                    if self.inlink[dst] > 0:
                        self.inlink[dst] -= 1

    def display(self) -> bytes:
        out = ["ctg_id\tincoming_link_num\toutgoing_link_num\t"
               "linked_id,pair_num,sum_size,avg_size;\n"]
        for i in range(1, self.n):
            out.append(f"{i}\t{int(self.inlink[i])}\t{int(self.link[i])}")
            for e in self.links[i] or ():
                if e[1] > 0:
                    out.append(f"\t{e[0]},{e[1]},{e[2]},"
                               f"{c_div(e[2], e[1])}")
            out.append("\n")
        return "".join(out).encode()

    def get_linear_seq(self, start: int):
        out = []
        nxt = start
        while True:
            nxt, gap = self.next_linked(nxt)
            if self.deleted[nxt]:
                break
            out += [gap, nxt]
            self.deleted[nxt] = True
            self.deleted[get_pair_id(nxt)] = True
            if self.link[nxt] != 1:
                break
        return out


def parse_pairs(data: bytes, g: LinkGraph, seqs, insert: int,
                is_mate: bool):
    """link_func.cpp:226-426: each 2ctg line's two links, the gap from
    the F/R combination, kept in (-insert / 2, insert]."""
    lo = -c_div(insert, 2)
    for line in data.split(b"\n"):
        if line[:1] == b"#":
            continue
        v = [t for t in line.replace(b"\t", b" ").split(b" ") if t]
        if len(v) < 19:
            continue
        d1, d2 = v[8], v[18]
        c1, c2 = v[4], v[14]
        c1s, c1e = int(v[6]), int(v[7])
        c2s, c2e = int(v[16]), int(v[17])
        I = insert

        def L(i):
            return len(seqs[i])
        combo = (d1 + d2).decode()
        if combo not in ("FR", "RF", "FF", "RR"):
            g.counters["wrong"] += 1
            continue
        g.counters[combo] += 1
        if not is_mate:
            if combo == "FR":
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                gap = I - (L(a1) - c1s) - c2e
            elif combo == "RF":
                a1 = ctg_str2id(c2); a2 = a1 + 1
                a3 = ctg_str2id(c1); a4 = a3 + 1
                gap = I - (L(a1) - c2s) - c1e
            elif combo == "FF":
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a4 = ctg_str2id(c2); a3 = a4 + 1
                gap = I - (L(a1) - c1s) - (L(a4) - c2s)
            else:
                a2 = ctg_str2id(c1); a1 = a2 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                gap = I - (L(a2) - (L(a2) - c1e)) - c2e
        else:
            if combo == "FR":
                a1 = ctg_str2id(c2); a2 = a1 + 1
                a3 = ctg_str2id(c1); a4 = a3 + 1
                gap = I - (L(a1) - c2s) - c1e
            elif combo == "RF":
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                gap = I - (L(a1) - c1s) - c2e
            elif combo == "FF":
                a2 = ctg_str2id(c1); a1 = a2 + 1
                a3 = ctg_str2id(c2); a4 = a3 + 1
                gap = I - (L(a2) - (L(a2) - c1e)) - c2e
            else:
                a1 = ctg_str2id(c1); a2 = a1 + 1
                a4 = ctg_str2id(c2); a3 = a4 + 1
                gap = I - (L(a1) - c1s) - (L(a4) - c2s)
        if lo < gap <= I:
            g.add(a1, a3, gap)
            g.add(a4, a2, gap)


def _scaffold_blocks(seqs, combined):
    """generate_scaffold (link_scaffold.cpp:427-463): the blocks (contig
    slot or gap size), the sequence and each block's F / R / N."""
    blocks, seq, directs = [], bytearray(), []
    for i, v in enumerate(combined):
        if i % 2 == 0:
            if v % 2 == 1:
                blocks.append(v)
                seq += seqs[v]
                directs.append("F")
            else:
                p = get_pair_id(v)
                blocks.append(p)
                seq += rev_comp(seqs[p])
                directs.append("R")
        else:
            gap = v if v > 1 else 1
            blocks.append(gap)
            seq += b"N" * gap
            directs.append("N")
    return blocks, bytes(seq), directs


def link_scaffold(fasta: bytes, twoctg: list, insert: int = 400,
                  cut: int = 3, is_mate: bool = False) -> dict:
    """link_scaffold on the contigs' FASTA and the decompressed bytes of
    each 2ctg file; returns each output's bytes by its suffix after
    ``<prefix>.insert<I>.``."""
    seqs, ids = read_contig_file(fasta)
    n = len(seqs)
    g = LinkGraph(n)
    for data in twoctg:
        parse_pairs(data, g, seqs, insert, is_mate)
    g.remove_lowfreq_and_stat(cut)
    links_all = g.display()
    g.remove_interleaving(seqs)
    repeat_nodes = g.remove_repeat_nodes()
    g.remove_links_from_deleted()
    links_uniq = g.display()

    recs = []
    for i in range(1, n):
        if g.deleted[i] or i % 2 == 0:
            continue
        g.deleted[i] = True
        g.deleted[get_pair_id(i)] = True
        right = g.get_linear_seq(i) if g.link[i] == 1 else []
        paired = get_pair_id(i)
        left = []
        if g.link[paired] == 1:
            left = g.get_linear_seq(paired)
            left.reverse()
            for j in range(0, len(left), 2):
                left[j] = get_pair_id(left[j])
        blocks, seq, directs = _scaffold_blocks(seqs, left + [i] + right)
        count = length = wogap = 0
        pos = []
        for j, v in enumerate(blocks):
            start = length + 1
            if j % 2 == 0:
                count += 1
                size = len(seqs[v])
                wogap += size
                length += size
                pos.append(f"\t{ids[v].decode()}\t{start}\t{length}\t{size}"
                           f"\t{directs[j]}\n")
            else:
                length += v
                pos.append(f"\tgap\t{start}\t{length}\t{v}\t{directs[j]}\n")
        recs.append((length, f"   fragment_num:{count}   length:{length}"
                     f"   lenwogap:{wogap}\n" + seq.decode() + "\n",
                     "".join(pos)))
    out = {"scaffold.links.all": links_all,
           "scaffold.links.uniq": links_uniq}
    sf, pf = [], []
    sid = -1
    for pi in gcc44_sort_perm_desc(np.array([r[0] for r in recs],
                                            np.uint64)):
        sid += 2
        _, seq_text, pos_text = recs[pi]
        sf.append(f">scf_{sid}" + seq_text)
        pf.append(f">scf_{sid}\n" + pos_text)
    out["scaffold.seq.fa"] = "".join(sf).encode()
    out["scaffold.pos.tab"] = "".join(pf).encode()
    reps = []
    for c in repeat_nodes:
        if c % 2 == 1:
            s = seqs[c]
            reps.append((len(s), s, f"\t{ids[c].decode()}\t1\t{len(s)}"
                         f"\t{len(s)}\tF\n"))
    sf, pf = [], []
    for pi in gcc44_sort_perm_desc(np.array([r[0] for r in reps],
                                            np.uint64)):
        sid += 2
        ln, s, pos = reps[pi]
        sf.append(f">scf_{sid}   fragment_num:1   length:{ln}"
                  f"   lenwogap:{ln}   RepeatNode\n" + s.decode() + "\n")
        pf.append(f">scf_{sid}\n" + pos)
    out["scaffold_repeat.seq.fa"] = "".join(sf).encode()
    out["scaffold_repeat.pos.tab"] = "".join(pf).encode()
    return out
