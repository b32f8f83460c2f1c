"""link_scaffold: the scaffold readout and its output files, on the host.

Counterpart of dbg_assembly_tpu/scaffold/scaffold.py.  Parity:
link_scaffold/link_scaffold.cpp:89-463.
Outputs: <prefix>.insert<I>.scaffold.links.all/.uniq, .scaffold.seq.fa,
.scaffold.pos.tab, .scaffold_repeat.seq.fa/.pos.tab.

Spans on the command thread: ``link_scaffold.read`` (the contigs and the
2ctg files into the link graph), ``link_scaffold.graph`` (the low-frequency
cut, interleaving and repeat removal, both .links files; the graph's
counters) and ``link_scaffold.readout`` (the scaffolds' sequence and
.pos.tab files and the repeat singlets).
"""

from __future__ import annotations

import numpy as np

from .. import native, spans
from ..io.lib import read_file_list
from .link import (LinkGraph, get_pair_id, parse_pair_map_file,
                   read_contig_file, rev_comp)


def generate_scaffold(contig_seqs, combined):
    """Parity: generate_scaffold (link_scaffold.cpp:427-463).
    Returns (scaff_ids, scaff_seq bytes, scaff_directs str)."""
    scaff_ids = []
    seq = bytearray()
    directs = []
    for i, v in enumerate(combined):
        if i % 2 == 0:                      # contig id
            if v % 2 == 1:
                scaff_ids.append(v)
                seq += contig_seqs[v]
                directs.append("F")
            else:
                p = get_pair_id(v)
                scaff_ids.append(p)
                seq += rev_comp(contig_seqs[p])
                directs.append("R")
        else:                               # gap size
            gap = v if v > 1 else 1
            scaff_ids.append(gap)
            seq += b"N" * gap
            directs.append("N")
    return scaff_ids, bytes(seq), directs


def run(contig_fa: str, twoctg_lib: str, prefix: str, insert_size: int = 400,
        pair_num_cut: int = 3, is_mate: bool = False) -> dict:
    with spans.span("link_scaffold.read"):
        contig_seqs, contig_ids = read_contig_file(contig_fa)
        n = len(contig_seqs)
        g = LinkGraph.create(n)
        for path in read_file_list(twoctg_lib):
            parse_pair_map_file(path, g, contig_seqs, insert_size, is_mate)
        spans.add(contigs=n // 2, pairs=sum(
            g.counters[x] for x in ("FR", "RF", "FF", "RR", "wrong")))

    base = f"{prefix}.insert{insert_size}.scaffold"
    with spans.span("link_scaffold.graph"):
        g.remove_lowfreq_and_stat(pair_num_cut)
        g.display(base + ".links.all")
        g.remove_interleaving(contig_seqs)
        repeat_nodes = g.remove_repeat_nodes()
        g.remove_links_from_deleted()
        g.display(base + ".links.uniq")
        spans.add(**g.counters)

    with spans.span("link_scaffold.readout"):
        totals = _readout(g, contig_seqs, contig_ids, repeat_nodes, base,
                          f"{prefix}.insert{insert_size}.scaffold_repeat")
        spans.add(scaffolds=totals["num"], bases=totals["len"])
    return {"seq": base + ".seq.fa", "pos": base + ".pos.tab",
            "links_all": base + ".links.all",
            "links_uniq": base + ".links.uniq", **totals,
            "counters": g.counters}


def _readout(g: LinkGraph, contig_seqs, contig_ids, repeat_nodes,
             base: str, repeat_base: str) -> dict:
    """The scaffolds walked from the cleaned graph, written to
    ``base``.seq.fa / .pos.tab longest first, then the repeat singlets to
    ``repeat_base``.seq.fa / .pos.tab; returns the scaffolds' totals."""
    n = len(contig_seqs)
    # ------------------------------------------------------------- readout
    # (read_out_scaffold, link_scaffold.cpp:300-423)
    recs = []      # (len, seq_text, pos_text)
    totals = dict(num=0, len=0, lenwogap=0, inc_num=0, inc_len=0)
    for i in range(1, n):
        if g.deleted[i] or i % 2 == 0:
            continue
        g.deleted[i] = True
        g.deleted[get_pair_id(i)] = True
        vec_right = g.get_linear_seq(i) if g.link[i] == 1 else []
        paired = get_pair_id(i)
        vec_left = []
        if g.link[paired] == 1:
            vec_left = g.get_linear_seq(paired)
            vec_left.reverse()
            for k in range(0, len(vec_left), 2):
                vec_left[k] = get_pair_id(vec_left[k])
        combined = vec_left + [i] + vec_right

        scaff_ids, scaff_seq, directs = generate_scaffold(contig_seqs,
                                                          combined)
        scaf_ctg_num = 0
        scaf_len = 0
        scaf_lenwogap = 0
        pos_text = []
        for j, v in enumerate(scaff_ids):
            if j % 2 == 0:
                scaf_ctg_num += 1
                block_start = scaf_len + 1
                block_size = len(contig_seqs[v])
                scaf_len += block_size
                scaf_lenwogap += block_size
                pos_text.append(
                    f"\t{contig_ids[v].decode()}\t{block_start}\t{scaf_len}"
                    f"\t{block_size}\t{directs[j]}\n")
                totals["inc_num"] += 1
                totals["inc_len"] += block_size
            else:
                block_size = v
                block_start = scaf_len + 1
                scaf_len += block_size
                pos_text.append(
                    f"\tgap\t{block_start}\t{scaf_len}\t{block_size}"
                    f"\t{directs[j]}\n")
        seq_text = (f"   fragment_num:{scaf_ctg_num}   length:{scaf_len}"
                    f"   lenwogap:{scaf_lenwogap}\n"
                    + scaff_seq.decode() + "\n")
        recs.append((scaf_len, seq_text, "".join(pos_text)))
        totals["num"] += 1
        totals["len"] += scaf_len
        totals["lenwogap"] += scaf_lenwogap

    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in recs], np.uint64)) if recs else []
    scaffold_id = -1
    with open(base + ".seq.fa", "w") as sf, open(base + ".pos.tab", "w") as pf:
        for pi in perm:
            scaffold_id += 2
            _, seq_text, pos_text = recs[int(pi)]
            sf.write(f">scf_{scaffold_id}" + seq_text)
            pf.write(f">scf_{scaffold_id}\n" + pos_text)

    # ------------------------------------------ repeat singlets (:242-275)
    reps = []
    for cid in repeat_nodes:
        if cid % 2 == 1:
            s = contig_seqs[cid]
            pos = (f"\t{contig_ids[cid].decode()}\t1\t{len(s)}\t{len(s)}"
                   f"\tF\n")
            reps.append((len(s), s, pos))
    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in reps], np.uint64)) if reps else []
    with open(repeat_base + ".seq.fa", "w") as sf, \
            open(repeat_base + ".pos.tab", "w") as pf:
        for pi in perm:
            scaffold_id += 2
            ln, s, pos = reps[int(pi)]
            sf.write(f">scf_{scaffold_id}   fragment_num:1   length:{ln}"
                     f"   lenwogap:{ln}   RepeatNode\n" + s.decode() + "\n")
            pf.write(f">scf_{scaffold_id}\n" + pos)
    return totals
