"""link_contig / link_supertig: scafftig linking with consensus gap filling,
on the host.

Counterpart of dbg_assembly_tpu/scaffold/link_contig.py.  Parity:
link_scaffold/link_contig.cpp (and link_supertig.cpp, which is the same
pipeline re-labeled for PacBio reads linking scafftigs: 'spt_' ids and a
.supertig.* file family).  Flow:

  read-end 2ctg links (no acceptance window) -> lowfreq prune -> links.all
  -> repeat-node removal (NO interleaving pass) -> links.uniq
  -> chain readout (read_out_scaffinfo, link_contig.cpp:676-727)
  -> gap filling (fill_gaps_inside_scaffold, :350-566):
       gap size = MODE of per-read gap estimates (decide_gap_size, :569-610);
       negative gap  -> truncate the upstream contig by the overlap (:437-454);
       positive gap  -> per-column majority consensus over the spanning
                        reads' gap substrings with orientation fixing
                        (:456-531), consensus ties resolved by base order
                        (std::map iteration).
"""

from __future__ import annotations

import gzip

import numpy as np

from .. import native
from ..io.lib import read_file_list
from .link import (LinkGraph, get_pair_id, parse_read_ends_map_file,
                   read_contig_file, rev_comp)


def _fmt_f32(x) -> str:
    """boost::lexical_cast<string>(float) — %.9g of the float32 value."""
    return "%.9g" % float(np.float32(x))


def decide_gap_size(map_info: dict) -> dict:
    """gap_key -> [mode_size, mode_freq, total_freq, avg_variance]."""
    out = {}
    for key, rows in map_info.items():
        freq = {}
        for row in rows:
            gap = int(row[3]) - int(row[2]) - 1
            freq[gap] = freq.get(gap, 0) + 1
        mode_size = 0
        mode_freq = 0
        for g in sorted(freq):              # std::map iterates keys ascending
            if freq[g] > mode_freq:
                mode_size = g
                mode_freq = freq[g]
        total = sum(freq.values())
        var = sum(abs(g - mode_size) * c for g, c in freq.items()) // total
        out[key] = [mode_size, mode_freq, total, var]
    return out


def run(contig_fa: str, twoctg_lib: str, prefix: str, pair_num_cut: int = 3,
        id_prefix: str = "sct", out_tag: str = ".contig_R") -> dict:
    """link_contig with id_prefix='sct'/out_tag='.contig_R';
    link_supertig uses id_prefix='spt'/out_tag='.supertig'."""
    contig_seqs, contig_ids = read_contig_file(contig_fa)
    n = len(contig_seqs)
    g = LinkGraph.create(n)

    map_files = read_file_list(twoctg_lib)
    for path in map_files:
        parse_read_ends_map_file(path, g)

    g.remove_lowfreq_and_stat(pair_num_cut)
    g.display(prefix + out_tag + ".links.all")
    repeat_nodes = g.remove_repeat_nodes()
    g.remove_links_from_deleted()
    g.display(prefix + out_tag + ".links.uniq")

    # ---- chain readout (read_out_scaffinfo) ----
    scaf_info = []
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
        scaf_info.append(vec_left + [i] + vec_right)

    # ---- load gap-filling inputs ----
    reads_info = {}
    for path in map_files:
        rf = path + ".reads.fa.gz"
        with gzip.open(rf, "rb") as f:
            rid = None
            for line in f:
                line = line.rstrip(b"\n")
                if line[:1] == b">":
                    toks = [t for t in line.replace(b">", b" ")
                            .replace(b"\t", b" ").split(b" ") if t]
                    rid = toks[0] if toks else b""
                elif rid is not None:
                    reads_info[rid] = line
                    rid = None

    map_info = {}
    for path in map_files:
        with gzip.open(path, "rb") as f:
            for line in f:
                if line[:1] == b"#":
                    continue
                v = [t for t in line.replace(b"\t", b" ").rstrip(b"\n")
                     .split(b" ") if t]
                if len(v) < 19:
                    continue
                key = v[4] + v[14] if v[4] < v[14] else v[14] + v[4]
                map_info.setdefault(key, []).append(
                    [v[0], v[1], v[3], v[12], v[4], v[8]])

    gap_size = decide_gap_size(map_info)

    # ---- gap filling + output ----
    recs = []
    totals = dict(num=0, len=0, lenwogap=0, inc_num=0, inc_len=0)
    for combined in scaf_info:
        scaff_seq = bytearray()
        scaf_len = 0
        scaf_ctg_num = 0
        pos_text = []
        j = 0
        while j < len(combined):
            v = combined[j]
            if v % 2 == 1:
                ctg_id = v
                direction = "F"
                ctg_seq = contig_seqs[ctg_id]
            else:
                ctg_id = v - 1
                direction = "R"
                ctg_seq = rev_comp(contig_seqs[ctg_id])
            scaf_ctg_num += 1

            if j + 2 >= len(combined):           # last contig
                scaff_seq += ctg_seq
                bs = scaf_len + 1
                scaf_len += len(ctg_seq)
                pos_text.append(
                    f"\t{contig_ids[ctg_id].decode()}\t{bs}\t{scaf_len}"
                    f"\t{len(ctg_seq)}\t{direction}\n")
                totals["inc_num"] += 1
                totals["inc_len"] += len(ctg_seq)
                break

            v2 = combined[j + 2]
            if v2 % 2 == 1:
                ctg2_id, dir2 = v2, "F"
            else:
                ctg2_id, dir2 = v2 - 1, "R"
            s1 = contig_ids[ctg_id]
            s2 = contig_ids[ctg2_id]
            key = s1 + s2 if s1 < s2 else s2 + s1
            mode, mfreq, tfreq, var = gap_size.get(key, [0, 0, 0, 0])

            if mode <= 0:
                ctg_seq = ctg_seq[:len(ctg_seq) + mode]
                scaff_seq += ctg_seq
                bs = scaf_len + 1
                scaf_len += len(ctg_seq)
                pos_text.append(
                    f"\t{contig_ids[ctg_id].decode()}\t{bs}\t{scaf_len}"
                    f"\t{len(ctg_seq)}\t{direction}\n")
                pos_text.append(
                    f"\tgap\t{scaf_len}\t{scaf_len}\t{mode}\tN\t{mfreq}"
                    f"\t{tfreq}\t{var}\n")
                totals["inc_num"] += 1
                totals["inc_len"] += len(ctg_seq)
            else:
                gap_seqs = []
                for row in map_info.get(key, []):
                    rid = row[0]
                    a1_end = int(row[2])
                    a2_start = int(row[3])
                    if a2_start - a1_end - 1 != mode:
                        continue
                    rseq = reads_info.get(rid, b"")
                    gseq = rseq[a1_end:a1_end + mode]
                    m_ctg = row[4]
                    m_dir = row[5].decode()
                    if (m_ctg == s1 and m_dir != direction) or \
                            (m_ctg == s2 and m_dir != dir2):
                        gseq = rev_comp(gseq)
                    gap_seqs.append(gseq)
                cons = bytearray()
                support = np.float32(0.0)
                for kk in range(mode):
                    stat = {}
                    for gs in gap_seqs:
                        base = gs[kk:kk + 1]
                        if base:
                            stat[base] = stat.get(base, 0) + 1
                    cbase = b"\x00"
                    cfreq = 0
                    tot = 0
                    for bch in sorted(stat):
                        if stat[bch] > cfreq:
                            cbase = bch
                            cfreq = stat[bch]
                        tot += stat[bch]
                    cons += cbase
                    support = np.float32(
                        support + np.float32(cfreq) / np.float32(tot))
                support = np.float32(support / np.float32(mode))

                scaff_seq += ctg_seq + cons
                bs = scaf_len + 1
                scaf_len += len(ctg_seq)
                pos_text.append(
                    f"\t{contig_ids[ctg_id].decode()}\t{bs}\t{scaf_len}"
                    f"\t{len(ctg_seq)}\t{direction}\n")
                totals["inc_num"] += 1
                totals["inc_len"] += len(ctg_seq)
                bs = scaf_len + 1
                scaf_len += len(cons)
                pos_text.append(
                    f"\tgap\t{bs}\t{scaf_len}\t{len(cons)}\tN\t{mfreq}"
                    f"\t{tfreq}\t{var}\t{_fmt_f32(support)}\n")
            j += 2

        seq_text = (f"   fragment_num:{scaf_ctg_num}   length:{scaf_len}"
                    f"   lenwogap:{scaf_len}\n"
                    + scaff_seq.decode() + "\n")
        recs.append((scaf_len, seq_text, "".join(pos_text)))
        totals["num"] += 1
        totals["len"] += scaf_len
        totals["lenwogap"] += scaf_len

    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in recs], np.uint64)) if recs else []
    tig_id = -1
    with open(prefix + out_tag + ".seq.fa", "w") as sf, \
            open(prefix + out_tag + ".pos.tab", "w") as pf:
        pf.write("#scafftig_id\tblock_id\tblock_start\tblock_end\t"
                 "block_size\tdirection\tgapsize_mode_freq\t"
                 "gapsize_total_freq\tgapsize_variance\tgapseq_identity\n")
        for pi in perm:
            tig_id += 2
            _, seq_text, pos_text = recs[int(pi)]
            sf.write(f">{id_prefix}_{tig_id}" + seq_text)
            pf.write(f">{id_prefix}_{tig_id}\n" + pos_text)

    # repeat singlets
    reps = []
    for cid in repeat_nodes:
        if cid % 2 == 1:
            s = contig_seqs[cid]
            reps.append((len(s), s,
                         f"\t{contig_ids[cid].decode()}\t1\t{len(s)}"
                         f"\t{len(s)}\tF\n"))
    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in reps], np.uint64)) if reps else []
    with open(prefix + out_tag + ".repeat.seq.fa", "w") as sf, \
            open(prefix + out_tag + ".repeat.pos.tab", "w") as pf:
        for pi in perm:
            tig_id += 2
            ln, s, pos = reps[int(pi)]
            sf.write(f">{id_prefix}_{tig_id}   fragment_num:1   length:{ln}"
                     f"   lenwogap:{ln}   RepeatNode\n" + s.decode() + "\n")
            pf.write(f">{id_prefix}_{tig_id}\n" + pos)
    return totals


def run_supertig(contig_fa: str, twoctg_lib: str, prefix: str,
                 pair_num_cut: int = 3) -> dict:
    """link_supertig — PacBio reads linking scafftigs into supertigs.

    Parity: link_supertig.cpp:90-330,333-557.  Differences from
    link_contig: MEAN-based gap sizing (decide_gap_size :560-607, fields
    mean/min/max/freq/variance), mean clamped to >=1 with N-fill instead of
    base consensus, a .supertig.gap.data dump of the median-length spanning
    substring (+/-250bp flanks) plus similar-length (0.75x-1.25x) mates in
    utg format for external consensus, and pos.tab rows carrying the contig
    sequence column and numbered gap ids.
    """
    contig_seqs, contig_ids = read_contig_file(contig_fa)
    n = len(contig_seqs)
    g = LinkGraph.create(n)
    map_files = read_file_list(twoctg_lib)
    for path in map_files:
        parse_read_ends_map_file(path, g)
    g.remove_lowfreq_and_stat(pair_num_cut)
    g.display(prefix + ".supertig.links.all")
    repeat_nodes = g.remove_repeat_nodes()
    g.remove_links_from_deleted()
    g.display(prefix + ".supertig.links.uniq")

    scaf_info = []
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
        scaf_info.append(vec_left + [i] + vec_right)

    reads_info = {}
    for path in map_files:
        with gzip.open(path + ".reads.fa.gz", "rb") as f:
            rid = None
            for line in f:
                line = line.rstrip(b"\n")
                if line[:1] == b">":
                    toks = [t for t in line.replace(b">", b" ")
                            .replace(b"\t", b" ").split(b" ") if t]
                    rid = toks[0] if toks else b""
                elif rid is not None:
                    reads_info[rid] = line
                    rid = None
    map_info = {}
    for path in map_files:
        with gzip.open(path, "rb") as f:
            for line in f:
                if line[:1] == b"#":
                    continue
                v = [t for t in line.replace(b"\t", b" ").rstrip(b"\n")
                     .split(b" ") if t]
                if len(v) < 19:
                    continue
                key = v[4] + v[14] if v[4] < v[14] else v[14] + v[4]
                map_info.setdefault(key, []).append(
                    [v[0], v[1], v[3], v[12], v[4], v[8]])

    # mean-based gap stats
    gap_stats = {}
    for key, rows in map_info.items():
        sizes = [int(r[3]) - int(r[2]) - 1 for r in rows]
        total = len(sizes)
        mean = sum(sizes) // total if total else 0
        var = sum(abs(mean - s) for s in sizes) // total if total else 0
        gap_stats[key] = [mean, min(sizes), max(sizes), total, var]

    recs = []
    totals = dict(num=0, len=0, lenwogap=0, inc_num=0, inc_len=0)
    gap_id = 1
    gap_reads_id = 1
    gap_lines = []
    for combined in scaf_info:
        scaff_seq = bytearray()
        scaf_len = 0
        scaf_ctg_num = 0
        pos_text = []
        j = 0
        while j < len(combined):
            v = combined[j]
            if v % 2 == 1:
                ctg_id, direction = v, "F"
                ctg_seq = contig_seqs[ctg_id]
            else:
                ctg_id, direction = v - 1, "R"
                ctg_seq = rev_comp(contig_seqs[ctg_id])
            scaf_ctg_num += 1
            if j + 2 >= len(combined):
                scaff_seq += ctg_seq
                bs = scaf_len + 1
                scaf_len += len(ctg_seq)
                pos_text.append(
                    f"\t{contig_ids[ctg_id].decode()}\t{bs}\t{scaf_len}"
                    f"\t{len(ctg_seq)}\t{direction}"
                    f"\t{ctg_seq.decode()}\n")
                totals["inc_num"] += 1
                totals["inc_len"] += len(ctg_seq)
                break
            v2 = combined[j + 2]
            ctg2_id, dir2 = (v2, "F") if v2 % 2 == 1 else (v2 - 1, "R")
            s1, s2 = contig_ids[ctg_id], contig_ids[ctg2_id]
            key = s1 + s2 if s1 < s2 else s2 + s1
            mean, mn, mx, tfreq, var = gap_stats.get(key, [0, 0, 0, 0, 0])
            if mean <= 0:
                mean = 1
            # collect flanked gap substrings, median + similar lengths
            gseqs = []
            for row in map_info.get(key, []):
                a1_end = int(row[2])
                a2_start = int(row[3])
                gsz = a2_start - a1_end - 1 if a2_start > a1_end else 0
                mid = (a1_end + a2_start) // 2
                ext = 250
                rseq = reads_info.get(row[0], b"")
                start = mid - ext - gsz // 2
                if start < 0:
                    start = 0    # C++ substr would throw; clamp instead
                gs = rseq[start:start + gsz + 2 * ext]
                if (row[4] == s1 and row[5].decode() != direction) or \
                        (row[4] == s2 and row[5].decode() != dir2):
                    gs = rev_comp(gs)
                gseqs.append(gs)
            perm = native.gcc44_sort_perm_desc(
                np.array([len(s) for s in gseqs], np.uint64))
            gseqs = [gseqs[int(p)] for p in perm]
            med = len(gseqs) // 2
            med_seq = gseqs[med] if gseqs else b""
            head = f">gap{gap_id} length={len(med_seq)} nodes="
            content = (f"Y\tS{gap_reads_id}\t+\t0\t{len(med_seq)}\t"
                       + med_seq.decode() + "\n")
            gap_reads_id += 1
            nodes = 1
            for idx, gs in enumerate(gseqs):
                if idx != med:
                    if len(med_seq) * 0.75 < len(gs) < len(med_seq) * 1.25:
                        content += (f"N\tS{gap_reads_id}\t+\t0\t{len(gs)}\t"
                                    + gs.decode() + "\n")
                        gap_reads_id += 1
                        nodes += 1
            gap_lines.append(head + f"{nodes}\n" + content)

            nfill = b"N" * mean
            scaff_seq += ctg_seq + nfill
            bs = scaf_len + 1
            scaf_len += len(ctg_seq)
            pos_text.append(
                f"\t{contig_ids[ctg_id].decode()}\t{bs}\t{scaf_len}"
                f"\t{len(ctg_seq)}\t{direction}\t{ctg_seq.decode()}\n")
            totals["inc_num"] += 1
            totals["inc_len"] += len(ctg_seq)
            bs = scaf_len + 1
            scaf_len += len(nfill)
            pos_text.append(
                f"\tgap{gap_id}\t{bs}\t{scaf_len}\t{len(nfill)}\tN\t{mn}"
                f"\t{mx}\t{tfreq}\t{var}\n")
            gap_id += 1
            j += 2
        seq_text = (f"   fragment_num:{scaf_ctg_num}   length:{scaf_len}"
                    f"   lenwogap:{scaf_len}\n" + scaff_seq.decode() + "\n")
        recs.append((scaf_len, seq_text, "".join(pos_text)))
        totals["num"] += 1
        totals["len"] += scaf_len

    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in recs], np.uint64)) if recs else []
    tig_id = -1
    with open(prefix + ".supertig.seq.fa", "w") as sf, \
            open(prefix + ".supertig.pos.tab", "w") as pf, \
            open(prefix + ".supertig.gap.data", "w") as gf:
        gf.write("".join(gap_lines))
        for pi in perm:
            tig_id += 2
            _, seq_text, pos_text = recs[int(pi)]
            sf.write(f">spt_{tig_id}" + seq_text)
            pf.write(f">spt_{tig_id}\n" + pos_text)
    reps = []
    for cid in repeat_nodes:
        if cid % 2 == 1:
            s = contig_seqs[cid]
            reps.append((len(s), s,
                         f"\t{contig_ids[cid].decode()}\t1\t{len(s)}"
                         f"\t{len(s)}\tF\n"))
    perm = native.gcc44_sort_perm_desc(
        np.array([r[0] for r in reps], np.uint64)) if reps else []
    with open(prefix + ".supertig_repeat.seq.fa", "w") as sf, \
            open(prefix + ".supertig_repeat.pos.tab", "w") as pf:
        for pi in perm:
            tig_id += 2
            ln, s, pos = reps[int(pi)]
            sf.write(f">spt_{tig_id}   fragment_num:1   length:{ln}"
                     f"   lenwogap:{ln}   RepeatNode\n" + s.decode() + "\n")
            pf.write(f">spt_{tig_id}\n" + pos)
    return totals
