"""PacBio / hybrid-assembly converter chain (Perl ports).

Counterpart of dbg_assembly_tpu/utils/pacbio.py.

Parity sources in the reference:
  * blasrm4_besthit.pl:63-97   — best hit per (read, target) pair from
    blasr -m4 or minimap PAF records
  * blasrm4_map.pl:69-163      — semi-global filter + overlap dedup by
    identity, per-read ordered scafftig chain
  * blasrm4_twoctg.pl:66-106   — chain -> 2ctg pair format for
    link_supertig, with repeat-scafftig filtering
  * fullread_to_subread.pl:49-66 — pbsim reads -> PacBio-style headers
"""

from __future__ import annotations


def blasrm4_besthit(lines, fileformat: str = "blasrm4", cutoff=None):
    """Best alignment per (query, target) pair.  Yields kept lines sorted by
    the composite key (Perl `sort keys`, ASCIIbetical)."""
    data = {}
    for line in lines:
        line = line.rstrip("\n")
        if fileformat == "blasrm4":
            if line.startswith("qName"):
                continue
            t = line.split()
            qname = t[0] + "-" + t[1]
            value = (int(t[6]) - int(t[5])) * float(t[3])
        else:                       # paf
            t = line.split("\t")
            qname = t[0] + "-" + t[5]
            value = (int(t[3]) - int(t[2])) / int(t[1])
        if cutoff is not None and value > cutoff:
            continue
        if qname not in data or data[qname][0] < value:
            data[qname] = (value, line)
    for qname in sorted(data):
        yield data[qname][1]


def blasrm4_map(lines, end_len_cut: int = 100, align_len_cut: int = 1000,
                identity_cut: float = 0.7):
    """Semi-global filter + overlap dedup; yields per-read chain lines.
    Returns (output_lines, stats dict)."""
    align = {}
    stats = dict(total=0, unconfident=0, nonsemiglobal=0, multiple=0,
                 lines=0, aligns=0)
    for line in lines:
        f = line.split()
        if not f or f[0] == "qName":
            continue
        (qid, tid, score, identity, qstrand, qstart, qend, qlen, tstrand,
         tstart, tend, tlen) = f[:12]
        qstart, qend, qlen = int(qstart), int(qend), int(qlen)
        tstart, tend, tlen = int(tstart), int(tend), int(tlen)
        stats["total"] += 1
        if qend - qstart >= align_len_cut and tend - tstart >= align_len_cut \
                and float(identity) > identity_cut:
            # rates stringified like Perl's default (%.15g); identity kept
            # as its original string
            align.setdefault(qid, []).append(
                [qstart, qend, qlen, "%.15g" % ((qend - qstart) / qlen),
                 tid, tstart, tend, tlen,
                 "%.15g" % ((tend - tstart) / tlen), tstrand, identity])
        else:
            stats["unconfident"] += 1

    out = ["#pacbio_Id\tscafftig_num\tpacbio_start\tpacbio_end\t"
           "pacbio_length\tpacbio_coverage\tscafftig_id\tscafftig_start\t"
           "scafftig_end\tscafftig_length\tscafftig_coverage\talign_strand\t"
           "align_identity"]
    for qid in sorted(align):
        ary = sorted(align[qid], key=lambda p: p[0])
        ary2 = []
        for p in ary:
            qleft = p[0]
            qright = p[2] - p[1]
            tleft = p[5]
            tright = p[7] - p[6]
            if (qleft > end_len_cut and tleft > end_len_cut) or \
                    (qright > end_len_cut and tright > end_len_cut):
                stats["nonsemiglobal"] += 1
                continue
            ary2.append(p)
        if not ary2:
            continue
        groups = [[ary2[0]]]
        for p in ary2[1:]:
            if p[0] < groups[-1][-1][1]:
                groups[-1].append(p)
            else:
                groups.append([p])
        ary3 = []
        for grp in groups:
            if len(grp) > 1:
                best = None
                best_id = 0.0
                for p in grp:
                    if float(p[-1]) > best_id:
                        best_id = float(p[-1])
                        best = p
                stats["multiple"] += len(grp) - 1
                ary3.append(best)
            else:
                ary3.append(grp[0])
        stats["lines"] += 1
        stats["aligns"] += len(ary3)
        row = f"{qid}\t{len(ary3)}"
        for p in ary3:
            row += "".join("\t" + str(x) for x in p)
        out.append(row)
    stats["fine"] = (stats["total"] - stats["unconfident"]
                     - stats["nonsemiglobal"] - stats["multiple"])
    return out, stats


def blasrm4_twoctg(lines, repeat_ctgs=None):
    """Chain -> 2ctg pair rows (consecutive alignment pairs per read)."""
    repeat_ctgs = set(repeat_ctgs or [])
    out = []
    for line in lines:
        if line.startswith("#"):
            continue
        t = line.split()
        if len(t) < 2:
            continue
        reads_id = t[0]
        hit_num = int(t[1])
        if hit_num < 2:
            continue
        t = t[2:]
        recs = []
        for i in range(0, len(t), 11):
            read_start, read_end, read_len = t[i], t[i + 1], t[i + 2]
            ctg_id = t[i + 4]
            strand = t[i + 9]
            ctg_len = int(t[i + 7])
            if strand == "0":
                cs, ce, sc = t[i + 5], t[i + 6], "F"
            else:
                cs = str(ctg_len - int(t[i + 6]))
                ce = str(ctg_len - int(t[i + 5]))
                sc = "R"
            identity = t[i + 10]
            if ctg_id not in repeat_ctgs:
                recs.append(f"{reads_id}\t{read_len}\t{read_start}\t"
                            f"{read_end}\t{ctg_id}\t{ctg_len}\t{cs}\t{ce}\t"
                            f"{sc}\t{identity}%")
        if len(recs) < 2:
            continue
        for i in range(1, len(recs)):
            out.append(recs[i - 1] + "\t" + recs[i])
    return out


def fullread_to_subread(lines, smart_cell_id: str):
    """pbsim FASTQ -> PacBio-style subread headers
    (m.../<zmw>/0_<len> RQ=0.84)."""
    it = iter(lines)
    zmw = 1
    out = []
    for line in it:
        if line.startswith("@"):
            seq = next(it).rstrip("\n")
            next(it)
            qual = next(it).rstrip("\n")
            out.append(f"@{smart_cell_id}/{zmw}/0_{len(seq)} RQ=0.84")
            out.append(seq)
            out.append("+")
            out.append(qual)
            zmw += 1
    return out
