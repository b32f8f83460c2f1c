"""merge_assembly: patch scafftigs over a PacBio backbone assembly.

Counterpart of dbg_assembly_tpu/utils/merge_assembly.py.

Parity: link_scaffold/merge_assembly.pl:72-263.  Consumes a blat PSL best
file (scafftig vs utg), replaces aligned utg regions with illumina scafftig
sequence, keeps pacbio-cns sequence in the gaps, and appends unaligned utgs
and unaligned scafftigs (>=250bp).

Note: the Perl script iterates the unaligned sets in Perl hash order
(randomized per process); this port uses input order, which is
deterministic — the aligned section is byte-compatible.
"""

from __future__ import annotations


def _read_fasta(path: str) -> dict:
    out = {}
    name = None
    seq = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(seq)
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq = []
            else:
                seq.append("".join(line.split()))
    if name is not None:
        out[name] = "".join(seq)
    return out


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))[::-1]


def _disp(s: str, width: int = 100) -> str:
    """Perl Display_seq(\\$seq, 100) followed by print "$seq\\n": each
    width-chunk newline-terminated (empty seq -> lone newline), plus the
    trailing print newline — records end with a blank line."""
    wrapped = "".join(s[i:i + width] + "\n" for i in range(0, len(s), width))
    return (wrapped or "\n") + "\n"


def run(psl_best: str, scafftig_fa: str, utg_fa: str,
        output_prefix: str = "Output", seq_id_prefix: str = "TMC_",
        align_len_cut: int = 125, identity_cut: float = 0.9,
        query_rate_cut: float = 0.5) -> dict:
    scafftig = _read_fasta(scafftig_fa)
    utg = _read_fasta(utg_fa)

    aligned_sct = set()
    aligned_utg = set()
    align_data: dict[str, list] = {}
    with open(psl_best) as f:
        for line in f:
            t = line.split()
            if len(t) < 21 or not t[0].isdigit():
                continue
            (match, mismatch, _rep, _ns, _qgc, qgap, _tgc, tgap, strand,
             qname, qsize, qstart, qend, tname, tsize, tstart,
             tend) = t[:17]
            match, mismatch = int(match), int(mismatch)
            qgap, tgap = int(qgap), int(tgap)
            qsize, qstart, qend = int(qsize), int(qstart), int(qend)
            tsize, tstart, tend = int(tsize), int(tstart), int(tend)
            qrate = (qend - qstart) / qsize
            denom = match + mismatch + qgap + tgap
            identity = match / denom if denom else 0.0
            if identity > identity_cut and qend - qstart > align_len_cut \
                    and qrate > query_rate_cut:
                align_data.setdefault(tname, []).append(
                    [tstart, tend, tsize, (tend - tstart) / tsize, qname,
                     qstart, qend, qsize, qrate, strand, identity])
                aligned_sct.add(qname)
                aligned_utg.add(tname)

    seq_f = open(f"{output_prefix}.merged_assembly.seq.fa", "w")
    pos_f = open(f"{output_prefix}.merged_assembly.pos.tab", "w")
    pos_f.write("#Seq_Id\tblock_start\tblock_end\tblock_size\t"
                "target_block_start\ttarget_block_end\ttarget_block_size\t"
                "target_name\t+\toutput_block_length\t"
                "output_block_sequence\n")

    stats = dict(aligned_utg=0, unaligned_utg=0, unaligned_sct=0)
    seq_id = 0
    for tname in sorted(align_data):
        stats["aligned_utg"] += 1
        seq_id += 1
        ary2 = sorted(align_data[tname], key=lambda p: p[0])
        ary3 = [ary2[0]]
        for p in ary2[1:]:
            if p[1] > ary3[-1][1] + 100:
                ary3.append(p)
        out_rows = []
        for i, p in enumerate(ary3):
            tstart, tend, tsize, trate, qname, qstart, qend, qsize, \
                qrate, strand, identity = p
            gap_size = tstart - (0 if i == 0 else ary3[i - 1][1])
            qseq = scafftig.get(qname, "")
            if strand == "-":
                qseq = _revcomp(qseq)
                qstart, qend = qsize - qend, qsize - qstart
            if gap_size < 0:
                qseq = qseq[qstart + abs(gap_size):qend]
            else:
                qseq = qseq[qstart:qend]
            out_rows.append([tstart, tend, qname, qsize, qstart, qend,
                             strand, gap_size, qseq])

        tseq = utg.get(tname, "")
        final = []
        flen = 0
        pos_out = []
        names = ""
        for (tstart, tend, qname, qsize, qstart, qend, strand, gap_size,
             ctg_seq) in out_rows:
            gap_seq = ""
            gap_start = gap_end = tstart
            if gap_size > 0:
                gap_start = gap_end - gap_size
                gap_seq = tseq[gap_start:gap_start + gap_size]
            final.append(gap_seq + ctg_seq)
            bs = flen + 1
            bsize = gap_size if gap_size > 0 else 0
            flen += bsize
            pos_out.append(
                f"{seq_id_prefix}{seq_id}\t{bs}\t{flen}\t{bsize}\t"
                f"{gap_start}\t{gap_end}\t{gap_size}\t{tname}\t+\t"
                f"{len(gap_seq)}\t{gap_seq}\n")
            names += "," + qname
            bs = flen + 1
            bsize = len(ctg_seq)
            flen += bsize
            pos_out.append(
                f"{seq_id_prefix}{seq_id}\t{bs}\t{flen}\t{bsize}\t"
                f"{tstart}\t{tend}\t{tend - tstart}\t{qname}\t{strand}\t"
                f"{len(ctg_seq)}\t{ctg_seq}\n")
        if out_rows[-1][1] < len(tseq):
            gap_start = out_rows[-1][1]
            gap_end = len(tseq)
            gap_size = gap_end - gap_start
            gap_seq = tseq[gap_start:gap_end]
            bs = flen + 1
            bsize = gap_size if gap_size > 0 else 0
            flen += bsize
            pos_out.append(
                f"{seq_id_prefix}{seq_id}\t{bs}\t{flen}\t{bsize}\t"
                f"{gap_start}\t{gap_end}\t{gap_size}\t{tname}\t+\t"
                f"{len(gap_seq)}\t{gap_seq}\n")
            final.append(gap_seq)
        final_seq = "".join(final)
        seq_f.write(f">{seq_id_prefix}{seq_id}     Length: "
                    f"{len(final_seq)}     Category: "
                    f"Merged_illumina_pacbio      Source: {tname}{names}\n"
                    + _disp(final_seq))
        pos_f.write("".join(pos_out))

    for utg_id, useq in utg.items():
        if utg_id not in aligned_utg:
            stats["unaligned_utg"] += 1
            seq_id += 1
            ulen = len(useq)
            pos_f.write(f"{seq_id_prefix}{seq_id}\t1\t{ulen}\t{ulen}\t0\t"
                        f"{ulen}\t{ulen}\t{utg_id}\t+\t{ulen}\t{useq}\n")
            seq_f.write(f">{seq_id_prefix}{seq_id}    Length: {ulen}    "
                        f"Category: Derived_from_pacbio     "
                        f"Source: {utg_id}\n" + _disp(useq))
    for sct_id, sseq in scafftig.items():
        slen = len(sseq)
        if sct_id not in aligned_sct and slen >= 250:
            stats["unaligned_sct"] += 1
            seq_id += 1
            pos_f.write(f"{seq_id_prefix}{seq_id}\t1\t{slen}\t{slen}\t0\t"
                        f"{slen}\t{slen}\t{sct_id}\t+\t{slen}\t{sseq}\n")
            seq_f.write(f">{seq_id_prefix}{seq_id}     Length: {slen}    "
                        f"Category: Derived_from_illumina     "
                        f"Source: {sct_id}\n" + _disp(sseq))
    seq_f.close()
    pos_f.close()
    return stats
