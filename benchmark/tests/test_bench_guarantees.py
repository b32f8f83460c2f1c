"""The guarantee checks of reference/guarantees.py on records made by
hand: each breach is counted once, and sound records read 0."""

import numpy as np
import torch

from benchmark.reference import guarantees as g
from benchmark.reference import kmers

K = 5


def _table(seqs: list) -> torch.Tensor:
    """The 1-bit table of every k-mer of the given reads, both strands."""
    fwd = torch.cat([kmers.windows(torch.tensor([list(s)], dtype=torch.uint8),
                                   K, None, 0)[0].flatten() for s in seqs])
    return kmers.bitmap(torch.cat([fwd, kmers.revcomp(fwd, K)]), K)


def _record(name, seq, score=0, tl=0, tr=0, deleted=0):
    out = b"" if deleted else seq
    return [name + b"\tModifiedBaseNum: %d\tFinalReadLength: %d"
            b"\tLeftEndTrim: %d\tRightEndTrim: %d\tIsDeleted: %d"
            % (score, len(out), tl, tr, deleted), out]


def _stat(n, L, res_reads, res_bases, trimmed, trimmed_bases, deleted,
          score) -> bytes:
    return ("num_raw_reads %d\nnum_raw_bases %d\nnum_result_reads %d\n"
            "num_result_bases %d\n\nnum_trimmed_reads %d\n"
            "num_trimmed_bases %d\nnum_deleted_reads %d\n\n"
            "num_corrected_bases_by_Fast_method 7\n"
            "num_corrected_bases_by_BBtree_method 9\n"
            "num_corrected_bases_by_two_methods %d\n\n"
            "filter_ratio: (num_raw_bases - num_res_bases) / num_raw_bases "
            "%g\ncorrect_ratio: total_all_base_correct_score / "
            "num_res_bases %g\n"
            % (n, n * L, res_reads, res_bases, trimmed, trimmed_bases,
               deleted, score, (n * L - res_bases) / (n * L),
               score / res_bases)).encode()


def _correction_case():
    good = b"ACGTTGCAAGGT"
    bad = b"ACGTTCCAAGGT"                   # one base off good
    seqs = np.frombuffer(good + bad + good, np.uint8).reshape(3, 12).copy()
    names = [b">r1", b">r2", b">r3"]
    solid = g.solid_reads(torch.from_numpy(seqs), _table([good]), K)
    lines = (_record(b">r1", good) + _record(b">r2", b"ACGTTGCAAG", 1, 0, 2)
             + _record(b">r3", good) + [b""])
    stat = _stat(3, 12, 3, 34, 1, 2, 0, 1)
    return lines, seqs, names, solid, stat


def test_solid_reads():
    _, _, _, solid, _ = _correction_case()
    assert solid.tolist() == [True, False, True]


def test_correction_sound_reads_zero():
    lines, seqs, names, solid, stat = _correction_case()
    out = g.correction(lines, seqs, names, solid, 2, 8, stat)
    assert out == {"untouched_reads_differ": 0,
                   "corrected_reads_malformed": 0,
                   "correct_stat_totals_differ": 0}


def test_correction_breaches_counted():
    lines, seqs, names, solid, stat = _correction_case()
    # a read with a low k-mer left as it was
    broken = list(lines)
    broken[2:4] = _record(b">r2", seqs[1].tobytes())
    out = g.correction(broken, seqs, names, solid, 2, 8, stat)
    assert out["untouched_reads_differ"] == 1
    # a solid read trimmed; more bases changed than announced; over -c
    for rec, key in ((_record(b">r1", b"ACGTTGCAAG", 0, 0, 2),
                      "untouched_reads_differ"),
                     (_record(b">r2", b"TTGTTGCAAG", 1, 0, 2),
                      "corrected_reads_malformed"),
                     (_record(b">r2", b"ACGTTGCAAG", 3, 0, 2),
                      "corrected_reads_malformed")):
        broken = list(lines)
        i = 0 if rec[0].startswith(b">r1") else 2
        broken[i:i + 2] = rec
        assert g.correction(broken, seqs, names, solid, 2, 8, stat)[key] \
            == 1, rec
    # too short to keep, a wrong name, a stat total off
    short = list(lines)
    short[2:4] = _record(b">r2", b"ACGTTG", 1, 0, 6)
    assert g.correction(short, seqs, names, solid, 2, 8, stat)[
        "corrected_reads_malformed"] == 1
    renamed = list(lines)
    renamed[4] = renamed[4].replace(b">r3", b">r9")
    assert g.correction(renamed, seqs, names, solid, 2, 8, stat)[
        "corrected_reads_malformed"] == 1
    off = stat.replace(b"num_trimmed_bases 2", b"num_trimmed_bases 3")
    assert g.correction(lines, seqs, names, solid, 2, 8, off)[
        "correct_stat_totals_differ"] == 1


def _node_table(reads: list, k: int):
    """(kmers, lcnt, rcnt) of the reads, as reference/contig.py builds
    it."""
    from benchmark.reference import contig
    seqs = [torch.tensor([list(r)], dtype=torch.uint8) for r in reads]
    t = contig.node_table(seqs, k, 1000, "cpu")
    return t[0], t[1], t[2]


def _contig_files(recs: list, k: int, table):
    """.contig.seq.fa / .depth bytes of (id, sequence) records, with
    depths from the table (the seed at the start)."""
    fa, dp = b"", b""
    for cid, seq in recs:
        steps = []
        for p in range(len(seq) - k):
            x, b = seq[p:p + k], seq[p + k]
            steps.append(_link(table, x, b, k))
        avg = sum(steps) / len(steps)
        fa += b">ctg_%d\tlength: %d\tavgDepth: %s\n%s\n" % (
            cid, len(seq), repr(avg).encode(), seq)
        seed = bytes([g._depth_byte(int(avg))] * k)
        dp += b">ctg_%d\n" % cid + seed + bytes(
            g._depth_byte(s) for s in steps) + b"\n"
    return fa, dp


def _link(table, x: bytes, b: int, k: int) -> int:
    code = {65: 0, 67: 1, 71: 2, 84: 3}
    f = 0
    for c in x:
        f = (f << 2) | code[c]
    rc = 0
    for c in reversed(x):
        rc = (rc << 2) | (3 - code[c])
    kmers_, lcnt, rcnt = table
    i = int(np.searchsorted(kmers_, np.uint64(min(f, rc))))
    return int(rcnt[i, code[b]] if f <= rc else lcnt[i, 3 - code[b]])


def test_contigs():
    k = 7
    genome = b"ACGTTGCATGCCATAGGCTTAACGGATCCTAGGA"
    reads = [genome] * 4 + [genome[:20]] * 2      # depth 6 on the left
    table = _node_table(reads, k)
    ctg = genome[:26]
    fa, dp = _contig_files([(1, ctg)], k, table)

    def run(fa, dp, cutoff=2, small=(b"", b"")):
        return g.contigs(fa, small[0], dp, small[1], *table, k, cutoff, 10,
                         "cpu")
    assert run(fa, dp) == {"contig_steps_unsupported": 0,
                           "contig_nodes_shared": 0,
                           "contig_depths_differ": 0,
                           "contig_records_malformed": 0}
    # links of 4 fail a cutoff of 4; a base off the genome is no node
    assert run(fa, dp, cutoff=4)["contig_steps_unsupported"] == 26 - k - 13
    mut = fa.replace(ctg, ctg[:12] + b"G" + ctg[13:])   # was A
    assert run(mut, dp)["contig_steps_unsupported"] > 0
    # a depth off by one, an average off
    assert run(fa, dp[:-2] + bytes([dp[-2] + 1]) + b"\n")[
        "contig_depths_differ"] == 1
    assert run(fa.replace(b"avgDepth: ", b"avgDepth: 1"), dp)[
        "contig_depths_differ"] == 1
    # a second contig through the same interior nodes, and ids out of
    # order, a small one too long
    fa2, dp2 = _contig_files([(3, ctg[2:20])], k, table)
    assert run(fa + fa2, dp + dp2)["contig_nodes_shared"] > 0
    fa3, dp3 = _contig_files([(5, ctg[:12])], k, table)
    assert run(fa + fa3, dp + dp3)["contig_records_malformed"] == 1
    assert run(fa, dp, small=(fa2, dp2))["contig_records_malformed"] == 1
    # two contigs that only share an end k-mer: the second starts where
    # the first ends
    fa4, dp4 = _contig_files([(3, genome[26 - k:30])], k, table)
    assert run(fa + fa4, dp + dp4) == run(fa, dp)
