"""debruijn_contig (the exact readout): all eight files, every line,
against the reference assembler (reference/contig.py) on the node table
built from the cell's reads, and every contig held to what the upstream
guarantees of it (reference/guarantees.py)."""

import argparse
import os

from benchmark.checks import lines_differ
from benchmark.reference import contig as ref_contig
from benchmark.reference import guarantees

CONTIG_FILES = {
    "contigs_lines_differ": (".contig.seq.fa", ".contig.small.fa"),
    "depth_lines_differ": (".contig.seq.depth", ".contig.small.depth"),
    "pruned_lines_differ": (".contig.tip.fa", ".contig.lowedge.fa",
                            ".contig.bubble.fa"),
    "kmer_freq_lines_differ": (".contig.kmer.freq",),
}


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="debruijn_contig")
    for flag, typ, default in (
            ("-k", int, 31), ("-r", int, 250), ("-o", str, "output"),
            ("-i", float, 1.0), ("-l", float, 0.7), ("-D", int, 2),
            ("-T", int, 1), ("-I", int, 100), ("-P", float, 3.0),
            ("-W", int, 1), ("-C", int, 100), ("-G", float, 3.0),
            ("-B", int, 1), ("-U", int, 100), ("-L", float, 0.1),
            ("-E", float, 0.1), ("-M", int, 125)):
        ap.add_argument(flag, type=typ, default=default)
    ap.add_argument("lib")
    a, _ = ap.parse_known_args(argv)
    params = ref_contig.AssembleParams(
        ksize=a.k, kmer_freq_cutoff=a.D, init_hash_size=a.i,
        load_factor=a.l, is_remove_tip=bool(a.T), tip_len_cutoff=a.I,
        tip_depth_cutoff=a.P, is_remove_lowedge=bool(a.W),
        lowedge_len_cutoff=a.C, lowedge_depth_cutoff=a.G,
        is_remove_bubble=bool(a.B), bubble_len_cutoff=a.U,
        bubble_len_diff_rate=a.L, bubble_base_diff_rate=a.E,
        contig_len_cutoff=a.M)
    table = ref_contig.node_table(run.inputs["seqs"], a.k, a.r, run.device)

    def got(ext):
        try:
            with open(a.o + ext, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""
    held = guarantees.contigs(
        got(".contig.seq.fa"), got(".contig.small.fa"),
        got(".contig.seq.depth"), got(".contig.small.depth"), table[0],
        table[1], table[2], a.k, a.D, a.M, run.device)
    want = os.path.join(run.scratch, "reference_contig")
    ref_contig.Assembler(*table, params).run(want)
    del table

    def ref(ext):
        with open(want + ext, "rb") as f:
            return f.read()
    out = {name: (sum(lines_differ(a.o + ext, ref(ext)) for ext in exts),
                  0)
           for name, exts in CONTIG_FILES.items()}
    out.update({key: (val, 0) for key, val in held.items()})
    return out
