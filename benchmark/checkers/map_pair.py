"""map_pair: for each pair of files of its .lib, every line of the
.2ctg, .1ctg and .gap files and of the .stat, and the .map_pair.2ctg.lib
list, against the mapper in torch (reference/scaffold.py) on every pair
of the cell's reads and the reference's own contigs or scaffolds; every
mapped mate and the .stat held to what the upstream guarantees
(reference/guarantees_scaffold.py).  Leaves the reference's 2ctg lines in
``state`` for link_scaffold's check."""

import argparse
import os

import torch

from benchmark import checks_scaffold as cs
from benchmark.gen import read_name
from benchmark.reference import guarantees_scaffold as guarantees
from benchmark.reference import scaffold as ref

SUFFIXES = ("2ctg", "1ctg", "gap")


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="map_pair")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-s", type=int, default=5)
    ap.add_argument("-l", type=int, default=125)
    ap.add_argument("-r", type=int, default=250)
    ap.add_argument("-i", type=float, default=0.97)
    ap.add_argument("-f", type=int, default=1)
    ap.add_argument("-o", default="./")
    ap.add_argument("contig_fa")
    ap.add_argument("lib")
    a, _ = ap.parse_known_args(argv)
    if a.f != 1:
        raise ValueError("the map_pair check reads the cell's FASTQ (-f 1)")
    fasta = cs.reference_file(a.contig_fa, run, state)
    with open(a.contig_fa, "rb") as f:
        contigs = dict(ref.fasta_records(f.read()))
    reads = cs.Reads(run)
    files = cs.file_list(a.lib)
    out = dict.fromkeys(("map_lines_differ", "map_stat_lines_differ",
                         "map_lines_misaligned", "map_stat_totals_differ"),
                        0)
    for f1, f2 in zip(files[::2], files[1::2]):
        mates, ids = [], []
        for path in (f1, f2):
            fi = run.pass_files.index(path)
            lib, mate = run.inputs["names"][fi]
            seqs = run.inputs["seqs"][fi]
            mates.append((seqs, torch.full((seqs.shape[0],), seqs.shape[1],
                                           dtype=torch.int64)))
            ids.append([read_name(lib, mate, i)[1:]
                        for i in range(seqs.shape[0])])
        want = ref.map_pair(fasta, mates, ids, a.k, a.s, a.l, a.r, a.i,
                            run.device)
        base = os.path.join(a.o, os.path.basename(f1)) + ".map_pair."
        got = {suf: cs.read_back(base + suf + ".gz") for suf in SUFFIXES}
        out["map_lines_differ"] += sum(
            cs.lines_differ(base + suf + ".gz", want[suf])
            for suf in SUFFIXES)
        out["map_stat_lines_differ"] += cs.lines_differ(
            base + "stat", want["stat"].encode())
        out["map_lines_misaligned"] += guarantees.map_lines(
            [got[suf] for suf in SUFFIXES], contigs, reads.rows, a.i)
        n = min(m[0].shape[0] for m in mates)
        pairs = int(((mates[0][1][:n] >= a.r) & (mates[1][1][:n] >= a.r))
                    .sum())
        out["map_stat_totals_differ"] += guarantees.map_stat(
            cs.read_back(base + "stat"), got["2ctg"], got["1ctg"],
            got["gap"], pairs)
        cs.keep(base + "2ctg.gz", want["2ctg"], state)
    # the list file names each pair's 2ctg file under -o, as the upstream
    # writes it (map_pair.cpp:89-95)
    out["map_list_lines_differ"] = cs.lines_differ(
        a.lib + ".map_pair.2ctg.lib", "".join(
            f"{a.o}/{p}.map_pair.2ctg.gz\n" for p in files[::2]).encode())
    return {name: (val, 0) for name, val in out.items()}
