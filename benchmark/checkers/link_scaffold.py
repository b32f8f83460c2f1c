"""link_scaffold: all six files, every line, against the frozen link
graph and readout (reference/scaffold.py) on the reference's own contigs
and 2ctg lines, and the scaffolds held to what the upstream guarantees of
them (reference/guarantees_scaffold.py).  Leaves the reference's
scaffolds in ``state`` for the next round's map_pair check."""

import argparse

from benchmark import checks_scaffold as cs
from benchmark.reference import guarantees_scaffold as guarantees
from benchmark.reference import scaffold as ref

FILES = {
    "scaffold_links_lines_differ": ("scaffold.links.all",
                                    "scaffold.links.uniq"),
    "scaffold_seq_lines_differ": ("scaffold.seq.fa",
                                  "scaffold_repeat.seq.fa"),
    "scaffold_pos_lines_differ": ("scaffold.pos.tab",
                                  "scaffold_repeat.pos.tab"),
}


def check(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="link_scaffold")
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-n", type=int, default=3)
    ap.add_argument("-i", type=int, default=400)
    ap.add_argument("-o", default="Output")
    ap.add_argument("contig_fa")
    ap.add_argument("twoctg_lib")
    a, _ = ap.parse_known_args(argv)
    paths = cs.file_list(a.twoctg_lib)
    want = ref.link_scaffold(
        cs.reference_file(a.contig_fa, run, state),
        [cs.reference_file(p, run, state) for p in paths], a.i, a.n,
        bool(a.m))
    pre = f"{a.o}.insert{a.i}."
    out = {name: (sum(cs.lines_differ(pre + ext, want[ext])
                      for ext in exts), 0)
           for name, exts in FILES.items()}
    cs.keep(pre + "scaffold.seq.fa", want["scaffold.seq.fa"], state)
    with open(a.contig_fa, "rb") as f:
        contigs = f.read()
    got = {ext: cs.read_back(pre + ext) for exts in FILES.values()
           for ext in exts}
    out["scaffold_contigs_repeated"] = (guarantees.scaffold_contigs(
        contigs, got["scaffold.pos.tab"], got["scaffold_repeat.pos.tab"]),
        0)
    out["scaffold_sequence_differs"] = (sum(
        guarantees.scaffold_sequences(contigs, got[seq], got[pos])
        for seq, pos in (("scaffold.seq.fa", "scaffold.pos.tab"),
                         ("scaffold_repeat.seq.fa",
                          "scaffold_repeat.pos.tab"))), 0)
    twoctg = [cs.read_back(p) for p in paths]
    out["scaffold_links_unsupported"] = (guarantees.scaffold_links(
        got["scaffold.links.uniq"], twoctg, a.n), 0)
    out["scaffold_gaps_unsupported"] = (guarantees.scaffold_gaps(
        contigs, got["scaffold.pos.tab"], twoctg, a.i, a.n, bool(a.m)), 0)
    return out
