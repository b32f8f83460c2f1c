"""The port's map_pair and link_scaffold against the benchmark's plain
reference (benchmark/reference/scaffold.py), byte for byte over the
upstream's two scaffolding rounds (insert 400, then 800 on the round-1
scaffolds), and the guarantee checks that replay no tool
(benchmark/reference/guarantees_scaffold.py): each 0 on the port's files
and each counting a file altered to break it.

A seeded 40 kb genome with planted 700 bp repeats, two paired libraries of
150 bp reads at inserts 400 and 800, contigs from the port's own
debruijn_contig; every command through cli.main on the CPU."""

import gzip
import os

import numpy as np
import pytest
import torch

from benchmark.reference import guarantees_scaffold as guarantees
from benchmark.reference import scaffold as ref
from dbg_assembly_tpu_torch import cli
from torch_port_data import write_fastq
from tools.simulate_reads import make_genome, simulate_pe

READ_LEN = 150
INSERTS = (400, 800)
MAP_SUFFIXES = ("2ctg", "1ctg", "gap")
SCAFFOLD_FILES = ("scaffold.links.all", "scaffold.links.uniq",
                  "scaffold.seq.fa", "scaffold.pos.tab",
                  "scaffold_repeat.seq.fa", "scaffold_repeat.pos.tab")


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    """The libraries' files and reads, and the port's contigs of both."""
    d = tmp_path_factory.mktemp("scaffold_reference")
    genome = make_genome(40_000, seed=25)
    libs = {}
    for ins in INSERTS:
        r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, ins, 6.0,
                                     seed=ins, err_end=0.03)
        files = []
        for mate, (reads, quals) in enumerate(((r1, q1), (r2, q2)), 1):
            files.append(str(d / f"ins{ins}_{mate}.fq"))
            write_fastq(files[-1], f"ins{ins}", reads, quals, mate)
        with open(d / f"ins{ins}.lib", "w") as f:
            f.write("".join(p + "\n" for p in files))
        libs[ins] = (files, (r1, r2))
    with open(d / "all.lib", "w") as f:
        f.write("".join(p + "\n" for ins in INSERTS for p in libs[ins][0]))
    cli.main(["debruijn_contig", "-k", "31", "-r", str(READ_LEN), "-i",
              "0.01", "-M", "100", "-o", str(d / "asm"), str(d / "all.lib"),
              "--device", "cpu"])
    return d, libs


def _read(path: str) -> bytes:
    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) \
            as f:
        return f.read()


def _rounds(assembly, where, k: int, S: int) -> dict:
    """Both rounds of the port and of the reference; for each round's
    files, (the port's bytes, the reference's bytes) by name."""
    d, libs = assembly
    where.mkdir()
    contigs = str(d / "asm.contig.seq.fa")
    ref_fasta = _read(contigs)
    out = {}
    for rnd, ins in enumerate(INSERTS, 1):
        files, reads = libs[ins]
        mapdir = str(where / f"map{ins}")
        cli.main(["map_pair", "-k", str(k), "-s", str(S), "-l", "100",
                  "-r", str(READ_LEN), "-i", "0.97", "-o", mapdir, contigs,
                  str(d / f"ins{ins}.lib"), "--device", "cpu"])
        mates = [(torch.from_numpy(r), torch.full((len(r),), READ_LEN))
                 for r in reads]
        ids = [[b"ins%d_%d/%d" % (ins, i + 1, m) for i in range(len(r))]
               for m, r in enumerate(reads, 1)]
        want = ref.map_pair(ref_fasta, mates, ids, k, S, 100, READ_LEN,
                            0.97, "cpu", block=700)
        base = os.path.join(mapdir, os.path.basename(files[0])) \
            + ".map_pair."
        for suf in MAP_SUFFIXES:
            out[f"{rnd}.{suf}"] = (_read(base + suf + ".gz"), want[suf])
        out[f"{rnd}.stat"] = (_read(base + "stat"), want["stat"].encode())
        lst = where / f"twoctg{ins}.lib"
        lst.write_text(base + "2ctg.gz\n")
        prefix = str(where / f"round{rnd}")
        cli.main(["link_scaffold", "-i", str(ins), "-o", prefix, contigs,
                  str(lst), "--device", "cpu"])
        scaffolds = ref.link_scaffold(ref_fasta, [want["2ctg"]], ins)
        for name in SCAFFOLD_FILES:
            out[f"{rnd}.{name}"] = (_read(f"{prefix}.insert{ins}.{name}"),
                                    scaffolds[name])
        out[f"{rnd}.input"] = (_read(contigs), ref_fasta)
        contigs = f"{prefix}.insert{ins}.scaffold.seq.fa"
        ref_fasta = scaffolds["scaffold.seq.fa"]
    return out


@pytest.fixture(scope="module")
def rounds(assembly, tmp_path_factory):
    return _rounds(assembly, tmp_path_factory.mktemp("r") / "k31", 31, 5)


@pytest.mark.parametrize("k,S", [(31, 5), (21, 3)])
def test_port_equals_reference(assembly, rounds, tmp_path, k, S):
    """Every map_pair and link_scaffold file of both rounds, the port's
    against the reference's, and enough of each kind of record that the
    comparison means something."""
    got = rounds if (k, S) == (31, 5) else _rounds(assembly,
                                                   tmp_path / "x", k, S)
    for name, (port, want) in got.items():
        assert port == want, name
    for rnd in (1, 2):
        for suf in MAP_SUFFIXES:
            assert got[f"{rnd}.{suf}"][0].count(b"\n") > 5, (rnd, suf)
        assert b"\tR\n" in got[f"{rnd}.scaffold.pos.tab"][0]
        assert b"\tgap\t" in got[f"{rnd}.scaffold.pos.tab"][0]
    # round 2 maps onto scaffolds, whose N runs the index splits at
    assert b"N" in got["2.input"][0]


def _mapping_checks(files: dict, rnd: int, reads) -> dict:
    contigs = dict(ref.fasta_records(files[f"{rnd}.input"][0]))
    ins = INSERTS[rnd - 1]
    by = {(b"ins%d" % ins, m): r for m, r in enumerate(reads[ins], 1)}

    def rows(ids):
        seqs = np.zeros((len(ids), READ_LEN), np.uint8)
        lens = np.full(len(ids), -1, np.int64)
        for j, rid in enumerate(ids):
            head, _, mate = rid.rpartition(b"/")
            lib, _, num = head.rpartition(b"_")
            if (lib, int(mate)) in by:
                seqs[j] = by[(lib, int(mate))][int(num) - 1]
                lens[j] = READ_LEN
        return seqs, lens
    maps = [files[f"{rnd}.{suf}"][0] for suf in MAP_SUFFIXES]
    return {
        "map_lines_misaligned": guarantees.map_lines(maps, contigs, rows,
                                                     0.97),
        "map_stat_totals_differ": guarantees.map_stat(
            files[f"{rnd}.stat"][0], *maps, len(reads[ins][0]))}


def _scaffold_checks(files: dict, rnd: int) -> dict:
    def got(name):
        return files[f"{rnd}.{name}"][0]
    contigs = got("input")
    return {
        "scaffold_contigs_repeated": guarantees.scaffold_contigs(
            contigs, got("scaffold.pos.tab"), got("scaffold_repeat.pos.tab")),
        "scaffold_sequence_differs": sum(
            guarantees.scaffold_sequences(contigs, got(s), got(p))
            for s, p in (("scaffold.seq.fa", "scaffold.pos.tab"),
                         ("scaffold_repeat.seq.fa",
                          "scaffold_repeat.pos.tab"))),
        "scaffold_links_unsupported": guarantees.scaffold_links(
            got("scaffold.links.uniq"), [got("2ctg")], 3),
        "scaffold_gaps_unsupported": guarantees.scaffold_gaps(
            contigs, got("scaffold.pos.tab"), [got("2ctg")],
            INSERTS[rnd - 1], 3)}


def _checks(files: dict, libs) -> dict:
    reads = {ins: libs[ins][1] for ins in INSERTS}
    out: dict = {}
    for rnd in (1, 2):
        for name, val in {**_mapping_checks(files, rnd, reads),
                          **_scaffold_checks(files, rnd)}.items():
            out[name] = out.get(name, 0) + val
    return out


def _swap_field(data: bytes, field: int, new) -> bytes:
    """The first record line with field ``field`` replaced by new(old)."""
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines) if x and x[:1] != b"#")
    f = lines[i].split(b"\t")
    f[field] = new(f[field])
    lines[i] = b"\t".join(f)
    return b"\n".join(lines)


def _drop_record(data: bytes) -> bytes:
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines) if x and x[:1] != b"#")
    return b"\n".join(lines[:i] + lines[i + 1:])


def _repeat_block(data: bytes) -> bytes:
    """A contig block of .pos.tab named a second time."""
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines) if x.startswith(b"\t")
             and not x.startswith(b"\tgap"))
    return b"\n".join(lines[:i + 1] + lines[i:])


def _flip_base(data: bytes) -> bytes:
    head, _, rest = data.partition(b"\n")
    flip = {ord("A"): b"C", ord("C"): b"A", ord("G"): b"T", ord("T"): b"G"}
    return head + b"\n" + flip[rest[0]] + rest[1:]


def _inflate_link(data: bytes) -> bytes:
    """A kept link's pair count raised past the 2ctg lines behind it."""
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines[1:], 1) if x.count(b"\t") > 2)
    f = lines[i].split(b"\t")
    link = f[3].split(b",")
    link[1] = b"1000"
    f[3] = b",".join(link)
    lines[i] = b"\t".join(f)
    return b"\n".join(lines)


def _gap_block(data: bytes, change) -> bytes:
    """The first gap block of .pos.tab with its size replaced by
    change(size)."""
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines) if x.startswith(b"\tgap\t"))
    f = lines[i].split(b"\t")
    f[4] = b"%d" % change(int(f[4]))
    lines[i] = b"\t".join(f)
    return b"\n".join(lines)


def _flip_block(data: bytes) -> bytes:
    """The first contig block of a scaffold of several contigs read from
    the other strand."""
    lines = data.split(b"\n")
    i = next(j for j, x in enumerate(lines)
             if x.startswith(b"\tgap\t")) - 1
    f = lines[i].split(b"\t")
    f[5] = b"R" if f[5] == b"F" else b"F"
    lines[i] = b"\t".join(f)
    return b"\n".join(lines)


BREAKS = {
    "map_lines_misaligned": ("1.2ctg", lambda x: _swap_field(
        x, 3, lambda v: b"%d" % (int(v) - 1))),
    "map_stat_totals_differ": ("1.2ctg", _drop_record),
    "scaffold_contigs_repeated": ("1.scaffold.pos.tab", _repeat_block),
    "scaffold_sequence_differs": ("1.scaffold.seq.fa", _flip_base),
    "scaffold_links_unsupported": ("1.scaffold.links.uniq", _inflate_link),
    "scaffold_gaps_unsupported": ("1.scaffold.pos.tab", lambda x: _gap_block(
        x, lambda v: v + 1)),
}


@pytest.mark.parametrize("check", sorted(BREAKS))
def test_guarantee_check(assembly, rounds, check):
    """Each check reads 0 on the port's files, and counts the file
    altered to break it."""
    _, libs = assembly
    clean = _checks(rounds, libs)
    assert clean == dict.fromkeys(BREAKS, 0), clean
    name, alter = BREAKS[check]
    files = dict(rounds)
    files[name] = (alter(files[name][0]), None)
    assert _checks(files, libs)[check] > 0


@pytest.mark.parametrize("alter", ["flipped", "gap_minus_one"])
def test_gap_check_holds_order_and_orientation(rounds, alter):
    """The gap check counts a contig block read from the wrong strand,
    and a gap one short, in either round."""
    for rnd, ins in enumerate(INSERTS, 1):
        pos = rounds[f"{rnd}.scaffold.pos.tab"][0]
        broken = _flip_block(pos) if alter == "flipped" else _gap_block(
            pos, lambda v: v - 1)
        args = (rounds[f"{rnd}.input"][0], broken,
                [rounds[f"{rnd}.2ctg"][0]], ins, 3)
        assert guarantees.scaffold_gaps(*args) > 0, rnd


def test_gap_check_reads_mate_pairs(rounds):
    """Mate pairs (-m 1) place contigs by the pair rules with both mates'
    directions flipped: the round's 2ctg lines flipped so and read as mate
    pairs support the same scaffolds."""
    flip = {b"F": b"R", b"R": b"F"}
    for rnd, ins in enumerate(INSERTS, 1):
        lines = []
        for line in rounds[f"{rnd}.2ctg"][0].split(b"\n"):
            f = line.split(b"\t")
            if len(f) == 20 and line[:1] != b"#":
                f[8], f[18] = flip[f[8]], flip[f[18]]
            lines.append(b"\t".join(f))
        args = (rounds[f"{rnd}.input"][0],
                rounds[f"{rnd}.scaffold.pos.tab"][0], [b"\n".join(lines)],
                ins, 3)
        assert guarantees.scaffold_gaps(*args, is_mate=True) == 0, rnd
        assert guarantees.scaffold_gaps(*args) > 0, rnd
