"""What decides ``correct``: each stage command's files from the last timed
pass, held against the plain reference under ``reference/``.

A checker is keyed by the stage's command.  It parses the stage's own
argument list with the flags and defaults of the upstream tool, works the
expected answer out from the cell's inputs alone, and returns named
numbers, each with its limit.  Every comparison here is exact (limit 0):
the port promises files byte-identical to the upstream tools'.  The
correction and contig stages are also held, on every read and contig, to
what the upstream guarantees of each record (reference/guarantees.py),
which replays neither tool.  Checkers share what one derives for the next
(the k-mer table) through ``state``.
"""

from __future__ import annotations

import argparse
import gzip
import os
import zlib

import numpy as np
import torch

from .gen import read_name
from .reference import clean as ref_clean
from .reference import contig as ref_contig
from .reference import correct as ref_correct
from .reference import guarantees
from .reference import kmers as ref_kmers

CZ_BLOCK_BYTES = 1 << 20       # 8M k-mers a compressed block of the table


def _read_cz(path: str, k: int) -> np.ndarray:
    """A .cz table (blocks listed in <path>.len) as 4^k / 8 bytes."""
    out = np.zeros((1 << (2 * k)) // 8, np.uint8)
    with open(path + ".len") as f:
        sizes = [int(x) for x in f.read().split()]
    off = 0
    with open(path, "rb") as f:
        for s in sizes:
            raw = zlib.decompress(f.read(s))
            out[off:off + len(raw)] = np.frombuffer(raw, np.uint8)
            off += CZ_BLOCK_BYTES
    return out


def _differ(got: list, want: list) -> int:
    """Items that differ, position by position, and those one side lacks."""
    return sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))


def _lines_differ(path: str, want: bytes) -> int:
    """Lines of the file at ``path`` (none if it is missing) that differ
    from ``want``'s."""
    try:
        with open(path, "rb") as f:
            got = f.read()
    except FileNotFoundError:
        got = b""
    return _differ(got.split(b"\n"), want.split(b"\n"))


def check_kmerfreq(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="kmerfreq")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=1)
    ap.add_argument("-q", type=int, default=0)
    ap.add_argument("lib")
    a, _ = ap.parse_known_args(argv)
    dev = run.device
    uniq, counts, total = ref_kmers.count(
        list(zip(run.inputs["seqs"], run.inputs["quals"])), a.k, a.q, dev)
    high = uniq[counts > a.m]
    state["high_kmers"] = (a.k, high)
    want_stat = ref_kmers.stat_text(a.k, total, uniq.numel(),
                                    ref_kmers.spectrum(counts))
    del uniq, counts
    want = ref_kmers.bitmap(high, a.k)
    got = torch.from_numpy(_read_cz(a.lib + ".kmer.freq.cz", a.k)).to(dev)
    table_differ = int((got != want).sum())
    del got, want
    stat_differ = _lines_differ(a.lib + ".kmer.freq.stat",
                                want_stat.encode())
    return {"table_bytes_differ": (table_differ, 0),
            "spectrum_lines_differ": (stat_differ, 0)}


def sample_reads(n: int, errors: torch.Tensor, seed: int, n_random: int,
                 n_hardest: int) -> list:
    """Rows to check: n_random drawn from the seed, and the n_hardest with
    the most true errors (the rows most likely to take the long paths)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    rand = torch.randperm(n, generator=g)[:n_random]
    hard = torch.argsort(errors, descending=True, stable=True)[:n_hardest]
    return sorted(set(rand.tolist()) | set(hard.tolist()))


def check_correct(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="correct_error_reads")
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-m", type=int, default=0)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-x", type=int, default=0)
    ap.add_argument("-n", type=int, default=5_000_000)
    ap.add_argument("-r", type=int, default=75)
    ap.add_argument("-j", type=int, default=0)
    ap.add_argument("cz")
    ap.add_argument("lib")
    a, _ = ap.parse_known_args(argv)
    if a.j != 0:
        raise ValueError("the correction check reads unmerged outputs (-j 0)")
    k, high = state["high_kmers"]
    if k != a.k:
        raise ValueError(f"kmerfreq counted k={k}, correction reads k={a.k}")
    # the consumer's table: every k-mer whose canonical form is high
    table = ref_kmers.bitmap(torch.cat([high, ref_kmers.revcomp(high, k)]),
                             k)
    solid = [guarantees.solid_reads(s, table, k) for s in run.inputs["seqs"]]
    table = table.cpu().numpy()
    params = ref_correct.CorrectParams(
        ksize=a.k, high_freq_reg_len=a.m, max_change=a.c, further_trim=a.x,
        max_bbt_nodes=a.n, min_read_len=a.r)
    differ = 0
    out = {}
    for fi, path in enumerate(run.pass_files):
        with gzip.open(path + ".correct.fa.gz") as f:
            lines = f.read().split(b"\n")
        seqs = run.inputs["seqs"][fi]
        lib, mate = run.inputs["names"][fi]
        with open(path + ".correct.stat", "rb") as f:
            stat = f.read()
        names = [b">" + read_name(lib, mate, i)[1:]
                 for i in range(seqs.shape[0])]
        for key, val in guarantees.correction(
                lines, seqs.numpy(), names, solid[fi], params.max_change,
                params.min_read_len, stat).items():
            out[key] = out.get(key, 0) + val
        rows = sample_reads(seqs.shape[0], run.inputs["errors"][fi],
                            run.seed + fi, run.check["random_reads"],
                            run.check["hardest_reads"])
        if len(lines) != 2 * seqs.shape[0] + 1:
            differ += len(rows)
            continue
        for i in rows:
            want = ref_correct.correct_record(
                read_name(lib, mate, i), seqs[i].numpy().tobytes(), table,
                params)
            got = lines[2 * i] + b"\n" + lines[2 * i + 1] + b"\n"
            differ += got != want
    return {"reads_differ": (differ, 0),
            **{key: (val, 0) for key, val in out.items()}}


CONTIG_FILES = {
    "contigs_lines_differ": (".contig.seq.fa", ".contig.small.fa"),
    "depth_lines_differ": (".contig.seq.depth", ".contig.small.depth"),
    "pruned_lines_differ": (".contig.tip.fa", ".contig.lowedge.fa",
                            ".contig.bubble.fa"),
    "kmer_freq_lines_differ": (".contig.kmer.freq",),
}


def check_contig(argv: list, run, state: dict) -> dict:
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
    out = {name: (sum(_lines_differ(a.o + ext, ref(ext)) for ext in exts),
                  0)
           for name, exts in CONTIG_FILES.items()}
    out.update({key: (val, 0) for key, val in held.items()})
    return out


def _input_records(path: str, run, state: dict) -> list:
    """(head, seq, qual) records of a stage's input: a cell input file,
    or what the reference made for an earlier stage's output."""
    if path in state.get("records", {}):
        return state["records"][path]
    fi = run.pass_files.index(path)
    lib, mate = run.inputs["names"][fi]
    seqs = run.inputs["seqs"][fi].numpy()
    quals = run.inputs["quals"][fi].numpy()
    return [(read_name(lib, mate, i), seqs[i].tobytes(), quals[i].tobytes())
            for i in range(seqs.shape[0])]


def _records_differ(got_path: str, want: list) -> int:
    """Records (four lines each) of a FASTQ.gz that differ from want."""
    with gzip.open(got_path) as f:
        lines = f.read().split(b"\n")
    got = [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]
    return _differ(got, [(h, s, b"+", q) for h, s, q in want])


def _clean_result(name, out_path, stat_path, records, stat, state):
    state.setdefault("records", {})[out_path] = records
    stat_differ = _lines_differ(stat_path, stat.encode())
    return {f"{name}_reads_differ": (_records_differ(out_path, records), 0),
            f"{name}_stat_lines_differ": (stat_differ, 0)}


def check_lowqual(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="clean_lowqual")
    ap.add_argument("-e", type=float, default=0.001)
    ap.add_argument("-q", type=int, default=33)
    ap.add_argument("-r", type=int, default=75)
    for x in ("input", "output", "stat"):
        ap.add_argument(x)
    a, _ = ap.parse_known_args(argv)
    records, stat = ref_clean.lowqual(_input_records(a.input, run, state),
                                      a.e, a.r, a.q, run.device)
    return _clean_result("lowqual", a.output, a.stat, records, stat, state)


def check_adapter(argv: list, run, state: dict) -> dict:
    ap = argparse.ArgumentParser(prog="clean_adapter")
    ap.add_argument("-a", default="Both-adapter")
    ap.add_argument("-s", type=int, default=12)
    ap.add_argument("-r", type=int, default=75)
    for x in ("input", "output", "stat"):
        ap.add_argument(x)
    a, _ = ap.parse_known_args(argv)
    records, stat = ref_clean.adapter(_input_records(a.input, run, state),
                                      ref_clean.DEFAULT_ADAPTERS[a.a], a.s,
                                      a.r, run.device)
    return _clean_result("adapter", a.output, a.stat, records, stat, state)


CHECKS = {"kmerfreq": check_kmerfreq, "correct_error_reads": check_correct,
          "debruijn_contig": check_contig, "clean_lowqual": check_lowqual,
          "clean_adapter": check_adapter}


def digests(directory: str, skip=("reads.lib",)) -> dict:
    """blake2b of every regular file a pass wrote (the inputs are links;
    the .lib lists the pass's own paths)."""
    import hashlib
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if name in skip or os.path.islink(path) or not os.path.isfile(path):
            continue
        h = hashlib.blake2b()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out
