"""correct_error_reads (-j 0): every read of ``<file>.correct.fa.gz``
held to what the upstream guarantees of it (reference/guarantees.py), and
a sample of reads (``check.random_reads`` drawn from the seed, and the
``check.hardest_reads`` with the most true errors) against the frozen
host engine (reference/correct.py), on the table that kmerfreq's check
left in ``state``."""

import argparse
import gzip

import torch

from benchmark.gen import read_name
from benchmark.reference import correct as ref_correct
from benchmark.reference import guarantees
from benchmark.reference import kmers as ref_kmers


def sample_reads(n: int, errors: torch.Tensor, seed: int, n_random: int,
                 n_hardest: int) -> list:
    """Rows to check: n_random drawn from the seed, and the n_hardest with
    the most true errors (the rows most likely to take the long paths)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    rand = torch.randperm(n, generator=g)[:n_random]
    hard = torch.argsort(errors, descending=True, stable=True)[:n_hardest]
    return sorted(set(rand.tolist()) | set(hard.tolist()))


def check(argv: list, run, state: dict) -> dict:
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
