"""Counting statistics, the device contig stage and the last host helpers
of dbg_assembly_tpu_torch against the JAX package, on inputs made from a
seed with numpy: kmer/stats.py (histogram_small, histogram256,
spectrum_sorted and its last-run rule), kmer/count.py (run_length,
count_stats, count_spectrum_fast), pointer_doubling.contig_stage_step
(cyclic states included), graph.build_from_files, the dna helpers and the
FASTQ/FASTA writers.  Exact equality: every output is an integer or a
byte string."""

import gzip
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dbg_assembly_tpu import dna as jdna  # noqa: E402
from dbg_assembly_tpu.contig import graph as jgraph  # noqa: E402
from dbg_assembly_tpu.contig import pointer_doubling as jpd  # noqa: E402
from dbg_assembly_tpu.io import fastq as jfq  # noqa: E402
from dbg_assembly_tpu.kmer import count as jcount  # noqa: E402
from dbg_assembly_tpu.kmer import stats as jstats  # noqa: E402
from dbg_assembly_tpu_torch import dna as tdna  # noqa: E402
from dbg_assembly_tpu_torch.contig import graph as tgraph  # noqa: E402
from dbg_assembly_tpu_torch.contig import pointer_doubling as tpd  # noqa: E402
from dbg_assembly_tpu_torch.io import fastq as tfq  # noqa: E402
from dbg_assembly_tpu_torch.kmer import count as tcount  # noqa: E402
from dbg_assembly_tpu_torch.kmer import stats as tstats  # noqa: E402
from dbg_assembly_tpu_torch.ops.chop import SENTINEL  # noqa: E402

import torch_port_data  # noqa: E402

JSENT = jcount.SENTINEL


def _both(values: np.ndarray, n_sentinel: int = 0):
    """A sorted uint64 vector (values < 2^62) with a SENTINEL tail, as JAX's
    jnp array and as the port's int64 tensor."""
    v = np.sort(np.asarray(values, np.uint64))
    j = np.concatenate([v, np.full(n_sentinel, JSENT, np.uint64)])
    t = np.concatenate([v.view(np.int64),
                        np.full(n_sentinel, SENTINEL, np.int64)])
    return jnp.asarray(j), torch.from_numpy(t)


def _runs_values(seed: int, n_species: int, longest: int):
    """Values whose runs have lengths 1..longest, in a random order."""
    rng = np.random.default_rng(seed)
    species = rng.choice(1 << 40, n_species, replace=False)
    lens = rng.integers(1, longest + 1, n_species)
    lens[:3] = longest                 # a few runs past a small max_freq
    return np.repeat(species, lens)


CASES = {
    "sentinel_tail": (_runs_values(1, 400, 12), 57),
    "no_tail": (_runs_values(2, 400, 12), 0),
    "runs_past_255": (_runs_values(3, 40, 300), 9),
    "all_sentinel": (np.zeros(0, np.uint64), 31),
    "empty": (np.zeros(0, np.uint64), 0),
    "one_run": (np.full(7, 5), 0),
    "quirk": (np.array([1, 2, 2, 3]), 0),
}


@pytest.mark.parametrize("nbins", [8, 256])
def test_histogram_small(nbins):
    rng = np.random.default_rng(nbins)
    v = rng.integers(-5, nbins + 5, 5000).astype(np.int32)
    want = np.asarray(jstats.histogram_small(jnp.asarray(v), nbins))
    got = tstats.histogram_small(torch.from_numpy(v), nbins)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if nbins == 256:
        np.testing.assert_array_equal(
            tstats.histogram256(torch.from_numpy(v)).numpy(),
            np.asarray(jstats.histogram256(jnp.asarray(v))))


@pytest.mark.parametrize("max_freq", [8, 255])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spectrum_sorted_and_count_stats(case, max_freq):
    values, n_sent = CASES[case]
    jx, tx = _both(values, n_sent)
    js, jn = jstats.spectrum_sorted(jx, max_freq=max_freq)
    ts, tn = tstats.spectrum_sorted(tx, max_freq)
    assert ts.dtype == torch.int64 and ts.shape == (max_freq + 1,)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tn == int(jn)
    js, jn, jv = jcount.count_stats(jx, max_freq=max_freq)
    ts, tn, tv = tcount.count_stats(tx, max_freq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tn, tv) == (int(jn), int(jv))


def test_spectrum_last_run_rule():
    """The JAX package's spectrum_sorted marks no boundary at the end of
    the vector: with no SENTINEL tail the last run lands in bin max_freq,
    where count_stats counts it exactly.  The port keeps the rule."""
    _, tx = _both(np.array([1, 2, 2, 3]))
    spec, n = tstats.spectrum_sorted(tx, 8)
    assert spec.tolist() == [0, 1, 1, 0, 0, 0, 0, 0, 1] and n == 3
    spec, n, nv = tcount.count_stats(tx, 8)
    assert spec.tolist() == [0, 2, 1, 0, 0, 0, 0, 0, 0] and (n, nv) == (3, 4)
    _, tx = _both(np.array([1, 2, 2, 3]), 1)
    assert tstats.spectrum_sorted(tx, 8)[0].tolist() == \
        [0, 2, 1, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_length(case):
    values, n_sent = CASES[case]
    jx, tx = _both(values, n_sent)
    ju, jc, jn = (np.asarray(v) for v in jcount.run_length(jx))
    tu, tc, tn = tcount.run_length(tx)
    assert tn == int(jn) and tc.dtype == torch.int64
    tu = tu.numpy().view(np.uint64).copy()
    tu[tu == np.uint64(2 ** 63 - 1)] = JSENT
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tc.numpy(), jc)


def _reads(seed: int, N: int, L: int, k: int, full: bool):
    """Reads with repeats (runs past max_freq 8), ragged unless ``full``:
    full-length reads have no invalid window, so no SENTINEL tail."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    codes[N // 2:] = codes[:1]
    lengths = np.full(N, L, np.int32) if full else \
        rng.integers(k - 3, L + 1, N).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


@pytest.mark.parametrize("k,full,max_freq,N", [
    (17, False, 255, 64), (21, True, 255, 64), (21, True, 8, 64),
    (31, False, 8, 64), (21, False, 255, 0)])
def test_count_spectrum_fast(k, full, max_freq, N):
    codes, lengths = _reads(k, N, 40, k, full)
    want = jcount.count_spectrum_fast(jnp.asarray(codes),
                                      jnp.asarray(lengths), k,
                                      max_freq=max_freq)
    spec, n_unique, n_valid = tcount.count_spectrum_fast(
        torch.from_numpy(codes), torch.from_numpy(lengths), k, max_freq)
    np.testing.assert_array_equal(spec.numpy(), np.asarray(want[0]))
    assert (n_unique, n_valid) == (int(want[1]), int(want[2]))
    # against the capped histogram of the exact counts: equal, except that
    # with no invalid window the largest k-mer's run moves to max_freq
    _, counts, _, _ = tcount.count_unique_fast(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    c = counts.numpy()
    exact = np.bincount(np.minimum(c[c > 0], max_freq),
                        minlength=max_freq + 1)
    if full and N:
        last = min(int(c[c > 0][-1]), max_freq)
        exact[last] -= 1
        exact[max_freq] += 1
    np.testing.assert_array_equal(spec.numpy(), exact)


# ------------------------------------------------------ the contig stage
def _stage_table():
    """tests/test_contig_stage_step.py's table (5 kb genome, 600 reads of
    80, k 21) plus the reads of a 2 kb circular genome, whose nodes all
    lie on one cycle of linear nodes."""
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    starts = rng.integers(0, 5000 - 80, 600)
    codes = [np.stack([genome[s:s + 80] for s in starts])]
    ring = np.random.default_rng(12).integers(0, 4, 2000).astype(np.uint8)
    ring2 = np.concatenate([ring, ring[:80]])
    codes.append(np.stack([ring2[s:s + 80] for s in range(0, 2000, 5)] * 3))
    codes = np.concatenate(codes).astype(np.uint8)
    gb = jgraph.GraphBuilder(21)
    gb.add(codes, np.full(len(codes), 80, np.int32))
    return gb.finalize()


@pytest.mark.parametrize("n_sentinel", [0, 5])
def test_contig_stage_step(n_sentinel):
    t = _stage_table()
    kmers = np.concatenate([t.kmers, np.full(n_sentinel, JSENT, np.uint64)])
    lcnt = np.concatenate([t.lcnt, np.zeros((n_sentinel, 4), np.int32)])
    rcnt = np.concatenate([t.rcnt, np.zeros((n_sentinel, 4), np.int32)])
    want = [np.asarray(v) for v in jpd.contig_stage_step(
        jnp.asarray(kmers), jnp.asarray(lcnt), jnp.asarray(rcnt), k=21,
        cut=2)]
    tk = kmers.view(np.int64).copy()
    tk[kmers == JSENT] = SENTINEL
    got = tpd.contig_stage_step(torch.from_numpy(tk), torch.from_numpy(lcnt),
                                torch.from_numpy(rcnt), k=21, cut=2)
    names = ("l_num", "r_num", "linear", "e", "dist", "cyclic")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for name, g in zip(names, got):
        assert g.dtype == {"l_num": torch.int32, "r_num": torch.int32,
                           "linear": torch.bool, "cyclic": torch.bool}.get(
                               name, torch.int64), name
    cyclic = got[5].numpy()
    # the ring's states keep rotating: their e and dist are what the fixed
    # number of rounds leaves, and must still agree
    assert cyclic.sum() >= 2 * 1900 and (~cyclic).sum() > 1000


def test_build_from_files(tmp_path):
    lib = torch_port_data.write_lib(str(tmp_path), genome_len=6000,
                                    depth=10.0)
    with open(lib) as f:
        files = f.read().split()
    want = jgraph.build_from_files(files, 21, "fq", 90)
    got = tgraph.build_from_files(files, 21, "fq", 90, device="cpu")
    for name in ("kmers", "lcnt", "rcnt", "first_idx", "counts"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.total_kmers, got.total_reads) == (want.total_kmers,
                                                  want.total_reads)


# ------------------------------------------------------------ host helpers
def test_dna_helpers():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 6, (20, 33)).astype(np.uint8)
    np.testing.assert_array_equal(tdna.codes_to_ascii(codes),
                                  jdna.codes_to_ascii(codes))
    np.testing.assert_array_equal(tdna.revcomp_codes(codes),
                                  jdna.revcomp_codes(codes))
    for k in (1, 17, 31):
        kb = rng.integers(0, 1 << (2 * k), 200, dtype=np.uint64)
        base = rng.integers(0, 4, 200).astype(np.uint64)
        for fn in ("next_kmer_rightward", "next_kmer_leftward"):
            want = getattr(jdna, fn)(kb, base, k)
            got = getattr(tdna, fn)(kb, base, k)
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, want)
            assert int(getattr(tdna, fn)(int(kb[0]), 3, k)) == \
                int(getattr(jdna, fn)(int(kb[0]), 3, k))


def test_fastq_writers(tmp_path):
    rng = np.random.default_rng(6)
    heads = [b"@r%d/1" % i for i in range(50)]
    seqs = [bytes(rng.choice(list(b"ACGTN"), int(n)))
            for n in rng.integers(0, 90, 50)]
    quals = [bytes(rng.integers(35, 75, len(s)).astype(np.uint8))
             for s in seqs]
    for mod in (jfq, tfq):
        name = mod.__name__.split(".")[0]
        mod.write_fastq_gz(str(tmp_path / f"{name}.fq.gz"), heads, seqs,
                           quals)
        mod.write_fasta_gz(str(tmp_path / f"{name}.fa.gz"),
                           [b">" + h[1:] for h in heads], seqs, level=1)
    for ext in ("fq.gz", "fa.gz"):
        a, b = (gzip.decompress((tmp_path / f"{n}.{ext}").read_bytes())
                for n in ("dbg_assembly_tpu", "dbg_assembly_tpu_torch"))
        assert a == b and len(a) > 1000
