"""The doubling readout (contig/pointer_doubling.py) against the JAX
package's: the device programs _resolve_chains and _succ_resolve (and the
native succ_build), assemble_doubling's eight artifacts byte for byte on
the fixtures of tests/test_pointer_doubling.py, and pipeline.run / the CLI
with readout="doubling" and their run logs.  Also the readout's helpers:
seg_argmin (which raises on an empty group), collect_heads, fmt_lexical and
the bubble comparison."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dbg_assembly_tpu import dna as jdna  # noqa: E402
from dbg_assembly_tpu import native as jnative  # noqa: E402
from dbg_assembly_tpu.contig import pipeline as jpipe  # noqa: E402
from dbg_assembly_tpu.contig import pointer_doubling as jpd  # noqa: E402
from dbg_assembly_tpu.contig.graph import GraphBuilder as JBuilder  # noqa
from dbg_assembly_tpu.contig.refassemble import (  # noqa: E402
    AssembleParams as JParams)
from dbg_assembly_tpu_torch import native  # noqa: E402
from dbg_assembly_tpu_torch.contig import pipeline as tpipe  # noqa: E402
from dbg_assembly_tpu_torch.contig import pointer_doubling as tpd  # noqa
from dbg_assembly_tpu_torch.contig.graph import NodeTable  # noqa: E402
from dbg_assembly_tpu_torch.contig.refassemble import (  # noqa: E402
    AssembleParams as TParams)

import torch_port_data  # noqa: E402
from tools.simulate_reads import make_genome, simulate_pe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = (".contig.kmer.freq", ".contig.tip.fa", ".contig.lowedge.fa",
            ".contig.bubble.fa", ".contig.seq.fa", ".contig.seq.depth",
            ".contig.small.fa", ".contig.small.depth")


def _assert_same_files(jprefix: str, tprefix: str) -> None:
    for suf in SUFFIXES:
        with open(jprefix + suf, "rb") as a, open(tprefix + suf, "rb") as b:
            assert a.read() == b.read(), suf


def _normalize(log: str, prefix: str) -> str:
    return re.sub(r"(Run time: )[0-9.e+-]+", r"\1X",
                  log.replace(prefix, "PREFIX"))


# ------------------------------------------------------------ fixtures
def _jax_table(codes: np.ndarray, k: int):
    gb = JBuilder(k, max_read_len=250)
    gb.add(codes, np.full(len(codes), codes.shape[1], np.int32))
    return gb.finalize()


def _haploid(genome_size, seed, err=0.0, cov=30.0):
    """The reads of test_pointer_doubling.build_table."""
    genome = make_genome(genome_size, seed=seed, repeat_frac=0.0)
    r1, _, r2, _ = simulate_pe(genome, 100, 300, cov, seed=seed + 1,
                               err_start=err, err_end=err)
    return np.concatenate([jdna.ascii_to_codes(r1), jdna.ascii_to_codes(r2)])


def _diploid():
    """The reads of test_pointer_doubling.test_diploid_bubbles_match."""
    rng = np.random.default_rng(9)
    g1 = np.asarray(make_genome(30_000, seed=8, repeat_frac=0.0))
    g2 = g1.copy()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for p in range(300, len(g2) - 300, 600):
        cur = int(np.flatnonzero(acgt == g2[p])[0])
        g2[p] = acgt[(cur + 1 + int(rng.integers(3))) % 4]
    parts = []
    for i, g in enumerate((g1, g2)):
        r1, _, r2, _ = simulate_pe(g, 100, 300, 25.0, seed=30 + i,
                                   err_start=0.0, err_end=0.0)
        parts += [jdna.ascii_to_codes(r1), jdna.ascii_to_codes(r2)]
    return np.concatenate(parts)


FIXTURES = {
    # name: (reads, pruning on)
    "no_pruning": (lambda: _haploid(30_000, 5), False),
    "errors": (lambda: _haploid(40_000, 17, err=0.006, cov=40.0), True),
    "diploid": (_diploid, True),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_assemble_doubling_matches_jax(tmp_path, name):
    make_reads, prune = FIXTURES[name]
    k = 21
    jt = _jax_table(make_reads(), k)
    tt = NodeTable.from_numpy(jt.kmers, jt.lcnt, jt.rcnt, jt.first_idx,
                              jt.counts, jt.total_kmers, jt.total_reads)
    flags = dict(ksize=k, init_hash_size=0.001, contig_len_cutoff=100,
                 is_remove_tip=prune, is_remove_lowedge=prune,
                 is_remove_bubble=prune)
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    if not prune:   # the disabled passes write no file
        for pre in (jprefix, tprefix):
            for suf in (".contig.tip.fa", ".contig.lowedge.fa",
                        ".contig.bubble.fa"):
                open(pre + suf, "w").close()
    js = jpd.assemble_doubling(jt, JParams(**flags), jprefix)
    ts = tpd.assemble_doubling(tt, TParams(**flags), tprefix, device="cpu")
    assert vars(ts) == vars(js)
    assert ts.contig_num > 0
    if name == "errors":
        assert ts.tips_removed > 0
    if name == "diploid":
        assert ts.bubbles_removed > 0
    _assert_same_files(jprefix, tprefix)


# ------------------------------------------------------- device programs
def _functional_graph(rng, n: int, shape: str) -> np.ndarray:
    """A successor function over n states, STOP = n."""
    succ = rng.integers(0, n + 1, n).astype(np.int64)
    if shape == "chains":
        perm = rng.permutation(n)
        succ = np.where(rng.random(n) < 0.9, np.roll(perm, 1),
                        succ).astype(np.int64)
        succ[perm[rng.integers(0, n)]] = n
    elif shape == "cycles":        # disjoint cycles, no STOP
        perm = rng.permutation(n)
        cuts = np.sort(rng.choice(np.arange(1, n), min(5, n - 1),
                                  replace=False))
        for seg in np.split(perm, cuts):
            succ[seg] = np.roll(seg, -1)
    elif shape == "rho":           # tails leading into one cycle
        perm = rng.permutation(n)
        c = max(n // 10, 1)
        succ[perm[:c]] = np.roll(perm[:c], -1)
        succ[perm[c:]] = perm[rng.integers(0, np.arange(c, n))]
    elif shape == "merges":        # in-degree > 1, all reach STOP
        order = rng.permutation(n)
        succ[order[0]] = n
        succ[order[1:]] = order[rng.integers(0, np.arange(1, n))]
    return succ


@pytest.mark.parametrize("shape", ["random", "chains", "cycles", "rho",
                                   "merges"])
def test_resolve_chains_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    for n in (1, 2, 3, int(rng.integers(50, 3000))):
        succ = _functional_graph(rng, n, shape) if n > 1 else \
            np.array([1], np.int64)
        te, td, tc = tpd._resolve_chains(torch.from_numpy(succ))
        je, jd, jc = (np.asarray(v) for v in
                      jpd._resolve_chains(jnp.asarray(succ)))
        assert te.dtype == td.dtype == torch.int64 and tc.dtype == torch.bool
        assert np.array_equal(te.numpy(), je)
        assert np.array_equal(td.numpy(), jd)
        assert np.array_equal(tc.numpy(), jc)
        if shape == "cycles" and n > 1:
            assert tc.all()
        if shape == "merges":
            assert not tc.any()


@pytest.mark.parametrize("k", [17, 31])
def test_succ_resolve_matches_jax_and_native(k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 60, 400)
    codes = np.stack([genome[s:s + 60] for s in starts]).astype(np.uint8)
    jt = _jax_table(codes, k)
    tt = NodeTable.from_numpy(*(getattr(jt, f) for f in (
        "kmers", "lcnt", "rcnt", "first_idx", "counts", "total_kmers",
        "total_reads")))
    g = tpd._Graph(tt, TParams(ksize=k, init_hash_size=0.0001), "cpu")
    g.calc_links()
    M = g.M
    alive = (~g.deleted[:M]) & g.linear[:M]
    got = tpd.resolve_on_device(g, alive)
    want = [np.asarray(x) for x in jpd._succ_resolve(
        jnp.asarray(g.kmers), jnp.asarray(g.l_base[:M]),
        jnp.asarray(g.r_base[:M]), jnp.asarray(alive), k=k)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    succ_native = native.succ_build(g.kmers, g.l_base[:M], g.r_base[:M],
                                    alive.astype(np.uint8), k)
    assert np.array_equal(got[0], succ_native)
    assert (got[0] < 2 * M).sum() > 500     # real chains exist
    en, dn, cn = native.resolve_chains_host(succ_native)
    ok = ~cn
    assert np.array_equal(cn, got[3])
    assert np.array_equal(en[ok], got[1][ok])
    assert np.array_equal(dn[ok], got[2][ok])


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return torch_port_data.write_lib(str(tmp_path_factory.mktemp("dbl")))


def test_pipeline_doubling_matches_jax(lib, tmp_path):
    k = 31
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    jlog, tlog = io.StringIO(), io.StringIO()
    js = jpipe.run(lib, jprefix, ksize=k, readout="doubling",
                   params=JParams(ksize=k, init_hash_size=0.01),
                   log_stream=jlog, log_buffer=100)
    ts = tpipe.run(lib, tprefix, ksize=k, readout="doubling",
                   params=TParams(ksize=k, init_hash_size=0.01),
                   log_stream=tlog, log_buffer=100, device="cpu")
    assert vars(ts) == vars(js)
    assert ts.contig_num > 0
    _assert_same_files(jprefix, tprefix)
    assert (_normalize(tlog.getvalue(), tprefix)
            == _normalize(jlog.getvalue(), jprefix))


def test_cli_debruijn_contig_doubling(lib, tmp_path):
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    jlog = io.StringIO()
    jpipe.run(lib, jprefix, ksize=25, max_read_len=90, readout="doubling",
              params=JParams(ksize=25, init_hash_size=0.01,
                             contig_len_cutoff=100),
              log_stream=jlog, log_threads=2)
    proc = subprocess.run(
        [sys.executable, "-m", "dbg_assembly_tpu_torch", "debruijn_contig",
         "-k", "25", "-r", "90", "-i", "0.01", "-M", "100", "-t", "2",
         "--readout", "doubling", "-o", tprefix, "--device", "cpu", lib],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    _assert_same_files(jprefix, tprefix)
    assert (_normalize(proc.stderr, tprefix)
            == _normalize(jlog.getvalue(), jprefix))


def test_bad_readout_raises(lib, tmp_path):
    with pytest.raises(ValueError, match="readout"):
        tpipe.run(lib, str(tmp_path / "x"), readout="serial", device="cpu")


# --------------------------------------------------------------- helpers
def test_seg_argmin_matches_lexsort():
    rng = np.random.default_rng(4)
    n_groups = 50
    cid = np.concatenate([np.arange(n_groups),
                          rng.integers(0, n_groups, 2000)])
    rng.shuffle(cid)
    key = rng.permutation(len(cid)).astype(np.int64)
    got = native.seg_argmin(cid, key, n_groups)
    order = np.lexsort((key, cid))
    _, first = np.unique(cid[order], return_index=True)
    assert np.array_equal(got, order[first])
    assert np.array_equal(got, jnative.seg_argmin(cid, key, n_groups))


def test_seg_argmin_raises_on_an_empty_group():
    cid = np.array([0, 2, 2, 0, 3], np.int64)      # group 1 has no member
    key = np.array([5, 4, 3, 2, 1], np.int64)
    assert jnative.seg_argmin(cid, key, 4).tolist() == [3, -1, 2, 4]
    with pytest.raises(ValueError, match="no member"):
        native.seg_argmin(cid, key, 4)
    assert native.seg_argmin(cid[cid != 3], key[cid != 3], 1).tolist() == [3]


def test_collect_heads_matches_numpy():
    rng = np.random.default_rng(11)
    for _ in range(4):
        M = int(rng.integers(4, 800))
        n = 2 * M
        alive = rng.random(M) < 0.8
        succ = rng.integers(0, n + 1, n).astype(np.int64)
        node = np.repeat(np.arange(M, dtype=np.int64), 2)
        succ[~alive[node]] = n
        _, _, cyc = tpd._resolve_chains(torch.from_numpy(succ))
        cyc = cyc.numpy()
        hn, fbn = native.collect_heads(alive.astype(np.uint8), succ,
                                       cyc.astype(np.uint8))
        is_state = alive[node]
        rev = np.arange(n, dtype=np.int64) ^ 1
        heads = is_state & ~cyc & (succ[rev] >= n) & ~cyc[rev]
        assert np.array_equal(hn, np.flatnonzero(heads))
        assert sorted(fbn.tolist()) == sorted(set(node[cyc & is_state]))


@pytest.mark.parametrize("a,b", [("ACGTACGTTA", "ACGAACGTTA"),
                                 ("ACGTTTACG", "ACGTTACG"),
                                 ("GATTACA", "TACAGATT"), ("A", "")])
def test_bubble_compare_matches_jax(a, b):
    from dbg_assembly_tpu.contig import refassemble as jref
    from dbg_assembly_tpu_torch.contig import refassemble as tref
    assert tref.global_aligning(a, b) == jref.global_aligning(a, b)
    x, y = tref.global_aligning(a, b)
    assert tref.compare_two_seq_simple(x, y) == \
        jref.compare_two_seq_simple(x, y)


def test_fmt_lexical_matches_jax():
    from dbg_assembly_tpu.io import stat as jstat
    from dbg_assembly_tpu_torch.io import stat as tstat
    for x in (0.1, 1 / 3, 25.0, 123456.789, 1e-7, 2.0 / 7 * 1e9):
        assert tstat.fmt_lexical(x) == jstat.fmt_lexical(x)
