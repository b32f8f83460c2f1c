"""The port's distributed stages against the JAX package's and against the
port's own single-device runs, with the slots on the CPU: the mesh contig
stage (MeshGraph's search and chain resolution, assemble_doubling_mesh's
files), the sharded corrector (probe_collective, stage_a_sharded,
correct_batch_sharded with fallback rows), the sharded mapper, the three
commands with ``--mesh 4 --device cpu`` and run_full with mesh_devices=4,
file by file.  Exact equality: integers and bytes.  JAX's data_mesh(n)
takes the first n of the 8 CPU devices tests/conftest.py forces."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu.contig import mesh_assemble as jma
from dbg_assembly_tpu.contig.refassemble import AssembleParams as JParams
from dbg_assembly_tpu.correct import sharded as jsh
from dbg_assembly_tpu.kmer import count as jkc
from dbg_assembly_tpu.parallel import mesh as jmesh
from dbg_assembly_tpu.scaffold import index as jix
from dbg_assembly_tpu.scaffold import sharded as jmsh
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch import workflow as twf
from dbg_assembly_tpu_torch.contig import mesh_assemble as tma
from dbg_assembly_tpu_torch.contig import pointer_doubling as tpd
from dbg_assembly_tpu_torch.contig.graph import NodeTable
from dbg_assembly_tpu_torch.contig.refassemble import AssembleParams as TParams
from dbg_assembly_tpu_torch.correct import device as tdev
from dbg_assembly_tpu_torch.correct import sharded as tsh
from dbg_assembly_tpu_torch.parallel import mesh as tmesh
from dbg_assembly_tpu_torch.scaffold import index as tix
from dbg_assembly_tpu_torch.scaffold import sharded as tmsh
from test_mesh_assemble import _build_table
from test_torch_correct import OUTS, _case, _params, _same
from test_torch_mesh import two_torch_threads  # noqa: F401 (autouse)
from torch_port_data import write_lib

CONTIG_SUFFIXES = (".contig.kmer.freq", ".contig.tip.fa",
                   ".contig.lowedge.fa", ".contig.bubble.fa",
                   ".contig.seq.fa", ".contig.seq.depth",
                   ".contig.small.fa", ".contig.small.depth")


def _read(path: str) -> bytes:
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def _files(prefix: str, suffixes) -> dict:
    return {s: _read(prefix + s) for s in suffixes}


# ------------------------------------------------------------ contig stage
@pytest.fixture(scope="module")
def tables():
    """test_mesh_assemble's table (20 kb at 1 % errors, k = 21: tips and
    bubbles), built by JAX and handed to the port as numpy."""
    jt, k = _build_table()
    tt = NodeTable.from_numpy(jt.kmers, jt.lcnt, jt.rcnt, jt.first_idx,
                              jt.counts, jt.total_kmers, jt.total_reads)
    return jt, tt, k


def _flags(k):
    return dict(ksize=k, init_hash_size=0.001, contig_len_cutoff=125)


def test_mesh_graph_search_and_resolve(tables):
    jt, tt, k = tables
    g = tma.MeshGraph(tt, TParams(**_flags(k)), tmesh.data_mesh(4, "cpu"))
    jg = jma.MeshGraph(jt, JParams(**_flags(k)), jmesh.data_mesh(4))
    rng = np.random.default_rng(0)
    q = np.concatenate([g.kmers[rng.integers(0, g.M, 257)],
                        rng.integers(0, 1 << (2 * k), 131).astype(np.uint64)])
    idx = np.minimum(np.searchsorted(g.kmers, q), g.M - 1)
    want = np.where(g.kmers[idx] == q, idx, -1)
    np.testing.assert_array_equal(g._search(q), want)
    np.testing.assert_array_equal(jg._search(q), want)
    assert (want >= 0).sum() == 257 and len(g._search(q[:0])) == 0
    # a random functional graph with stops and a planted cycle
    n = 1001
    succ = rng.integers(0, n + 1, n).astype(np.int64)
    succ[10:13] = [11, 12, 10]
    e1, d1, c1 = (t.numpy() for t in tpd._resolve_chains(
        torch.from_numpy(succ)))
    for e2, d2, c2 in (g.resolve_chains(succ), jg.resolve_chains(succ)):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(e1[~c1], e2[~c1])
        np.testing.assert_array_equal(d1[~c1], d2[~c1])
    assert c1[10:13].all() and (~c1).sum() > 100


@pytest.mark.parametrize("n_dev", [4, 8])
def test_assemble_doubling_mesh(tables, tmp_path, n_dev):
    """The eight files equal the port's single-device doubling readout's
    and JAX's mesh files; the link pass's histogram (the .kmer.freq)
    included, with ragged slots and no pad rows."""
    jt, tt, k = tables
    pre = {n: str(tmp_path / n) for n in ("single", "mesh", "jax")}
    s1 = tpd.assemble_doubling(tt, TParams(**_flags(k)), pre["single"],
                               device="cpu")
    s2 = tma.assemble_doubling_mesh(tt, TParams(**_flags(k)), pre["mesh"],
                                    tmesh.data_mesh(n_dev, "cpu"))
    s3 = jma.assemble_doubling_mesh(jt, JParams(**_flags(k)), pre["jax"],
                                    jmesh.data_mesh(n_dev))
    assert vars(s1) == vars(s2) == vars(s3)
    assert s1.tips_removed > 0 and s1.contig_num > 0
    want = _files(pre["single"], CONTIG_SUFFIXES)
    assert _files(pre["mesh"], CONTIG_SUFFIXES) == want
    assert _files(pre["jax"], CONTIG_SUFFIXES) == want


# ------------------------------------------------------------ correction
def test_probe_collective_and_stage_a_sharded():
    a, c, lens, bm, k = _case(2, 12, 0.0, n_reads=150, ragged=True)
    tm, jm = tmesh.data_mesh(4, "cpu"), jmesh.data_mesh(4)
    shards = tsh.shard_bitmap(tm, bm)
    assert len(shards) == 4 and shards[0].dtype == torch.int32
    rng = np.random.default_rng(6)
    idx = [torch.from_numpy(rng.integers(0, 4 ** k, n)) for n in
           (100, 37, 0, 64)]
    for got, i in zip(tsh.probe_collective(tm, shards, idx), idx):
        np.testing.assert_array_equal(got.numpy(),
                                      jkc.bitmap_get(bm, i.numpy()) == 1)
    p = _params(k)[0].resolved()
    kw = dict(k=k, m=p.high_freq_reg_len, max_change=p.max_change)
    want = jsh.stage_a_sharded(jm, a, c, lens, jsh.shard_bitmap(jm, bm),
                               **kw)
    got = tsh.stage_a_sharded(tm, a, c, lens, shards, **kw)
    single = tdev._stage_a(*(torch.from_numpy(x) for x in (a, c, lens)),
                           tdev.bitmap_device(bm, "cpu"), **kw)
    _same(want, got, range(6))
    _same(got, single, range(6))


@pytest.mark.parametrize("seed,n_err,dens", [(1, 10, 0.1), (3, 4, 0.0)])
def test_correct_batch_sharded(seed, n_err, dens):
    """The seven outputs, fallback flags included, against JAX's sharded
    corrector (its slots' beam loops in lockstep) and the port's
    single-device engine (each slot's loops stop on their own here)."""
    a, c, lens, bm, k = _case(seed, n_err, dens, n_reads=150, ragged=True)
    jp, tp = _params(k)
    tm, jm = tmesh.data_mesh(4, "cpu"), jmesh.data_mesh(4)
    want = jsh.correct_batch_sharded(jm, a.copy(), c, lens,
                                     jsh.shard_bitmap(jm, bm), jp)
    tdev.reset_counts()
    got = tsh.correct_batch_sharded(tm, a.copy(), c, lens,
                                    tsh.shard_bitmap(tm, bm), tp)
    assert tdev.counts["batches"] == 4
    single = tdev.correct_batch_device(a.copy(), c, lens,
                                       tdev.bitmap_device(bm, "cpu"), tp)
    _same(want, got, OUTS)
    _same(single, got, OUTS)
    assert got[6].any() == bool(dens)
    assert (got[0] + got[1]).sum() > 0


# ------------------------------------------------------------ mapping
def test_map_reads_sharded():
    """test_mesh_map's case (20 kb, 203 reads of 120 bp, half reverse
    complemented, 1 % errors): JAX's array-backed mapper, its mesh mapper
    and the port's single-device mapper."""
    rng = np.random.default_rng(4)
    k, S, glen, n, L = 21, 3, 20_000, 203, 120
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    ctgs = [np.frombuffer(b"ACGT", np.uint8)[genome[o:o + 4000]].tobytes()
            for o in range(0, glen - 4000, 4000)]
    codes = np.stack([genome[s:s + L]
                      for s in rng.integers(0, glen - L, n)])
    errs = rng.random(codes.shape) < 0.01
    codes = np.where(errs, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.uint8)
    codes[::2] = 3 - codes[::2, ::-1]
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    lengths = np.full(n, L, np.int32)
    jx = jix._build_py(ctgs, k)
    want = jix._map_reads_jax(jx, codes, ascii_seq, lengths, S, 0.95)
    jmulti = jmsh.map_reads_sharded(jmesh.data_mesh(4), jx, codes,
                                    ascii_seq, lengths, S, 0.95)
    tx = tix.build(ctgs, k, device="cpu")
    tm = tmesh.data_mesh(4, "cpu")
    single = tix.map_reads(tx, codes, ascii_seq, lengths, S, 0.95)
    got = tmsh.map_reads_sharded(tm, tmsh.replicate(tm, tx), codes,
                                 ascii_seq, lengths, S, 0.95)
    for f in ("mapped", "contig", "read_start", "read_end", "contig_start",
              "contig_end", "direct", "identity"):
        for other in (want, jmulti, single):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(other, f), err_msg=f)
    assert got.mapped.sum() > n // 2
    with pytest.raises(ValueError, match="torch engine"):
        tmsh.map_reads_sharded(tm, tix.build(ctgs, k, engine="native"),
                               codes, ascii_seq, lengths, S, 0.95)


# ------------------------------------------------------------ commands
@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """A 40 kb library at 8x with 2 % errors at the 3' end (pruning has
    work, contigs are fragmented)."""
    d = tmp_path_factory.mktemp("mesh_lib")
    return str(d), write_lib(str(d), genome_len=40_000, read_len=100,
                             insert=300, depth=8.0, seed=5, err_end=0.02)


def _mirror(lib: str, where: str) -> str:
    """A .lib of symlinks in ``where``: each run writes beside its own."""
    os.makedirs(where)
    links = []
    for p in [ln.strip() for ln in open(lib) if ln.strip()]:
        links.append(os.path.join(where, os.path.basename(p)))
        os.symlink(p, links[-1])
    out = os.path.join(where, "reads.lib")
    with open(out, "w") as f:
        f.write("".join(p + "\n" for p in links))
    return out


def test_cli_debruijn_contig_mesh(library, tmp_path):
    """``debruijn_contig --mesh 4 --device cpu``: the port's files equal
    its single-device --readout doubling run's and JAX's --mesh 4 run's."""
    _, lib = library
    base = ["debruijn_contig", "-k", "31", "-i", "0.01", "-M", "100"]
    runs = {"mesh": (tcli.main, ["--mesh", "4", "--device", "cpu"]),
            "single": (tcli.main, ["--readout", "doubling", "--device",
                                   "cpu"]),
            "jax": (jcli.main, ["--mesh", "4"])}
    out = {}
    for name, (main, extra) in runs.items():
        pre = str(tmp_path / name)
        main(base + ["-o", pre, *extra, lib])
        out[name] = _files(pre, CONTIG_SUFFIXES)
    assert out["mesh"] == out["single"] == out["jax"]
    assert out["mesh"][".contig.tip.fa"]


def test_cli_correct_error_reads_mesh(library, tmp_path):
    """``correct_error_reads -k 13 -j 1 --mesh 4 --device cpu`` against
    the port's single-device torch engine and JAX's --mesh 4, every file
    (.gz decompressed)."""
    _, lib = library
    from dbg_assembly_tpu.kmer import kmerfreq as jkf
    libs = {n: _mirror(lib, str(tmp_path / n))
            for n in ("mesh", "single", "jax")}
    jkf.run(libs["jax"], ksize=13, low_freq_cutoff=1)
    for n in ("mesh", "single"):
        for suf in (".kmer.freq.cz", ".kmer.freq.cz.len"):
            shutil.copy(libs["jax"] + suf, libs[n] + suf)
    argv = ["correct_error_reads", "-k", "13", "-r", "60", "-j", "1"]
    for name, main, extra in (
            ("mesh", tcli.main, ["--mesh", "4", "--device", "cpu"]),
            ("single", tcli.main, ["--device", "cpu"]),
            ("jax", jcli.main, ["--mesh", "4"])):
        main(argv + extra + [libs[name] + ".kmer.freq.cz", libs[name]])
    sufs = (".correct.fa.gz", ".correct.stat", ".correct.fa.gz.pair.fa.gz",
            ".correct.fa.gz.single.fa.gz", ".correct.fa.gz.pair.single.stat")
    out = {}
    for name, lb in libs.items():
        first = [ln.strip() for ln in open(lb)][0]
        out[name] = _files(first, sufs)
    assert out["mesh"] == out["single"] == out["jax"]
    assert b"ModifiedBaseNum: 1" in out["mesh"][".correct.fa.gz"]


def test_cli_map_pair_mesh(library, tmp_path):
    """``map_pair --mesh 4 --device cpu`` on the port's contigs against
    the single-device torch engine and JAX's --mesh 4: every map file and
    the .2ctg.lib list."""
    d, lib = library
    pre = str(tmp_path / "asm")
    tcli.main(["debruijn_contig", "-k", "31", "-i", "0.01", "-M", "100",
               "-o", pre, "--device", "cpu", lib])
    contigs = pre + ".contig.seq.fa"
    argv = ["map_pair", "-k", "25", "-s", "5", "-l", "100", "-r", "100",
            "-i", "0.95"]
    out = {}
    for name, main, extra in (
            ("mesh", tcli.main, ["--mesh", "4", "--device", "cpu"]),
            ("single", tcli.main, ["--device", "cpu"]),
            ("jax", jcli.main, ["--mesh", "4"])):
        mlib = _mirror(lib, str(tmp_path / name))
        mdir = str(tmp_path / name / "out")
        main(argv + extra + ["-o", mdir, contigs, mlib])
        base = os.path.basename([ln.strip() for ln in open(mlib)][0])
        out[name] = _files(os.path.join(mdir, base),
                           (".map_pair.2ctg.gz", ".map_pair.1ctg.gz",
                            ".map_pair.gap.gz", ".map_pair.stat"))
        out[name]["lib"] = _read(mlib + ".map_pair.2ctg.lib").replace(
            str(tmp_path / name).encode(), b"<d>")
    assert out["mesh"] == out["single"] == out["jax"]
    assert out["mesh"][".map_pair.2ctg.gz"].count(b"\n") > 50


def test_run_full_mesh(tmp_path):
    """run_full with mesh_devices=4 (correction and the contig stage on 4
    slots) against JAX's, every file under the work dirs (.gz
    decompressed, each dir's path replaced).  A 30 kb two-library
    dataset."""
    from dbg_assembly_tpu import workflow as jwf
    from test_torch_workflow import CFG, _dataset, _same_tree
    libs = _dataset(tmp_path / "sim", 30_000)
    jw, tw = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jwf.run_full(libs, jwf.PipelineConfig(mesh_devices=4, **CFG), jw)
    got = twf.run_full(libs, twf.PipelineConfig(mesh_devices=4, device="cpu",
                                                **CFG), tw)
    assert got == {k: v.replace(jw, tw) for k, v in want.items()}
    assert _same_tree(tw, jw) > 50
    with open(got["contigs"]) as f:
        assert f.read().count(">") > 0
