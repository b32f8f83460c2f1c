"""The port's host twins against the JAX package, exactly (tolerance 0):
the 8-bit k-mer table (kmerfreq table_format "8bit", write_cz_bytes, and
correct_error on the port's own table), the Python assembler
(DBG_PY_ASSEMBLE), the numpy contig index and mapper (DBG_PY_MAP), the
Python FASTQ parser (DBG_PY_FASTQ) and the doubling readout's
DBG_PD_PROFILE step lines; the native bindings the JAX loader has; the
port's torch ingest against the JAX package's native ingest on the CPU.
Each twin also equals the port's default engine.  Every flag is set
through monkeypatch, so none leaks into another test."""

import gzip
import io
import os
import re

import numpy as np
import pytest

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu import dna as jdna
from dbg_assembly_tpu.contig import pipeline as jpipe
from dbg_assembly_tpu.contig import pointer_doubling as jpd
from dbg_assembly_tpu.contig.graph import GraphBuilder as JBuilder
from dbg_assembly_tpu.contig.refassemble import AssembleParams as JParams
from dbg_assembly_tpu.contig.refassemble import RefAssembler as JAssembler
from dbg_assembly_tpu.correct import pipeline as jcorrect
from dbg_assembly_tpu.io import cz as jcz
from dbg_assembly_tpu.io import fastq as jfq
from dbg_assembly_tpu.kmer import kmerfreq as jkf
from dbg_assembly_tpu.kmer.count import KmerCounter as JCounter
from dbg_assembly_tpu.scaffold import index as jix
from dbg_assembly_tpu.scaffold import map_pair as jmp
from dbg_assembly_tpu.scaffold import map_reads as jmr
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch.contig import pipeline as tpipe
from dbg_assembly_tpu_torch.contig import pointer_doubling as tpd
from dbg_assembly_tpu_torch.contig.graph import GraphBuilder as TBuilder
from dbg_assembly_tpu_torch.contig.graph import NodeTable
from dbg_assembly_tpu_torch.contig.refassemble import (
    AssembleParams as TParams, RefAssembler as TAssembler)
from dbg_assembly_tpu_torch.io import cz as tcz
from dbg_assembly_tpu_torch.io import fastq as tfq
from dbg_assembly_tpu_torch.kmer import kmerfreq as tkf
from dbg_assembly_tpu_torch.kmer.count import KmerCounter as TCounter
from dbg_assembly_tpu_torch.scaffold import index as tix
from dbg_assembly_tpu_torch.scaffold import map_pair as tmp_
from dbg_assembly_tpu_torch.scaffold import map_reads as tmr
from torch_port_data import write_fastq, write_lib
from tools.simulate_reads import make_genome, simulate_pe

CONTIG_SUFFIXES = (".contig.kmer.freq", ".contig.tip.fa",
                   ".contig.lowedge.fa", ".contig.bubble.fa",
                   ".contig.seq.fa", ".contig.seq.depth",
                   ".contig.small.fa", ".contig.small.depth")
FLAGS = ("DBG_PY_ASSEMBLE", "DBG_PY_MAP", "DBG_PY_FASTQ", "DBG_PD_PROFILE",
         "DBG_JAX_MAP", "DBG_PY_INGEST")


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for f in FLAGS:
        monkeypatch.delenv(f, raising=False)


def _read(path) -> bytes:
    with (gzip.open(path, "rb") if str(path).endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def _files(prefix: str, suffixes=CONTIG_SUFFIXES) -> dict:
    return {s: _read(prefix + s) for s in suffixes}


# ------------------------------------------------------------ 8-bit table
def test_write_cz_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    # two 8 MiB source blocks and a short third one
    freqs = np.zeros(2 * tcz.SRC_BLOCK_KMERS + 12345, np.uint8)
    hot = rng.integers(0, len(freqs), 200_000)
    freqs[hot] = rng.integers(0, 256, len(hot))
    bits = np.packbits(rng.random(3 * tcz.SRC_BLOCK_KMERS) < 0.01)
    for level in (1, 6):
        for name, write, arr in (("b", "write_cz_bytes", freqs),
                                 ("1", "write_cz_bits", bits)):
            j, t = str(tmp_path / f"j{name}{level}.cz"), \
                str(tmp_path / f"t{name}{level}.cz")
            getattr(jcz, write)(j, arr, level)
            getattr(tcz, write)(t, arr, level=level)
            assert _read(j) == _read(t) and \
                _read(j + ".len") == _read(t + ".len"), (write, level)
    assert len(open(t + ".len").read().split()) == 3
    np.testing.assert_array_equal(
        tcz.read_cz_bytes(str(tmp_path / "tb1.cz"), 13)[:len(freqs)], freqs)


@pytest.fixture(scope="module")
def small_lib(tmp_path_factory):
    return write_lib(str(tmp_path_factory.mktemp("kf")), genome_len=8000,
                     read_len=100, depth=20.0, seed=11, err_end=0.03)


@pytest.mark.parametrize("k", [5, 11, 12, 13])
def test_kmerfreq_8bit_matches_jax(small_lib, tmp_path, k):
    """At k 5 most k-mers of the library count over 255: the cap."""
    j = jkf.run(small_lib, ksize=k, table_format="8bit",
                out_prefix=str(tmp_path / "jax"))
    t = tkf.run(small_lib, ksize=k, table_format="8bit",
                out_prefix=str(tmp_path / "torch"), device="cpu")
    assert t["bitmap"] is None and j["bitmap"] is None
    assert (t["species"], t["individuals"]) == (j["species"],
                                                j["individuals"])
    for suf in (".cz", ".cz.len", ".stat"):
        assert _read(str(tmp_path / "jax") + suf) == \
            _read(str(tmp_path / "torch") + suf), suf
    # the 8-bit table's > 1 bits, packed, are the 1-bit table's
    freqs = tcz.read_cz_bytes(t["cz"], k)
    one = tkf.run(small_lib, ksize=k, out_prefix=str(tmp_path / "one"),
                  device="cpu")
    np.testing.assert_array_equal(np.packbits(freqs > 1), one["bitmap"])
    counter = TCounter(k, device="cpu")
    for path in tpipe.read_file_list(small_lib):
        b = tfq.read_batch(path)
        counter.add(b.codes, b.lengths)
    u, c, _ = counter.finalize()
    np.testing.assert_array_equal(freqs[u.astype(np.int64)],
                                  np.minimum(c, 255))
    assert np.count_nonzero(freqs) == len(u)
    assert ((c > 255).sum() > len(c) // 2) == (k == 5)
    with pytest.raises(ValueError, match="table_format"):
        tkf.run(small_lib, ksize=k, table_format="4bit", device="cpu")


def test_correct_error_on_own_table(tmp_path):
    """correct_error (8-bit) on the port's own table through the port's
    CLI == the JAX package's run_8bit on JAX's table."""
    k = 13
    libs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        libs[name] = write_lib(str(d), genome_len=6000, read_len=100,
                               depth=12.0, seed=5, err_end=0.03)
    jkf.run(libs["jax"], ksize=k, table_format="8bit")
    tkf.run(libs["torch"], ksize=k, table_format="8bit", device="cpu")
    assert _read(libs["torch"] + ".kmer.freq.cz") == \
        _read(libs["jax"] + ".kmer.freq.cz")
    jcorrect.run_8bit(libs["jax"] + ".kmer.freq.cz", libs["jax"], ksize=k,
                      low_freq_cutoff=3)
    tcli.main(["correct_error", "-k", str(k), "-l", "3",
               libs["torch"] + ".kmer.freq.cz", libs["torch"]])
    sufs = (".cor", ".cor.stat", ".cor.pair.fa.gz", ".cor.single.fa.gz",
            ".cor.pair.single.stat")
    got = {}
    for name, lib in libs.items():
        files = [ln.strip() for ln in open(lib) if ln.strip()]
        got[name] = {os.path.basename(f) + s: gzip.open(f + s).read()
                     if s.endswith((".gz", ".cor")) else _read(f + s)
                     for f in files for s in sufs
                     if os.path.exists(f + s)}
    assert len(got["jax"]) == 7 and got["torch"] == got["jax"]


# -------------------------------------------------------------- assembler
def _diploid_reads(genome_len: int = 20_000):
    """Two haplotypes (a SNP every 600 bases) at 20x each, 0.4-1 % errors:
    tips, low-coverage edges and heterozygous bubbles."""
    rng = np.random.default_rng(9)
    g1 = np.asarray(make_genome(genome_len, seed=8, repeat_frac=0.02))
    g2 = g1.copy()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for p in range(300, len(g2) - 300, 600):
        cur = int(np.flatnonzero(acgt == g2[p])[0])
        g2[p] = acgt[(cur + 1 + int(rng.integers(3))) % 4]
    out = []
    for i, g in enumerate((g1, g2)):
        out.append(simulate_pe(g, 100, 300, 20.0, seed=30 + i,
                               err_start=0.004, err_end=0.01))
    return out


@pytest.fixture(scope="module")
def diploid_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("diploid")
    paths = []
    for mate in (1, 2):
        paths.append(str(d / f"dip_{mate}.fq"))
        with open(paths[-1], "wb"):
            pass
    for i, (r1, q1, r2, q2) in enumerate(_diploid_reads()):
        for mate, (r, q) in enumerate(((r1, q1), (r2, q2))):
            part = str(d / f"part{i}_{mate}.fq")
            write_fastq(part, f"h{i}", r, q, mate + 1)
            with open(paths[mate], "ab") as f:
                f.write(_read(part))
    lib = str(d / "dip.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return lib


@pytest.fixture(scope="module")
def diploid_table(diploid_lib):
    """The JAX package's node table of the library (k 21) and the port's
    NodeTable of the same arrays."""
    gb = JBuilder(21, 250)
    for path in jpipe.read_file_list(diploid_lib):
        b = jfq.read_batch(path)
        gb.add(b.codes, b.lengths)
    jt = gb.finalize()
    return jt, NodeTable.from_numpy(jt.kmers, jt.lcnt, jt.rcnt, jt.first_idx,
                                    jt.counts, jt.total_kmers,
                                    jt.total_reads)


@pytest.mark.parametrize("tip,lowedge,bubble", [
    (True, True, True), (False, True, True), (True, False, True),
    (True, True, False), (False, False, False)])
def test_python_assembler_matches_jax(diploid_table, tmp_path, monkeypatch,
                                      tip, lowedge, bubble):
    jt, tt = diploid_table
    flags = dict(ksize=21, init_hash_size=0.001, contig_len_cutoff=100,
                 is_remove_tip=tip, is_remove_lowedge=lowedge,
                 is_remove_bubble=bubble)
    runs = {"jax": lambda p: JAssembler(jt, JParams(**flags)).run_python(p),
            "python": lambda p: TAssembler(tt, TParams(**flags)).run(p),
            "native": lambda p: TAssembler(tt, TParams(**flags)).run(p)}
    out = {}
    for name, run in runs.items():
        prefix = str(tmp_path / name)
        for suf in CONTIG_SUFFIXES:     # a pass turned off writes no file
            open(prefix + suf, "w").close()
        with monkeypatch.context() as m:
            if name == "python":
                m.setenv("DBG_PY_ASSEMBLE", "1")
            out[name] = (vars(run(prefix)), _files(prefix))
    assert out["python"] == out["jax"]
    assert out["native"] == out["python"]
    st = out["python"][0]
    assert st["contig_num"] > 0
    assert (st["tips_removed"] > 0) == tip
    assert (st["lowedges_removed"] > 0) == lowedge
    assert (st["bubbles_removed"] > 0) == bubble


def test_python_assembler_methods(diploid_table):
    """The walks and helpers one by one, against JAX's on the same table."""
    jt, tt = diploid_table
    ja = JAssembler(jt, JParams(ksize=21, init_hash_size=0.001))
    ta = TAssembler(tt, TParams(ksize=21, init_hash_size=0.001))
    ja.calculate_kmer_links()
    ta.calculate_kmer_links()
    for f in ("l_num", "r_num", "l_base", "r_base", "linear", "deleted",
              "tip_nodes", "branch_nodes", "depth_stat"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), f)
    for idx in ta.tip_nodes[:20].tolist():
        walk = -1 if ta.l_num[idx] == 1 else 1
        assert ta.get_linear_path(idx, walk, 100) == \
            ja.get_linear_path(idx, walk, 100)
    for idx in ta.branch_nodes[:20].tolist():
        assert ta._branch_bases(ta.lcnt[idx]) == \
            ja._branch_bases(ja.lcnt[idx])
        ta.recalculate_kmer_links(idx)
        ja.recalculate_kmer_links(idx)
        assert (ta.l_num[idx], ta.r_num[idx], ta.linear[idx]) == \
            (ja.l_num[idx], ja.r_num[idx], ja.linear[idx])
    for km in jt.kmers[:50].tolist():
        assert ta.exist(km) == ja.exist(km)
    assert ta.exist(12345678901) == ta.SENT_ID
    lin = np.flatnonzero(ta.linear[:ta.n_nodes])[:10].tolist()
    for i in lin:
        assert ta.get_linear_seq(i, 1) == ja.get_linear_seq(i, 1)
    from dbg_assembly_tpu.contig import refassemble as jra
    from dbg_assembly_tpu_torch.contig import refassemble as tra
    rng = np.random.default_rng(1)
    for km in rng.integers(0, 1 << 42, 20).tolist():
        assert tra.revcomp_int(km, 21) == jra.revcomp_int(km, 21)
        assert tra.bit2seq(km, 21) == jra.bit2seq(km, 21)


def _normalize(log: str, prefix: str) -> str:
    return re.sub(r"(Run time: )[0-9.e+-]+", r"\1X",
                  log.replace(prefix, "PREFIX"))


@pytest.mark.parametrize("init,doublings", [(0.01, 10), (2e-5, 10),
                                            (2e-5, 1)])
def test_py_assemble_pipeline_matches_jax(diploid_lib, tmp_path, monkeypatch,
                                          init, doublings):
    """DBG_PY_ASSEMBLE=1 through both packages' pipeline.run, within and
    over the initial hash capacity (an enlargement schedule; -e 1: the
    degrade re-pass): files, stats and run log; then the port's native
    engine on the same run."""
    k = 31
    kw = dict(ksize=k, log_buffer=100, log_doublings=doublings)
    logs, stats = {}, {}
    monkeypatch.setenv("DBG_PY_ASSEMBLE", "1")
    for name, run, P, extra in (("jax", jpipe.run, JParams, {}),
                                ("python", tpipe.run, TParams,
                                 {"device": "cpu"})):
        log = io.StringIO()
        stats[name] = vars(run(diploid_lib, str(tmp_path / name),
                               params=P(ksize=k, init_hash_size=init),
                               log_stream=log, **kw, **extra))
        logs[name] = _normalize(log.getvalue(), str(tmp_path / name))
    monkeypatch.delenv("DBG_PY_ASSEMBLE")
    log = io.StringIO()
    stats["native"] = vars(tpipe.run(
        diploid_lib, str(tmp_path / "native"),
        params=TParams(ksize=k, init_hash_size=init), log_stream=log,
        device="cpu", **kw))
    logs["native"] = _normalize(log.getvalue(), str(tmp_path / "native"))
    want = _files(str(tmp_path / "jax"))
    for name in ("python", "native"):
        assert stats[name] == stats["jax"], name
        assert logs[name] == logs["jax"], name
        assert _files(str(tmp_path / name)) == want, name
    assert stats["jax"]["contig_num"] > 0
    if init < 0.01:
        assert "nlarge" in logs["jax"]
    if doublings == 1:
        assert "Alert" in logs["jax"]


def test_cli_py_assemble(diploid_lib, tmp_path, monkeypatch, capsys):
    """DBG_PY_ASSEMBLE=1 debruijn_contig through both CLIs: files and run
    log."""
    monkeypatch.setenv("DBG_PY_ASSEMBLE", "1")
    argv = ["debruijn_contig", "-k", "25", "-i", "0.01", "-M", "100"]
    jcli.main(argv + ["-o", str(tmp_path / "jax"), diploid_lib])
    jlog = capsys.readouterr().err
    assert tcli.main(argv + ["-o", str(tmp_path / "torch"), "--device",
                             "cpu", diploid_lib]) == 0
    tlog = capsys.readouterr().err
    assert _files(str(tmp_path / "torch")) == _files(str(tmp_path / "jax"))
    assert _normalize(tlog, str(tmp_path / "torch")) == \
        _normalize(jlog, str(tmp_path / "jax"))
    assert "Run time" in tlog


def test_pd_profile_lines(diploid_table, tmp_path, monkeypatch, capsys):
    """DBG_PD_PROFILE prints one [pd] line a stage step and one [ro] line a
    readout step, as JAX's; the port's device step succ_resolve stands for
    JAX's host succ_build + resolve_chains."""
    jt, tt = diploid_table
    flags = dict(ksize=21, init_hash_size=0.001, contig_len_cutoff=100)
    tpd.assemble_doubling(tt, TParams(**flags), str(tmp_path / "q"),
                          device="cpu")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("DBG_PD_PROFILE", "1")
    jpd.assemble_doubling(jt, JParams(**flags), str(tmp_path / "jax"))
    jout = capsys.readouterr().out
    tpd.assemble_doubling(tt, TParams(**flags), str(tmp_path / "torch"),
                          device="cpu")
    tout = capsys.readouterr().out
    assert _files(str(tmp_path / "torch")) == _files(str(tmp_path / "q"))
    pat = re.compile(r"^( +\[(?:pd|ro)\] \S+(?: \S+)?) +\d+\.\d\ds$")

    def steps(out):
        lines = out.rstrip("\n").split("\n")
        assert all(pat.match(ln) for ln in lines), lines
        return [pat.match(ln).group(1).rstrip() for ln in lines]

    js = [s for s in steps(jout) if not s.endswith("resolve_chains")]
    js = [s.replace("succ_build", "succ_resolve") for s in js]
    assert steps(tout) == js
    assert "  [pd] readout" in js and "    [ro] write files" in js


# ------------------------------------------------------- index and mapper
def _bases(rng, n: int) -> bytes:
    return bytes(bytearray(b"ACGT"[c] for c in rng.integers(0, 4, n)))


def _contigs(seed: int = 9) -> list:
    """Contigs with N runs (upper and lower case), a segment repeated in
    two contigs, an empty slot, one shorter than k, and a block between N
    runs shorter than k."""
    rng = np.random.default_rng(seed)
    rep = _bases(rng, 60)
    return [_bases(rng, 400),
            _bases(rng, 100) + b"NNNN" + _bases(rng, 200) + rep,
            b"", _bases(rng, 12),
            _bases(rng, 150) + rep + b"n" + _bases(rng, 5) + b"N"
            + _bases(rng, 80),
            b"NNN" + _bases(rng, 300) + b"NN"]


def _ix_arrays(ix) -> dict:
    return {f: getattr(ix, f) for f in ("kmers", "ids", "pos", "direct",
                                        "uniq", "concat", "offsets",
                                        "lengths")}


@pytest.mark.parametrize("contigs", ["mixed", [], [b""], [b"ACGT"],
                                     [b"ACGTACGTACGTACGTACGTAC"]])
@pytest.mark.parametrize("k", [13, 17])
def test_python_index_matches_jax(monkeypatch, contigs, k):
    contigs = _contigs() if contigs == "mixed" else contigs
    want = _ix_arrays(jix._build_py(contigs, k))
    monkeypatch.setenv("DBG_PY_MAP", "1")
    for engine in ("torch", "native"):
        ix = tix.build(contigs, k, engine=engine, device="cpu")
        assert ix.engine == "python" and ix.native is None
        got = _ix_arrays(ix)
        for name in want:
            assert isinstance(got[name], np.ndarray), name
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], name)


def _reads(contigs, seed: int, n: int = 300, L: int = 100):
    """Reads of the contigs with 0-2 substitutions, half reverse-
    complemented, ragged (some shorter than k + S), an N in a few."""
    rng = np.random.default_rng(seed)
    src = [c for c in contigs if len(c) > L]
    reads = []
    for _ in range(n):
        c = src[rng.integers(0, len(src))]
        s = rng.integers(0, len(c) - L)
        r = bytearray(c[s:s + L])
        for _ in range(rng.integers(0, 3)):
            r[rng.integers(0, L)] = ord("ACGT"[rng.integers(0, 4)])
        if rng.integers(0, 20) == 0:
            r[rng.integers(0, L)] = ord("N")
        if rng.integers(0, 2):
            r = r[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))
        reads.append(bytes(r))
    ascii_seq = np.frombuffer(b"".join(reads), np.uint8).reshape(n, L).copy()
    lengths = rng.integers(20, L + 1, n).astype(np.int32)
    lengths[: n // 4] = L
    ascii_seq[np.arange(L)[None, :] >= lengths[:, None]] = 0
    codes = jdna.ascii_to_codes(ascii_seq)
    codes[ascii_seq == 0] = 4
    return codes, ascii_seq, lengths


MAP_FIELDS = ("mapped", "contig", "read_start", "read_end", "contig_start",
              "contig_end", "direct", "identity")


@pytest.mark.parametrize("k,S,per_read_start", [(17, 5, False),
                                                (17, 10, True),
                                                (25, 5, True)])
def test_python_mapper_matches_jax(monkeypatch, k, S, per_read_start):
    contigs = _contigs()
    codes, ascii_seq, lengths = _reads(contigs, seed=k + S)
    ss = (np.random.default_rng(1).integers(1, 40, len(codes))
          if per_read_start else 1)
    torch_path = tix.map_reads(tix.build(contigs, k, device="cpu"), codes,
                               ascii_seq, lengths, S, 0.95, ss)
    monkeypatch.setenv("DBG_PY_MAP", "1")
    ix = tix.build(contigs, k, device="cpu")
    got = tix.map_reads(ix, codes, ascii_seq, lengths, S, 0.95, ss)
    jix_ = jix.build(contigs, k)
    want = jix.map_reads(jix_, codes, ascii_seq, lengths, S, 0.95, ss)
    for name in MAP_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)
        m = want.mapped
        np.testing.assert_array_equal(getattr(torch_path, name)[m], g[m],
                                      name)
    np.testing.assert_array_equal(torch_path.mapped, want.mapped)
    assert 0 < got.mapped.sum() < len(codes)
    probe = np.concatenate([ix.kmers[::3], np.random.default_rng(3).integers(
        0, 1 << 34, 100).astype(np.uint64)])
    for g, w in zip(tix.lookup(ix, probe), jix.lookup(jix_, probe)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    """A 30 kb library at 8x with 2 % errors at the 3' end and its contigs
    from the port's debruijn_contig; returns (lib, contig .fa)."""
    d = tmp_path_factory.mktemp("hostmap")
    lib = write_lib(str(d), genome_len=30_000, read_len=100, insert=300,
                    depth=8.0, seed=5, err_end=0.02)
    prefix = str(d / "asm")
    tpipe.run(lib, prefix, ksize=31,
              params=TParams(ksize=31, init_hash_size=0.01,
                             contig_len_cutoff=100),
              device="cpu")
    return lib, prefix + ".contig.seq.fa"


MAP_ARGS = dict(ksize=25, seed_kmer_num=5, min_ctg_len=100, min_read_len=100,
                min_identity=0.95)


@pytest.mark.parametrize("command", ["map_pair", "map_reads"])
def test_py_map_files_match_jax(assembly, tmp_path, monkeypatch, command):
    """map_pair and map_reads under DBG_PY_MAP=1 in both packages: every
    file, and the port's default torch engine's files too."""
    lib, contigs = assembly
    files = [ln.strip() for ln in open(lib) if ln.strip()]
    runs = {"map_pair": (jmp.run, tmp_.run, (".map_pair.2ctg.gz",
                                              ".map_pair.1ctg.gz",
                                              ".map_pair.gap.gz",
                                              ".map_pair.stat"),
                         files[:1]),
            "map_reads": (jmr.run, tmr.run, (".map_reads.2ctg.gz",
                                              ".map_reads.1ctg.gz",
                                              ".map_reads.2ctg.gz.reads.fa.gz",
                                              ".map_reads.stat"), files)}
    jrun, trun, sufs, outs = runs[command]
    monkeypatch.setenv("DBG_PY_MAP", "1")
    jrun(contigs, lib, str(tmp_path / "jax"), **MAP_ARGS)
    tc = trun(contigs, lib, str(tmp_path / "python"), device="cpu",
              **MAP_ARGS)
    monkeypatch.delenv("DBG_PY_MAP")
    dc = trun(contigs, lib, str(tmp_path / "torch"), device="cpu",
              **MAP_ARGS)
    assert tc == dc
    for f in outs:
        base = os.path.basename(f)
        for suf in sufs:
            want = _read(tmp_path / "jax" / (base + suf))
            assert _read(tmp_path / "python" / (base + suf)) == want, suf
            assert _read(tmp_path / "torch" / (base + suf)) == want, suf
    assert tc[0]["diff"] > 20


def test_py_map_mesh_replicates(assembly, tmp_path, monkeypatch):
    """map_pair --mesh 2 under DBG_PY_MAP=1 maps on the slots with the
    python engine's index copied to them, as JAX's mesh path maps with its
    array index: the files equal the single-device run's."""
    lib, contigs = assembly
    monkeypatch.setenv("DBG_PY_MAP", "1")
    tmp_.run(contigs, lib, str(tmp_path / "one"), device="cpu", **MAP_ARGS)
    tmp_.run(contigs, lib, str(tmp_path / "mesh"), device="cpu",
             mesh_devices=2, **MAP_ARGS)
    base = os.path.basename(open(lib).readline().strip())
    for suf in (".map_pair.2ctg.gz", ".map_pair.1ctg.gz",
                ".map_pair.gap.gz", ".map_pair.stat"):
        assert _read(tmp_path / "mesh" / (base + suf)) == \
            _read(tmp_path / "one" / (base + suf)), suf


# ------------------------------------------------------------ FASTQ parser
def _fastq_cases(tmp_path) -> dict:
    """name -> (path, read_batch kwargs)."""
    rng = np.random.default_rng(2)
    seqs = [_bases(rng, int(n)) for n in rng.integers(1, 60, 30)]
    seqs[3] = seqs[3][:5] + b"N" + seqs[3][6:]
    seqs[4] = b"nNACGTNN"
    fq = b"".join(b"@r%d/1\n%s\n+\n%s\n" % (i, s, bytes(
        rng.integers(35, 75, len(s)).astype(np.uint8)))
        for i, s in enumerate(seqs))
    fa = b"".join(b">r%d desc\n%s\n" % (i, s) for i, s in enumerate(seqs))
    raw = {"fastq": (fq, "x.fq"), "fasta": (fa, "x.fa"),
           "truncated": (fq + b"@cut\nACGT\n+\n", "t.fq"),
           "truncated_fa": (fa + b">cut\n", "t.fa"),
           "stray": (b"junk\n" + fq[:200] + b"\nstray line\n+\n" + fq[200:],
                     "s.fq"),
           "no_newline": (fq.rstrip(b"\n"), "n.fq"),
           "empty": (b"", "e.fq")}
    out = {}
    for name, (data, fname) in raw.items():
        p = str(tmp_path / fname)
        with open(p, "wb") as f:
            f.write(data)
        out[name] = p
    gz = str(tmp_path / "z.fq.gz")
    with gzip.open(gz, "wb") as f:
        f.write(fq)
    out["gz"] = gz
    return out


@pytest.mark.parametrize("kw", [{}, {"strict_n": True}, {"max_len": 17},
                                {"keep_ascii": True},
                                {"keep_heads": False}])
def test_python_parser_matches_jax(tmp_path, monkeypatch, kw):
    cases = _fastq_cases(tmp_path)
    kw = {"keep_heads": True, **kw}
    for name, path in cases.items():
        native = tfq.read_batch(path, **kw)
        monkeypatch.setenv("DBG_PY_FASTQ", "1")
        got = tfq.read_batch(path, **kw)
        want = jfq.read_batch(path, **kw)
        monkeypatch.delenv("DBG_PY_FASTQ")
        for b in (got, native):
            assert b.heads == want.heads, name
            assert b.n_reads == want.n_reads and b.n_bases == want.n_bases
            for f in ("codes", "quals", "lengths", "seqs_ascii"):
                g, w = getattr(b, f), getattr(want, f)
                if w is None:
                    assert g is None, (name, f)
                    continue
                assert g.dtype == w.dtype, (name, f)
                np.testing.assert_array_equal(g, w, f"{name} {f}")


# ---------------------------------------------------------- native ingest
def test_native_bindings_match_jax():
    """NativeIngest.n_nodes, reserve and extract, hash_layout and
    stdsort_perm_desc against the JAX package's bindings."""
    from dbg_assembly_tpu import native as jnat
    from dbg_assembly_tpu_torch import native as tnat
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 1 << 40, 3000).astype(np.uint64)
    for size in (3001, 7919):
        got, want = tnat.hash_layout(keys, size), jnat.hash_layout(keys, size)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[1] > 0
    lens = rng.integers(0, 40, 2000).astype(np.uint64)
    np.testing.assert_array_equal(tnat.stdsort_perm_desc(lens),
                                  jnat.stdsort_perm_desc(lens))
    t, j = tnat.NativeIngest(15), jnat.NativeIngest(15)
    t.reserve(50_000)
    j.reserve(50_000)
    for codes, lengths in _ragged_batches(7):
        for x in (t, j):
            x.add(codes, lengths, 11)
    assert t.n_nodes() == j.n_nodes() > 0
    for g, w in zip(t.extract(), j.extract()):
        np.testing.assert_array_equal(g, w)
    t.close()
    j.close()


@pytest.mark.parametrize("want_snapshots", [True, False])
def test_hash_layout_epochs_matches_jax(want_snapshots):
    """hash_layout_epochs over three epochs (two enlargements) == JAX's
    binding: the same slots and conflicts, and the snapshots, or None for
    both with want_snapshots=False."""
    from dbg_assembly_tpu import native as jnat
    from dbg_assembly_tpu_torch import native as tnat
    keys = np.random.default_rng(9).integers(0, 1 << 40, 3000).astype(
        np.uint64)
    sizes, ends = [1009, 4001, 8009], [800, 2000]
    got = tnat.hash_layout_epochs(keys, sizes, ends, want_snapshots)
    want = jnat.hash_layout_epochs(keys, sizes, ends, want_snapshots)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1] > 0
    if want_snapshots:
        assert got[2].shape == (3, 3000)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[2][-1], got[0])
    else:
        assert got[2] is None and want[2] is None
        np.testing.assert_array_equal(
            got[0], tnat.hash_layout_epochs(keys, sizes, ends)[0])


def _ragged_batches(seed: int):
    """Three 'files' of ragged reads, some shorter than k, one empty."""
    rng = np.random.default_rng(seed)
    g = make_genome(3000, seed=seed)
    out = []
    for n in (37, 0, 53):
        r1, _, _, _ = simulate_pe(g, 80, 200, 4.0, seed=seed + n,
                                  err_start=0.01, err_end=0.01)
        r1 = r1[:n]
        codes = jdna.ascii_to_codes(r1)
        lengths = rng.integers(5, 81, len(r1)).astype(np.int32)
        codes[np.arange(80)[None, :] >= lengths[:, None]] = 4
        out.append((codes, lengths))
    return out


@pytest.mark.parametrize("batch_reads", [7, 1000])
def test_graph_builder_matches_jax_native_ingest(batch_reads):
    """The port's torch ingest == the JAX package's builder on the CPU
    (native ingest there): several batches, new_file, reads shorter than
    k, stream_to_read."""
    k = 21
    builders = {"torch": TBuilder(k, 60, batch_reads=batch_reads,
                                  device="cpu"),
                "jax": JBuilder(k, 60, batch_reads=batch_reads)}
    for codes, lengths in _ragged_batches(3):
        for gb in builders.values():
            gb.new_file()
            gb.add(codes, lengths)
    t, want = (gb.finalize() for gb in builders.values())
    assert want.n_nodes > 0
    for f in ("kmers", "lcnt", "rcnt", "first_idx", "counts"):
        g, w = getattr(t, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, f)
    assert (t.total_kmers, t.total_reads) == (want.total_kmers,
                                              want.total_reads)
    gb, jb = builders["torch"], builders["jax"]
    assert (gb.file_starts, gb.read_seq, gb.stream_pos) == \
        (jb.file_starts, jb.read_seq, jb.stream_pos)
    np.testing.assert_array_equal(gb.stream_to_read(t.first_idx),
                                  jb.stream_to_read(want.first_idx))


@pytest.mark.parametrize("batch_reads", [7, 1000])
def test_kmer_counter_matches_jax_native_ingest(batch_reads):
    """The port's torch counter == the JAX package's counter on the CPU
    (native ingest there)."""
    counters = {"jax": JCounter(17, batch_reads=batch_reads),
                "torch": TCounter(17, batch_reads=batch_reads,
                                  device="cpu")}
    for codes, lengths in _ragged_batches(5):
        for c in counters.values():
            c.add(codes, lengths)
    wu, wc, wt = counters["jax"].finalize()
    assert len(wu) > 0
    u, c, t = counters["torch"].finalize()
    assert (u.dtype, c.dtype) == (wu.dtype, wc.dtype)
    np.testing.assert_array_equal(u, wu)
    np.testing.assert_array_equal(c, wc)
    assert t == wt
