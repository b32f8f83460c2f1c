"""map_reads, link_contig and link_supertig in the port
(dbg_assembly_tpu_torch.scaffold) against the JAX package, exactly: every
output file (.gz decompressed) and the counts, tolerance 0.

Long single reads are simulated as tests/test_golden_linkcontig.py does
(700 bp from 1500 bp fragments at 8x, 0.1-0.4 % errors, mate 1) from the
40 kb genome of tests/test_torch_scaffold.py, whose contigs come from the
port's own debruijn_contig.  map_reads runs on both of the port's engines
(torch on the CPU, native) against both of JAX's paths (its default and
DBG_JAX_MAP=1); a hand-built library holds every route of a read (two
contigs, one, none, the same contig twice, too short) in FASTQ and FASTA.
The LinkGraph parts only link_contig's family uses (the read-ends parser,
the strong interleaving pass, the small-node removal) are held to JAX's on
hand-built graphs, the cases of tests/test_strong_interleaving.py among
them.
"""

import gzip
import io
import os

import numpy as np
import pytest

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu.scaffold import link as jlink
from dbg_assembly_tpu.scaffold import link_contig as jlc
from dbg_assembly_tpu.scaffold import map_reads as jmr
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch.contig import pipeline as tpipe
from dbg_assembly_tpu_torch.contig.refassemble import AssembleParams
from dbg_assembly_tpu_torch.scaffold import link as tlink
from dbg_assembly_tpu_torch.scaffold import link_contig as tlc
from dbg_assembly_tpu_torch.scaffold import map_reads as tmr
from torch_port_data import write_lib
from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz

MAP_SUFFIXES = (".map_reads.2ctg.gz", ".map_reads.1ctg.gz",
                ".map_reads.2ctg.gz.reads.fa.gz", ".map_reads.stat")
CONTIG_SUFFIXES = (".contig_R.links.all", ".contig_R.links.uniq",
                   ".contig_R.seq.fa", ".contig_R.pos.tab",
                   ".contig_R.repeat.seq.fa", ".contig_R.repeat.pos.tab")
SUPERTIG_SUFFIXES = (".supertig.links.all", ".supertig.links.uniq",
                     ".supertig.seq.fa", ".supertig.pos.tab",
                     ".supertig.gap.data", ".supertig_repeat.seq.fa",
                     ".supertig_repeat.pos.tab")
MAP_ARGS = dict(ksize=31, seed_kmer_num=5, min_ctg_len=100,
                min_read_len=250, min_identity=0.97, fmt=1)


def _read(path) -> bytes:
    path = str(path)
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def _lib(d, files) -> str:
    """A .lib of ``files`` in its own directory ``d``: each run writes its
    .map_reads.2ctg.lib beside its .lib."""
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "long.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in files))
    return lib


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's contigs of a 40 kb library and long reads of the same
    genome; returns (contig .fa, long-read FASTQ)."""
    d = tmp_path_factory.mktemp("linkcontig")
    lib = write_lib(str(d), genome_len=40_000, read_len=100, insert=300,
                    depth=8.0, seed=5, err_end=0.02)
    prefix = str(d / "asm")
    tpipe.run(lib, prefix, ksize=31,
              params=AssembleParams(ksize=31, init_hash_size=0.01,
                                    contig_len_cutoff=100),
              log_stream=io.StringIO(), device="cpu")
    r1, q1, _, _ = simulate_pe(make_genome(40_000, seed=5), 700, 1500, 8.0,
                               seed=99, err_start=0.001, err_end=0.004)
    fq = str(d / "long.fq.gz")
    write_fq_gz(fq, "long", r1, q1, 1)
    return prefix + ".contig.seq.fa", fq


@pytest.fixture(scope="module")
def jax_maps(setup, tmp_path_factory):
    """JAX's map_reads outputs on its default path and its device path
    (DBG_JAX_MAP=1): {path name: (out dir, .lib)}."""
    contigs, fq = setup
    d = tmp_path_factory.mktemp("jax_maps")
    out = {}
    mp = pytest.MonkeyPatch()
    for name, env in (("default", None), ("DBG_JAX_MAP", "1")):
        mp.delenv("DBG_JAX_MAP", raising=False)
        mp.delenv("DBG_PY_MAP", raising=False)
        if env:
            mp.setenv("DBG_JAX_MAP", env)
        lib = _lib(str(d / name), [fq])
        jmr.run(contigs, lib, str(d / name / "out"), **MAP_ARGS)
        out[name] = (str(d / name / "out"), lib)
    mp.undo()
    return out


@pytest.mark.parametrize("jax_path", ["default", "DBG_JAX_MAP"])
@pytest.mark.parametrize("engine", ["torch", "native"])
def test_map_reads_files(setup, jax_maps, tmp_path, engine, jax_path):
    contigs, fq = setup
    jdir, jlib = jax_maps[jax_path]
    lib = _lib(str(tmp_path), [fq])
    counts = tmr.run(contigs, lib, str(tmp_path / "out"), engine=engine,
                     device="cpu", **MAP_ARGS)
    base = os.path.basename(fq)
    for suf in MAP_SUFFIXES:
        assert _read(tmp_path / "out" / (base + suf)) == \
            _read(os.path.join(jdir, base + suf)), suf
    with open(jlib + ".map_reads.2ctg.lib") as f:
        want = f.read().replace(jdir, str(tmp_path / "out"))
    with open(lib + ".map_reads.2ctg.lib") as f:
        assert f.read() == want
    c = counts[0]
    assert c["diff"] > 100 and c["same"] > 0
    assert c["total"] == c["diff"] + c["same"] + c["none"] + c["err"]


def _bases(rng, n: int) -> bytes:
    return bytes(bytearray(b"ACGT"[c] for c in rng.integers(0, 4, n)))


def _rc(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


@pytest.mark.parametrize("fmt", [1, 2])
def test_map_reads_routes(tmp_path, fmt):
    """A read over two contigs (.2ctg), over one (.1ctg), over none, over
    the same contig twice (error_map_num, written nowhere), shorter than
    -r (not counted), reverse-complemented and with an N; the .lib entry a
    relative path (the list names it whole)."""
    rng = np.random.default_rng(11)
    a, b, c = _bases(rng, 300), _bases(rng, 400), _bases(rng, 260)
    (tmp_path / "ctg.fa").write_bytes(
        b">ctg_1 x\n" + a + b"\n>ctg_3\n" + b[:200] + b"\n" + b[200:]
        + b"\n>ctg_5\n" + c + b"\n>ctg_7\n" + _bases(rng, 90) + b"\n")
    reads = [a[50:] + b[:250], _rc(a[100:] + b[:300]), c[10:250],
             _bases(rng, 300), a + a, b[:120], a[:150] + b"N" + a[151:]
             + c[:100], c + _bases(rng, 40)]
    lead = b"@" if fmt == 1 else b">"
    name = "r.fq" if fmt == 1 else "r.fa"
    with open(tmp_path / name, "wb") as f:
        for i, r in enumerate(reads):
            f.write(lead + b"read_%d/1 extra\n%s\n" % (i, r))
            if fmt == 1:
                f.write(b"+\n" + b"I" * len(r) + b"\n")
    args = dict(MAP_ARGS, min_read_len=150, fmt=fmt)
    outs = {}
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for run_name, run in (
                ("jax", lambda lib, o: jmr.run("ctg.fa", lib, o, **args)),
                ("torch", lambda lib, o: tmr.run("ctg.fa", lib, o,
                                                 device="cpu", **args)),
                ("native", lambda lib, o: tmr.run("ctg.fa", lib, o,
                                                  engine="native", **args))):
            os.makedirs(run_name)
            lib = os.path.join(run_name, "x.lib")
            with open(lib, "w") as f:
                f.write(name + "\n")
            res = run(lib, run_name + "/out")
            outs[run_name] = [_read(f"{run_name}/out/{name}{s}")
                              for s in MAP_SUFFIXES]
            outs[run_name].append(_read(lib + ".map_reads.2ctg.lib")
                                  .replace(run_name.encode(), b"<run>"))
            if run_name == "torch":
                counts = res[0]
    finally:
        os.chdir(cwd)
    assert outs["torch"] == outs["jax"]
    assert outs["native"] == outs["jax"]
    assert counts == dict(total=7, diff=3, same=2, none=1, err=1)


def test_map_reads_empty(tmp_path):
    """No read reaches -r: the .stat's shares are NaN."""
    (tmp_path / "ctg.fa").write_bytes(b">ctg_1\n" + b"ACGT" * 50 + b"\n")
    (tmp_path / "r.fq").write_bytes(b"@r\nACGTACGT\n+\nIIIIIIII\n")
    stats = []
    for name, mod, kw in (("jax", jmr, {}), ("torch", tmr, {"device": "cpu"})):
        lib = _lib(str(tmp_path / name), [str(tmp_path / "r.fq")])
        mod.run(str(tmp_path / "ctg.fa"), lib, str(tmp_path / name / "o"),
                **kw)
        stats.append(_read(tmp_path / name / "o" / "r.fq.map_reads.stat"))
    assert stats[0] == stats[1] and b"nan%" in stats[1]


@pytest.fixture(scope="module")
def twoctg(setup, jax_maps, tmp_path_factory):
    """The JAX package's .map_reads.2ctg.gz of the long reads, in a .lib."""
    _, fq = setup
    out = str(tmp_path_factory.mktemp("two") / "twoctg.lib")
    with open(out, "w") as f:
        f.write(os.path.join(jax_maps["default"][0],
                             os.path.basename(fq)) + ".map_reads.2ctg.gz\n")
    return out


@pytest.mark.parametrize("cut", [3, 1, 10])
def test_link_contig_files(setup, twoctg, tmp_path, cut):
    contigs, _ = setup
    jpre, tpre = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jlc.run(contigs, twoctg, jpre, pair_num_cut=cut)
    got = tlc.run(contigs, twoctg, tpre, pair_num_cut=cut)
    assert got == want
    for suf in CONTIG_SUFFIXES:
        assert _read(tpre + suf) == _read(jpre + suf), suf
    if cut == 3:
        assert want["inc_num"] > want["num"]     # some scafftigs join


@pytest.mark.parametrize("cut", [3, 1])
def test_link_supertig_files(setup, twoctg, tmp_path, cut):
    """No filter of the .2ctg rows: JAX truncates a gap substring whose
    flanks pass a read's edge, where the C++ reference throws, and the port
    does as JAX."""
    contigs, _ = setup
    jpre, tpre = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jlc.run_supertig(contigs, twoctg, jpre, pair_num_cut=cut)
    got = tlc.run_supertig(contigs, twoctg, tpre, pair_num_cut=cut)
    assert got == want
    for suf in SUPERTIG_SUFFIXES:
        assert _read(tpre + suf) == _read(jpre + suf), suf
    assert b"gap1 " in _read(tpre + ".supertig.gap.data")


def test_gap_helpers():
    for x in (0.0, 1 / 3, 0.97, 123456.789, 1e-9):
        assert tlc._fmt_f32(x) == jlc._fmt_f32(x)
    info = {b"ab": [[b"r", b"9", b"10", b"15"], [b"s", b"9", b"10", b"15"],
                    [b"t", b"9", b"20", b"18"], [b"u", b"9", b"5", b"40"]],
            b"cd": [[b"r", b"9", b"10", b"3"], [b"s", b"9", b"10", b"30"]]}
    assert tlc.decide_gap_size(info) == jlc.decide_gap_size(info)


def test_parse_read_ends(setup, twoctg, tmp_path):
    """The read-ends parser on the real .2ctg plus a row of an unknown
    strand and a short row: links in insertion order and counters equal."""
    path = open(twoctg).read().strip()
    odd = str(tmp_path / "odd.2ctg.gz")
    with gzip.open(path, "rb") as f, gzip.open(odd, "wb") as o:
        o.write(f.read())
        o.write(b"r\t700\t1\t300\tctg_1\t400\t1\t300\tX\t99%\tr\t700\t"
                b"400\t700\tctg_3\t500\t1\t300\tF\t99%\n"
                b"short\tline\n")
    j, t = (_parsed(mod, setup[0], odd) for mod in (jlink, tlink))
    assert t.links == j.links and t.counters == j.counters
    assert j.counters["wrong"] == 1
    assert sum(j.counters[k] for k in ("FF", "RR", "FR", "RF")) > 100


def _parsed(mod, contigs: str, twoctg_gz: str):
    seqs, _ = mod.read_contig_file(contigs)
    g = mod.LinkGraph.create(len(seqs))
    mod.parse_read_ends_map_file(twoctg_gz, g)
    return g


def _same_graph(t, j) -> None:
    assert t.links == j.links
    assert t.counters == j.counters
    for name in ("link", "inlink", "deleted"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)


def _graph(mod, n, edges, freq=5):
    """A graph as tests/test_strong_interleaving.py makes one."""
    g = mod.LinkGraph.create(n)
    for s, d in edges:
        for _ in range(freq):
            g.add(s, d, 10)
    g.remove_lowfreq_and_stat(pair_num_cut=3)
    return g


# (n, edges, node 1's links after the pass): test_strong_interleaving.py's
# cases (rank-1 and rank-2 shortcuts removed, rank 3 kept, four out-links
# skipped, both successors reachable from each other)
STRONG_CASES = [(8, [(1, 3), (1, 5), (3, 5)], [3]),
                (10, [(1, 3), (1, 5), (3, 7), (7, 5)], [3]),
                (12, [(1, 3), (1, 5), (3, 7), (7, 9), (9, 5)], [3, 5]),
                (14, [(1, 3), (1, 5), (1, 7), (1, 9), (3, 5)], [3, 5, 7, 9]),
                (10, [(1, 3), (1, 5), (3, 5), (5, 3)], [])]


@pytest.mark.parametrize("n,edges,left", STRONG_CASES)
def test_strong_remove_interleaving(n, edges, left):
    graphs, orders = [], []
    for mod in (jlink, tlink):
        g = _graph(mod, n, edges)
        order = []
        orig = g.delete_link

        def spy(src, dst, orig=orig, order=order):
            order.append((src, dst))
            orig(src, dst)
        g.delete_link = spy
        g.strong_remove_interleaving()
        graphs.append(g)
        orders.append(order)
    j, t = graphs
    _same_graph(t, j)
    assert orders[1] == orders[0]
    assert sorted(t.linked_ids(1)[0]) == left


def test_strong_remove_interleaving_real(setup, twoctg):
    """The pass on the link graph of the long reads, which map_reads makes
    nearly linear, with a shortcut i -> k added over every third path
    i -> j -> k (rank 1) and every fifth i -> j -> k -> m (rank 2)."""
    path = open(twoctg).read().strip()
    graphs = []
    for mod in (jlink, tlink):
        g = _parsed(mod, setup[0], path)
        g.remove_lowfreq_and_stat(1)
        for i in range(1, g.n):
            nxt = g.linked_ids(i)[0]
            for hops, every in ((2, 3), (3, 5)):
                if i % every or len(nxt) != 1:
                    continue
                end = nxt[0]
                for _ in range(hops - 1):
                    after = g.linked_ids(end)[0]
                    end = after[0] if after else 0
                if end:
                    g.add(i, end, 50)
                    g.link[i] += 1
                    g.inlink[end] += 1
        g.strong_remove_interleaving()
        graphs.append(g)
    _same_graph(graphs[1], graphs[0])
    assert graphs[0].counters["interleave"] > 10


@pytest.mark.parametrize("insert", [300, 700])
def test_remove_small_nodes(setup, twoctg, insert):
    path = open(twoctg).read().strip()
    out = []
    for mod in (jlink, tlink):
        seqs, _ = mod.read_contig_file(setup[0])
        g = _parsed(mod, setup[0], path)
        g.remove_lowfreq_and_stat(3)
        small = g.remove_small_nodes(seqs, insert)
        g.remove_links_from_deleted()
        out.append((g, small))
    (j, jsmall), (t, tsmall) = out
    assert tsmall == jsmall and len(jsmall) > 0
    _same_graph(t, j)


def test_cli_map_reads_link_contig(setup, tmp_path):
    """map_reads, link_contig and link_supertig through both CLIs, chained
    as a user chains them: every file equal."""
    contigs, fq = setup
    base = os.path.basename(fq)
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        lib = _lib(str(tmp_path / name), [fq])
        mdir = str(tmp_path / name / "map")
        assert main(["map_reads", "-k", "31", "-s", "5", "-l", "100", "-r",
                     "250", "-i", "0.97", "-o", mdir, *extra, contigs,
                     lib]) == 0
        two = str(tmp_path / name / "twoctg.lib")
        with open(two, "w") as f:
            f.write(f"{mdir}/{base}.map_reads.2ctg.gz\n")
        pre = str(tmp_path / name / "out")
        for cmd in ("link_contig", "link_supertig"):
            assert main([cmd, "-n", "3", "-o", pre, *extra, contigs,
                         two]) == 0
        out[name] = ([_read(f"{mdir}/{base}{s}") for s in MAP_SUFFIXES]
                     + [_read(pre + s) for s in CONTIG_SUFFIXES
                        + SUPERTIG_SUFFIXES])
    assert out["torch"] == out["jax"]
