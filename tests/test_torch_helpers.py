"""The port's host helpers (dbg_assembly_tpu_torch.utils) and their ten
commands against the JAX package, exactly: every output file (.gz
decompressed) and every byte of stdout.

Inputs are those of tests/test_helper_goldens.py, test_pacbio_chain.py,
test_simulate_lowfreq.py and test_nstat.py, built here; those tests hold
the JAX package against the reference scripts, this file holds the port to
the JAX package.
"""

import gzip
import importlib
import io
import os
import sys

import numpy as np
import pytest

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu.utils import helpers as jh
from dbg_assembly_tpu.utils import merge_assembly as jma
from dbg_assembly_tpu.utils import nstat as jns
from dbg_assembly_tpu.utils import pacbio as jpb
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch.utils import helpers as th
from dbg_assembly_tpu_torch.utils import merge_assembly as tma
from dbg_assembly_tpu_torch.utils import nstat as tns
from dbg_assembly_tpu_torch.utils import pacbio as tpb
from dbg_assembly_tpu_torch.utils import simulate_lowfreq as tsl
from test_helper_goldens import _psl_line, _rand_seq, _write_fasta, \
    _write_fq_gz
from test_pacbio_chain import _synth_blasrm4


def _read(path) -> bytes:
    path = str(path)
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def _tree(d) -> dict:
    """Every file under d by relative path, .gz decompressed."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = _read(p)
    return out


@pytest.fixture
def jsl():
    """JAX's simulate_lowfreq, imported for one test only: its run() takes
    as default stream the sys.stdout of its import, so a module left
    imported here would send a later test's report (tests/test_cli.py)
    into this test's closed capture."""
    name = "dbg_assembly_tpu.utils.simulate_lowfreq"
    had = name in sys.modules
    yield importlib.import_module(name)
    if not had:
        del sys.modules[name]
        delattr(sys.modules["dbg_assembly_tpu.utils"], "simulate_lowfreq")


# ------------------------------------------------------------------ inputs
def _fq_pair(d):
    """test_filter_unpaired_matches_perl's mates: 60 pairs, either mate or
    both empty in some, long headers."""
    rng = np.random.default_rng(5)
    rec1, rec2 = [], []
    for i in range(60):
        kind = rng.integers(0, 4)
        n1 = 0 if kind == 1 or kind == 3 else int(rng.integers(30, 80))
        n2 = 0 if kind == 2 or kind == 3 else int(rng.integers(30, 80))
        name = f"read_{i} extra tokens RQ: 0.1%"
        rec1.append((name, _rand_seq(rng, n1), "I" * n1))
        rec2.append((name, _rand_seq(rng, n2), "I" * n2))
    r1, r2 = os.path.join(d, "lib_1.fq.gz"), os.path.join(d, "lib_2.fq.gz")
    _write_fq_gz(r1, rec1)
    _write_fq_gz(r2, rec2)
    return r1, r2


def _revcom_fasta(d):
    rng = np.random.default_rng(9)
    recs = []
    for i in (3, 11, 1, 20, 7, 3):            # a duplicate id overwrites
        seq = _rand_seq(rng, int(rng.integers(20, 180)))
        seq = seq[:5].lower() + seq[5:15] + "NNN" + seq[15:]
        recs.append((f"ctg_{i} len={len(seq)} cov 3.5", seq))
    recs.append(("empty", ""))
    fa = os.path.join(d, "in.fa")
    _write_fasta(fa, recs, width=60)
    return fa


def _redecide_fastas(d):
    rng = np.random.default_rng(17)
    big, small = [], []
    for i in range(1, 40, 2):
        n = int(rng.integers(80, 400))
        big.append((f"{i} length {n} cvg_30.0", _rand_seq(rng, n)))
    for i in range(1, 30):
        n = int(rng.integers(40, 260))
        small.append((f"{i} length {n}", _rand_seq(rng, n)))
    c, s = os.path.join(d, "contig.fa"), os.path.join(d, "small.fa")
    _write_fasta(c, big, width=70)
    _write_fasta(s, small, width=70)
    return c, s


def _merge_inputs(d):
    """test_merge_assembly_matches_perl's scafftigs, utgs and PSL."""
    rng = np.random.default_rng(23)
    scafftigs, utgs = [], []
    for i in range(14):
        n = int(rng.integers(300, 1200))
        scafftigs.append((f"sct_{2 * i + 1} len {n}", _rand_seq(rng, n)))
    for i in range(6):
        n = int(rng.integers(2000, 6000))
        utgs.append((f"utg_{i:03d}", _rand_seq(rng, n)))
    sct_fa, utg_fa = os.path.join(d, "sct.fa"), os.path.join(d, "utg.fa")
    _write_fasta(sct_fa, scafftigs, width=80)
    _write_fasta(utg_fa, utgs, width=80)
    lines = []
    for i, (h, s) in enumerate(scafftigs[:10]):
        tname = utgs[i % 4][0]
        lines.append(_psl_line(rng, h.split()[0], tname, len(s),
                               len(utgs[i % 4][1]), i % 5 != 4))
    psl = os.path.join(d, "best.psl")
    with open(psl, "w") as f:
        f.write("psLayout version 3\n" + "\n".join(lines) + "\n")
    return psl, sct_fa, utg_fa


def _subread_fastq(d):
    rng = np.random.default_rng(1)
    lines = []
    for i in range(20):
        L = int(rng.integers(50, 200))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
        lines += [f"@S1_{i}", seq, "+", "I" * L]
    fq = os.path.join(d, "r.fq")
    with open(fq, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fq, lines


def _len_file(d):
    """A .len file of ragged lengths (nstat's fixture is the reference's
    E. coli contig .len, absent here)."""
    rng = np.random.default_rng(4)
    p = os.path.join(d, "x.len")
    with open(p, "w") as f:
        for i, n in enumerate(rng.integers(100, 80_000, 517)):
            f.write(f"ctg_{2 * i + 1}\t{n}\n")
    return p


# ----------------------------------------------------- functions vs JAX
@pytest.mark.parametrize("variant", ["contig", "scafftig"])
def test_redecide(tmp_path, variant):
    kw = ({} if variant == "contig" else
          dict(prefix="sct", small_prefix="smalltig"))
    outs = {}
    for name, mod in (("jax", jh), ("torch", th)):
        d = tmp_path / name
        d.mkdir()
        c, s = _redecide_fastas(str(d))
        outs[name] = [_read(p) for p in
                      mod.redecide_contig_and_small(c, s, 200, **kw)]
    assert outs["torch"] == outs["jax"]
    assert all(outs["jax"])


def test_read_fasta_dict(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">a 1 2\nAC GT\n\n>b\n>\nTT\n>a dup\nGG\n")
    assert th._read_fasta_dict(str(fa)) == jh._read_fasta_dict(str(fa))


def test_filter_unpaired(tmp_path):
    r1, r2 = _fq_pair(str(tmp_path))
    want = jh.filter_unpaired_reads(r1, r2, str(tmp_path / "j1.gz"),
                                    str(tmp_path / "j2.gz"))
    got = th.filter_unpaired_reads(r1, r2, str(tmp_path / "t1.gz"),
                                   str(tmp_path / "t2.gz"))
    for k in ("both", "single", "empty", "bases1", "bases2"):
        assert got[k] == want[k], k
    for m in (1, 2):
        assert _read(tmp_path / f"t{m}.gz") == _read(tmp_path / f"j{m}.gz")
    assert got["both"] and got["single"] and got["empty"]


def test_filter_unpaired_name_mismatch(tmp_path):
    r1, r2 = str(tmp_path / "a.fq.gz"), str(tmp_path / "b.fq.gz")
    _write_fq_gz(r1, [("x", "ACGT", "IIII")])
    _write_fq_gz(r2, [("y", "ACGT", "IIII")])
    for mod in (jh, th):
        with pytest.raises(ValueError, match="mismatch"):
            mod.filter_unpaired_reads(r1, r2, str(tmp_path / "o1.gz"),
                                      str(tmp_path / "o2.gz"))


def test_rev_com_seq(tmp_path):
    fa = _revcom_fasta(str(tmp_path))
    jh.rev_com_seq_file(fa, str(tmp_path / "j.fa"))
    th.rev_com_seq_file(fa, str(tmp_path / "t.fa"))
    assert _read(tmp_path / "t.fa") == _read(tmp_path / "j.fa")


def test_split_libfile(tmp_path):
    content = "a/b/reads_1.fq.gz\n\n/x/reads_2.fq.gz\nlast_no_newline"
    outs = {}
    for name, mod in (("jax", jh), ("torch", th)):
        lib = tmp_path / f"{name}.lib"
        lib.write_text(content)
        paths = mod.split_libfile(str(lib))
        assert paths == [f"{lib}.{i}" for i in range(1, 5)]
        outs[name] = [_read(p) for p in paths]
    assert outs["torch"] == outs["jax"]


def test_merge_assembly(tmp_path):
    psl, sct, utg = _merge_inputs(str(tmp_path))
    want = jma.run(psl, sct, utg, str(tmp_path / "J"), "TMC_")
    got = tma.run(psl, sct, utg, str(tmp_path / "T"), "TMC_")
    assert got == want
    assert want["aligned_utg"] and want["unaligned_utg"] \
        and want["unaligned_sct"]
    for suf in (".merged_assembly.seq.fa", ".merged_assembly.pos.tab"):
        assert _read(str(tmp_path / "T") + suf) == \
            _read(str(tmp_path / "J") + suf)


@pytest.mark.parametrize("fileformat", ["blasrm4", "paf"])
def test_blasrm4_chain(fileformat):
    raw = _synth_blasrm4()
    if fileformat == "paf":
        rng = np.random.default_rng(2)
        raw = ["\t".join(str(x) for x in (
            f"S1_{rng.integers(1, 40)}", 5000, s, s + int(rng.integers(
                100, 3000)), "+", f"sct_{2 * rng.integers(0, 20) + 1}"))
            for s in rng.integers(0, 2000, 200)]
    for cut in (None, 0.5):
        assert list(tpb.blasrm4_besthit(raw, fileformat, cut)) == \
            list(jpb.blasrm4_besthit(raw, fileformat, cut))
    if fileformat == "paf":
        return
    best = list(jpb.blasrm4_besthit(raw, "blasrm4"))
    for args in ((100, 1000, 0.7), (100, 500, 0.7), (300, 500, 80.0)):
        assert tpb.blasrm4_map(best, *args) == jpb.blasrm4_map(best, *args)
    chain, _ = jpb.blasrm4_map(best, 100, 500, 0.7)
    reps = ["sct_1", "sct_7"]
    for r in (None, reps):
        assert tpb.blasrm4_twoctg(chain, r) == jpb.blasrm4_twoctg(chain, r)


def test_fullread_to_subread(tmp_path):
    _, lines = _subread_fastq(str(tmp_path))
    assert tpb.fullread_to_subread(lines, "m0001") == \
        jpb.fullread_to_subread(lines, "m0001")


def test_nstat(tmp_path):
    ln = _len_file(str(tmp_path))
    jns.write_len_stat(ln, str(tmp_path / "j.stat"))
    tns.write_len_stat(ln, str(tmp_path / "t.stat"))
    assert _read(tmp_path / "t.stat") == _read(tmp_path / "j.stat")
    for lens in ([], [5], [3, 3, 3], list(range(1, 50))):
        assert tns.seqlen_stat(lens) == jns.seqlen_stat(lens)
    fa = _revcom_fasta(str(tmp_path))
    assert list(tns.fasta_lengths(fa)) == list(jns.fasta_lengths(fa))
    jns.write_len_file(fa, str(tmp_path / "j.len"))
    tns.write_len_file(fa, str(tmp_path / "t.len"))
    assert _read(tmp_path / "t.len") == _read(tmp_path / "j.len")


@pytest.mark.parametrize("k,skip", [(13, 100), (11, 37)])
def test_simulate_lowfreq(tmp_path, jsl, k, skip):
    from tools.simulate_reads import make_genome, write_genome_fa
    fa = str(tmp_path / "g.fa")
    write_genome_fa(fa, make_genome(60_000, seed=3))
    want, got = io.StringIO(), io.StringIO()
    jsl.run(fa, ksize=k, skip=skip, out=want)
    tsl.run(fa, ksize=k, skip=skip, out=got)
    assert got.getvalue() == want.getvalue()
    assert list(tsl.read_fasta_seqs(fa)) == list(jsl.read_fasta_seqs(fa))


# ------------------------------------------------------- the ten commands
def _commands(d):
    """(name, argv) of each helper command on inputs built in d."""
    r1, r2 = _fq_pair(d)
    c, s = _redecide_fastas(d)
    psl, sct, utg = _merge_inputs(d)
    fq, _ = _subread_fastq(d)
    raw = os.path.join(d, "x.blasrm4")
    with open(raw, "w") as f:
        f.write("\n".join(_synth_blasrm4()) + "\n")
    best = os.path.join(d, "x.best")
    with open(best, "w") as f:
        f.write("".join(x + "\n" for x in jpb.blasrm4_besthit(
            _synth_blasrm4(), "blasrm4")))
    chain = os.path.join(d, "x.map")
    with open(chain, "w") as f:
        f.write("".join(x + "\n" for x in jpb.blasrm4_map(
            open(best).read().splitlines(), 100, 500)[0]))
    reps = os.path.join(d, "reps.txt")
    with open(reps, "w") as f:
        f.write("sct_1\tx\nsct_7\n\n")
    lib = os.path.join(d, "r.lib")
    with open(lib, "w") as f:
        f.write("a_1.fq\n\nb_2.fq\n")
    from tools.simulate_reads import make_genome, write_genome_fa
    genome = os.path.join(d, "g.fa")
    write_genome_fa(genome, make_genome(20_000, seed=3))
    fa = _revcom_fasta(d)
    return [
        ("fasta_len", ["fasta_len", fa]),
        ("fasta_len -o", ["fasta_len", fa, "-o", os.path.join(d, "o.len")]),
        ("seqlen_stat", ["seqlen_stat", _len_file(d)]),
        ("seqlen_stat -col", ["seqlen_stat", "-col", "2", fa + ".len", "-o",
                              os.path.join(d, "fa.len.stat")]),
        ("redecide", ["redecide_contig_and_small", c, s, "150"]),
        ("redecide --scafftig", ["redecide_contig_and_small", "--scafftig",
                                 c, s]),
        ("filter_unpaired_reads", ["filter_unpaired_reads", r1, r2]),
        ("merge_assembly", ["merge_assembly", "--output_prefix", "M", psl,
                            sct, utg]),
        ("blasrm4 besthit", ["blasrm4", "besthit", raw]),
        ("blasrm4 map", ["blasrm4", "map", best, "--alignlencut", "500"]),
        ("blasrm4 twoctg", ["blasrm4", "twoctg", chain, reps]),
        ("blasrm4 fullread_to_subread", ["blasrm4", "fullread_to_subread",
                                         fq, "m0042"]),
        ("split_libfile", ["split_libfile", lib]),
        ("rev_com_seq", ["rev_com_seq", fa]),
        ("fullread_to_subread", ["fullread_to_subread", fq]),
        ("simulate_lowfreq_kmer", ["simulate_lowfreq_kmer", "-k", "11", "-s",
                                   "50", genome]),
    ]


def test_helper_commands(tmp_path, monkeypatch, capsys, jsl):
    """Each helper command through both CLIs in a work dir of its own (some
    write into the current directory): the files they leave and their
    stdout and stderr equal, after the work dir's name is replaced."""
    runs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        # the JAX package's report stream is the sys.stdout of its import
        monkeypatch.setattr(jsl.run, "__defaults__", (17, 100, sys.stdout))
        cmds = _commands(str(d))
        before = _tree(d)
        out = []
        for title, argv in cmds:
            assert main(argv) == 0, title
            cap = capsys.readouterr()
            out.append((title, cap.out.replace(str(d), "<d>"),
                        cap.err.replace(str(d), "<d>")))
        made = {k: v.replace(str(d).encode(), b"<d>")
                for k, v in _tree(d).items() if k not in before}
        runs[name] = (out, made, [t for t, _ in cmds])
    assert runs["torch"][2] == runs["jax"][2]
    for (t, o, e), (_, wo, we) in zip(runs["torch"][0], runs["jax"][0]):
        assert (o, e) == (wo, we), t
    assert runs["torch"][1] == runs["jax"][1]
    assert len(runs["jax"][1]) >= 12
    out = dict((t, o) for t, o, _ in runs["jax"][0])
    assert out["blasrm4 map"] and out["simulate_lowfreq_kmer"]
