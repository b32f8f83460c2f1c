"""Mapping and scaffolding in the port (dbg_assembly_tpu_torch.scaffold)
against the JAX package, exactly: integers, float32 identities and bytes,
tolerance 0.

The contig index's arrays against _build_py (contigs with N runs, a
repeated segment, empty and short slots); the mapper against JAX's device
path (_map_reads_jax, forced with DBG_JAX_MAP=1) and the native engine:
``mapped`` exactly, every other field exactly on the mapped rows, as
tests/test_engine_agreement.py does (reads half reverse-complemented, a
per-read search_start, reads shorter than k + S); chunking; and at file
level every map_pair and link_scaffold artifact against the JAX package's
on a simulated library whose contigs come from the port's own
debruijn_contig.  The port runs on the CPU here; chip_smoke.py holds the
card against the native engine.
"""

import gzip
import io
import os

import numpy as np
import pytest
import torch

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu import dna as jdna
from dbg_assembly_tpu.contig import pipeline as jcpipe
from dbg_assembly_tpu.io import lib as jlib
from dbg_assembly_tpu.scaffold import index as jix
from dbg_assembly_tpu.scaffold import map_pair as jmp
from dbg_assembly_tpu.scaffold import scaffold as jscf
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch.contig import pipeline as tpipe
from dbg_assembly_tpu_torch.contig.refassemble import AssembleParams
from dbg_assembly_tpu_torch.io import lib as tlib
from dbg_assembly_tpu_torch.scaffold import index as tix
from dbg_assembly_tpu_torch.scaffold import map_pair as tmp_
from dbg_assembly_tpu_torch.scaffold import scaffold as tscf
from torch_port_data import write_lib

FIELDS = ("contig", "read_start", "read_end", "contig_start", "contig_end",
          "direct", "identity")
MAP_SUFFIXES = (".map_pair.2ctg.gz", ".map_pair.1ctg.gz", ".map_pair.gap.gz",
                ".map_pair.stat")
SCAFFOLD_SUFFIXES = (".scaffold.links.all", ".scaffold.links.uniq",
                     ".scaffold.seq.fa", ".scaffold.pos.tab",
                     ".scaffold_repeat.seq.fa", ".scaffold_repeat.pos.tab")


def _bases(rng, n: int) -> bytes:
    return bytes(bytearray(b"ACGT"[c] for c in rng.integers(0, 4, n)))


def _contigs(seed: int = 9) -> list[bytes]:
    """Contig slots with N runs (upper and lower case), a segment repeated
    in two contigs (uniq 0), an empty slot and one shorter than k."""
    rng = np.random.default_rng(seed)
    rep = _bases(rng, 60)
    return [_bases(rng, 400),
            _bases(rng, 100) + b"NNNN" + _bases(rng, 200) + rep,
            b"",
            _bases(rng, 20),
            _bases(rng, 150) + rep + b"n" + _bases(rng, 5) + b"N"
            + _bases(rng, 80),
            b"NNN" + _bases(rng, 300) + b"NN"]


def _reads(contigs, seed: int, n: int = 400, L: int = 100):
    """Reads drawn from the contigs with 0-2 substitutions, half reverse-
    complemented, ragged lengths (some shorter than k + S), an N in a few.
    Returns (codes [n, L] with pad 4, ascii [n, L] with pad 0, lengths)."""
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


@pytest.mark.parametrize("k", [13, 17, 31])
def test_build_index(k):
    contigs = _contigs()
    want = jix._build_py(contigs, k)
    got = tix.build(contigs, k, device="cpu")
    assert got.kmers.dtype == torch.int64
    np.testing.assert_array_equal(got.kmers.numpy().astype(np.uint64),
                                  want.kmers)
    for name in ("ids", "pos", "direct", "uniq", "offsets", "lengths",
                 "concat"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (want.uniq == 0).any() and (want.uniq == 1).any()


@pytest.mark.parametrize("contigs", [[], [b""], [b"ACGT", b"NNNNNNNNNNNN"],
                                     [b"ACGTACGTACGTACGTAC"]])
def test_build_index_edges(contigs):
    want = jix._build_py(contigs, 17)
    got = tix.build(contigs, 17, device="cpu")
    np.testing.assert_array_equal(got.kmers.numpy().astype(np.uint64),
                                  want.kmers)
    for name in ("ids", "pos", "direct", "uniq", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)


def test_lookup():
    contigs = _contigs()
    want_ix = jix._build_py(contigs, 17)
    got_ix = tix.build(contigs, 17, device="cpu")
    rng = np.random.default_rng(3)
    probe = np.concatenate([want_ix.kmers[::3], rng.integers(
        0, 1 << 34, 200).astype(np.uint64)])
    want = jix.lookup(want_ix, probe)
    got = tix.lookup(got_ix, torch.from_numpy(probe.astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    f = want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[f], w[f])


def _same_map(got, want, what: str) -> None:
    np.testing.assert_array_equal(got.mapped, want.mapped,
                                  err_msg=f"mapped [{what}]")
    m = want.mapped
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (name, what)
        np.testing.assert_array_equal(g[m], w[m], err_msg=f"{name} [{what}]")


@pytest.mark.parametrize("k,S,per_read_start", [(17, 5, False),
                                                (17, 10, True),
                                                (25, 5, True), (31, 3, False)])
def test_map_reads(monkeypatch, k, S, per_read_start):
    contigs = _contigs()
    codes, ascii_seq, lengths = _reads(contigs, seed=k + S)
    ss = (np.random.default_rng(1).integers(1, 40, len(codes))
          if per_read_start else 1)
    got = tix.map_reads(tix.build(contigs, k, device="cpu"), codes,
                        ascii_seq, lengths, S, 0.95, ss)
    monkeypatch.setenv("DBG_JAX_MAP", "1")
    jax_path = jix.map_reads(jix.build(contigs, k), codes, ascii_seq,
                             lengths, S, 0.95, ss)
    monkeypatch.delenv("DBG_JAX_MAP")
    native = jix.map_reads(jix.build(contigs, k), codes, ascii_seq, lengths,
                           S, 0.95, ss)
    port_native = tix.map_reads(tix.build(contigs, k, engine="native"),
                                codes, ascii_seq, lengths, S, 0.95, ss)
    _same_map(got, jax_path, "jax")
    _same_map(got, native, "native")
    _same_map(port_native, native, "port's native binding")
    assert 0 < got.mapped.sum() < len(codes)
    assert (got.direct[got.mapped] == 0).any()


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_map_reads_chunks(chunk):
    contigs = _contigs()
    codes, ascii_seq, lengths = _reads(contigs, seed=4, n=150)
    ix = tix.build(contigs, 17, device="cpu")
    whole = tix.map_reads(ix, codes, ascii_seq, lengths, 5, 0.95)
    parts = tix.map_reads(ix, codes, ascii_seq, lengths, 5, 0.95,
                          chunk=chunk)
    for name in ("mapped",) + FIELDS:
        np.testing.assert_array_equal(getattr(parts, name),
                                      getattr(whole, name), err_msg=name)


def test_map_reads_no_kmers():
    """An index without k-mers and reads shorter than k map nothing."""
    codes, ascii_seq, lengths = _reads(_contigs(), seed=5, n=20)
    r = tix.map_reads(tix.build([b"ACGT"], 17, device="cpu"), codes,
                      ascii_seq, lengths, 5, 0.95)
    assert not r.mapped.any()
    r = tix.map_reads(tix.build(_contigs(), 17, device="cpu"),
                      codes[:, :10], ascii_seq[:, :10],
                      np.minimum(lengths, 10), 5, 0.95)
    assert not r.mapped.any()


def test_index_checks():
    with pytest.raises(ValueError):
        tix.build([b"ACGT" * 20], 32, device="cpu")
    with pytest.raises(ValueError):
        tix.build([b"ACGT" * 20], 17, engine="jax", device="cpu")
    with pytest.raises(RuntimeError):
        tix.lookup(tix.build([b"ACGT" * 20], 17, engine="native"),
                   torch.zeros(3, dtype=torch.int64))


def test_read_helpers(tmp_path):
    fa = tmp_path / "c.fa"
    fa.write_bytes(b">ctg_1 len=5\nACGTA\nCC\n>empty\n>ctg_3\tx\nGGG\n"
                   b">last\n")
    assert tmp_.read_contig_fasta(str(fa)) == jmp.read_contig_fasta(str(fa))
    for head in (b"@r1/1 extra\tmore", b"@@r2", b"@ r3 x y", b">r4\tq",
                 b"@"):
        for lead in (b"@", b">"):
            assert tmp_._read_id(head, lead) == jmp._read_id(head, lead)
    lib = tmp_path / "x.lib"
    lib.write_text("# comment\na.fq extra\n\n  b.fq\n")
    assert tlib.read_lib(str(lib)) == jlib.read_lib(str(lib))
    para = tmp_path / "x.para"
    para.write_text("#rank k s ident ins cut mate file\n"
                    "1 31 5 0.97 400 3 0 a.lib\n2 25 5 0.95 2000 5 1 b.lib\n"
                    "3 31 5\n")
    assert [vars(r) for r in tlib.read_para(str(para))] == \
        [vars(r) for r in jlib.read_para(str(para))]


@pytest.mark.parametrize("newline", ["\n", "\r\n", None])
def test_read_file_list(tmp_path, newline):
    """The .lib reader of every stage (io/lib.py) against the JAX
    package's (contig/pipeline.py) on blank lines, lines of spaces and
    trailing whitespace; newline None ends the file without one."""
    lines = ["a.fq", "", "b.fq  ", "   ", "\tc.fq", "", "d e.fq\t"]
    text = (newline or "\n").join(lines)
    lib = tmp_path / "x.lib"
    lib.write_bytes((text + (newline or "")).encode())
    got = tlib.read_file_list(str(lib))
    assert got == jcpipe.read_file_list(str(lib))
    assert len(got) == 5 and got[2] == "   "   # text mode reads CRLF as LF
    assert tpipe.read_file_list is tlib.read_file_list


# ------------------------------------------------------------ file level
@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    """A 40 kb library at 8x with 2 % errors at the 3' end (fragmented
    contigs, so scaffolds join several), its contigs from the port's
    debruijn_contig; returns (lib, contig .fa)."""
    d = tmp_path_factory.mktemp("scaffold")
    lib = write_lib(str(d), genome_len=40_000, read_len=100, insert=300,
                    depth=8.0, seed=5, err_end=0.02)
    prefix = str(d / "asm")
    tpipe.run(lib, prefix, ksize=31,
              params=AssembleParams(ksize=31, init_hash_size=0.01,
                                    contig_len_cutoff=100),
              log_stream=io.StringIO(), device="cpu")
    return lib, prefix + ".contig.seq.fa"


def _read(path: str) -> bytes:
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def _mirror(lib: str, where) -> str:
    """A .lib of symlinks in ``where``: each run writes its list file
    beside its own .lib."""
    where.mkdir()
    links = []
    for p in tlib.read_lib(lib):
        links.append(str(where / os.path.basename(p)))
        os.symlink(p, links[-1])
    out = str(where / "reads.lib")
    with open(out, "w") as f:
        f.write("".join(p + "\n" for p in links))
    return out


MAP_ARGS = dict(ksize=25, seed_kmer_num=5, min_ctg_len=100, min_read_len=100,
                min_identity=0.95)


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_map_pair_files(assembly, tmp_path, engine):
    lib, contigs = assembly
    jlib_, tlib_ = _mirror(lib, tmp_path / "j"), _mirror(lib, tmp_path / "t")
    jmp.run(contigs, jlib_, str(tmp_path / "jmap"), **MAP_ARGS)
    counts = tmp_.run(contigs, tlib_, str(tmp_path / "tmap"), engine=engine,
                      device="cpu", **MAP_ARGS)
    base = os.path.basename(tlib.read_lib(lib)[0])
    for suf in MAP_SUFFIXES:
        assert _read(str(tmp_path / "tmap" / base) + suf) == \
            _read(str(tmp_path / "jmap" / base) + suf), suf
    with open(jlib_ + ".map_pair.2ctg.lib") as a, \
            open(tlib_ + ".map_pair.2ctg.lib") as b:
        want = a.read()
        for j, t in (("jmap", "tmap"), ("j/", "t/")):
            want = want.replace(str(tmp_path / j), str(tmp_path / t))
        assert b.read() == want
    c = counts[0]
    assert c["diff"] > 100 and c["same"] > 0 and c["gap"] > 0
    assert c["total"] == c["diff"] + c["same"] + c["gap"] + c["none"]


@pytest.fixture(scope="module")
def twoctg(assembly, tmp_path_factory):
    """The JAX package's .map_pair.2ctg.gz of the library, in a .lib."""
    lib, contigs = assembly
    d = tmp_path_factory.mktemp("twoctg")
    jmp.run(contigs, lib, str(d / "map"), **MAP_ARGS)
    base = os.path.basename(tlib.read_lib(lib)[0])
    out = str(d / "twoctg.lib")
    with open(out, "w") as f:
        f.write(str(d / "map" / base) + ".map_pair.2ctg.gz\n")
    return out


@pytest.mark.parametrize("insert,cut,is_mate", [(300, 3, False),
                                                (300, 1, False),
                                                (250, 2, True)])
def test_link_scaffold_files(assembly, twoctg, tmp_path, insert, cut,
                             is_mate):
    _, contigs = assembly
    jpre, tpre = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jscf.run(contigs, twoctg, jpre, insert_size=insert,
                    pair_num_cut=cut, is_mate=is_mate)
    got = tscf.run(contigs, twoctg, tpre, insert_size=insert,
                   pair_num_cut=cut, is_mate=is_mate)
    for suf in SCAFFOLD_SUFFIXES:
        assert _read(f"{tpre}.insert{insert}{suf}") == \
            _read(f"{jpre}.insert{insert}{suf}"), suf
    for key in ("num", "len", "lenwogap", "inc_num", "inc_len", "counters"):
        assert got[key] == want[key], key
    if not is_mate:
        assert got["inc_num"] > got["num"]      # some scaffolds join contigs


def test_cli_map_pair_link_scaffold(assembly, tmp_path):
    """Both commands through both CLIs, chained as the workflow chains them
    (workflow.scaffold_iterative)."""
    lib, contigs = assembly
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        mlib = _mirror(lib, tmp_path / name)
        mdir = str(tmp_path / name / "map")
        assert main(["map_pair", "-k", "25", "-s", "5", "-l", "100", "-r",
                     "100", "-i", "0.95", "-o", mdir, *extra, contigs,
                     mlib]) == 0
        two = str(tmp_path / name / "twoctg.lib")
        base = os.path.basename(tlib.read_lib(lib)[0])
        with open(two, "w") as f:
            f.write(f"{mdir}/{base}.map_pair.2ctg.gz\n")
        pre = str(tmp_path / name / "scf")
        assert main(["link_scaffold", "-i", "300", "-n", "3", "-o", pre,
                     *extra, contigs, two]) == 0
        out[name] = [_read(f"{mdir}/{base}{s}") for s in MAP_SUFFIXES] + \
            [_read(f"{pre}.insert300{s}") for s in SCAFFOLD_SUFFIXES]
    assert out["torch"] == out["jax"]


def test_map_pair_mesh_raises(assembly, tmp_path, monkeypatch):
    """--mesh is ported: the sharded mapper writes the single-device
    mapper's files (tests/test_torch_mesh_stages.py holds it against JAX's
    --mesh); on cuda without a card it raises before it writes a file."""
    lib, contigs = assembly
    out = {}
    for name, extra in (("mesh", ["--mesh", "2"]), ("single", [])):
        mlib = _mirror(lib, tmp_path / name)
        tcli.main(["map_pair", *extra, "--device", "cpu", "-k", "25", "-r",
                   "100", "-l", "100", "-i", "0.95", "-o",
                   str(tmp_path / name / "out"), contigs, mlib])
        base = os.path.basename(tlib.read_lib(mlib)[0])
        out[name] = [_read(str(tmp_path / name / "out" / base) + suf)
                     for suf in MAP_SUFFIXES]
    assert out["mesh"] == out["single"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["map_pair", "--mesh", "2", "-o", str(tmp_path / "c"),
                   contigs, lib])
    assert not os.path.exists(tmp_path / "c")


@pytest.mark.gpu
def test_map_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    contigs = _contigs()
    codes, ascii_seq, lengths = _reads(contigs, seed=6)
    cpu_ix = tix.build(contigs, 17, device="cpu")
    gpu_ix = tix.build(contigs, 17, device="cuda")
    for name in ("kmers", "ids", "pos", "direct", "uniq"):
        assert torch.equal(getattr(gpu_ix, name).cpu(),
                           getattr(cpu_ix, name)), name
    _same_map(tix.map_reads(gpu_ix, codes, ascii_seq, lengths, 5, 0.95),
              tix.map_reads(cpu_ix, codes, ascii_seq, lengths, 5, 0.95),
              "card")
