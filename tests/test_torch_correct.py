"""Correction in the port (dbg_assembly_tpu_torch.correct) against the JAX
package, exactly: integers and bytes, tolerance 0.

Inputs are test_correct_device's cases (k = 13, 80 bp reads from a random
4 kb genome with planted errors, seeds 1-4), some at k = 9 with a denser
table (random extra k-mers, reverse-complement closed) so that beams
overflow and rows fall back, some with ragged reads and N.  The port's
device engine runs on the CPU here; the gpu-marked case holds the card
against the CPU.
"""

import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu import dna as jdna
from dbg_assembly_tpu.correct import device as jdev
from dbg_assembly_tpu.correct import engine as jeng
from dbg_assembly_tpu.correct import pipeline as jpipe
from dbg_assembly_tpu.io import cz as jcz
from dbg_assembly_tpu.io import fastq as jfq
from dbg_assembly_tpu.kmer import count as jkc
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch import spans
from dbg_assembly_tpu_torch.correct import device as tdev
from dbg_assembly_tpu_torch.correct import engine as teng
from dbg_assembly_tpu_torch.correct import pipeline as tpipe
from dbg_assembly_tpu_torch.io import cz as tcz
from dbg_assembly_tpu_torch.io import fastq as tfq
from dbg_assembly_tpu_torch.kmer import count as tkc
from dbg_assembly_tpu_torch.parallel import mesh as tmesh
from test_correct_device import _make_case
from torch_port_data import write_lib

K = 13
K_DENSE = 9       # the dense tables' k: 4^9 bits are cheap to fill


def _params(k=K):
    """The same parameters for the JAX package and the port."""
    return (jeng.CorrectParams(ksize=k, max_change=2, min_read_len=40),
            teng.CorrectParams(ksize=k, max_change=2, min_read_len=40))


PARAMS, TPARAMS = _params()


def _case(seed, n_err_max=4, dens=0.0, n_reads=120, ragged=False):
    """_make_case's batch and its k; dens > 0 goes to k = 9 and adds
    random k-mers to the table (then closes it under reverse complement
    again); ragged cuts some reads short (some below k) and puts N into
    others."""
    k = K_DENSE if dens else K
    a, c, lens, bm = _make_case(seed, n_reads=n_reads, n_err_max=n_err_max,
                                k=k)
    rng = np.random.default_rng(100 + seed)
    if dens:
        noise = np.packbits(rng.random(bm.size * 8) < dens)
        bm = jkc.expand_bitmap_rc(bm | noise, k)
    a, c, lens = a.copy(), c.copy(), lens.copy()
    if ragged:
        lens[::7] = rng.integers(3, a.shape[1], len(lens[::7]))
        for i in range(len(lens)):
            a[i, lens[i]:] = 0
            c[i, lens[i]:] = 4
        a[1::11, 30] = ord("N")
        c[1::11, 30] = 0
    return a, c, lens, bm, k


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(jax_out, torch_out, names):
    for j, t, name in zip(jax_out, torch_out, names):
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        np.testing.assert_array_equal(np.asarray(j), t, err_msg=name)


def _stage_a_both(a, c, lens, bm, k):
    p = _params(k)[0].resolved()
    kw = dict(k=k, m=p.high_freq_reg_len, max_change=p.max_change)
    j = jdev._stage_a(jnp.asarray(a), jnp.asarray(c), jnp.asarray(lens),
                      jdev.bitmap_device(bm), **kw)
    t = tdev._stage_a(_t(a), _t(c), _t(lens), tdev.bitmap_device(bm, "cpu"),
                      **kw)
    return j, t


# --------------------------------------------------------------- functions
def test_probe():
    _, _, _, bm, _ = _case(1)
    idx = np.random.default_rng(0).integers(0, 4 ** K, 50_000)
    idx[:3] = [0, 4 ** K - 1, 12345]
    want = np.asarray(jdev._probe(jdev.bitmap_device(bm),
                                  jnp.asarray(idx.astype(np.uint64))))
    got = tdev._probe(tdev.bitmap_device(bm, "cpu"), _t(idx))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, jkc.bitmap_get(bm, idx) == 1)
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("seed,n_err,dens,ragged", [
    (1, 4, 0.0, False), (2, 12, 0.0, True), (3, 20, 0.0, False),
    (4, 6, 0.2, True)])
def test_stage_a(seed, n_err, dens, ragged):
    """_stage_a's six outputs, with reads past R_MAX regions, C_MAX
    candidates and H_MAX high regions among them."""
    j, t = _stage_a_both(*_case(seed, n_err, dens, ragged=ragged))
    _same(j, t, ["ascii", "one_score", "hs1", "he1", "num_h", "fallback"])


def _bbt_args(kind, rightward, k, a, lens, one, hs1, he1, num_h):
    """Arguments of a gap BBT (phase 4) or an end BBT (phase 5) derived
    from stage A's regions."""
    L = a.shape[1]
    num_h = np.asarray(num_h)
    hs1, he1 = np.asarray(hs1), np.asarray(he1)
    ma = (2 - np.asarray(one)).astype(np.int32)
    if kind == "gap":
        act = num_h >= 2
        if rightward:
            cs, ce = he1[:, 0] + k, hs1[:, 1] + k - 2
        else:
            cs, ce = hs1[:, 1] - 1, he1[:, 0] + 1
        lci = np.full(len(a), -1, np.int32)
    elif rightward:
        high_end = he1[:, 0] + k - 1
        act = (num_h > 0) & (high_end < lens)
        cs, ce = np.minimum(high_end + 1, lens), lens
        lci = (lens + 1).astype(np.int32)
    else:
        act = (num_h > 0) & (hs1[:, 0] > 1)
        cs, ce = np.maximum(hs1[:, 0] - 1, 1), np.ones(len(a), np.int32)
        lci = np.zeros(len(a), np.int32)
    assert act.sum() > 0 and L > 0
    return (act, cs.astype(np.int32), ce.astype(np.int32), ma, lci)


@pytest.mark.parametrize("kind", ["gap", "end"])
@pytest.mark.parametrize("rightward", [True, False])
def test_bbt_impl(kind, rightward):
    """One beam call both ways, its children probed one word a lane, on a
    table dense enough that beams overflow."""
    a, c, lens, bm, k = _case(2, n_err_max=8, dens=0.2, n_reads=200)
    j, _ = _stage_a_both(a, c, lens, bm, k)
    asc = np.asarray(j[0])
    args = _bbt_args(kind, rightward, k, asc, lens, *j[1:5])
    kw = dict(k=k, rightward=rightward, is_modify_trimmed=(kind == "end"))
    jargs = [jnp.asarray(x) for x in (asc, lens, *args)]
    want = jdev._bbt_batch(jargs[0], jargs[1], jdev.bitmap_device(bm),
                           *jargs[2:], **kw)
    got = tdev._bbt_impl(_t(asc), _t(lens), tdev.bitmap_device(bm, "cpu"),
                         *[_t(x) for x in args], **kw)
    _same(want, got, ["ascii", "num", "len_need_trim", "last_change",
                      "overflow"])
    assert np.asarray(want[1]).sum() > 0
    assert np.asarray(want[4]).any()         # some beam overflowed


@pytest.mark.parametrize("rightward", [True, False])
def test_bbt_compact(rightward):
    """Compaction with more active rows than compact rows: the rows past
    the first compact_c active ones are flagged, the rest scattered back."""
    a, c, lens, bm, k = _case(3, n_err_max=6, dens=0.1, n_reads=160)
    j, _ = _stage_a_both(a, c, lens, bm, k)
    asc = np.asarray(j[0])
    args = _bbt_args("end", rightward, k, asc, lens, *j[1:5])
    assert args[0].sum() > 16
    jw = jdev.bitmap_device(bm)
    kw = dict(k=k, rightward=rightward, is_modify_trimmed=True, compact_c=16)
    want = jdev._bbt_compact(jnp.asarray(asc), jnp.asarray(lens),
                             lambda idx: jdev._probe(jw, idx),
                             *[jnp.asarray(x) for x in args],
                             probe_word=lambda widx: jw[widx], **kw)
    got = tdev._bbt_compact(_t(asc), _t(lens), tdev.bitmap_device(bm, "cpu"),
                            *[_t(x) for x in args], **kw)
    _same(want, got, ["ascii", "num", "len_need_trim", "last_change",
                      "overflow"])
    assert np.asarray(want[4]).sum() >= args[0].sum() - 16


def test_max_combined_ties():
    """Equal combined lengths in one row: both take the first maximum."""
    rng = np.random.default_rng(5)
    N, H = 400, jdev.H_MAX
    num_h = rng.integers(0, H + 1, N).astype(np.int32)
    hs1 = np.sort(rng.integers(1, 60, (N, H)), axis=1).astype(np.int32)
    hs1[::2] = np.arange(H)[None, :] * 10 + 1          # equal spacing ...
    he1 = (hs1 + rng.integers(0, 4, (N, H))).astype(np.int32)
    he1[::2] = hs1[::2] + 5                            # ... equal lengths
    fail = rng.random((N, H)) < 0.4
    h_ok = np.arange(H)[None, :] < num_h[:, None]
    hs1, he1 = np.where(h_ok, hs1, 0), np.where(h_ok, he1, 0)
    want = jdev._max_combined(*map(jnp.asarray, (hs1, he1, num_h, fail)))
    got = tdev._max_combined(*map(_t, (hs1, he1, num_h, fail)))
    _same(want, got, ["max_start", "max_end"])


def _after_stage_a(seed, dens):
    a, c, lens, bm, k = _case(seed, n_err_max=8, dens=dens, n_reads=200,
                              ragged=True)
    j, _ = _stage_a_both(a, c, lens, bm, k)
    return lens, bm, k, j


@pytest.mark.parametrize("i,compact_c", [(0, None), (0, 32), (1, 32)])
def test_wave_step(i, compact_c):
    lens, bm, k, (asc, one, hs1, he1, num_h, fb) = _after_stage_a(1, 0.15)
    N = len(lens)
    fail = np.zeros((N, jdev.H_MAX), bool)
    state = [np.asarray(x) for x in (asc, one, np.zeros(N, np.int32), fail,
                                     fb)]
    common = [np.asarray(x) for x in (hs1, he1, num_h)]
    want = jdev._wave_step(jnp.asarray(state[0]), jnp.asarray(lens),
                           jdev.bitmap_device(bm),
                           *map(jnp.asarray, common),
                           *map(jnp.asarray, state[1:]), jnp.int32(i),
                           jnp.int32(2), k=k, compact_c=compact_c)
    got = tdev._wave_step(_t(state[0]), _t(lens),
                          tdev.bitmap_device(bm, "cpu"), *map(_t, common),
                          *map(_t, state[1:]), i, 2, k=k,
                          compact_c=compact_c)
    _same(want, got, ["ascii", "accum", "multi", "fail", "fallback"])
    if i == 0:
        assert (np.asarray(want[2]) > 0).any() and np.asarray(want[3]).any()


@pytest.mark.parametrize("compact_c", [None, 32])
def test_phase5(compact_c):
    lens, bm, k, (asc, one, hs1, he1, num_h, fb) = _after_stage_a(2, 0.15)
    N = len(lens)
    jw = jdev.bitmap_device(bm)
    common = [np.asarray(x) for x in (hs1, he1, num_h)]
    # the state after gap wave 0, so that some gaps failed
    asc, accum, multi, fail, fb = (np.asarray(x) for x in jdev._wave_step(
        asc, jnp.asarray(lens), jw, *map(jnp.asarray, common), one,
        jnp.zeros(N, jnp.int32), jnp.zeros((N, jdev.H_MAX), bool), fb,
        jnp.int32(0), jnp.int32(2), k=k))
    assert fail.any()
    p = _params(k)[0].resolved()
    kw = dict(k=k, mc=2, ft=p.further_trim, min_len=p.min_read_len,
              compact_c=compact_c)
    state = (accum, multi, fail, fb)
    want = jdev._phase5(jnp.asarray(asc), jnp.asarray(lens), jw,
                        *map(jnp.asarray, common + list(state)), **kw)
    got = tdev._phase5(_t(asc), _t(lens), tdev.bitmap_device(bm, "cpu"),
                       *map(_t, common + list(state)), **kw)
    _same(want, got, ["ascii", "multi", "deleted", "trim_left",
                      "trim_right", "fallback"])
    assert np.asarray(want[5]).sum() > np.asarray(fb).sum()


OUTS = ["one", "multi", "deleted", "trim_left", "trim_right", "ascii",
        "fallback"]


@pytest.mark.parametrize("seed,n_err,dens,ragged", [
    (1, 4, 0.0, False), (2, 4, 0.0, False), (3, 4, 0.0, False),
    (4, 4, 0.0, False), (1, 10, 0.1, True), (2, 6, 0.25, True)])
def test_correct_batch_device(seed, n_err, dens, ragged):
    """The seven outputs, fallback flags included, on the same arrays."""
    a, c, lens, bm, k = _case(seed, n_err, dens, n_reads=300, ragged=ragged)
    jp, tp = _params(k)
    want = jdev.correct_batch_device(a.copy(), c, lens,
                                     jdev.bitmap_device(bm), jp)
    got = tdev.correct_batch_device(a.copy(), c, lens,
                                    tdev.bitmap_device(bm, "cpu"), tp)
    _same(want, got, OUTS)
    if dens:
        assert want[6].any()


def test_unroll_1_vs_8():
    """Reading the loop's flag every trip or every 8 trips: same outputs,
    fewer host reads."""
    a, c, lens, bm, k = _case(4, 8, 0.15, n_reads=200, ragged=True)
    tw = tdev.bitmap_device(bm, "cpu")
    res = {}
    for u in (1, 8):
        tdev.reset_counts()
        res[u] = tdev.correct_batch_device(a.copy(), c, lens, tw,
                                           _params(k)[1], unroll=u), \
            dict(tdev.counts)
    _same(res[1][0], res[8][0], OUTS)
    assert res[8][1]["host_reads"] < res[1][1]["host_reads"]
    assert res[8][1]["trips"] >= res[1][1]["trips"]


def test_scatter_destinations_distinct(monkeypatch):
    """Every masked write of the engine names distinct elements, so no
    result depends on index_put_'s order for duplicates."""
    calls = []
    put = tdev._put

    def checked(dst, index, vals):
        lin = index[0].to(torch.int64)
        if len(index) == 2:
            lin = lin * dst.shape[1] + index[1]
        assert lin.unique().numel() == lin.numel(), "duplicate destination"
        calls.append(lin.numel())
        put(dst, index, vals)

    monkeypatch.setattr(tdev, "_put", checked)
    for seed, dens in ((1, 0.0), (2, 0.1), (3, 0.25)):
        a, c, lens, bm, k = _case(seed, 8, dens, n_reads=300, ragged=True)
        tdev.correct_batch_device(a, c, lens, tdev.bitmap_device(bm, "cpu"),
                                  _params(k)[1])
    assert len(calls) > 20 and sum(calls) > 100


def test_read_length_guard():
    L = 1023
    a = np.full((2, L), ord("A"), np.uint8)
    args = [np.full(2, 1, np.int32) for _ in range(5)]
    args[0] = np.ones(2, bool)
    with pytest.raises(ValueError) as jerr:
        jdev._bbt_impl(jnp.asarray(a), jnp.full(2, L, jnp.int32), None,
                       *map(jnp.asarray, args), k=K, rightward=True,
                       is_modify_trimmed=False)
    with pytest.raises(ValueError, match="max 1022") as terr:
        tdev._bbt_impl(_t(a), torch.full((2,), L), torch.zeros(8,
                       dtype=torch.int32), *map(_t, args), k=K,
                       rightward=True, is_modify_trimmed=False)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- host side
@pytest.mark.parametrize("seed,dens", [(1, 0.0), (2, 0.1)])
def test_read_corrector(seed, dens):
    a, c, lens, bm, k = _case(seed, 8, dens, n_reads=150, ragged=True)
    bits = jeng.classify_regions_batch(c, lens, bm, k)
    np.testing.assert_array_equal(
        bits, teng.classify_regions_batch(c, lens, bm, k))
    jp, tp = _params(k)
    jc, tc = jeng.ReadCorrector(bm, jp), teng.ReadCorrector(bm, tp)
    for i in range(len(lens)):
        L = int(lens[i])
        if L < k:
            continue
        b = bits[i, :L - k + 1]
        assert jeng._regions_from_bits(b) == teng._regions_from_bits(b)
        rj, rt = (bytearray(a[i, :L].tobytes()) for _ in range(2))
        assert jc.correct_one_read(rj, b) == tc.correct_one_read(rt, b)
        assert rj == rt


def test_expand_bitmap_rc_and_cz(tmp_path):
    _, _, _, bm, _ = _case(1)
    rng = np.random.default_rng(1)
    raw = np.packbits(rng.random(bm.size * 8) < 0.01)
    np.testing.assert_array_equal(jkc.expand_bitmap_rc(raw, K),
                                  tkc.expand_bitmap_rc(raw, K))
    empty = np.zeros_like(raw)
    np.testing.assert_array_equal(tkc.expand_bitmap_rc(empty, K), empty)
    jcz.write_cz_bits(str(tmp_path / "t.cz"), raw)
    np.testing.assert_array_equal(
        tcz.read_cz_bits(str(tmp_path / "t.cz"), K),
        jcz.read_cz_bits(str(tmp_path / "t.cz"), K))
    freqs = rng.integers(0, 256, 4 ** 12).astype(np.uint8)
    jcz.write_cz_bytes(str(tmp_path / "t8.cz"), freqs)
    np.testing.assert_array_equal(
        tcz.read_cz_bytes(str(tmp_path / "t8.cz"), 12), freqs)
    np.testing.assert_array_equal(
        tpipe.load_bitmap_8bit(str(tmp_path / "t8.cz"), 12, 200),
        jpipe.load_bitmap_8bit(str(tmp_path / "t8.cz"), 12, 200))


def _write_reads(path, seqs, fasta=False, gz=False):
    out = b""
    for i, s in enumerate(seqs):
        out += (b">r%d desc\n%s\n" % (i, s) if fasta
                else b"@r%d/1\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(out)
    else:
        with open(path, "wb") as f:
            f.write(out)


def _odd_reads(seed=7, n=60):
    """_make_case reads plus reads shorter than k, reads with N and a
    lower-case read."""
    a, _, _, bm = _make_case(seed, n_reads=n)
    seqs = [r.tobytes() for r in a]
    seqs[3] = seqs[3][:K - 1]
    seqs[4] = seqs[4][:K]
    seqs[5] = b""
    seqs[6] = seqs[6][:20] + b"N" + seqs[6][21:]
    seqs[7] = seqs[7][:50] + b"NN" + seqs[7][52:70]
    seqs[8] = seqs[8].lower()
    return seqs, bm


@pytest.mark.parametrize("fasta", [False, True])
def test_read_batch_heads_and_bytes(tmp_path, fasta):
    seqs, _ = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    for kw in ({}, {"strict_n": True}, {"max_len": 50}):
        j = jfq.read_batch(path, keep_ascii=True, **kw)
        t = tfq.read_batch(path, keep_heads=True, keep_ascii=True, **kw)
        for name in ("codes", "quals", "lengths", "seqs_ascii"):
            np.testing.assert_array_equal(getattr(j, name),
                                          getattr(t, name), err_msg=name)
        assert j.heads == t.heads and len(t.heads) == len(seqs)
    # the defaults are JAX's: headers kept, no ASCII plane
    j, t = jfq.read_batch(path), tfq.read_batch(path)
    assert t.heads == j.heads and len(t.heads) == len(seqs)
    assert t.seqs_ascii is None and j.seqs_ascii is None
    t = tfq.read_batch(path, keep_heads=False)
    assert t.heads == [] == jfq.read_batch(path, keep_heads=False).heads


def _outputs(path):
    with gzip.open(path + ".correct.fa.gz") as f:
        fa = f.read()
    with open(path + ".correct.stat", "rb") as f:
        return fa, f.read()


@pytest.mark.parametrize("fasta", [False, True])
def test_correct_file(tmp_path, fasta):
    """correct_file on the port's three engines (torch on the CPU) against
    the JAX package's jax and native engines."""
    seqs, bm = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    fmt = 2 if fasta else 1
    want = {}
    for engine in ("jax", "native"):
        jpipe.correct_file(path, bm, PARAMS, fmt=fmt, engine=engine)
        want[engine] = _outputs(path)
    assert want["jax"] == want["native"]
    assert b"IsDeleted: 1" in want["jax"][0]
    for engine in ("torch", "native", "python"):
        tpipe.correct_file(path, bm, TPARAMS, fmt=fmt, engine=engine,
                           device="cpu")
        assert _outputs(path) == want["jax"], engine
    tdev.reset_counts()
    tpipe.correct_file(path, bm, TPARAMS, fmt=fmt, device="cpu", chunk=16)
    assert _outputs(path) == want["jax"]
    assert tdev.counts["batches"] == -(-len(seqs) // 16)


@pytest.mark.parametrize("fasta", [False, True])
def test_correct_file_all_rows_fall_back(tmp_path, monkeypatch, fasta):
    """Every row the device engine returns flagged: the host fallback
    re-runs each from its original read, the reads shorter than k and the
    empty one among them, and writes the JAX package's bytes."""
    seqs, bm = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    fmt = 2 if fasta else 1
    jpipe.correct_file(path, bm, PARAMS, fmt=fmt, engine="jax")
    want = _outputs(path)
    real = tdev.correct_batch_device

    def flag_all(*a, **kw):
        out = real(*a, **kw)
        return out[:-1] + (np.ones(len(out[-1]), bool),)
    monkeypatch.setattr(tdev, "correct_batch_device", flag_all)
    tdev.reset_counts()
    spans.reset()
    tpipe.correct_file(path, bm, TPARAMS, fmt=fmt, device="cpu", chunk=16)
    assert _outputs(path) == want
    assert tdev.counts["fallback"] == len(seqs)
    assert [r.counts["rows"] for r in spans.records()
            if r.name == "correct.fallback"] == [16, 16, 16, 12]


@pytest.mark.parametrize("fasta", [False, True])
def test_correct_file_8bit(tmp_path, fasta):
    """correct_error's per-file step on reads shorter than k, an empty
    read, reads with N and deleted reads: the JAX package's .cor and
    .cor.stat."""
    seqs, bm = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    fmt = 2 if fasta else 1
    out = {}
    for pipe, params in ((jpipe, PARAMS), (tpipe, TPARAMS)):
        pipe.correct_file_8bit(path, bm, params, fmt)
        with gzip.open(path + ".cor") as f, open(path + ".cor.stat",
                                                 "rb") as g:
            out[pipe] = f.read(), g.read()
    assert out[tpipe] == out[jpipe]
    assert b"num_deleted_reads 0\n" not in out[jpipe][1]
    assert b"\n\n" in out[jpipe][0]             # a deleted read's line


@pytest.mark.parametrize("fasta", [False, True])
def test_correct_file_gz_chunks(tmp_path, monkeypatch, fasta):
    """correct_file's .correct.fa.gz deflated in chunks of 1 KiB on three
    workers, so the fixture's output takes gz_write_bytes's pool: its
    bytes decompressed are still the JAX package's."""
    seqs, bm = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    fmt = 2 if fasta else 1
    jpipe.correct_file(path, bm, PARAMS, fmt=fmt, engine="native")
    want = _outputs(path)
    monkeypatch.setattr(tfq, "GZ_CHUNK", 1024)
    monkeypatch.setattr(tfq.os, "sched_getaffinity",
                        lambda pid: set(range(3)))
    spans.reset()
    tpipe.correct_file(path, bm, TPARAMS, fmt=fmt, device="cpu")
    assert _outputs(path) == want
    [gz] = [r.counts for r in spans.records() if r.name == "io.gzip"]
    assert gz["chunks"] > 1 and gz["workers"] == 3


@pytest.mark.parametrize("fasta", [False, True])
def test_correct_file_positional_args(tmp_path, fasta):
    """correct_file(path, bitmap, params, fmt, engine, mesh) called
    positionally in JAX's order: the mesh binds as the mesh (the port's
    device, words and chunk come after it), and the files are JAX's."""
    seqs, bm = _odd_reads()
    path = str(tmp_path / ("r.fa" if fasta else "r.fq.gz"))
    _write_reads(path, seqs, fasta=fasta, gz=not fasta)
    fmt = 2 if fasta else 1
    jpipe.correct_file(path, bm, PARAMS, fmt, "native", None)
    want = _outputs(path)
    tdev.reset_counts()
    tpipe.correct_file(path, bm, TPARAMS, fmt, "torch",
                       tmesh.data_mesh(2, "cpu"))
    assert tdev.counts["batches"] > 0
    assert _outputs(path) == want


def _library(root, name):
    d = os.path.join(root, name)
    os.makedirs(d)
    return write_lib(d, genome_len=6000, read_len=100, depth=12.0, seed=5,
                     err_end=0.03)


def _files(lib, suffixes):
    out = {}
    files = [ln.strip() for ln in open(lib) if ln.strip()]
    for f in files:
        for suf in suffixes:
            p = f + suf
            if not os.path.exists(p):
                continue
            with (gzip.open(p) if p.endswith((".gz", ".cor")) else
                  open(p, "rb")) as h:
                out[os.path.basename(p)] = h.read()
    return out


def test_cli_correct_error_reads(tmp_path):
    """correct_error_reads -j 1 on a two-file library: the port's CLI (torch
    engine on the CPU) against the JAX package's CLI."""
    root = str(tmp_path)
    libs = {n: _library(root, n) for n in ("jax", "torch")}
    from dbg_assembly_tpu.kmer import kmerfreq as jkf
    jkf.run(libs["jax"], ksize=K, low_freq_cutoff=1)
    shutil.copy(libs["jax"] + ".kmer.freq.cz", libs["torch"] + ".kmer.freq.cz")
    shutil.copy(libs["jax"] + ".kmer.freq.cz.len",
                libs["torch"] + ".kmer.freq.cz.len")
    argv = ["correct_error_reads", "-k", str(K), "-r", "60", "-j", "1"]
    jcli.main(argv + [libs["jax"] + ".kmer.freq.cz", libs["jax"]])
    tdev.reset_counts()
    tcli.main(argv + ["--device", "cpu", libs["torch"] + ".kmer.freq.cz",
                      libs["torch"]])
    assert tdev.counts["batches"] == 2
    sufs = [".correct.fa.gz", ".correct.stat", ".correct.fa.gz.pair.fa.gz",
            ".correct.fa.gz.single.fa.gz", ".correct.fa.gz.pair.single.stat"]
    want, got = _files(libs["jax"], sufs), _files(libs["torch"], sufs)
    assert len(want) == 7 and got == want
    # the sharded corrector (--mesh) writes the same files over them
    tcli.main(argv + ["--mesh", "2", "--device", "cpu",
                      libs["torch"] + ".kmer.freq.cz", libs["torch"]])
    assert _files(libs["torch"], sufs) == want


def test_run_positional_args(tmp_path):
    """correct/pipeline.run(cz, lib, params, fmt, engine, mesh_devices)
    called positionally in JAX's order, the port's device after it: the
    JAX package's .correct.fa.gz and .correct.stat files."""
    root = str(tmp_path)
    libs = {n: _library(root, n) for n in ("jax", "torch")}
    from dbg_assembly_tpu.kmer import kmerfreq as jkf
    jkf.run(libs["jax"], ksize=K, low_freq_cutoff=1)
    cz = libs["jax"] + ".kmer.freq.cz"
    jpipe.run(cz, libs["jax"], PARAMS, 1, "native", 0)
    tpipe.run(cz, libs["torch"], TPARAMS, 1, "torch", 2, "cpu")
    sufs = [".correct.fa.gz", ".correct.stat"]
    want, got = _files(libs["jax"], sufs), _files(libs["torch"], sufs)
    assert len(want) == 4 and got == want


def test_cli_correct_error_8bit(tmp_path):
    """correct_error (8-bit table written by the JAX package's
    write_cz_bytes) through both CLIs."""
    root = str(tmp_path)
    libs = {n: _library(root, n) for n in ("jax", "torch")}
    rng = np.random.default_rng(9)
    freqs = np.zeros(4 ** K, np.uint8)
    kmers = []
    for line in open(libs["jax"]):
        b = jfq.read_batch(line.strip())
        km = jdna.rolling_kmers(b.codes, K).reshape(-1)
        kmers.append(np.minimum(km, jdna.revcomp_kbit(km, K)))
    u, cnt = np.unique(np.concatenate(kmers), return_counts=True)
    freqs[u.astype(np.int64)] = np.minimum(cnt + rng.integers(0, 3, len(u)),
                                           255)
    for name in libs:
        jcz.write_cz_bytes(os.path.join(root, name, "t8.cz"), freqs)
    argv = ["correct_error", "-k", str(K), "-l", "3"]
    jcli.main(argv + [os.path.join(root, "jax", "t8.cz"), libs["jax"]])
    tcli.main(argv + [os.path.join(root, "torch", "t8.cz"), libs["torch"]])
    sufs = [".cor", ".cor.stat", ".cor.pair.fa.gz", ".cor.single.fa.gz",
            ".cor.pair.single.stat"]
    want, got = _files(libs["jax"], sufs), _files(libs["torch"], sufs)
    assert len(want) == 7 and got == want


# ----------------------------------------------------------------- on card
@pytest.mark.gpu
def test_device_engine_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the torch engine runs on the CPU here")
    for seed, dens in ((1, 0.0), (2, 0.25)):
        a, c, lens, bm, k = _case(seed, 8, dens, n_reads=300, ragged=True)
        tp = _params(k)[1]
        want = tdev.correct_batch_device(a, c, lens,
                                         tdev.bitmap_device(bm, "cpu"), tp)
        got = tdev.correct_batch_device(a, c, lens,
                                        tdev.bitmap_device(bm, "cuda"), tp)
        _same(want, got, OUTS)
