"""The 1-bit table's reverse-complement expand on the device
(dbg_assembly_tpu_torch/ops/rc_expand.py) and the correction run that uses
it, against the JAX package's host expand and correction files, exactly.

On the CPU the wrapper runs its plain twin; the gpu-marked cases hold the
CUDA kernel against the twin and the numpy expand on the card.
"""

import numpy as np
import pytest
import torch

from dbg_assembly_tpu.correct import pipeline as jpipe
from dbg_assembly_tpu.io import cz as jcz
from dbg_assembly_tpu.kmer import count as jkc
from dbg_assembly_tpu.kmer import kmerfreq as jkf
from dbg_assembly_tpu_torch import dna, spans
from dbg_assembly_tpu_torch.correct import device as tdev
from dbg_assembly_tpu_torch.correct import pipeline as tpipe
from dbg_assembly_tpu_torch.io import cz as tcz
from dbg_assembly_tpu_torch.kmer import count as tkc
from dbg_assembly_tpu_torch.ops import rc_expand as rce
from test_torch_correct import K, PARAMS, TPARAMS, _files, _library

SUFFIXES = [".correct.fa.gz", ".correct.stat"]


def _table(kind: str, k: int, seed: int = 0) -> np.ndarray:
    """A raw (not rc-closed) table of 4^k/8 bytes."""
    rng = np.random.default_rng(seed + k)
    n = 4 ** k
    if kind == "sparse":
        return np.packbits(rng.random(n) < 0.02)
    if kind == "empty":
        return np.zeros(n // 8, np.uint8)
    if kind == "ones_word":
        t = np.packbits(rng.random(n) < 0.001)
        t[4:8] = 0xFF                    # all 32 bits of word 1
        t[-4:] = 0xFF                    # and of the last word
        return t
    if kind == "palindromes":
        # every rc-palindrome (even k) and a few k-mers that are not
        idx = np.arange(n, dtype=np.uint64)
        pal = idx[dna.revcomp_kbit(idx, k) == idx]
        assert len(pal) == 4 ** (k // 2)
        t = np.zeros(n // 8, np.uint8)
        tkc.bitmap_set(t, np.concatenate(
            [pal, rng.integers(0, n, 20).astype(np.uint64)]))
        return t
    if kind == "full":
        return np.full(n // 8, 0xFF, np.uint8)
    raise ValueError(kind)


CASES = [("sparse", 3), ("sparse", 5), ("sparse", 9), ("sparse", 13),
         ("empty", 9), ("ones_word", 5), ("ones_word", 9),
         ("palindromes", 4), ("palindromes", 6), ("palindromes", 10),
         ("full", 3)]


@pytest.mark.parametrize("kind,k", CASES)
def test_plain_twin_matches_host_expand(kind, k):
    """The wrapper on a CPU tensor, and the plain twin, equal the port's
    and the JAX package's host expand, and leave the raw table as it
    was."""
    raw = _table(kind, k)
    keep = raw.copy()
    want = jkc.expand_bitmap_rc(raw, k)
    np.testing.assert_array_equal(tkc.expand_bitmap_rc(raw, k), want)
    words = tdev.bitmap_device(raw, "cpu")
    launched = rce.launches
    for fn in (rce.rc_expand, rce.rc_expand_plain):
        got = fn(words, k)
        assert got.dtype == torch.int32 and got.shape == words.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want)
        np.testing.assert_array_equal(raw, keep)
    assert rce.launches == launched          # no kernel on the CPU
    # closed under rc: expanding again changes nothing
    np.testing.assert_array_equal(
        rce.rc_expand(torch.from_numpy(want.view("<i4").copy()),
                      k).numpy().view(np.uint8), want)


def _bad(name):
    words = torch.zeros(4 ** 5 // 32, dtype=torch.int32)
    if name == "int64":
        return words.to(torch.int64), 5, TypeError
    if name == "uint8":
        return words.view(torch.uint8), 5, TypeError
    if name == "two_dims":
        return words.view(8, 4), 5, TypeError
    if name == "strided":
        return torch.zeros(2 * words.numel(), dtype=torch.int32)[::2], 5, \
            ValueError
    if name == "short":
        return words[:-1], 5, ValueError
    if name == "wrong_k":
        return words, 6, ValueError
    if name == "k_too_small":
        return torch.zeros(1, dtype=torch.int32), 2, ValueError
    raise ValueError(name)


@pytest.mark.parametrize("name", ["int64", "uint8", "two_dims", "strided",
                                  "short", "wrong_k", "k_too_small"])
def test_wrapper_raises(name):
    words, k, exc = _bad(name)
    for fn in (rce.rc_expand, rce.rc_expand_plain):
        with pytest.raises(exc):
            fn(words, k)


def test_cz_array_unchanged(tmp_path):
    """The table read from a .cz, uploaded and expanded on the CPU: the
    numpy array it was read into keeps the raw bits."""
    raw = _table("sparse", K)
    jcz.write_cz_bits(str(tmp_path / "t.cz"), raw)
    bits = tcz.read_cz_bits(str(tmp_path / "t.cz"), K)
    np.testing.assert_array_equal(bits, raw)
    words = tdev.bitmap_device(bits, "cpu")
    assert np.shares_memory(words.numpy(), bits)
    got = tpipe._expand_table(words, K)
    np.testing.assert_array_equal(bits, raw)
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  jkc.expand_bitmap_rc(raw, K))


def _libraries(root):
    """The same two-file library for the JAX package and the port, with
    the JAX package's kmerfreq table (canonical bits only) beside each."""
    libs = {n: _library(root, n) for n in ("jax", "torch")}
    jkf.run(libs["jax"], ksize=K, low_freq_cutoff=1)
    cz = libs["jax"] + ".kmer.freq.cz"
    raw = jcz.read_cz_bits(cz, K)
    # the raw table is not rc-closed, so a fallback that read it would
    # classify k-mers differently from one that reads the expanded table
    assert not np.array_equal(jkc.expand_bitmap_rc(raw, K), raw)
    jpipe.run(cz, libs["jax"], PARAMS, 1, "native", 0)
    return libs, cz


def _flag_all(monkeypatch):
    real = tdev.correct_batch_device

    def flag_all(*a, **kw):
        out = real(*a, **kw)
        return out[:-1] + (np.ones(len(out[-1]), bool),)
    monkeypatch.setattr(tdev, "correct_batch_device", flag_all)


def _run_torch(cz, lib, device):
    tdev.reset_counts()
    spans.reset()
    tpipe.run(cz, lib, TPARAMS, 1, "torch", 0, device)
    return {r.name: [x for x in spans.records() if x.name == r.name]
            for r in spans.records()}


@pytest.mark.parametrize("fallback", [True, False])
def test_run_host_table(tmp_path, monkeypatch, fallback):
    """run() on the torch engine (the table expanded on the device): the
    JAX package's files.  With every row forced to fall back, the host
    engine reads the device's expanded table, copied to the host once for
    the two files; with none, it is never copied."""
    libs, cz = _libraries(str(tmp_path))
    if fallback:
        _flag_all(monkeypatch)
    by = _run_torch(cz, libs["torch"], "cpu")
    assert _files(libs["torch"], SUFFIXES) == _files(libs["jax"], SUFFIXES)
    assert len(_files(libs["jax"], SUFFIXES)) == 4
    assert tdev.counts["batches"] == 2          # one a file
    assert tdev.counts["host_table"] == int(fallback)
    assert len(by.get("correct.host_table", [])) == int(fallback)
    if fallback:
        [ht] = by["correct.host_table"]
        assert ht.counts == {"bytes": 4 ** K // 8}
        assert tdev.counts["fallback"] > 0
    else:
        assert tdev.counts["fallback"] == 0
    [up], [ex] = by["correct.table_upload"], by["correct.table_expand"]
    assert ex.parent == up.index
    assert ex.counts == {"words": 4 ** K // 32, "launches": 0}
    [load] = by["correct.table_load"]
    assert load.counts["bytes"] == 4 ** K // 8 and up.parent != load.index


# ----------------------------------------------------------------- on card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: rc_expand runs its plain twin here")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sparse", "ones_word", "full"])
def test_kernel_matches_plain_on_card(kind):
    _card()
    raw = _table(kind, K)
    words = tdev.bitmap_device(raw, "cuda")
    want = rce.rc_expand_plain(words, K)
    launched = rce.launches
    got = rce.rc_expand(words.clone(), K)
    torch.cuda.synchronize()
    assert rce.launches == launched + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_matches_numpy_k17_on_card():
    """A k = 17 table (2 GiB) of about 6 M random canonical k-mers."""
    _card()
    k = 17
    rng = np.random.default_rng(17)
    idx = rng.integers(0, 4 ** k, 6_000_000).astype(np.uint64)
    can = np.minimum(idx, dna.revcomp_kbit(idx, k))
    raw = np.zeros(4 ** k // 8, np.uint8)
    tkc.bitmap_set(raw, can)
    want = tkc.expand_bitmap_rc(raw, k)
    got = rce.rc_expand(tdev.bitmap_device(raw, "cuda"), k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint8), want)


@pytest.mark.gpu
def test_run_host_table_on_card(tmp_path, monkeypatch):
    """The forced fallback of test_run_host_table with the table on the
    card: the JAX package's files, one copy of the table to the host."""
    _card()
    libs, cz = _libraries(str(tmp_path))
    _flag_all(monkeypatch)
    by = _run_torch(cz, libs["torch"], "cuda")
    assert _files(libs["torch"], SUFFIXES) == _files(libs["jax"], SUFFIXES)
    assert tdev.counts["host_table"] == 1
    assert len(by["correct.host_table"]) == 1
    assert by["correct.table_expand"][0].counts["launches"] == 1
