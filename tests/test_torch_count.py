"""Counting (kmer/count.py, kmer/kmerfreq.py) against the JAX package:
count_unique_fast under jit on the CPU, count_batch + merge_counted over
several batches, and the kmerfreq files byte for byte.  Exact equality."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dbg_assembly_tpu.kmer import count as jcount  # noqa: E402
from dbg_assembly_tpu.kmer import kmerfreq as jkf  # noqa: E402
from dbg_assembly_tpu_torch.kmer import count as tcount  # noqa: E402
from dbg_assembly_tpu_torch.kmer import kmerfreq as tkf  # noqa: E402
from dbg_assembly_tpu_torch.ops.chop import SENTINEL  # noqa: E402

import torch_port_data  # noqa: E402


def _reads(seed: int, N: int = 300, L: int = 80, k: int = 21):
    """Random reads with repeats (so runs have length > 1), ragged lengths
    and reads shorter than k."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    codes[N // 3: 2 * (N // 3)] = codes[:N // 3]
    lengths = rng.integers(k - 3, L + 1, N).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


@pytest.mark.parametrize("k", [17, 21, 31])
def test_count_unique_fast(k):
    codes, lengths = _reads(k, k=k)
    ju, jc, jn, jv = jcount.count_unique_fast(jnp.asarray(codes),
                                              jnp.asarray(lengths), k)
    tu, tc, tn, tv = tcount.count_unique_fast(torch.from_numpy(codes),
                                              torch.from_numpy(lengths), k)
    ju, jc = np.asarray(ju), np.asarray(jc)
    assert (tn, tv) == (int(jn), int(jv))
    # the masked runs sit at the same sorted positions in both
    tu = tu.numpy()
    assert np.array_equal(tu == SENTINEL, ju == jcount.SENTINEL)
    keep = ju != jcount.SENTINEL
    assert np.array_equal(tu[keep].view(np.uint64), ju[keep])
    assert np.array_equal(tc.numpy(), jc)


def test_kmer_counter_matches_count_batch_and_merge():
    k = 19
    codes, lengths = _reads(7, N=500, k=k)
    parts, total = [], 0
    for off in range(0, 500, 64):
        u, c, t = jcount.count_batch(codes[off:off + 64],
                                     lengths[off:off + 64], k)
        parts.append((u, c))
        total += t
    (ju, jc), = jcount.merge_counted(parts)
    kc = tcount.KmerCounter(k, batch_reads=64, device="cpu")
    kc.add(codes[:250], lengths[:250])
    kc.add(codes[250:], lengths[250:])
    tu, tc, tt = kc.finalize()
    assert tu.dtype == np.uint64 and tc.dtype == np.int64
    assert tt == total
    assert np.array_equal(tu, ju)
    assert np.array_equal(tc, jc)


def test_count_batch_and_merge_counted():
    k = 15
    codes, lengths = _reads(11, k=k)
    parts_j, parts_t = [], []
    for off in (0, 100, 200):
        cb, lb = codes[off:off + 100], lengths[off:off + 100]
        ju, jc, jt = jcount.count_batch(cb, lb, k)
        tu, tc, tt = tcount.count_batch(torch.from_numpy(cb),
                                        torch.from_numpy(lb), k)
        assert tt == jt
        assert np.array_equal(tu.numpy().view(np.uint64), ju)
        assert np.array_equal(tc.numpy(), jc)
        parts_j.append((ju, jc))
        parts_t.append((tu, tc))
    (ju, jc), = jcount.merge_counted(parts_j)
    (tu, tc), = tcount.merge_counted(parts_t)
    assert np.array_equal(tu.numpy().view(np.uint64), ju)
    assert np.array_equal(tc.numpy(), jc)


def test_spectrum_bitmap_helpers():
    rng = np.random.default_rng(2)
    k = 9
    uniq = np.unique(rng.integers(0, 1 << (2 * k), 500).astype(np.uint64))
    counts = rng.integers(1, 70000, len(uniq)).astype(np.int64)
    assert np.array_equal(tcount.spectrum(counts), jcount.spectrum(counts))
    bm = tcount.freq_bitmap(uniq, counts, k, 3)
    assert np.array_equal(bm, jcount.freq_bitmap(uniq, counts, k, 3))
    idx = rng.integers(0, 1 << (2 * k), 300).astype(np.uint64)
    assert np.array_equal(tcount.bitmap_get(bm, idx),
                          jcount.bitmap_get(bm, idx))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("kmerfreq")
    return torch_port_data.write_lib(str(d), genome_len=8000, depth=25.0,
                                     err_end=0.05)


@pytest.mark.parametrize("k,q", [(11, 0), (13, 0), (11, 20), (13, 20),
                                 (13, 15)])
def test_kmerfreq_files(lib, tmp_path, k, q):
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = jkf.run(lib, ksize=k, low_freq_cutoff=1, out_prefix=jp,
                 batch_reads=700, qual_cutoff=q)
    tr = tkf.run(lib, ksize=k, low_freq_cutoff=1, out_prefix=tp,
                 batch_reads=700, qual_cutoff=q, device="cpu")
    assert (tr["species"], tr["individuals"]) == (jr["species"],
                                                  jr["individuals"])
    for suf in (".cz", ".cz.len", ".stat"):
        with open(jp + suf, "rb") as a, open(tp + suf, "rb") as b:
            assert a.read() == b.read(), suf


def test_split_reads_by_quality():
    rng = np.random.default_rng(4)
    codes, lengths = _reads(4, N=60, k=11)
    quals = rng.integers(33, 75, codes.shape).astype(np.uint8)
    for cut in (0, 10, 30):
        a = jkf.split_reads_by_quality(codes, lengths, quals, 11, cut)
        b = tkf.split_reads_by_quality(codes, lengths, quals, 11, cut)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("k", [17, 31])
def test_chop_canonical_matches_jax(k, sort, monkeypatch):
    """chop_canonical(..., sort) == JAX's: sorted with the sentinels last,
    or (sort=False) row-major [N*P] with the sentinel at the invalid
    windows; the same n_valid; sort=False calls no sort."""
    codes, lengths = _reads(k + 5, k=k)
    jflat, jn = jcount.chop_canonical(jnp.asarray(codes),
                                      jnp.asarray(lengths), k, sort)
    calls = []
    real = tcount.radix.sort
    monkeypatch.setattr(tcount.radix, "sort",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tflat, tn = tcount.chop_canonical(torch.from_numpy(codes),
                                      torch.from_numpy(lengths), k, sort)
    assert len(calls) == int(sort)
    jflat, tflat = np.asarray(jflat), tflat.numpy()
    assert tflat.shape == jflat.shape == (codes.shape[0] *
                                          (codes.shape[1] - k + 1),)
    assert tn == int(jn) and 0 < tn < len(tflat)
    assert np.array_equal(tflat == SENTINEL, jflat == jcount.SENTINEL)
    keep = jflat != jcount.SENTINEL
    assert np.array_equal(tflat[keep].view(np.uint64), jflat[keep])
