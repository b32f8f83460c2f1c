"""dbg_assembly_tpu_torch.dna against dbg_assembly_tpu.dna: the same codes
(made from a seed with numpy) through both, exact equality."""

import numpy as np
import pytest
import torch

from dbg_assembly_tpu import dna as jdna
from dbg_assembly_tpu_torch import dna as tdna

KS = [13, 16, 17, 21, 31]


def _codes(seed: int, k: int):
    """[N, L] codes 0..3 inside each read, pad 4 past it; some reads are
    shorter than k, some hold N (0 in the k-mer alphabet)."""
    rng = np.random.default_rng(seed)
    N, L = 50, 60
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (N, L))]
    codes = tdna.ascii_to_codes(ascii_)
    lengths = rng.integers(0, L + 1, N)
    lengths[:5] = rng.integers(0, k, 5)            # shorter than k
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_luts_match():
    buf = np.arange(256, dtype=np.uint8)
    for strict in (False, True):
        assert np.array_equal(tdna.ascii_to_codes(buf, strict),
                              jdna.ascii_to_codes(buf, strict))
    assert np.array_equal(tdna.BASES, jdna.BASES)
    assert np.array_equal(tdna.C_BASES, jdna.C_BASES)


@pytest.mark.parametrize("k", KS)
def test_rolling_kmers(k):
    codes = _codes(k, k)
    want = jdna.rolling_kmers(codes, k)
    got = tdna.rolling_kmers(torch.from_numpy(codes), k)
    assert got.dtype == torch.int64
    assert np.array_equal(_u64(got), want)
    assert np.array_equal(tdna.rolling_kmers(codes, k), want)


@pytest.mark.parametrize("k", KS)
def test_revcomp_and_canonical(k):
    # raw windows, pad 4 included: bits above 2k must not change the result
    km = jdna.rolling_kmers(_codes(100 + k, k), k)
    t = torch.from_numpy(km.view(np.int64))
    assert np.array_equal(_u64(tdna.revcomp_kbit(t, k)),
                          jdna.revcomp_kbit(km, k))
    assert np.array_equal(tdna.revcomp_kbit(km, k), jdna.revcomp_kbit(km, k))
    can_t, rc_t = tdna.canonical(t, k)
    can_j, rc_j = jdna.canonical(km, k)
    assert np.array_equal(_u64(can_t), can_j)
    assert np.array_equal(_u64(rc_t), rc_j)


@pytest.mark.parametrize("k", KS)
def test_seq2bit_bit2seq(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (20, k)).astype(np.uint8)
    packed = tdna.seq2bit(codes)
    assert np.array_equal(packed, jdna.seq2bit(codes))
    for v in packed[:5]:
        assert tdna.bit2seq(v, k) == jdna.bit2seq(v, k)


@pytest.mark.parametrize("k", [13, 31])
def test_seq2bit_takes_ksize(k):
    """seq2bit(codes, ksize), JAX's signature: ksize is accepted and
    unused in both."""
    codes = np.random.default_rng(k + 1).integers(0, 4, (7, 3, k)).astype(
        np.uint8)
    got = tdna.seq2bit(codes, k)
    assert got.dtype == np.uint64 and got.shape == (7, 3)
    assert np.array_equal(got, jdna.seq2bit(codes, k))
    assert np.array_equal(got, tdna.seq2bit(codes, ksize=None))
