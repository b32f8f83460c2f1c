"""The reference's stand-ins for the native helpers its replay called,
each against the program's native library on random inputs (the tests may
read the program; the reference may not)."""

import numpy as np
import pytest

from benchmark.reference import contig as ref


@pytest.fixture(scope="module")
def native():
    from dbg_assembly_tpu_torch import native as nat
    nat.lib()
    return nat


def test_revcomp_int():
    def plain(x, k):
        out = 0
        for _ in range(k):
            out = (out << 2) | (3 - (x & 3))
            x >>= 2
        return out
    rng = np.random.default_rng(1)
    for k in (1, 13, 17, 31, 32):
        for x in rng.integers(0, 1 << min(2 * k, 63), 2000).tolist():
            assert ref.revcomp_int(x, k) == plain(x, k)


def test_jenkins64_and_primes(native):
    x = np.random.default_rng(2).integers(0, 2 ** 63, 5000, dtype=np.int64)
    x = x.astype(np.uint64) * np.uint64(2) + np.uint64(1)
    assert (ref.jenkins64(x) == native.jenkins64(x)).all()
    for n in (2, 3, 4, 100, 1_000_000, 100_000_000, 2_147_483_647 + 1):
        assert ref.find_next_prime(n) == native.find_next_prime(n)


@pytest.mark.parametrize("load", [0.2, 0.6, 0.9, 0.999])
def test_hash_layout(native, load):
    """Dense tables too, where runs cross the table's end."""
    size = 10007
    wrapped = 0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        keys = np.unique(rng.integers(0, 2 ** 62, int(size * load),
                                      dtype=np.int64)).astype(np.uint64)
        rng.shuffle(keys)
        want, _ = native.hash_layout(keys, size)
        assert (ref.hash_layout(keys, size) == want).all()
        home = ref.jenkins64(keys) % np.uint64(size)
        wrapped += int(ref._runs(home.astype(np.int64))[1][-1] >= size)
    if load > 0.5:
        assert wrapped


def test_gcc44_sort(native):
    rng = np.random.default_rng(3)
    for n in (0, 1, 5, 16, 17, 100, 3000):
        lens = rng.integers(100, 130, n).astype(np.uint64)   # many ties
        assert ref.gcc44_sort_perm_desc(lens) == \
            native.gcc44_sort_perm_desc(lens).tolist()
