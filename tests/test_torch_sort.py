"""The key sort (ops/sort.py): sort_plain against the JAX package's Pallas
sort sort_u64_via_pallas (interpret mode on the CPU) and against numpy's
stable argsort; the sentinel's place at key_bits = 2k + 1; the wrapper's
checks; and the four key sorts of counting and ingest going through it.
Exact equality throughout."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dbg_assembly_tpu.ops import pallas_sort as ps
from dbg_assembly_tpu_torch.ops import sort as srt

SENT = np.int64(np.iinfo(np.int64).max)


def _keys(seed: int, n: int, bits: int, sentinels: int = 0,
          distinct: int | None = None) -> np.ndarray:
    """n keys < 2^bits (drawn from `distinct` values when given, so there
    are many ties), with `sentinels` of them replaced by INT64_MAX."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        keys = rng.integers(0, 1 << bits, n, dtype=np.int64)
    else:
        pool = rng.integers(0, 1 << bits, distinct, dtype=np.int64)
        keys = pool[rng.integers(0, distinct, n)]
    keys[rng.choice(n, sentinels, replace=False)] = SENT
    return keys


@pytest.mark.parametrize("n,r_log", [(1000, 0), (5000, 1)])
def test_sort_plain_matches_pallas_sort(n, r_log):
    keys = _keys(n, n, 62, sentinels=n // 50, distinct=n // 3)
    want = np.asarray(ps.sort_u64_via_pallas(
        jnp.asarray(keys.view(np.uint64)), r_log=r_log))
    got, idx = srt.sort(torch.from_numpy(keys), 63)
    assert idx is None
    assert np.array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("bits", [5, 34, 35, 62])
def test_index_is_stable_argsort(bits):
    keys = _keys(bits, 4000, bits, distinct=300)
    got, idx = srt.sort(torch.from_numpy(keys), bits, return_index=True)
    order = np.argsort(keys, kind="stable")
    assert idx.dtype == torch.int64
    assert np.array_equal(idx.numpy(), order)
    assert np.array_equal(got.numpy(), keys[order])


@pytest.mark.parametrize("k", [16, 17, 31])
def test_sentinel_sorts_last_at_2k_plus_1_bits(k):
    keys = _keys(100 + k, 3000, 2 * k, sentinels=400, distinct=700)
    got, idx = srt.sort(torch.from_numpy(keys), 2 * k + 1, return_index=True)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(got.numpy(), keys[order])
    assert np.array_equal(idx.numpy(), order)
    assert (got.numpy()[-400:] == SENT).all()
    assert (got.numpy()[:-400] < (1 << (2 * k))).all()


def test_orders_by_the_low_key_bits():
    # at 34 bits the sentinel's low bits equal 2^34 - 1: the two tie and
    # keep their input order, as the kernel orders them
    keys = np.array([SENT, (1 << 34) - 1, 5, SENT, 0], np.int64)
    got, idx = srt.sort(torch.from_numpy(keys), 34, return_index=True)
    assert idx.tolist() == [4, 2, 0, 1, 3]
    assert got.tolist() == keys[[4, 2, 0, 1, 3]].tolist()


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs(n):
    keys = torch.arange(n, dtype=torch.int64).flip(0)
    got, idx = srt.sort(keys, 2, return_index=True)
    assert got.tolist() == list(range(n))
    assert idx.tolist() == list(range(n))[::-1]


def test_input_is_not_modified():
    keys = _keys(3, 500, 20, sentinels=10)
    t = torch.from_numpy(keys.copy())
    srt.sort(t, 21, return_index=True)
    assert np.array_equal(t.numpy(), keys)


def test_passes():
    assert [srt.passes(b) for b in (1, 8, 9, 34, 35, 62, 63)] == \
        [1, 1, 2, 5, 5, 8, 8]


@pytest.mark.parametrize("bad", ["dtype", "rank", "strided", "bits0",
                                 "bits64", "device"])
def test_wrapper_rejects(bad):
    keys = torch.arange(16, dtype=torch.int64)
    bits = 8
    if bad == "dtype":
        keys = keys.to(torch.int32)
    elif bad == "rank":
        keys = keys.reshape(4, 4)
    elif bad == "strided":
        keys = keys[::2]
    elif bad == "bits0":
        bits = 0
    elif bad == "bits64":
        bits = 64
    elif bad == "device":
        # neither a CPU nor a CUDA tensor: no plain fallback is taken
        keys = keys.to("meta")
    with pytest.raises((ValueError, TypeError)):
        srt.sort(keys, bits)


def test_cpu_tensor_runs_plain_and_launches_nothing():
    before = srt.launches
    keys = torch.from_numpy(_keys(4, 1000, 30))
    got, idx = srt.sort(keys, 30, return_index=True)
    want, widx = srt.sort_plain(keys, 30, return_index=True)
    assert torch.equal(got, want) and torch.equal(idx, widx)
    assert srt.launches == before


def test_counting_and_ingest_sort_through_the_wrapper(monkeypatch):
    """All four key sorts of counting and ingest call ops.sort.sort, with
    2k + 1 bits where the sentinel can appear and 2k in the merges."""
    from dbg_assembly_tpu_torch.contig.graph import GraphBuilder
    from dbg_assembly_tpu_torch.kmer.count import KmerCounter
    calls = []
    real = srt.sort

    def spy(keys, key_bits, return_index=False):
        calls.append((key_bits, return_index))
        return real(keys, key_bits, return_index)

    monkeypatch.setattr(srt, "sort", spy)
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (40, 60)).astype(np.uint8)
    lengths = np.full(40, 60, np.int32)
    kc = KmerCounter(17, batch_reads=5, device="cpu")
    kc.add(codes, lengths)
    kc.finalize()
    assert (35, False) in calls and (34, True) in calls
    calls.clear()
    gb = GraphBuilder(31, batch_reads=5, device="cpu")
    gb.add(codes, lengths)
    gb.finalize()
    assert (63, True) in calls and (62, True) in calls
    assert all(c in ((63, True), (62, True)) for c in calls)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,index", [(35, False), (63, True),
                                        (34, True), (62, True)])
def test_kernel_matches_plain_on_card(bits, index):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the radix sort kernel has no CPU "
                    "mode")
    sent = 1000 if bits % 2 else 0
    keys = torch.from_numpy(_keys(bits, 100_003, bits - bits % 2,
                                  sentinels=sent, distinct=5000)).cuda()
    before = srt.launches
    got, idx = srt.sort(keys, bits, index)
    torch.cuda.synchronize()
    assert srt.launches == before + 1
    want, widx = srt.sort_plain(keys, bits, index)
    assert torch.equal(got, want)
    assert (idx is None) == (widx is None)
    if index:
        assert torch.equal(idx, widx)


@pytest.mark.gpu
@pytest.mark.parametrize("at", ["tile-1", "tile", "tile+1", "3*tile+17"])
@pytest.mark.parametrize("index", [False, True])
def test_kernel_at_tile_boundaries_on_card(at, index):
    """The one-sweep kernel's ragged last tile and its look-back across
    one, two and four tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the radix sort kernel has no CPU "
                    "mode")
    tile = srt.tile()
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "3*tile+17": 3 * tile + 17}[at]
    keys = torch.from_numpy(_keys(n, n, 62, sentinels=n // 100,
                                  distinct=n // 4)).cuda()
    got, idx = srt.sort(keys, 63, index)
    torch.cuda.synchronize()
    want, widx = srt.sort_plain(keys, 63, index)
    assert torch.equal(got, want)
    assert (idx is None) == (widx is None)
    if index:
        assert torch.equal(idx, widx)
