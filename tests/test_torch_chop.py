"""The chop (ops/chop.py) against the JAX package's chops: the Pallas kernel
chop_canonical_pallas (interpret mode on the CPU) for counting, and
graph._chop_with_edges for ingest.  Exact equality; the Pallas kernel's
output is compared at valid windows only (it computes garbage past a
read's end, pallas_chop.py:85-88)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dbg_assembly_tpu.contig import graph as jgraph
from dbg_assembly_tpu.ops import pallas_chop as pc
from dbg_assembly_tpu_torch.ops import chop as ch

SENT = np.uint64(0x7FFFFFFFFFFFFFFF)


def _batch(seed: int, k: int, N: int = 64, L: int = 100):
    """Ragged reads: codes 0..3 inside, pad 4 past the length; some reads
    shorter than k, some exactly k, some full."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, N).astype(np.int32)
    lengths[:4] = [0, 1, k - 1, k]
    lengths[4:8] = L
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _valid(lengths, k, P):
    return np.arange(P)[None, :] < (lengths[:, None] - k + 1)


@pytest.mark.parametrize("k", [15, 16, 31])
def test_chop_plain_matches_pallas_kernel(k):
    from jax.experimental.pallas import tpu as pltpu
    codes, lengths = _batch(k, k)
    P = codes.shape[1] - k + 1
    assert P % 128 != 0
    with pltpu.force_tpu_interpret_mode():
        hi, lo = pc.chop_canonical_pallas(jnp.asarray(codes), k, block=32)
    want = np.asarray(pc.combine_u64(hi, lo))
    kmers, left, right = ch.chop(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k)
    assert left is None and right is None
    got = kmers.numpy().view(np.uint64)
    valid = _valid(lengths, k, P)
    assert np.array_equal(got[valid], want[valid])
    assert (got[~valid] == SENT).all()


@pytest.mark.parametrize("k", [16, 17, 31])
def test_edge_mode_matches_chop_with_edges(k):
    codes, lengths = _batch(100 + k, k, N=80, L=90)
    can, jl, jr, jvalid = map(np.asarray, jgraph._chop_with_edges(
        jnp.asarray(codes), jnp.asarray(lengths), k))
    kmers, left, right = ch.chop(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k, edges=True)
    valid = _valid(lengths, k, codes.shape[1] - k + 1)
    assert np.array_equal(valid, jvalid)
    got = kmers.numpy().view(np.uint64)
    assert np.array_equal(got[valid], can[valid])
    assert (got[~valid] == SENT).all()
    assert left.dtype == right.dtype == torch.uint8
    assert np.array_equal(left.numpy()[valid], jl[valid])
    assert np.array_equal(right.numpy()[valid], jr[valid])
    assert (left.numpy()[~valid] == 4).all()
    assert (right.numpy()[~valid] == 4).all()


@pytest.mark.parametrize("k", [11, 31])
def test_lengths_past_row_width_match_chop_with_edges(k):
    """A read longer than the row width L: its last window has a right
    neighbour past the row, which both strands read as code 0."""
    N, L = 64, 40 + k
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = np.full(N, L + 5, np.int32)
    lengths[::3] = L + 1
    can, jl, jr, jvalid = map(np.asarray, jgraph._chop_with_edges(
        jnp.asarray(codes), jnp.asarray(lengths), k))
    kmers, left, right = ch.chop(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k, edges=True)
    assert jvalid.all()
    fwd_last = np.zeros(N, np.uint64)
    for c in codes[:, -k:].T:
        fwd_last = (fwd_last << np.uint64(2)) | c.astype(np.uint64)
    rc_last = kmers.numpy()[:, -1].view(np.uint64) != fwd_last
    assert rc_last.any() and (~rc_last).any()      # both strands occur
    assert np.array_equal(kmers.numpy().view(np.uint64), can)
    assert np.array_equal(left.numpy(), jl)
    assert np.array_equal(right.numpy(), jr)


def _pack_words(raw: np.ndarray) -> np.ndarray:
    """csrc/chop.cu's packing: 16 code bytes -> a 32-bit half (pack4 is a
    multiply that gathers four 2-bit codes into the top byte), halves stored
    swapped so a little-endian 64-bit word holds 32 bases, first highest."""
    v = raw.view("<u4").astype(np.uint64)
    e = (((v & 0x03030303) * 0x40100401) & 0xFFFFFFFF) >> 24
    halves = (e[0::4] << 24 | e[1::4] << 16 | e[2::4] << 8
              | e[3::4]).astype(np.uint32)
    return halves.reshape(-1, 2)[:, ::-1].copy().view("<u8").ravel()


def _brev64(x: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(x.astype(">u8").view(np.uint8).reshape(-1, 8),
                         axis=1)
    return np.packbits(bits[:, ::-1], axis=1).view(">u8").ravel().astype(
        np.uint64)


def _n_tiles(N, L, k, rows, pw):
    """Tiles of an [N, L] batch under ch.tile_plan's numbering."""
    P = L - k + 1
    return -(-N // rows) if pw == P else N * -(-P // pw)


def _kernel_model(codes, lengths, k, edges, rows, pw, sh0=0, seed=0):
    """The CUDA kernel's tile walk and arithmetic in numpy (csrc/chop.cu):
    tiles from tile_plan, each tile's code span copied to a buffer at its
    address mod 16 (`sh0` is the codes array's own), bytes outside the span
    random, packed words, windows in output order by a funnel shift of two
    words and a bit-reversed reverse complement, outputs written once per
    window.  Returns (kmers, left, right, writes per window)."""
    rng = np.random.default_rng(seed)
    N, L = codes.shape
    P = L - k + 1
    u = np.uint64
    kmers = np.zeros(N * P, np.uint64)
    left = np.zeros(N * P, np.uint8)
    right = np.zeros(N * P, np.uint8)
    writes = np.zeros(N * P, np.int64)
    flat = codes.ravel()
    for t in range(_n_tiles(N, L, k, rows, pw)):
        if pw == P:
            row0, nr, j0, nwin, js = t * rows, min(rows, N - t * rows), 0, P, 0
            span = nr * L
        else:
            S = -(-P // pw)
            row0, nr, j0 = t // S, 1, (t % S) * pw
            nwin, js = min(pw, P - j0), max(j0 - 1, 0)
            span = min(L, j0 + nwin + k) - js
        g0 = row0 * L + js
        sh = (sh0 + g0) % 16
        raw = rng.integers(0, 256, (sh + span + 31) // 32 * 32 + 32).astype(
            np.uint8)
        raw[sh:sh + span] = flat[g0:g0 + span]
        pk = _pack_words(raw)
        f = np.arange(nr * nwin)
        r, j = f // nwin, j0 + f % nwin
        ln = lengths[row0 + r].astype(np.int64)
        ok = j < ln - k + 1
        q = sh + r * L + j - js
        o2 = (2 * (q & 31)).astype(np.uint64)
        hi, nx = pk[q >> 5], pk[(q >> 5) + 1]
        down = u(64 - 2 * k)
        fwd = ((hi << o2) | ((nx >> u(1)) >> (u(63) - o2))) >> down
        rc = _brev64(~fwd)
        m = u(0x5555555555555555)
        rc = (((rc >> u(1)) & m) | ((rc & m) << u(1))) >> down
        use_fwd = fwd <= rc
        out = row0 * P + j0 + f
        kmers[out] = np.where(ok, np.where(use_fwd, fwd, rc), SENT)
        writes[out] += 1
        if edges:
            has_l, has_r = j > 0, j < ln - k
            lc = np.where(has_l, raw[np.maximum(q - 1, 0)] & 3, 0)
            rcd = np.where(has_r & (j + k < L),
                           raw[np.minimum(q + k, len(raw) - 1)] & 3, 0)
            lo = np.where(use_fwd, np.where(has_l, lc, 4),
                          np.where(has_r, 3 - rcd, 4))
            ro = np.where(use_fwd, np.where(has_r, rcd, 4),
                          np.where(has_l, 3 - lc, 4))
            left[out] = np.where(ok, lo, 4)
            right[out] = np.where(ok, ro, 4)
    return (kmers.reshape(N, P), left.reshape(N, P), right.reshape(N, P),
            writes)


def _assert_equals_chop_with_edges(codes, lengths, k, kmers, left, right):
    """kmers/left/right equal graph._chop_with_edges at valid windows; the
    port's sentinel INT64_MAX and codes 4/4 at the others."""
    can, jl, jr, valid = map(np.asarray, jgraph._chop_with_edges(
        jnp.asarray(codes), jnp.asarray(lengths), k))
    assert np.array_equal(kmers[valid], can[valid])
    assert (kmers[~valid] == SENT).all()
    assert np.array_equal(left[valid], jl[valid])
    assert np.array_equal(right[valid], jr[valid])
    assert (left[~valid] == 4).all() and (right[~valid] == 4).all()


@pytest.mark.parametrize("N,L,k,budget", [
    (333, 150, 31, None), (301, 250, 17, None), (97, 157, 17, None),
    (1, 150, 1, None), (45, 61, 16, None), (7, 5003, 31, None),
    (3, 701, 17, 1024), (5, 333, 11, 800)])
@pytest.mark.parametrize("sh0", [0, 5])
def test_kernel_model_matches_chop_with_edges(monkeypatch, N, L, k, budget,
                                              sh0):
    """The kernel's tiling and bit arithmetic, modelled in numpy, equal the
    JAX chop in both strands: whole-row tiles (16-row multiples and not),
    segment tiles of long rows (a small shared-memory budget forces them),
    odd N, L and P, codes at an address not 16-aligned, lengths > L."""
    if budget is not None:
        monkeypatch.setattr(ch, "SMEM_BUDGET", budget)
        ch.tile_plan.cache_clear()
    try:
        rows, pw = ch.tile_plan(L, k)
    finally:
        ch.tile_plan.cache_clear()
    assert (pw < L - k + 1) == (budget is not None)
    codes, lengths = _batch(N + L + k, k, N=N, L=L) if N >= 8 else (
        np.random.default_rng(k).integers(0, 4, (N, L)).astype(np.uint8),
        np.full(N, L, np.int32))
    lengths[-1] = L + 3                       # a read longer than the row
    codes[-1] = np.arange(L) * 7 % 4
    km, kl, kr, writes = _kernel_model(codes, lengths, k, True, rows, pw,
                                       sh0=sh0)
    assert (writes == 1).all()
    _assert_equals_chop_with_edges(codes, lengths, k, km, kl, kr)


@pytest.mark.parametrize("L,k", [
    (150, 31), (150, 17), (250, 31), (250, 17), (157, 16), (157, 17),
    (151, 1), (100, 31), (61, 16), (5003, 31), (20011, 17), (30011, 17),
    (30011, 31), (100001, 1), (31, 31), (32, 1)])
def test_tile_plan_covers_each_window_once(L, k):
    """For odd and even N, L and P the tiles cover every row's windows
    exactly once, fit the shared-memory budget, and whole-row tiles take a
    multiple of 16 rows where 16 fit."""
    rows, pw = ch.tile_plan(L, k)
    P = L - k + 1
    assert ch.smem_bytes(rows, pw, L, k) <= ch.SMEM_BUDGET
    assert 1 <= rows <= ch.MAX_TILE_ROWS and 1 <= pw <= P
    if pw < P:
        assert rows == 1 and pw % 16 == 0
    elif ch.smem_bytes(16, P, L, k) <= ch.SMEM_BUDGET:
        assert rows % 16 == 0
    for N in (1, 15, 16, 17, 333 if P < 1000 else 33):
        seen = np.zeros((N, P), np.int8)
        S = -(-P // pw)
        for t in range(_n_tiles(N, L, k, rows, pw)):
            if pw == P:
                seen[t * rows:(t + 1) * rows] += 1
            else:
                seen[t // S, (t % S) * pw:(t % S + 1) * pw] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("L", [150, 250])
@pytest.mark.parametrize("k", [17, 31])
def test_plain_matches_jax_at_main_path_widths(L, k):
    """chop_plain at the main path's row widths (150, and the -r default
    250) against the Pallas chop in interpret mode and _chop_with_edges."""
    from jax.experimental.pallas import tpu as pltpu
    codes, lengths = _batch(L + k, k, N=300, L=L)
    with pltpu.force_tpu_interpret_mode():
        hi, lo = pc.chop_canonical_pallas(jnp.asarray(codes), k, block=100)
    want = np.asarray(pc.combine_u64(hi, lo))
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    kmers = ch.chop(c, ln, k)[0].numpy().view(np.uint64)
    valid = _valid(lengths, k, L - k + 1)
    assert np.array_equal(kmers[valid], want[valid])
    assert (kmers[~valid] == SENT).all()
    km, left, right = (t.numpy() for t in ch.chop(c, ln, k, edges=True))
    _assert_equals_chop_with_edges(codes, lengths, k, km.view(np.uint64),
                                   left, right)


def test_k1_matches_jax():
    """k = 1: one base a window, its complement the other strand."""
    codes, lengths = _batch(1, 1, N=50, L=33)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    km, left, right = (t.numpy() for t in ch.chop(c, ln, 1, edges=True))
    _assert_equals_chop_with_edges(codes, lengths, 1, km.view(np.uint64),
                                   left, right)
    valid = _valid(lengths, 1, 33)
    assert set(np.unique(km[valid])) <= {0, 1}


def test_counting_mode_equals_edge_mode_kmers():
    codes, lengths = _batch(5, 21)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    assert torch.equal(ch.chop(c, ln, 21)[0], ch.chop(c, ln, 21, True)[0])


def test_reads_all_shorter_than_k():
    codes = np.full((3, 10), 4, np.uint8)
    lengths = np.array([0, 5, 10], np.int32)
    codes[2, :] = 1
    kmers, left, right = ch.chop(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), 11, edges=True)
    assert kmers.shape == left.shape == right.shape == (3, 0)


@pytest.mark.parametrize("bad", ["k0", "k32", "dtype", "shape", "device"])
def test_wrapper_rejects(bad):
    codes = torch.zeros((4, 20), dtype=torch.uint8)
    lengths = torch.full((4,), 20, dtype=torch.int32)
    k = 11
    if bad == "k0":
        k = 0
    elif bad == "k32":
        k = 32
    elif bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "shape":
        lengths = lengths[:3]
    elif bad == "device":
        # neither a CPU nor a CUDA tensor: no plain fallback is taken
        codes, lengths = codes.to("meta"), lengths.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ch.chop(codes, lengths, k)


def _boundary_cases():
    """(what, codes, lengths, k) at the shapes the kernel's tiling makes
    hard: one row, N not a multiple of a tile's rows, L = 150 and 250, odd
    P, row spans not a multiple of 16 bytes, codes not 16-aligned, segment
    tiles of long rows, reads all shorter than k, reads longer than L,
    k = 1, 16, 17, 31."""
    out = []
    for k in (1, 16, 17, 31):
        for N, L in ((1, 150), (333, 150), (301, 250), (97, 157),
                     (5, 5003), (3, 30011)):
            codes, lengths = _batch(N * L + k, k, N=N + 4, L=L)
            rows = slice(4, 5) if N == 1 else slice(3, 3 + N)
            out.append((f"N={N} L={L} k={k}", codes[rows], lengths[rows], k))
        codes, lengths = _batch(7 + k, k, N=64, L=150)
        out.append((f"reads shorter than k, k={k}", codes,
                    np.minimum(lengths, k - 1), k))
        codes = np.random.default_rng(k).integers(0, 4, (64, 150)).astype(
            np.uint8)
        out.append((f"lengths > L, k={k}", codes,
                    np.full(64, 155, np.int32), k))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("edges", [False, True])
def test_kernel_matches_plain_on_card_at_boundaries(edges):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chop kernel has no CPU mode")
    for what, codes, lengths, k in _boundary_cases():
        ln = torch.from_numpy(lengths).cuda()
        for off in (0, 1):                     # codes at an odd address
            buf = torch.zeros(codes.size + off, dtype=torch.uint8,
                              device="cuda")
            c = buf[off:].view(codes.shape)
            c.copy_(torch.from_numpy(codes))
            before = ch.launches
            got = ch.chop(c, ln, k, edges)
            torch.cuda.synchronize()
            assert ch.launches == before + 1, what
            want = ch.chop_plain(c, ln, k, edges)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert torch.equal(g, w), (what, off)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 17, 31])
@pytest.mark.parametrize("edges", [False, True])
def test_kernel_matches_plain_on_card(k, edges):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chop kernel has no CPU mode")
    codes, lengths = _batch(200 + k, k, N=333, L=157)
    c, ln = torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda()
    before = ch.launches
    got = ch.chop(c, ln, k, edges)
    torch.cuda.synchronize()
    assert ch.launches == before + 1
    want = ch.chop_plain(c, ln, k, edges)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
