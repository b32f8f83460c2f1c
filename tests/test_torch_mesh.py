"""The port's distributed counting and ingest (dbg_assembly_tpu_torch/
parallel/) against the JAX package's, with the slots on the CPU: the
collectives, count_step and its exact wrapper on a skewed input,
graph_ingest_step_exact, GraphBuilder(mesh) against the single-device port
and JAX's mesh builder, the halo chop at the tile boundaries and
count_halo_sharded.  JAX's data_mesh(n) takes the first n of the 8 CPU
devices tests/conftest.py forces; its masked [D, n] rows are compacted
per slot.  Exact equality: every output is an integer."""

import numpy as np
import pytest
import torch

from dbg_assembly_tpu import dna as jdna
from dbg_assembly_tpu.contig import graph as jgraph
from dbg_assembly_tpu.parallel import count_sharded as jcs
from dbg_assembly_tpu.parallel import halo as jhalo
from dbg_assembly_tpu.parallel import mesh as jmesh
from dbg_assembly_tpu_torch.contig import graph as tgraph
from dbg_assembly_tpu_torch.parallel import count_sharded as tcs
from dbg_assembly_tpu_torch.parallel import halo as thalo
from dbg_assembly_tpu_torch.parallel import mesh as tmesh

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads while the module runs.  The tier-1 run puts six
    pytest workers on the host's cores; with torch's default of a thread
    a core, the port's many small CPU ops in every slot spend more time
    waiting for their threads than computing, and slow the other
    workers' tests down with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _meshes(n: int):
    return jmesh.data_mesh(n), tmesh.data_mesh(n, "cpu")


def _compact(jrows, n_unique):
    """JAX's masked [D, n] rows -> per slot the records at run starts."""
    un = np.asarray(jrows[0])
    out = []
    for d in range(un.shape[0]):
        keep = un[d] != SENT
        assert keep.sum() == int(np.asarray(n_unique)[d])
        out.append([np.asarray(r)[d][keep] for r in jrows])
    return out


def _u64(t: torch.Tensor) -> np.ndarray:
    """int64 k-mers as JAX's uint64, the port's INT64_MAX sentinel as
    JAX's all-ones one."""
    a = t.numpy().view(np.uint64).copy()
    a[a == np.uint64(2 ** 63 - 1)] = SENT
    return a


def _random_reads(seed: int, N: int, L: int, k: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)
    return codes, lengths


# ------------------------------------------------------------- the mesh
def test_mesh_layout_and_collectives():
    m = tmesh.data_mesh(4, "cpu")
    assert m.n == 4 and m.layout() == "4 shards on the CPU"
    xs = [torch.arange(3) + 10 * d for d in range(4)]
    tmesh.bytes_moved = 0
    g = tmesh.all_gather(m, xs)
    assert all(torch.equal(x, torch.cat(xs)) for x in g)
    assert tmesh.bytes_moved == 4 * 3 * 3 * 8        # 3 other slots each
    assert all(torch.equal(x, sum(xs)) for x in tmesh.psum(m, xs))
    # ragged all_to_all: bufs[s][t] has s + t elements, source order kept
    bufs = [[torch.full((s + t,), 10 * s + t) for t in range(4)]
            for s in range(4)]
    recv = tmesh.all_to_all(m, bufs)
    for t in range(4):
        assert torch.equal(recv[t], torch.cat([bufs[s][t]
                                               for s in range(4)]))
    ps = tmesh.psum_scatter(m, [torch.arange(10) * (d + 1)
                                for d in range(4)], [1, 2, 3, 4])
    assert [p.tolist() for p in ps] == [[0], [10, 20], [30, 40, 50],
                                        [60, 70, 80, 90]]
    ring = tmesh.ppermute(m, xs, [((j + 1) % 4, j) for j in range(4)])
    assert all(torch.equal(ring[j], xs[(j + 1) % 4]) for j in range(4))
    assert torch.equal(tmesh.reduce(m, xs, 2), sum(xs))
    assert all(torch.equal(b, xs[1]) for b in tmesh.broadcast(m, xs[1], 1))
    assert torch.equal(tmesh.gather(m, xs, 3), torch.cat(xs))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_batch(m, np.zeros((6, 2), np.uint8))
    assert [b.stop - b.start for b in tmesh.blocks(10, 4)] == [3, 3, 2, 2]
    np.testing.assert_array_equal(
        tmesh.pad_to_multiple(np.ones(5, np.int32), 4),
        jmesh.pad_to_multiple(np.ones(5, np.int32), 4))


# ------------------------------------------------------------- counting
@pytest.mark.parametrize("n_dev", [4, 8])
def test_count_step_matches_jax(n_dev):
    k, N, L = 15, 512, 64
    codes, lengths = _random_reads(0, N, L, k)
    jm, tm = _meshes(n_dev)
    cap = (N // n_dev) * (L - k + 1) // n_dev * 2 + 64
    ju, jc, jn, js = jcs.count_step(*jmesh.shard_batch(jm, codes, lengths),
                                    ksize=k, mesh=jm, capacity=cap)
    tu, tc, tn, ts = tcs.count_step(*tmesh.shard_batch(tm, codes, lengths),
                                    ksize=k, mesh=tm, capacity=cap)
    assert ts == {key: int(v) for key, v in js.items()}
    assert ts["dropped"] == 0 and tn == [int(x) for x in np.asarray(jn)]
    for d, (u, c) in enumerate(_compact((ju, jc), jn)):
        np.testing.assert_array_equal(_u64(tu[d]), u)
        np.testing.assert_array_equal(tc[d].numpy(), c)
        assert (u % n_dev == d).all()


def test_count_step_exact_skewed():
    """Every read the same 2-periodic sequence: one or two owners take
    everything, the default capacity overflows, and the exact wrapper
    doubles to JAX's capacity in JAX's number of doublings.  At the
    overflowing capacity both keep the same k-mers and drop as many."""
    k, N, L = 15, 512, 64
    codes = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    lengths = np.full(N, L, np.int32)
    jm, tm = _meshes(8)
    jargs = jmesh.shard_batch(jm, codes, lengths)
    targs = tmesh.shard_batch(tm, codes, lengths)
    cap0 = jcs.default_capacity(N, L, k, 8)
    assert tcs.default_capacity(N, L, k, 8) == cap0
    ju, jc, jn, js = jcs.count_step(*jargs, ksize=k, mesh=jm, capacity=cap0)
    tu, tc, tn, ts = tcs.count_step(*targs, ksize=k, mesh=tm, capacity=cap0)
    assert ts["dropped"] == int(js["dropped"]) > 0
    for d, (u, c) in enumerate(_compact((ju, jc), jn)):
        np.testing.assert_array_equal(_u64(tu[d]), u)
        np.testing.assert_array_equal(tc[d].numpy(), c)
    ju, jc, jn, js = jcs.count_step_exact(*jargs, ksize=k, mesh=jm)
    tu, tc, tn, ts = tcs.count_step_exact(*targs, ksize=k, mesh=tm)
    assert ts["capacity_doublings"] == js["capacity_doublings"] >= 1
    assert ts["capacity"] == js["capacity"]
    assert ts["dropped"] == 0 and ts["total_kmers"] == int(js["total_kmers"])
    for d, (u, c) in enumerate(_compact((ju, jc), jn)):
        np.testing.assert_array_equal(_u64(tu[d]), u)
        np.testing.assert_array_equal(tc[d].numpy(), c)
    with pytest.raises(RuntimeError, match="doublings"):
        tcs.count_step_exact(*targs, ksize=k, mesh=tm, capacity=8,
                             max_doublings=2)


# ------------------------------------------------------------- ingest
def test_graph_ingest_step_exact_matches_jax():
    """Skewed reads (a 3-periodic sequence, so the route overflows and
    doubles) and random ones, with a base index: every record, its
    unclipped counters and its smallest stream position."""
    k, N, L = 13, 256, 64
    skew = np.tile(np.array([0, 1, 2], np.uint8), (N, -(-L // 3)))[:, :L]
    rnd, lens = _random_reads(2, N, L, k)
    jm, tm = _meshes(4)
    doublings = []
    for codes, lengths in ((np.ascontiguousarray(skew),
                            np.full(N, L, np.int32)), (rnd, lens)):
        jout = jcs.graph_ingest_step_exact(
            *jmesh.shard_batch(jm, codes, lengths), 777, ksize=k, mesh=jm)
        tout = tcs.graph_ingest_step_exact(
            *tmesh.shard_batch(tm, codes, lengths), 777, ksize=k, mesh=tm)
        js, ts = jout[6], tout[6]
        assert ts == {key: int(v) for key, v in js.items()}
        assert tout[5] == [int(x) for x in np.asarray(jout[5])]
        for d, want in enumerate(_compact(jout[:5], jout[5])):
            got = [_u64(tout[0][d])] + [tout[i][d].numpy()
                                        for i in range(1, 5)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        doublings.append(ts["capacity_doublings"])
    assert doublings[0] >= 1 and doublings[1] == 0


def _tables_equal(a, b):
    for f in ("kmers", "lcnt", "rcnt", "first_idx", "counts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.total_kmers, a.total_reads) == (b.total_kmers, b.total_reads)


def test_graphbuilder_mesh_matches_single_device_and_jax():
    """GraphBuilder(mesh): uneven slices, batches that do not divide by D,
    reads shorter than k, more than 8 batches (the slots' merges), and
    a k-mer over 255 times (the counters clip at the end only)."""
    k, N, L = 13, 700, 72
    codes, lengths = _random_reads(3, N, L, k)
    codes[:300, :] = np.tile(np.array([0, 1, 2, 3], np.uint8), L // 4)
    lengths[:300] = L
    lengths[::17] = k - 2
    jm, tm = _meshes(4)
    builders = {"jax": jgraph.GraphBuilder(k, batch_reads=61, mesh=jm),
                "single": tgraph.GraphBuilder(k, batch_reads=61,
                                              device="cpu"),
                "mesh": tgraph.GraphBuilder(k, batch_reads=61, mesh=tm)}
    for off in range(0, N, 230):
        for gb in builders.values():
            gb.add(codes[off:off + 230], lengths[off:off + 230])
    tables = {name: gb.finalize() for name, gb in builders.items()}
    assert tables["mesh"].lcnt.max() == 255
    _tables_equal(tables["mesh"], tables["single"])
    _tables_equal(tables["mesh"], tables["jax"])
    assert builders["mesh"].stream_pos == builders["single"].stream_pos
    empty = tgraph.GraphBuilder(k, mesh=tm).finalize()
    assert empty.n_nodes == 0


# ------------------------------------------------------------- halo
def _oracle_kmers(row, length, k):
    if length < k:
        return np.zeros(0, np.uint64)
    km = jdna.rolling_kmers(np.asarray(row[:length], np.uint64)[None], k)[0]
    return np.asarray(jdna.canonical(km, k)[0])


@pytest.mark.parametrize("n_dev", [4, 8])
def test_halo_chop_matches_jax(n_dev):
    rng = np.random.default_rng(3)
    k = 21
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in (1000, 777, 1024, 40, k - 1, 985)]
    codes, lengths = thalo.pad_seqs_for_mesh(seqs, n_dev, k)
    jc, jl = jhalo.pad_seqs_for_mesh(seqs, n_dev, k)
    np.testing.assert_array_equal(codes, jc)
    jm, tm = _meshes(n_dev)
    want = np.asarray(jhalo.halo_chop(jc, jl, ksize=k, mesh=jm))
    got = torch.cat(thalo.halo_chop(codes, lengths, ksize=k, mesh=tm), 1)
    np.testing.assert_array_equal(_u64(got), want)
    for b in range(len(seqs)):
        exp = _oracle_kmers(codes[b], lengths[b], k)
        np.testing.assert_array_equal(_u64(got[b, :len(exp)]), exp)


def test_halo_chop_boundary_positions():
    """The windows that straddle a tile boundary, served by the halo
    (tests/test_halo.py:56)."""
    rng = np.random.default_rng(11)
    k = 31
    seq = rng.integers(0, 4, 8 * 64).astype(np.uint8)
    codes, lengths = thalo.pad_seqs_for_mesh([seq], 8, k)
    T = codes.shape[1] // 8
    tiles = thalo.halo_chop(codes, lengths, ksize=k,
                            mesh=tmesh.data_mesh(8, "cpu"))
    out = _u64(torch.cat(tiles, 1))[0]
    exp = _oracle_kmers(codes[0], lengths[0], k)
    n = 0
    for d in range(1, 8):
        for p in range(max(d * T - k + 1, 0), min(d * T, len(exp))):
            assert out[p] == exp[p], f"straddling k-mer at {p}"
            n += 1
    assert n > 100
    with pytest.raises(ValueError, match="narrower"):
        thalo.halo_chop(np.zeros((1, 16), np.uint8), np.array([16],
                                                              np.int32),
                        ksize=k, mesh=tmesh.data_mesh(8, "cpu"))


def test_count_halo_sharded_matches_jax():
    rng = np.random.default_rng(7)
    k = 17
    # a low-entropy alphabet, so k-mers repeat
    seqs = [np.repeat(rng.integers(0, 4, n // 3 + 1).astype(np.uint8), 3)[:n]
            for n in (3000, 2500, 1200)]
    codes, lengths = thalo.pad_seqs_for_mesh(seqs, 4, k)
    cap = codes.size // 4 + 64
    jm, tm = _meshes(4)
    ju, jc, jn, js = jhalo.count_halo_sharded(codes, lengths, ksize=k,
                                              mesh=jm, capacity=cap)
    tu, tc, tn, ts = thalo.count_halo_sharded(codes, lengths, ksize=k,
                                              mesh=tm, capacity=cap)
    assert ts == {key: int(v) for key, v in js.items()}
    assert ts["dropped"] == 0
    for d, (u, c) in enumerate(_compact((ju, jc), jn)):
        np.testing.assert_array_equal(_u64(tu[d]), u)
        np.testing.assert_array_equal(tc[d].numpy(), c)
    # and the single-device count of the same sequences
    from dbg_assembly_tpu_torch.kmer.count import KmerCounter
    kc = KmerCounter(k, device="cpu")
    for s in seqs:
        kc.add(s[None], np.array([len(s)], np.int32))
    u, c, total = kc.finalize()
    got_u = np.concatenate([_u64(x) for x in tu])
    order = np.argsort(got_u)
    np.testing.assert_array_equal(got_u[order], u)
    np.testing.assert_array_equal(torch.cat(tc).numpy()[order], c)
    assert ts["total_kmers"] == total


def test_data_mesh_defaults(monkeypatch):
    """data_mesh(n_devices=None), as JAX's: one slot on the CPU (a single
    device); with no card, "cuda" raises whatever the count."""
    m = tmesh.data_mesh(device="cpu")
    assert m.n == 1 and m.devices == [torch.device("cpu")]
    assert tmesh.data_mesh(None, "cpu").n == 1
    assert tmesh.data_mesh(3, "cpu").n == 3
    with pytest.raises(ValueError):
        tmesh.data_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tmesh.data_mesh, lambda: tmesh.data_mesh(None, "cuda:0"),
                 lambda: tmesh.data_mesh(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_graphbuilder_positional_args_match_jax():
    """GraphBuilder(ksize, max_read_len, batch_reads, mesh) called
    positionally in JAX's order: the mesh binds as the mesh (the port's
    device comes after it), and the table is JAX's."""
    k, N, L = 15, 300, 66
    codes, lengths = _random_reads(8, N, L, k)
    jm, tm = _meshes(2)
    jb = jgraph.GraphBuilder(k, L, 70, jm)
    tb = tgraph.GraphBuilder(k, L, 70, tm)
    assert tb.mesh is tm and tb.batch_reads == 70
    for gb in (jb, tb):
        gb.add(codes, lengths)
    _tables_equal(tb.finalize(), jb.finalize())
