"""Positional unique-k-mer contig index and seed-and-extend read mapper, on
the device.

Counterpart of dbg_assembly_tpu/scaffold/index.py.  Reference:
link_scaffold's positional KmerSet maps each canonical contig k-mer to
(contig index, offset, strand, uniqueness), kmerSet.h:54-61; a duplicate
insert keeps the FIRST payload and clears the uniqueness bit (add_kmerset,
kmerSet.cpp:168-210).  Scaffold inputs are split at N runs before chopping
(scaffold_to_contig + chop_contig_to_kmerset, map_func.cpp:119-173,303-324).

The index is a k-mer-sorted array searched with torch.searchsorted in place
of the reference's open-addressing hash: the first-inserted payload is kept
by a stable sort (ops.sort.sort, the hand-written radix sort on the card),
uniqueness is a run length of 1.  The seed scan (get_align_seed,
map_func.cpp:181-237: the first position whose k-mer and the k-mer
SeedKmerNum later are both unique, on the same contig, at consistent
spacing) is sequential with an early exit in the reference; here every
position's validity is computed at once and the seed is the first argmax
of the validity mask.  Extension (extend_align_region,
map_func.cpp:241-299) is ungapped: one gather and compare over each read's
span.

K-mers are int64 (2k <= 62 bits), where the JAX package holds uint64.
Engines: "torch" (the index and the mapper on ``device``) and "native" (the
shared C++ engine, native/map_engine.cpp).  DBG_PY_MAP=1 selects, as in the
JAX package, its numpy index and mapper on the host (index.py:98-150,
197-300; the index's arrays numpy, its k-mers uint64): engine "python".
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import dna, native, resolve_device, spans
from ..ops import sort as srt

# k-mer windows a device batch: 131 072 reads of 150 bases at k = 31.  The
# mapper's largest planes are [N, L - k + 1] and [N, L] int64 (about 10 kB
# a read at 150 bp, all planes together), so a batch is sized by windows,
# not reads: long reads (map_reads) make batches of fewer reads at about
# the same peak.  Rows are independent, so the batch only bounds the peak
CHUNK_WINDOWS = 131_072 * 120

_COMP_TABLE = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP_TABLE[_a] = _b


@dataclass
class ContigIndex:
    """``engine`` is the one that built it: "torch" (tensors on its
    device), "python" (numpy, k-mers uint64) or "native" (empty apart from
    the contigs' rows)."""
    kmers: torch.Tensor     # [M] int64 sorted canonical
    ids: torch.Tensor       # [M] int32 contig index
    pos: torch.Tensor       # [M] int32 offset of k-mer start in contig
    direct: torch.Tensor    # [M] uint8 1 = forward canonical
    uniq: torch.Tensor      # [M] uint8
    ksize: int
    # concatenated contig bases for extension gathers
    concat: torch.Tensor    # [sum len] uint8 ASCII
    offsets: torch.Tensor   # [n_contigs + 1] int64
    lengths: torch.Tensor   # [n_contigs] int64
    native: object = None   # NativeMapIndex for the native engine
    engine: str = "torch"


def build(contig_seqs: list[bytes], ksize: int, engine: str = "torch",
          device="cuda") -> ContigIndex:
    """contig_seqs: raw ASCII per contig slot (b"" allowed: it adds no
    k-mer).  The torch engine builds the index on ``device`` as _build_py
    (index.py:98-150) does: the windows' keys sorted stably, the first
    payload of each run kept, ``uniq`` a run of one.  The native engine
    builds it inside the C++ engine (its arrays here are empty).
    DBG_PY_MAP=1 builds it with _build_py on the host, whatever the
    engine.  Inside the span ``scaffold.index``, which on the torch engine
    ends on an idle device (the count of unique k-mers is its one read of
    the device), so that the sort is charged to the index and not to the
    first map chunk."""
    if not 1 <= ksize <= 31:
        raise ValueError(f"k = {ksize}: the port's k-mers are int64, "
                         "1 <= k <= 31")
    if engine not in ("torch", "native"):
        raise ValueError(f"unknown map engine {engine!r}")
    with spans.span("scaffold.index", contigs=len(contig_seqs)):
        ix = _build_engine(contig_seqs, ksize, engine, device)
        if ix.engine != "native":
            # on the device the count waits for every launch of the
            # build: the span's one read of it
            spans.add(kmers=len(ix.kmers), unique=int(ix.uniq.sum()))
    return ix


def _build_engine(contig_seqs: list[bytes], ksize: int, engine: str,
                  device) -> ContigIndex:
    """build's work on its engine; counts the windows of the torch
    engine's sort in the span open."""
    if os.environ.get("DBG_PY_MAP") == "1":
        return _build_py(contig_seqs, ksize)
    if engine == "native":
        concat, offsets, lengths = _host_rows(contig_seqs)
        nmi = native.NativeMapIndex(ksize, concat, offsets)
        e = torch.zeros(0, dtype=torch.int64)
        return ContigIndex(e, e.int(), e.int(), e.to(torch.uint8),
                           e.to(torch.uint8), ksize, torch.from_numpy(concat),
                           torch.from_numpy(offsets),
                           torch.from_numpy(lengths), native=nmi,
                           engine="native")
    concat, codes, offsets, lengths = device_rows(contig_seqs, device)
    can, ids, pos, direct = window_keys(concat, codes, offsets, ksize)
    kmers, order = srt.sort(can, 2 * ksize, return_index=True)
    ids, pos, direct = ids[order], pos[order], direct[order]
    n = kmers.shape[0]
    spans.add(windows=n)
    first = torch.ones(n, dtype=torch.bool, device=kmers.device)
    first[1:] = kmers[1:] != kmers[:-1]
    starts = torch.nonzero(first)[:, 0]
    run_len = torch.diff(starts, append=torch.tensor([n],
                                                     device=kmers.device))
    uniq = (run_len == 1).to(torch.uint8)
    return ContigIndex(kmers[first], ids[first], pos[first], direct[first],
                       uniq, ksize, concat, offsets, lengths)


def _build_py(contig_seqs: list[bytes], ksize: int) -> ContigIndex:
    """The JAX package's host index (index.py:98-150) in numpy: each
    contig of at least k bases split at N runs, each block of at least k
    bases chopped, the keys sorted stably, the first payload of each run
    kept, ``uniq`` a run of one."""
    concat, offsets, lengths = _host_rows(contig_seqs)
    all_k, all_id, all_pos, all_dir = [], [], [], []
    for i, seq in enumerate(contig_seqs):
        if len(seq) < ksize:
            continue
        b = np.frombuffer(seq, dtype=np.uint8)
        codes = dna.ascii_to_codes(b, strict_n=False)
        # split at N runs (scaffold_to_contig): chop each block alone
        isn = (b == ord("N")) | (b == ord("n"))
        if isn.any():
            bounds = np.flatnonzero(np.diff(np.concatenate(
                [[True], isn, [True]]).astype(np.int8)))
            blocks = [(bounds[j], bounds[j + 1])
                      for j in range(0, len(bounds) - 1)
                      if not isn[bounds[j]]]
        else:
            blocks = [(0, len(seq))]
        for s, e in blocks:
            if e - s < ksize:
                continue
            kk = dna.rolling_kmers(codes[s:e], ksize)
            rc = dna.revcomp_kbit(kk, ksize)
            fwd = kk < rc
            can = np.where(fwd, kk, rc)
            all_k.append(can)
            all_id.append(np.full(len(can), i, np.int32))
            all_pos.append((s + np.arange(len(can))).astype(np.int32))
            all_dir.append(fwd.astype(np.uint8))

    if not all_k:
        return ContigIndex(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), np.zeros(0, np.uint8),
                           np.zeros(0, np.uint8), ksize, concat, offsets,
                           lengths, engine="python")
    k = np.concatenate(all_k)
    cid = np.concatenate(all_id)
    cpos = np.concatenate(all_pos)
    cdir = np.concatenate(all_dir)
    order = np.argsort(k, kind="stable")
    k, cid, cpos, cdir = k[order], cid[order], cpos[order], cdir[order]
    first = np.ones(len(k), bool)
    first[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(first)
    run_len = np.diff(np.concatenate([starts, [len(k)]]))
    return ContigIndex(k[first], cid[first], cpos[first], cdir[first],
                       (run_len == 1).astype(np.uint8), ksize, concat,
                       offsets, lengths, engine="python")


def _host_rows(contig_seqs: list[bytes]):
    """(concat, offsets, lengths) as numpy: the contigs' bytes in one row,
    each contig's start in it (and the row's end), each contig's length."""
    lengths = np.array([len(s) for s in contig_seqs], dtype=np.int64)
    offsets = np.zeros(len(contig_seqs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    concat = np.frombuffer(b"".join(contig_seqs), dtype=np.uint8).copy() \
        if contig_seqs else np.zeros(0, np.uint8)
    return concat, offsets, lengths


def device_rows(contig_seqs: list[bytes], device="cuda"):
    """The index's input rows on ``device``: (concat ASCII, concat in the
    k-mer alphabet with N -> 0, offsets, lengths)."""
    dev = resolve_device(device)
    concat, offsets, lengths = _host_rows(contig_seqs)
    return (torch.from_numpy(concat).to(dev),
            torch.from_numpy(dna.ascii_to_codes(concat)).to(dev),
            torch.from_numpy(offsets).to(dev),
            torch.from_numpy(lengths).to(dev))


def window_keys(concat: torch.Tensor, codes: torch.Tensor,
                offsets: torch.Tensor, k: int):
    """The windows _build_py (index.py:98-143) inserts, over one code row:
    every window of the concatenated contigs, less those that cross a
    contig's end or hold an N, in contig and position order (the JAX
    package's insertion order).  Returns their (canonical k-mer int64,
    contig int32, position in the contig int32, forward strand uint8): the
    keys the index sorts stably, and the payloads."""
    dev = concat.device
    T = concat.shape[0]
    P = T - k + 1
    if P <= 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e.int(), e.int(), e.to(torch.uint8)
    isn = (concat == ord("N")) | (concat == ord("n"))
    ncum = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    ncum[1:] = torch.cumsum(isn, 0)
    start = torch.arange(P, device=dev)
    # the contig of a window's first base (empty contigs share their
    # offset with the next one; right=True passes over them)
    cid = torch.searchsorted(offsets, start, right=True) - 1
    keep = ((ncum[k:] - ncum[:P]) == 0) & (start + k <= offsets[cid + 1])

    km = dna.rolling_kmers(codes, k)
    rc = dna.revcomp_kbit(km, k)
    fwd = km < rc
    return (torch.where(fwd, km, rc)[keep], cid[keep].to(torch.int32),
            (start - offsets[cid])[keep].to(torch.int32),
            fwd[keep].to(torch.uint8))


def lookup(ix: ContigIndex, kmers: torch.Tensor):
    """Vectorized exist_kmerset: (found, ids, pos, direct, uniq) of each
    k-mer, on the index's device (numpy uint64 k-mers on a python
    engine's index).  Where a k-mer is absent the payload is another
    entry's (or 0 on an empty index)."""
    if ix.engine == "native":
        raise RuntimeError("lookup() needs the torch or python engine's "
                           "index: the native engine keeps its arrays "
                           "inside the C++ engine")
    if ix.engine == "python":
        loc = np.searchsorted(ix.kmers, kmers)
        loc = np.clip(loc, 0, max(len(ix.kmers) - 1, 0))
        found = (len(ix.kmers) > 0) & (ix.kmers[loc] == kmers)
        return (found, ix.ids[loc], ix.pos[loc], ix.direct[loc],
                ix.uniq[loc])
    M = ix.kmers.shape[0]
    if M == 0:
        z = torch.zeros_like(kmers)
        return (z.bool(), z.int(), z.int(), z.to(torch.uint8),
                z.to(torch.uint8))
    loc = torch.searchsorted(ix.kmers, kmers).clamp_(max=M - 1)
    return (ix.kmers[loc] == kmers, ix.ids[loc], ix.pos[loc], ix.direct[loc],
            ix.uniq[loc])


@dataclass
class MapResult:
    mapped: np.ndarray            # [N] bool
    contig: np.ndarray            # [N] int32 contig index
    read_start: np.ndarray        # [N] int32 1-based (extended)
    read_end: np.ndarray          # [N]
    contig_start: np.ndarray      # [N]
    contig_end: np.ndarray        # [N]
    direct: np.ndarray            # [N] uint8 1=F
    identity: np.ndarray          # [N] float32


def map_reads(ix: ContigIndex, codes: np.ndarray, ascii_seq: np.ndarray,
              lengths: np.ndarray, seed_kmer_num: int,
              min_identity: float, search_start=1,
              chunk: int | None = None) -> MapResult:
    """Map each read (first qualifying seed, ungapped extension): on the
    index's device ``chunk`` reads at a time for the torch engine (by
    default as many as hold CHUNK_WINDOWS k-mer windows), in the C++ engine
    for the native one, in numpy on the host for the python one.  Fields
    other than ``mapped`` are meaningful only where ``mapped`` is set.

    search_start: scalar or per-read array of 1-based positions to begin the
    seed scan (map_reads' second-alignment pass uses align_read_end+1,
    map_reads.cpp:484).  Inside the span ``scaffold.map``."""
    N = codes.shape[0]
    ss = np.asarray(search_start)
    if ss.ndim == 0:
        ss = np.full(N, int(ss), np.int64)
    with spans.span("scaffold.map", reads=N):
        r, chunks = _map_engine(ix, codes, ascii_seq, lengths,
                                seed_kmer_num, min_identity, ss, chunk)
        spans.add(chunks=chunks, mapped=int(r.mapped.sum()))
    return r


def _map_engine(ix: ContigIndex, codes, ascii_seq, lengths,
                seed_kmer_num: int, min_identity: float, ss: np.ndarray,
                chunk: int | None) -> tuple[MapResult, int]:
    """map_reads' work on the index's engine; returns the result and the
    device batches it took (one on the host engines)."""
    N = codes.shape[0]
    if ix.engine == "native":
        mapped, cid, rs, re_, cs, ce, dr, ident = ix.native.map(
            codes, ascii_seq, lengths, ss, seed_kmer_num, min_identity)
        return MapResult(mapped=mapped.astype(bool), contig=cid,
                         read_start=rs, read_end=re_, contig_start=cs,
                         contig_end=ce, direct=dr, identity=ident), 1
    if ix.engine == "python":
        return _map_reads_py(ix, codes, ascii_seq, lengths, seed_kmer_num,
                             min_identity, ss), 1
    dev = ix.kmers.device
    if chunk is None:
        windows = max(codes.shape[1] - ix.ksize + 1, 1)
        chunk = max(1, CHUNK_WINDOWS // windows)
    outs = [np.zeros(N, bool), *(np.zeros(N, np.int32) for _ in range(5)),
            np.zeros(N, np.uint8), np.zeros(N, np.float32)]
    offs = range(0, N, chunk)
    for off in offs:
        end = min(off + chunk, N)

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[off:end], dtype))
            return t.to(dev)

        res = _map_kernel(ix, put(codes), put(ascii_seq), put(lengths),
                          put(ss, np.int64), min_identity, ix.ksize,
                          seed_kmer_num)
        for o, r in zip(outs, res):
            o[off:end] = r.cpu().numpy()
    return MapResult(*outs), len(offs)


def _map_reads_py(ix: ContigIndex, codes: np.ndarray,
                  ascii_seq: np.ndarray, lengths: np.ndarray, S: int,
                  min_identity: float, ss: np.ndarray) -> MapResult:
    """The JAX package's numpy mapper (index.py:215-300) over a python
    engine's index, every read at once."""
    k = ix.ksize
    N, L = codes.shape
    P = max(L - k + 1, 0)
    km = dna.rolling_kmers(codes, k)
    rc = dna.revcomp_kbit(km, k)
    read_dir = (km < rc).astype(np.uint8)
    can = np.where(km < rc, km, rc)
    found, cid, cpos, cdir, cuniq = lookup(ix, can.reshape(-1))
    found = found.reshape(N, P)
    cid = cid.reshape(N, P)
    cpos = cpos.reshape(N, P).astype(np.int64)
    cdir = cdir.reshape(N, P)
    cuniq = cuniq.reshape(N, P)

    ok1 = found & (cuniq == 1)
    pos_i = np.arange(P)
    # i runs over search_start-1 .. read_len - k - S (inclusive)
    in_range = (pos_i[None, :] >= ss[:, None] - 1) & \
               (pos_i[None, :] <= lengths[:, None].astype(np.int64) - k - S)
    valid_pair = np.zeros((N, P), bool)
    if P > S:
        valid_pair[:, :P - S] = (
            ok1[:, :P - S] & ok1[:, S:]
            & (cid[:, :P - S] == cid[:, S:])
            & (np.abs(cpos[:, S:] - cpos[:, :P - S]) == S))
    valid = valid_pair & in_range
    has = valid.any(axis=1)
    seed_i = np.argmax(valid, axis=1)               # first valid position

    rows = np.arange(N)
    sid = cid[rows, seed_i]
    p1 = cpos[rows, seed_i]
    p2 = cpos[rows, np.minimum(seed_i + S, P - 1)]
    is_f = read_dir[rows, seed_i] == cdir[rows, seed_i]
    seed_contig_start = np.where(is_f, p1 + 1, p2 + 1)
    seed_contig_end = np.where(is_f, p2 + k, p1 + k)
    seed_read_start = seed_i + 1
    seed_read_end = seed_i + S + k

    Lr = lengths.astype(np.int64)
    clen = ix.lengths[np.clip(sid, 0, max(len(ix.lengths) - 1, 0))] \
        if len(ix.lengths) else np.zeros(N, np.int64)
    coff = ix.offsets[np.clip(sid, 0, max(len(ix.offsets) - 2, 0))] \
        if len(ix.lengths) else np.zeros(N, np.int64)

    # working coordinates on the (possibly reverse-complemented) read
    w_start = np.where(is_f, seed_read_start, Lr - seed_read_end + 1)
    w_end = np.where(is_f, seed_read_end, Lr - seed_read_start + 1)
    ext_l = np.minimum(w_start - 1, seed_contig_start - 1)
    ext_r = np.minimum(Lr - w_end, clen - seed_contig_end)
    a_read_start = w_start - ext_l
    a_read_end = w_end + ext_r
    a_ctg_start = seed_contig_start - ext_l
    a_ctg_end = seed_contig_end + ext_r
    align_len = a_read_end - a_read_start + 1

    # mismatches of the oriented read against the contig over the aligned
    # span, the seed span left out (extend_align_region starts at the seed
    # edges): forward t -> ascii[t-1], reverse t -> comp[ascii[L - t]]
    t = np.arange(1, L + 1)[None, :]
    t_in = ((t >= a_read_start[:, None]) & (t <= a_read_end[:, None])
            & ((t < w_start[:, None]) | (t > w_end[:, None])))
    fwd_chars = ascii_seq[:, :L]
    rev_idx = np.clip(Lr[:, None] - t, 0, L - 1)
    rev_chars = _COMP_TABLE[np.take_along_axis(ascii_seq, rev_idx, axis=1)]
    oriented = np.where(is_f[:, None], fwd_chars, rev_chars)
    cposx = coff[:, None] + a_ctg_start[:, None] - 1 \
        + (t - a_read_start[:, None])
    cposx = np.clip(cposx, 0, max(len(ix.concat) - 1, 0))
    ctg_chars = ix.concat[cposx] if len(ix.concat) \
        else np.zeros_like(oriented)
    mm = np.sum((oriented != ctg_chars) & t_in, axis=1)
    # float parity: identity = float(1.0 (double) - float(mm / len))
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = (mm.astype(np.float32) / align_len.astype(np.float32))
    identity = (np.float64(1.0) - frac.astype(np.float64)).astype(np.float32)

    out_read_start = np.where(is_f, a_read_start, Lr - a_read_end + 1)
    out_read_end = np.where(is_f, a_read_end, Lr - a_read_start + 1)
    # float against double promotes to double (map_pair.cpp:288)
    mapped = has & ~(identity.astype(np.float64) < np.float64(min_identity))
    return MapResult(mapped=mapped, contig=sid.astype(np.int32),
                     read_start=out_read_start.astype(np.int32),
                     read_end=out_read_end.astype(np.int32),
                     contig_start=a_ctg_start.astype(np.int32),
                     contig_end=a_ctg_end.astype(np.int32),
                     direct=is_f.astype(np.uint8), identity=identity)


def _map_kernel(ix: ContigIndex, codes: torch.Tensor,
                ascii_seq: torch.Tensor, lengths: torch.Tensor,
                search_start: torch.Tensor, min_identity: float, k: int,
                S: int):
    """_map_kernel (index.py:320-409) as torch ops on the index's device.
    Returns (mapped, contig, read_start, read_end, contig_start,
    contig_end, direct, identity) tensors [N]."""
    dev = codes.device
    N, L = codes.shape
    P = L - k + 1
    Lr = lengths.to(torch.int64)
    if P <= 0:               # no read holds a k-mer
        z = torch.zeros(N, dtype=torch.int32, device=dev)
        return (z.bool(), z, z, z, z, z, z.to(torch.uint8), z.float())

    km = dna.rolling_kmers(codes, k)
    rc = dna.revcomp_kbit(km, k)
    read_dir = (km < rc).to(torch.uint8)
    can = torch.where(km < rc, km, rc)
    del km, rc
    found, cid, cpos, cdir, cuniq = (
        x.reshape(N, P) for x in lookup(ix, can.reshape(-1)))
    cpos = cpos.to(torch.int64)

    ok1 = found & (cuniq == 1)
    pos_i = torch.arange(P, device=dev)
    ss = search_start.to(torch.int64)
    in_range = (pos_i[None, :] >= ss[:, None] - 1) & \
               (pos_i[None, :] <= Lr[:, None] - k - S)
    valid_pair = torch.zeros((N, P), dtype=torch.bool, device=dev)
    if P > S:
        valid_pair[:, :P - S] = (
            ok1[:, :P - S] & ok1[:, S:]
            & (cid[:, :P - S] == cid[:, S:])
            & ((cpos[:, S:] - cpos[:, :P - S]).abs() == S))
    valid = valid_pair & in_range
    has = valid.any(1)
    seed_i = torch.argmax(valid.to(torch.uint8), 1)     # first valid

    rows = torch.arange(N, device=dev)
    sid = cid[rows, seed_i].to(torch.int64)
    p1 = cpos[rows, seed_i]
    p2 = cpos[rows, torch.clamp(seed_i + S, max=P - 1)]
    is_f = read_dir[rows, seed_i] == cdir[rows, seed_i]
    seed_contig_start = torch.where(is_f, p1 + 1, p2 + 1)
    seed_contig_end = torch.where(is_f, p2 + k, p1 + k)
    seed_read_start = seed_i + 1
    seed_read_end = seed_i + S + k

    # an empty contig list gathers from one zero, as the JAX device arrays
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    clens = ix.lengths if ix.lengths.shape[0] else zero
    concat = ix.concat if ix.concat.shape[0] else zero.to(torch.uint8)
    clen = clens[sid.clamp(0, clens.shape[0] - 1)]
    coff = ix.offsets[sid.clamp(0, max(ix.offsets.shape[0] - 2, 0))]

    w_start = torch.where(is_f, seed_read_start, Lr - seed_read_end + 1)
    w_end = torch.where(is_f, seed_read_end, Lr - seed_read_start + 1)
    ext_l = torch.minimum(w_start - 1, seed_contig_start - 1)
    ext_r = torch.minimum(Lr - w_end, clen - seed_contig_end)
    a_read_start = w_start - ext_l
    a_read_end = w_end + ext_r
    a_ctg_start = seed_contig_start - ext_l
    a_ctg_end = seed_contig_end + ext_r
    align_len = a_read_end - a_read_start + 1

    # mismatches of the oriented read against the contig over the aligned
    # span, the seed span left out (extend_align_region starts at the seed
    # edges): forward t -> ascii[t-1], reverse t -> comp[ascii[L - t]]
    comp = torch.from_numpy(_COMP_TABLE).to(dev)
    t = torch.arange(1, L + 1, dtype=torch.int64, device=dev)[None, :]
    t_in = ((t >= a_read_start[:, None]) & (t <= a_read_end[:, None])
            & ((t < w_start[:, None]) | (t > w_end[:, None])))
    rev_idx = torch.clamp(Lr[:, None] - t, 0, L - 1)
    rev_chars = comp[ascii_seq.gather(1, rev_idx).to(torch.int64)]
    oriented = torch.where(is_f[:, None], ascii_seq, rev_chars)
    del rev_idx, rev_chars
    cposx = coff[:, None] + a_ctg_start[:, None] - 1 \
        + (t - a_read_start[:, None])
    ctg_chars = concat[cposx.clamp_(0, concat.shape[0] - 1)]
    mm = ((oriented != ctg_chars) & t_in).sum(1)
    # float parity: identity = float(1.0 (double) - float(mm / len))
    frac = mm.to(torch.float32) / align_len.to(torch.float32)
    identity = (1.0 - frac.to(torch.float64)).to(torch.float32)

    out_read_start = torch.where(is_f, a_read_start, Lr - a_read_end + 1)
    out_read_end = torch.where(is_f, a_read_end, Lr - a_read_start + 1)
    # float against double promotes to double (map_pair.cpp:288)
    mapped = has & ~(identity.to(torch.float64) < min_identity)
    i32 = torch.int32
    return (mapped, sid.to(i32), out_read_start.to(i32),
            out_read_end.to(i32), a_ctg_start.to(i32), a_ctg_end.to(i32),
            is_f.to(torch.uint8), identity)
