"""ctypes loader for the shared native runtime (native/*.cpp).

The same library as the JAX package's loader (dbg_assembly_tpu/native.py):
native/build/libdbg_native.so, built on first use with ``make -C native``
(g++).  This copy binds the JAX loader's entry points: the FASTQ parser,
the streaming ingest table (the smoke test's oracle), the hash-layout
emulation, the exact contig readout engine, the host passes of the
doubling readout (links, slot ranks, chain heads, seed argmin, the GCC
4.4 and host length sorts) with the host twins of its device chain
resolution, the batch error corrector (``correct_error_reads --engine
native``) and the contig index and read mapper (``map_pair --engine
native``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_ROOT, "native")
_SO = os.path.join(_NATIVE, "build", "libdbg_native.so")
_SRCS = [os.path.join(_NATIVE, f)
         for f in ("dbg_native.cpp", "correct_engine.cpp",
                   "assemble_engine.cpp", "ingest_engine.cpp",
                   "map_engine.cpp", "fastq_engine.cpp")]

_lib = None
_lib_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


def _stale() -> bool:
    return (not os.path.exists(_SO)
            or any(os.path.getmtime(_SO) < os.path.getmtime(s)
                   for s in _SRCS))


def build() -> None:
    """Run ``make -C native`` if the library is missing or stale.  A file
    lock serialises the build across processes (test workers)."""
    if not _stale():
        return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(os.path.join(os.path.dirname(_SO), ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if _stale():
            proc = subprocess.run(["make", "-C", _NATIVE],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("make -C native failed (needs make and "
                                   f"g++):\n{proc.stderr}")


def _build_and_load() -> ctypes.CDLL:
    build()
    lo = ctypes.CDLL(_SO)
    lo.find_next_prime.restype = ctypes.c_uint64
    lo.find_next_prime.argtypes = [ctypes.c_uint64]
    lo.hash_layout.restype = ctypes.c_int64
    lo.hash_layout.argtypes = [_u64p, ctypes.c_int64, ctypes.c_uint64,
                               _u8p, _i64p]
    lo.hash_layout_disp.restype = ctypes.c_int64
    lo.hash_layout_epochs.restype = ctypes.c_int64
    lo.madv_huge.restype = None
    lo.madv_huge.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lo.radix_argsort_u64.restype = None
    lo.assemble_run.restype = ctypes.c_int
    lo.ingest_create.restype = ctypes.c_void_p
    lo.ingest_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lo.ingest_add.restype = None
    lo.ingest_add.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64,
                              ctypes.c_int, _i32p, ctypes.c_int64]
    lo.ingest_size.restype = ctypes.c_int64
    lo.ingest_size.argtypes = [ctypes.c_void_p]
    lo.ingest_reserve.restype = None
    lo.ingest_reserve.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lo.ingest_total.restype = ctypes.c_int64
    lo.ingest_total.argtypes = [ctypes.c_void_p]
    lo.ingest_extract.restype = None
    lo.ingest_extract.argtypes = [ctypes.c_void_p, _u64p, _i32p, _i32p,
                                  _i64p]
    lo.ingest_extract_full.restype = None
    lo.ingest_extract_counts.restype = None
    lo.ingest_free.restype = None
    lo.ingest_free.argtypes = [ctypes.c_void_p]
    lo.fastq_scan.restype = None
    lo.fastq_fill.restype = None
    lo.slot_rank.restype = None
    lo.slot_rank.argtypes = [_i64p, ctypes.c_int64, ctypes.c_uint64, _i64p]
    lo.succ_build.restype = None
    lo.succ_build.argtypes = [_u64p, ctypes.c_int64, _i32p, _i32p, _u8p,
                              ctypes.c_int, _i64p]
    lo.resolve_chains_host.restype = None
    lo.resolve_chains_host.argtypes = [_i64p, ctypes.c_int64, _i64p, _i64p,
                                       _u8p]
    lo.collect_heads.restype = ctypes.c_int64
    lo.collect_heads.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, _i64p,
                                 _i64p, _i64p]
    lo.seg_argmin.restype = None
    lo.seg_argmin.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
                              _i64p]
    lo.links_pass.restype = None
    lo.links_pass.argtypes = [_i32p, _i32p, ctypes.c_int64, ctypes.c_int32,
                              _i32p, _i32p, _i32p, _i32p, _i64p]
    lo.gcc44_sort_perm_desc.restype = None
    lo.gcc44_sort_perm_desc.argtypes = [_u64p, ctypes.c_int64, _i64p]
    lo.stdsort_perm_desc.restype = None
    lo.stdsort_perm_desc.argtypes = [_u64p, ctypes.c_int64, _i64p]
    lo.correct_batch.restype = None
    lo.correct_batch.argtypes = [
        _u8p, _i64p, _i32p, ctypes.c_int64, _u8p, ctypes.c_int64, _u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, _i32p, _i32p, _i32p, _i32p, _i32p]
    lo.mapidx_create.restype = ctypes.c_void_p
    lo.mapidx_create.argtypes = [ctypes.c_int, _u8p, _i64p, ctypes.c_int64]
    lo.mapidx_free.restype = None
    lo.mapidx_free.argtypes = [ctypes.c_void_p]
    lo.mapidx_map.restype = None
    lo.mapidx_map.argtypes = [
        ctypes.c_void_p, _u8p, _u8p, ctypes.c_int64, ctypes.c_int, _i32p,
        _i64p, ctypes.c_int, ctypes.c_double, _u8p, _i32p, _i32p, _i32p,
        _i32p, _i32p, _u8p, ctypes.POINTER(ctypes.c_float)]
    return lo


class NativeIngest:
    """Streaming native chop+aggregate table (native/ingest_engine.cpp)."""

    def __init__(self, ksize: int, capacity_hint: int = 1 << 20):
        self._h = lib().ingest_create(ksize, capacity_hint)

    def add(self, codes: np.ndarray, lengths: np.ndarray,
            base_index: int) -> None:
        c = np.ascontiguousarray(codes, np.uint8)
        ln = np.ascontiguousarray(lengths, np.int32)
        lib().ingest_add(self._h, c.ctypes.data_as(_u8p),
                         ctypes.c_int64(c.shape[0]), ctypes.c_int(c.shape[1]),
                         ln.ctypes.data_as(_i32p),
                         ctypes.c_int64(base_index))

    def n_nodes(self) -> int:
        return int(lib().ingest_size(self._h))

    def reserve(self, expected_nodes: int) -> None:
        """Pre-size the table for ``expected_nodes`` (one rehash now in
        place of several doublings mid-stream)."""
        lib().ingest_reserve(self._h, ctypes.c_uint64(expected_nodes))

    def extract(self):
        """(kmers u64, lcnt [n,4] i32, rcnt [n,4] i32, first_idx i64,
        total) sorted by k-mer."""
        n = self.n_nodes()
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        lcnt = np.empty((n, 4), np.int32)
        rcnt = np.empty((n, 4), np.int32)
        fidx = np.empty(n, np.int64)
        lib().ingest_extract(
            ctypes.c_void_p(self._h), kmers.ctypes.data_as(_u64p),
            lcnt.ctypes.data_as(_i32p), rcnt.ctypes.data_as(_i32p),
            fidx.ctypes.data_as(_i64p))
        return kmers, lcnt, rcnt, fidx, total

    def extract_full(self):
        """(kmers u64, lcnt [n,4] i32, rcnt [n,4] i32, first_idx i64,
        counts i32, total) sorted by k-mer."""
        n = int(lib().ingest_size(self._h))
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        lcnt = np.empty((n, 4), np.int32)
        rcnt = np.empty((n, 4), np.int32)
        fidx = np.empty(n, np.int64)
        counts = np.empty(n, np.int32)
        lib().ingest_extract_full(
            ctypes.c_void_p(self._h), kmers.ctypes.data_as(_u64p),
            lcnt.ctypes.data_as(_i32p), rcnt.ctypes.data_as(_i32p),
            fidx.ctypes.data_as(_i64p), counts.ctypes.data_as(_i32p))
        return kmers, lcnt, rcnt, fidx, counts, total

    def extract_counts(self):
        """(kmers u64, counts i32, total) sorted by k-mer."""
        n = int(lib().ingest_size(self._h))
        total = int(lib().ingest_total(self._h))
        kmers = np.empty(n, np.uint64)
        counts = np.empty(n, np.int32)
        lib().ingest_extract_counts(
            ctypes.c_void_p(self._h), kmers.ctypes.data_as(_u64p),
            counts.ctypes.data_as(_i32p))
        return kmers, counts, total

    def close(self):
        if self._h:
            lib().ingest_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeMapIndex:
    """Positional contig index and seed-and-extend mapper
    (native/map_engine.cpp): ``map_pair --engine native``, the oracle of
    the device mapper (scaffold/index.py)."""

    def __init__(self, ksize: int, concat: np.ndarray, offsets: np.ndarray):
        # the engine copies the bases, so the arrays need not outlive it
        c = np.ascontiguousarray(concat, np.uint8)
        off = np.ascontiguousarray(offsets, np.int64)
        if len(off) < 1 or off[0] != 0 or off[-1] != len(c) \
                or (np.diff(off) < 0).any():
            raise ValueError("offsets must rise from 0 to len(concat)")
        self._h = lib().mapidx_create(ksize, c.ctypes.data_as(_u8p),
                                      off.ctypes.data_as(_i64p),
                                      ctypes.c_int64(len(off) - 1))

    def map(self, codes: np.ndarray, ascii_seq: np.ndarray,
            lengths: np.ndarray, search_start: np.ndarray,
            seed_kmer_num: int, min_identity: float):
        """(mapped u8, contig i32, read_start, read_end, contig_start,
        contig_end i32, direct u8, identity f32), one row a read."""
        c = np.ascontiguousarray(codes, np.uint8)
        a = np.ascontiguousarray(ascii_seq, np.uint8)
        ln = np.ascontiguousarray(lengths, np.int32)
        ss = np.ascontiguousarray(search_start, np.int64)
        N, L = c.shape
        if a.shape != c.shape or ln.shape != (N,) or ss.shape != (N,):
            raise ValueError(f"codes {c.shape}, ascii {a.shape}, lengths "
                             f"{ln.shape}, search_start {ss.shape}")
        mapped, dr = np.zeros(N, np.uint8), np.zeros(N, np.uint8)
        cid, rs, re_, cs, ce = (np.zeros(N, np.int32) for _ in range(5))
        ident = np.zeros(N, np.float32)
        lib().mapidx_map(
            ctypes.c_void_p(self._h), c.ctypes.data_as(_u8p),
            a.ctypes.data_as(_u8p), ctypes.c_int64(N), ctypes.c_int(L),
            ln.ctypes.data_as(_i32p), ss.ctypes.data_as(_i64p),
            ctypes.c_int(seed_kmer_num), ctypes.c_double(min_identity),
            mapped.ctypes.data_as(_u8p), cid.ctypes.data_as(_i32p),
            rs.ctypes.data_as(_i32p), re_.ctypes.data_as(_i32p),
            cs.ctypes.data_as(_i32p), ce.ctypes.data_as(_i32p),
            dr.ctypes.data_as(_u8p),
            ident.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return mapped, cid, rs, re_, cs, ce, dr, ident

    def close(self):
        if self._h:
            lib().mapidx_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def fastq_parse(data: bytes, fq: bool, strict_n: bool = False,
                max_len: int | None = None, keep_ascii: bool = False):
    """Parse a decompressed one-line FASTQ/FASTA buffer into padded arrays
    (native/fastq_engine.cpp): codes in the k-mer alphabet (N -> 0, or 4
    with ``strict_n``), rows cut at ``max_len``.  Returns (codes, quals,
    lengths, head_off, head_len, ascii or None); FASTA quals are zeros."""
    buf = np.frombuffer(data, np.uint8)
    p = buf.ctypes.data_as(_u8p)
    n_rec = ctypes.c_int64()
    mx = ctypes.c_int64()
    lib().fastq_scan(p, ctypes.c_int64(len(buf)), ctypes.c_int(int(fq)),
                     ctypes.byref(n_rec), ctypes.byref(mx))
    n, Lmax = n_rec.value, mx.value
    if max_len is not None:
        Lmax = min(Lmax, max_len)
    codes = np.empty((n, Lmax), np.uint8)
    quals = np.empty((n, Lmax), np.uint8) if fq else np.zeros(
        (n, Lmax), np.uint8)
    aarr = np.empty((n, Lmax), np.uint8) if keep_ascii else None
    lengths = np.empty(n, np.int32)
    hoff = np.empty(n, np.int64)
    hlen = np.empty(n, np.int64)
    lib().fastq_fill(
        p, ctypes.c_int64(len(buf)), ctypes.c_int(int(fq)),
        ctypes.c_int64(Lmax), ctypes.c_int(int(strict_n)),
        codes.ctypes.data_as(_u8p),
        quals.ctypes.data_as(_u8p) if fq else None,
        aarr.ctypes.data_as(_u8p) if aarr is not None else None,
        lengths.ctypes.data_as(_i32p), hoff.ctypes.data_as(_i64p),
        hlen.ctypes.data_as(_i64p))
    return codes, quals, lengths, hoff, hlen, aarr


def correct_batch(reads: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                  bits: np.ndarray, bitmap: np.ndarray, params) -> tuple:
    """Native 5-phase correction of a read batch IN PLACE
    (native/correct_engine.cpp, the same recipe as correct.engine's
    ReadCorrector).  reads: uint8 concatenated read bytes, modified in
    place; offsets/lens per read; bits: [n, P] phase-1 flags (uint8, row
    stride bits.shape[1]); params: resolved CorrectParams.  Returns
    (one_score, multi_score, deleted, trim_left, trim_right) int32."""
    if reads.dtype != np.uint8 or not reads.flags.c_contiguous:
        raise ValueError("reads must be a contiguous uint8 array (it is "
                         "corrected in place)")
    n = len(lens)
    off = np.ascontiguousarray(offsets, np.int64)
    ln = np.ascontiguousarray(lens, np.int32)
    bt = np.ascontiguousarray(bits, np.uint8)
    bm = np.ascontiguousarray(bitmap, np.uint8)
    if len(off) != n or (n and bt.shape[0] != n):
        raise ValueError(f"{n} reads but {len(off)} offsets and "
                         f"{bt.shape[0]} rows of bits")
    outs = [np.zeros(n, np.int32) for _ in range(5)]
    lib().correct_batch(
        reads.ctypes.data_as(_u8p), off.ctypes.data_as(_i64p),
        ln.ctypes.data_as(_i32p), ctypes.c_int64(n),
        bt.ctypes.data_as(_u8p),
        ctypes.c_int64(bt.shape[1] if bt.ndim == 2 else 0),
        bm.ctypes.data_as(_u8p), ctypes.c_int(params.ksize),
        ctypes.c_int(params.high_freq_reg_len),
        ctypes.c_int(params.max_change), ctypes.c_int(params.further_trim),
        ctypes.c_int64(params.max_bbt_nodes),
        ctypes.c_int(params.min_read_len),
        *(o.ctypes.data_as(_i32p) for o in outs))
    return tuple(outs)


def jenkins64(x) -> np.ndarray:
    """Vectorized Jenkins 64-bit hash (numpy; parity kmerSet.h:105-116)."""
    with np.errstate(over="ignore"):
        k = np.asarray(x, dtype=np.uint64).copy()
        t = np.empty_like(k)
        for sh, op, inv in ((32, "add", True), (22, "xor", False),
                            (13, "add", True), (8, "xor", False),
                            (3, "add", False), (15, "xor", False),
                            (27, "add", True), (31, "xor", False)):
            if op == "add":
                np.left_shift(k, np.uint64(sh), out=t)
                if inv:
                    np.invert(t, out=t)
                np.add(k, t, out=k)
            else:
                np.right_shift(k, np.uint64(sh), out=t)
                np.bitwise_xor(k, t, out=k)
        return k


def find_next_prime(n: int) -> int:
    return int(lib().find_next_prime(ctypes.c_uint64(n)))


def _huge_zeros(n: int) -> np.ndarray:
    """np.zeros marked MADV_HUGEPAGE before first touch (the hash-layout
    probes land at random)."""
    a = np.zeros(n, np.uint8)
    lib().madv_huge(ctypes.c_void_p(a.ctypes.data), a.nbytes)
    return a


def _huge_empty(n: int, dtype) -> np.ndarray:
    """np.empty marked MADV_HUGEPAGE before first touch: buffers the native
    passes and the readout's gathers touch at random."""
    a = np.empty(n, dtype)
    lib().madv_huge(ctypes.c_void_p(a.ctypes.data), a.nbytes)
    return a


def slot_rank(slot_of: np.ndarray, size: int) -> np.ndarray:
    """node -> iteration rank by ascending hash slot (one dense pass)."""
    so = np.ascontiguousarray(slot_of, np.int64)
    out = _huge_empty(len(so), np.int64)
    lib().slot_rank(so.ctypes.data_as(_i64p), ctypes.c_int64(len(so)),
                    ctypes.c_uint64(size), out.ctypes.data_as(_i64p))
    return out


def links_pass(lcnt: np.ndarray, rcnt: np.ndarray, cut: int):
    """Per-node link counts (capped at 3), first-strict-max bases and the
    256-bin depth histogram over both counter planes (calculate_kmer_links,
    contig.cpp:107-205).  Returns (l_num, r_num, l_base, r_base, hist)."""
    lc = np.ascontiguousarray(lcnt, np.int32)
    rc = np.ascontiguousarray(rcnt, np.int32)
    M = len(lc)
    l_num, r_num, l_base, r_base = (np.empty(M, np.int32) for _ in range(4))
    hist = np.empty(256, np.int64)
    lib().links_pass(lc.ctypes.data_as(_i32p), rc.ctypes.data_as(_i32p),
                     ctypes.c_int64(M), ctypes.c_int32(cut),
                     l_num.ctypes.data_as(_i32p), r_num.ctypes.data_as(_i32p),
                     l_base.ctypes.data_as(_i32p),
                     r_base.ctypes.data_as(_i32p), hist.ctypes.data_as(_i64p))
    return l_num, r_num, l_base, r_base, hist


def succ_build(kmers: np.ndarray, l_base: np.ndarray, r_base: np.ndarray,
               alive: np.ndarray, k: int) -> np.ndarray:
    """Directed successor function over the 2M interleaved states (host
    hash-lookup twin of pointer_doubling._succ_resolve's successor step)."""
    km = np.ascontiguousarray(kmers, np.uint64)
    lb = np.ascontiguousarray(l_base, np.int32)
    rb = np.ascontiguousarray(r_base, np.int32)
    al = np.ascontiguousarray(alive, np.uint8)
    out = _huge_empty(2 * len(km), np.int64)
    lib().succ_build(km.ctypes.data_as(_u64p), ctypes.c_int64(len(km)),
                     lb.ctypes.data_as(_i32p), rb.ctypes.data_as(_i32p),
                     al.ctypes.data_as(_u8p), ctypes.c_int(k),
                     out.ctypes.data_as(_i64p))
    return out


def resolve_chains_host(succ: np.ndarray):
    """Host twin of pointer_doubling._resolve_chains: the same (end, dist)
    on every non-cyclic state; cyclic states carry only the flag.  Returns
    (e int64, dist int64, cyclic bool)."""
    sc = np.ascontiguousarray(succ, np.int64)
    n = len(sc)
    e = _huge_empty(n, np.int64)
    dist = _huge_empty(n, np.int64)
    cyc = _huge_empty(n, np.uint8)
    lib().resolve_chains_host(sc.ctypes.data_as(_i64p), ctypes.c_int64(n),
                              e.ctypes.data_as(_i64p),
                              dist.ctypes.data_as(_i64p),
                              cyc.ctypes.data_as(_u8p))
    return e, dist, cyc.astype(bool)


def collect_heads(alive: np.ndarray, succ: np.ndarray, cyclic: np.ndarray):
    """Chain heads and cyclic-fallback nodes in one scan: state s is a head
    iff its node is alive, neither s nor s^1 is cyclic and s^1 has no
    successor.  Returns (head_states int64, fallback_nodes int64).

    Scratch: 8 * n bytes for the heads and 4 * n for the fallback nodes,
    allocated whole but touched only as far as they fill."""
    al = np.ascontiguousarray(alive, np.uint8)
    sc = np.ascontiguousarray(succ, np.int64)
    cy = np.ascontiguousarray(cyclic, np.uint8)
    n = len(sc)
    heads = np.empty(n, np.int64)
    fb = np.empty(n // 2 + 1, np.int64)
    fbc = ctypes.c_int64(0)
    nh = lib().collect_heads(al.ctypes.data_as(_u8p), sc.ctypes.data_as(_i64p),
                             cy.ctypes.data_as(_u8p), ctypes.c_int64(n),
                             heads.ctypes.data_as(_i64p),
                             fb.ctypes.data_as(_i64p), ctypes.byref(fbc))
    return heads[:nh].copy(), fb[:fbc.value].copy()


def seg_argmin(cid: np.ndarray, key: np.ndarray, n_groups: int) -> np.ndarray:
    """Per-group argmin: out[g] = the index i of the smallest (key[i], i)
    with cid[i] == g.  Raises if a group has no member, where the native
    pass leaves -1, which would index from the end if used."""
    ci = np.ascontiguousarray(cid, np.int64)
    ke = np.ascontiguousarray(key, np.int64)
    if len(ci) != len(ke):
        raise ValueError(f"cid has {len(ci)} entries, key {len(ke)}")
    out = np.empty(n_groups, np.int64)
    lib().seg_argmin(ci.ctypes.data_as(_i64p), ke.ctypes.data_as(_i64p),
                     ctypes.c_int64(len(ci)), ctypes.c_int64(n_groups),
                     out.ctypes.data_as(_i64p))
    empty = np.flatnonzero(out < 0)
    if len(empty):
        raise ValueError(f"seg_argmin: {len(empty)} of {n_groups} groups "
                         f"have no member (first: group {int(empty[0])})")
    return out


def gcc44_sort_perm_desc(lens: np.ndarray) -> np.ndarray:
    """Index permutation of GCC 4.4's std::sort (the reference binaries'
    compiler), descending by length, with its unstable tie order."""
    ln = np.ascontiguousarray(lens, np.uint64)
    out = np.empty(len(ln), np.int64)
    lib().gcc44_sort_perm_desc(ln.ctypes.data_as(_u64p),
                               ctypes.c_int64(len(ln)),
                               out.ctypes.data_as(_i64p))
    return out


def stdsort_perm_desc(lens: np.ndarray) -> np.ndarray:
    """Index permutation of this host's libstdc++ std::sort, descending by
    length (its tie order may differ from gcc44_sort_perm_desc's)."""
    ln = np.ascontiguousarray(lens, np.uint64)
    out = np.empty(len(ln), np.int64)
    lib().stdsort_perm_desc(ln.ctypes.data_as(_u64p),
                            ctypes.c_int64(len(ln)),
                            out.ctypes.data_as(_i64p))
    return out


def hash_layout(kmers_in_order: np.ndarray, size: int):
    """Slot of each key inserted in the given order.  Returns (slots int64
    [n], conflicts)."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    occ = _huge_zeros(size)
    out = np.empty(len(km), dtype=np.int64)
    conflicts = lib().hash_layout(
        km.ctypes.data_as(_u64p), ctypes.c_int64(len(km)),
        ctypes.c_uint64(size), occ.ctypes.data_as(_u8p),
        out.ctypes.data_as(_i64p))
    return out, int(conflicts)


def hash_layout_disp(kmers_in_order: np.ndarray, size: int):
    """Slot of each key inserted in the given order, plus its insert
    displacement.  Returns (slots int64 [n], disp int64 [n], conflicts)."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    occ = _huge_zeros(size)
    out = np.empty(len(km), dtype=np.int64)
    disp = np.empty(len(km), dtype=np.int64)
    conflicts = lib().hash_layout_disp(
        km.ctypes.data_as(_u64p), ctypes.c_int64(len(km)),
        ctypes.c_uint64(size), occ.ctypes.data_as(_u8p),
        out.ctypes.data_as(_i64p), disp.ctypes.data_as(_i64p))
    return out, disp, int(conflicts)


def hash_layout_epochs(kmers_in_order: np.ndarray, sizes: list[int],
                       ends: list[int], want_snapshots: bool = True):
    """Slot assignment with hash enlargement (kmerSet.cpp:132-189).
    sizes: hash size per epoch; ends[e]: node count at which enlargement e
    fires.  Returns (slots int64 [n], insert_conflicts, snapshots int64
    [E+1, n]: each node's slot during epoch e, -1 before insertion).
    want_snapshots=False, as in JAX's (dbg_assembly_tpu/native.py:471),
    passes the native call a null pointer, allocates no [E+1, n] array and
    returns None for the snapshots."""
    km = np.ascontiguousarray(kmers_in_order, dtype=np.uint64)
    n = len(km)
    n_enl = len(sizes) - 1
    sz = np.asarray(sizes, dtype=np.uint64)
    en = np.asarray(list(ends) + [0], dtype=np.int64)   # never empty
    out = np.empty(n, dtype=np.int64)
    snaps = np.empty((n_enl + 1, n), dtype=np.int64) if want_snapshots \
        else None
    conflicts = lib().hash_layout_epochs(
        km.ctypes.data_as(_u64p), ctypes.c_int64(n),
        sz.ctypes.data_as(_u64p), en.ctypes.data_as(_i64p),
        ctypes.c_int64(n_enl), out.ctypes.data_as(_i64p),
        None if snaps is None else snaps.ctypes.data_as(_i64p))
    return out, int(conflicts), snaps


def assemble_run(kmer: np.ndarray, lcnt: np.ndarray, rcnt: np.ndarray,
                 n_nodes: int, slot_of: np.ndarray, hash_size: int,
                 slot_order: np.ndarray, prefix: str, params) -> np.ndarray:
    """Full native pruning+readout (native/assemble_engine.cpp); writes the
    eight .contig.* artifacts and returns the int64[15] stats vector.
    lcnt/rcnt (int32, contiguous) are mutated in place."""
    p = params
    stats = np.zeros(15, np.int64)
    rc = lib().assemble_run(
        np.ascontiguousarray(kmer, np.uint64).ctypes.data_as(_u64p),
        lcnt.ctypes.data_as(_i32p), rcnt.ctypes.data_as(_i32p),
        ctypes.c_int64(n_nodes),
        np.ascontiguousarray(slot_of, np.int64).ctypes.data_as(_i64p),
        ctypes.c_uint64(hash_size),
        np.ascontiguousarray(slot_order, np.int64).ctypes.data_as(_i64p),
        ctypes.c_int(p.ksize), ctypes.c_int(p.kmer_freq_cutoff),
        ctypes.c_int(int(p.is_remove_tip)), ctypes.c_int(p.tip_len_cutoff),
        ctypes.c_double(p.tip_depth_cutoff),
        ctypes.c_int(int(p.is_remove_lowedge)),
        ctypes.c_int(p.lowedge_len_cutoff),
        ctypes.c_double(p.lowedge_depth_cutoff),
        ctypes.c_int(int(p.is_remove_bubble)),
        ctypes.c_int(p.bubble_len_cutoff),
        ctypes.c_double(p.bubble_len_diff_rate),
        ctypes.c_double(p.bubble_base_diff_rate),
        ctypes.c_int(p.contig_len_cutoff), prefix.encode(),
        stats.ctypes.data_as(_i64p))
    if rc != 0:
        raise OSError(f"assemble_engine could not open an output file "
                      f"under prefix {prefix!r} (see stderr)")
    return stats


def radix_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of uint64/int64 keys (native LSD radix)."""
    k = np.ascontiguousarray(keys, np.uint64)
    out = np.empty(len(k), np.int64)
    lib().radix_argsort_u64(k.ctypes.data_as(_u64p),
                            ctypes.c_int64(len(k)),
                            out.ctypes.data_as(_i64p))
    return out
