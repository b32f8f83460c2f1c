"""De Bruijn graph construction: per-batch chop, sort and segment reduce.

Counterpart of dbg_assembly_tpu/contig/graph.py.  The reference ingests
reads into a lock-free hash of KmerNode{kmer, l_link, r_link} with four
8-bit saturating counters per side (DBG_contig/kmerSet.h:70-75,
DBGgraph.cpp:126-213).  Here, per batch on the device:
  1. the chop kernel in edge mode gives each window its canonical k-mer and
     its strand-adjusted left/right neighbour codes (4 at a read edge,
     DBGgraph.cpp:76-89);
  2. a stable sort by k-mer (ops.sort, with the permutation);
  3. segment sums of the neighbour codes into 2x4 counters (clipped at 255
     per batch), run lengths, and the run's smallest stream index (first
     occurrence order, which the readout's hash-layout emulation needs).
Batches merge on the device; finalize() returns a NodeTable of numpy
arrays, the host boundary.

Parity notes: read length capped at max_read_len (DBGgraph.cpp:63); reads
shorter than k skipped (DBGgraph.cpp:51-53); N reads as A inside k-mers and
as a neighbour (seqKmer.cpp:15-17); saturation at 255 == min(total, 255).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops import sort as radix
from ..ops.chop import chop


def _chop_with_edges(codes: torch.Tensor, lengths: torch.Tensor,
                     ksize: int):
    """[N, L] codes -> (canonical kmers [N, P] int64, left, right [N, P]
    uint8); SENTINEL and 4/4 at invalid windows.  The chop kernel's edge
    mode."""
    return chop(codes, lengths, ksize, edges=True)


def _node_records(sk: torch.Tensor, order: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor):
    """Per-run records of sorted k-mers sk = keys[order] (no sentinel),
    left/right the flat neighbour codes of the unsorted keys.  Returns
    (uniq [M] int64, lcnt [M, 4] int32, rcnt [M, 4] int32, head [M] int64
    = order at each run's start, counts [M] int32)."""
    n = sk.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=sk.device)
    first[1:] = sk[1:] != sk[:-1]
    starts = torch.nonzero(first).squeeze(1)
    M = starts.shape[0]
    seg = torch.cumsum(first, 0) - 1
    counters = []
    for side in (left, right):
        # neighbour code 4 (none) lands in a fifth column that is dropped
        key = seg * 5 + side[order].to(torch.int64)
        cnt = torch.bincount(key, minlength=M * 5).view(M, 5)[:, :4]
        counters.append(cnt.to(torch.int32))
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    return (sk[starts], counters[0], counters[1], order[starts],
            (ends - starts).to(torch.int32))


def _aggregate_batch(codes: torch.Tensor, lengths: torch.Tensor,
                     ksize: int, base_index: int):
    """Chop one batch and reduce it per distinct k-mer.

    Window (row, j) has stream index base_index + row * P + j.  Returns
    (uniq [M] int64 ascending, lcnt [M, 4] int32, rcnt [M, 4] int32 clipped
    at 255, first_idx [M] int64 = the run's smallest stream index,
    counts [M] int32, n_valid)."""
    kmers, left, right = _chop_with_edges(codes, lengths, ksize)
    P = kmers.shape[1]
    n_valid = int((lengths.to(torch.int64) - ksize + 1).clamp(0, P).sum())
    # 2k + 1 bits: the sentinel's low bits order it after every k-mer
    sk, order = radix.sort(kmers.reshape(-1), 2 * ksize + 1,
                           return_index=True)
    uniq, lcnt, rcnt, head, counts = _node_records(
        sk[:n_valid], order[:n_valid], left.reshape(-1), right.reshape(-1))
    # the stable sort keeps stream order inside a run: its head is the min
    return (uniq, lcnt.clamp_(max=255), rcnt.clamp_(max=255),
            base_index + head, counts, n_valid)


@dataclass
class NodeTable:
    """Aggregated de Bruijn node table, sorted by k-mer value (host side)."""
    kmers: np.ndarray       # [M] uint64 canonical, sorted ascending
    lcnt: np.ndarray        # [M, 4] int32, saturated at 255 (the
    rcnt: np.ndarray        # reference's 8-bit counters, kmerSet.cpp:341)
    first_idx: np.ndarray   # [M] int64 first-occurrence stream position
    total_kmers: int = 0
    total_reads: int = 0
    counts: np.ndarray | None = None   # [M] int32 k-mer individuals

    @property
    def n_nodes(self) -> int:
        return len(self.kmers)

    @classmethod
    def from_numpy(cls, kmers_u64, lcnt, rcnt, first_idx, counts,
                   total_kmers: int, total_reads: int) -> "NodeTable":
        """A table from the arrays of a dbg_assembly_tpu NodeTable (or any
        caller's), checked against the dtypes the readout depends on."""
        M = len(kmers_u64)
        want = ((kmers_u64, np.uint64, (M,)), (lcnt, np.int32, (M, 4)),
                (rcnt, np.int32, (M, 4)), (first_idx, np.int64, (M,)),
                (counts, np.int32, (M,)))
        for arr, dt, shape in want:
            if arr.dtype != dt or arr.shape != shape:
                raise TypeError(f"expected {np.dtype(dt)} {shape}, got "
                                f"{arr.dtype} {arr.shape}")
        return cls(*(np.ascontiguousarray(a) for a in
                     (kmers_u64, lcnt, rcnt, first_idx)),
                   int(total_kmers), int(total_reads),
                   counts=np.ascontiguousarray(counts))

    def to_numpy(self):
        """(kmers uint64, lcnt, rcnt, first_idx, counts, total_kmers,
        total_reads): the arguments of from_numpy."""
        return (self.kmers, self.lcnt, self.rcnt, self.first_idx,
                self.counts, self.total_kmers, self.total_reads)


def _merge_parts(parts, ksize: int):
    """Merge per-batch node records into one, on their device: counters
    and counts add, first_idx takes the minimum."""
    ks = torch.cat([p[0] for p in parts])
    ks, order = radix.sort(ks, 2 * ksize, return_index=True)
    first = torch.ones(ks.shape[0], dtype=torch.bool, device=ks.device)
    first[1:] = ks[1:] != ks[:-1]
    starts = torch.nonzero(first).squeeze(1)
    seg = torch.cumsum(first, 0) - 1
    M = starts.shape[0]
    out = [ks[starts]]
    for i in (1, 2, 4):       # lcnt, rcnt, counts: sums
        v = torch.cat([p[i] for p in parts])[order]
        acc = torch.zeros((M,) + v.shape[1:], dtype=v.dtype, device=v.device)
        out.append(acc.index_add_(0, seg, v))
    fi = torch.cat([p[3] for p in parts])[order]
    fmin = torch.full((M,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=fi.device).scatter_reduce_(0, seg, fi, "amin")
    return [(out[0], out[1], out[2], fmin, out[3])]


class GraphBuilder:
    """Streaming builder on ``device``: feed read batches, finalize to a
    NodeTable.

    mesh (parallel/mesh.Mesh): the distributed path in place of
    ``device``: each batch's rows shard over the slots, k-mers route to
    their owner slot (parallel/count_sharded.graph_ingest_step_exact) and
    each slot merges its own records; finalize() equals the single-device
    builder's, array for array."""

    def __init__(self, ksize: int, max_read_len: int = 250,
                 batch_reads: int = 100_000, mesh=None, device="cuda"):
        if not 1 <= ksize <= 31:
            raise ValueError(f"k={ksize} outside 1..31")
        self.ksize = ksize
        self.max_read_len = max_read_len
        self.batch_reads = batch_reads
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        self.parts = []
        # the mesh's records, a list a slot, each on its slot's device
        self.slot_parts = [[] for _ in range(mesh.n)] if mesh else []
        self.stream_pos = 0       # global k-mer position counter
        self.total_kmers = 0
        self.total_reads = 0
        # stream -> read-ordinal mapping for the enlargement/degrade
        # emulation (kmerSet.cpp:132-189, DBGgraph.cpp:337-351): ordinals
        # count EVERY read fed (including <k skips — they occupy reference
        # buffer slots); segments record (stream_base, P, kept_ordinals)
        self.read_seq = 0
        self.file_starts: list[int] = []
        self._segments: list[tuple[int, int, np.ndarray]] = []

    def new_file(self) -> None:
        """Mark a reference file boundary (buffers never span files)."""
        self.file_starts.append(self.read_seq)

    def stream_to_read(self, stream_idx: np.ndarray) -> np.ndarray:
        """Map stream positions (first_idx values) to global read ordinals."""
        if not self._segments:
            return np.zeros(len(stream_idx), np.int64)
        bases = np.array([s[0] for s in self._segments], np.int64)
        seg = np.searchsorted(bases, stream_idx, side="right") - 1
        out = np.empty(len(stream_idx), np.int64)
        for s in np.unique(seg):
            base, P, ords = self._segments[s]
            m = seg == s
            out[m] = ords[(stream_idx[m] - base) // P]
        return out

    def add(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        if codes.shape[1] > self.max_read_len:
            codes = codes[:, :self.max_read_len]
            lengths = np.minimum(lengths, self.max_read_len)
        k = self.ksize
        for off in range(0, len(codes), self.batch_reads):
            lb = lengths[off:off + self.batch_reads]
            keep = lb >= k        # skip reads shorter than k
            cb = codes[off:off + self.batch_reads][keep]
            lb = lb[keep]
            if len(cb) == 0:
                continue
            # stream positions: row-major over this batch's [N, P] layout
            P = cb.shape[1] - k + 1
            self._segments.append(
                (self.stream_pos, P,
                 self.read_seq + off + np.flatnonzero(keep)))
            if self.mesh is not None:
                self._add_mesh(cb, lb)
                continue
            ct = torch.from_numpy(np.ascontiguousarray(cb, np.uint8))
            lt = torch.from_numpy(np.ascontiguousarray(lb, np.int32))
            *rec, n_valid = _aggregate_batch(
                ct.to(self.device), lt.to(self.device), k, self.stream_pos)
            self.parts.append(tuple(rec))
            self.stream_pos += len(cb) * P
            self.total_kmers += n_valid
            self.total_reads += len(cb)
            if len(self.parts) >= 8:
                self.parts = _merge_parts(self.parts, self.ksize)
        self.read_seq += len(codes)

    def _add_mesh(self, cb: np.ndarray, lb: np.ndarray) -> None:
        from ..parallel import count_sharded
        from ..parallel import mesh as meshmod
        k = self.ksize
        D = self.mesh.n
        n_rows = len(cb)
        # pad rows have length 0: no valid window, no position recorded
        cs, ls = meshmod.shard_batch(
            self.mesh,
            meshmod.pad_to_multiple(np.ascontiguousarray(cb, np.uint8), D),
            meshmod.pad_to_multiple(np.ascontiguousarray(lb, np.int32), D))
        *rec, n_unique, stats = count_sharded.graph_ingest_step_exact(
            cs, ls, self.stream_pos, ksize=k, mesh=self.mesh)
        for d in range(D):
            part = tuple(r[d] for r in rec)
            if any(x.shape[0] != n_unique[d] for x in part):
                raise RuntimeError(
                    f"shard {d}: record arrays of "
                    f"{[x.shape[0] for x in part]} rows != reported n_unique "
                    f"{n_unique[d]}; the merged node table would be corrupt")
            self.slot_parts[d].append(part)
            if len(self.slot_parts[d]) >= 8:
                self.slot_parts[d] = _merge_parts(self.slot_parts[d], k)
        # advance by the UNPADDED rows, as the single-device builder does
        self.stream_pos += n_rows * (cb.shape[1] - k + 1)
        self.total_kmers += stats["total_kmers"]
        self.total_reads += n_rows

    def _gather_slots(self) -> None:
        """Each slot's merged records, gathered to the first slot (owners
        hold disjoint k-mers, so the merge after only orders them).  Every
        batch gives every slot a part, empty or not."""
        from ..parallel import mesh as meshmod
        if self.slot_parts[0]:
            merged = [_merge_parts(p, self.ksize)[0] for p in self.slot_parts]
            self.parts = [tuple(meshmod.gather(self.mesh,
                                               [m[i] for m in merged])
                                for i in range(5))]
        self.slot_parts = [[] for _ in range(self.mesh.n)]

    def finalize(self) -> NodeTable:
        if self.mesh is not None:
            self._gather_slots()
        if not self.parts:
            return NodeTable(np.zeros(0, np.uint64), np.zeros((0, 4), np.int32),
                             np.zeros((0, 4), np.int32), np.zeros(0, np.int64),
                             0, self.total_reads,
                             counts=np.zeros(0, np.int32))
        self.parts = _merge_parts(self.parts, self.ksize)
        u, l_, r, f, c = self.parts[0]
        self.parts = []
        # saturation applies at the end of the merge chain: min(total, 255)
        # equals the reference's per-increment saturating add
        return NodeTable(u.cpu().numpy().view(np.uint64),
                         l_.clamp(max=255).cpu().numpy(),
                         r.clamp(max=255).cpu().numpy(),
                         f.cpu().numpy(), self.total_kmers, self.total_reads,
                         counts=c.cpu().numpy())


def build_from_files(files: list[str], ksize: int, fmt: str = "fq",
                     max_read_len: int = 250, device="cuda") -> NodeTable:
    """The node table of every read of ``files``, in order, on ``device``."""
    from ..io import fastq
    gb = GraphBuilder(ksize, max_read_len, device=device)
    for path in files:
        batch = fastq.read_batch(path, fmt=fmt, strict_n=False,
                                 keep_heads=False)
        gb.add(batch.codes, batch.lengths)
    return gb.finalize()
