"""clean_adapter: adapter trimming by an ungapped local DP, on the device.

Counterpart of dbg_assembly_tpu/clean/adapter.py.  Reference semantics
(clean_illumina/clean_adapter.cpp):
  * the alphabet maps N and every non-ACGT byte to 4 (:54-64); the score is
    +1 for a base match and -2 otherwise, N against N included (:67-73);
  * the "DP" is diagonal only (ungapped): S[i][j] = max(0, S[i-1][j-1] + s)
    (:120-135); the best cell is kept with a strict '>', so ties go to the
    first cell in row-major (read position, adapter position) order
    (:129-133);
  * the traceback walks the diagonal back to the nearest zero cell and the
    start is the cell after it (:138-149);
  * adapters are tried in file order and the FIRST whose best score reaches
    the cutoff wins, cutting the read at align_read_start - 1 (:189-206),
    with the header annotation of :199-202;
  * reads shorter than the minimum after trimming are emptied
    ("RemoveShort", :211-216); every read is written out.

The JAX package scans the read positions with lax.scan, carrying the DP row
[N, M+1] and each cell's run start [N, M+1, 2] so that no traceback pass is
needed.  Here the scan is a host loop over the positions, each step a few
torch ops on [N, M] int32 tensors on the device; the DP row and the run
starts are three [N, M+1] rows, each written into two buffers in turn.
All adapters are scored, and the first-hit rule is applied
afterwards by index arithmetic: the same result, no early exit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import dna, resolve_device, spans
from ..io import fastq, stat as statio

DEFAULT_ADAPTERS = {
    # shipped defaults: clean_illumina/illumina_NEB_adapter*.fa
    "Both-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC"),
                     ("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
    "R1-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC")],
    "R2-adapter": [("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
}

# reads a device batch: a step holds about ten [N, M+1] int32 planes
DEFAULT_CHUNK = 1 << 20

# what the DP did since the last reset_counts(): device batches (one an
# adapter a chunk) and host-loop steps (one a read position a batch)
counts = {"chunks": 0, "steps": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def _align_one_adapter(read_codes: torch.Tensor, lengths: torch.Tensor,
                       adapter_codes: np.ndarray, adapter_len: int):
    """Ungapped local alignment of every read against one adapter, on the
    device of ``read_codes``.

    read_codes: [N, L] uint8 (strict alphabet: N = 4); lengths [N].
    Returns (max_score, i_end, j_end, i_start, j_start), each [N] int32,
    in the reference traceback's 1-based coordinates."""
    dev = read_codes.device
    N, L = read_codes.shape
    M = adapter_len
    i32 = torch.int32
    a = torch.from_numpy(np.asarray(adapter_codes[:M], np.int64)).to(dev)
    # score of a read byte (the row) against each adapter position
    byte = torch.arange(256, device=dev)[:, None]
    score = torch.where((byte == a[None, :]) & (byte < 4), 1, -2).to(i32)
    jpos = torch.arange(1, M + 1, dtype=i32, device=dev)[None, :]
    ipos = torch.arange(L + 1, dtype=i32, device=dev)   # ipos[i]: a view
    lens = lengths.to(device=dev, dtype=i32)
    cols = read_codes.t().contiguous()                  # [L, N]

    # two buffers a row, used in turn: step i reads row i-1's columns
    # 0..M-1 and writes row i's columns 1..M; column 0 stays zero
    dp_row, start_i, start_j = ([torch.zeros((N, M + 1), dtype=i32,
                                             device=dev) for _ in range(2)]
                                for _ in range(3))
    bs, bi, bj, bsi, bsj = (torch.zeros(N, dtype=i32, device=dev)
                            for _ in range(5))
    for i in range(1, L + 1):                           # 1-based row
        cur, nxt = (i - 1) & 1, i & 1
        s = score[cols[i - 1].to(torch.int64)]          # [N, M]
        prev = dp_row[cur][:, :M]                       # S[i-1][j-1]
        val = torch.add(prev, s, out=dp_row[nxt][:, 1:]).clamp_min_(0)
        # a run starts at (i, j) when the diagonal predecessor cell is zero
        zero = prev == 0
        new_start_i = torch.where(zero, ipos[i], start_i[cur][:, :M],
                                  out=start_i[nxt][:, 1:])
        new_start_j = torch.where(zero, jpos, start_j[cur][:, :M],
                                  out=start_j[nxt][:, 1:])
        # row-major strict '>': within the row argmax picks the first
        # maximal j; across rows only a strictly greater score replaces
        row_best_j = torch.argmax(val, 1)
        row_best = torch.where(i <= lens, val.amax(1), -1)
        better = row_best > bs
        bs = torch.where(better, row_best, bs)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, (row_best_j + 1).to(i32), bj)
        take = row_best_j[:, None]
        bsi = torch.where(better, new_start_i.gather(1, take)[:, 0], bsi)
        bsj = torch.where(better, new_start_j.gather(1, take)[:, 0], bsj)
    counts["steps"] += L
    return bs, bi, bj, bsi, bsj


@dataclass
class AdapterResult:
    hit: np.ndarray            # [N] adapter index or -1
    score: np.ndarray          # [N]
    read_start: np.ndarray     # [N] 1-based alignment start on read
    read_end: np.ndarray       # [N]
    adapter_start: np.ndarray  # [N]
    adapter_end: np.ndarray    # [N]
    keep_len: np.ndarray       # [N] after trimming, before short filter
    short: np.ndarray          # [N] bool


def clean_adapter_arrays(read_codes: np.ndarray, lengths: np.ndarray,
                         adapters: list[str], score_cutoff: int,
                         min_read_len: int, device="cuda",
                         chunk: int = DEFAULT_CHUNK) -> AdapterResult:
    """Every adapter's DP on ``device``, ``chunk`` reads at a time; the
    first adapter whose score reaches ``score_cutoff`` wins."""
    dev = resolve_device(device)
    n = len(read_codes)
    per_adapter = []
    for aseq in adapters:
        acodes = dna.ascii_to_codes(
            np.frombuffer(aseq.encode(), np.uint8), strict_n=True)
        outs = [np.zeros(n, np.int32) for _ in range(5)]
        for off in range(0, n, chunk):
            end = min(off + chunk, n)
            with spans.span("adapter.align", chunks=1, reads=end - off):
                res = _align_one_adapter(
                    torch.from_numpy(np.ascontiguousarray(
                        read_codes[off:end])).to(dev),
                    torch.from_numpy(np.ascontiguousarray(
                        lengths[off:end], np.int32)),
                    acodes, len(aseq))
                for o, x in zip(outs, res):
                    o[off:end] = x.cpu().numpy()
            counts["chunks"] += 1
        per_adapter.append(outs)

    hit = np.full(n, -1, np.int64)
    score = np.zeros(n, np.int64)
    rs = np.zeros(n, np.int64)
    re_ = np.zeros(n, np.int64)
    as_ = np.zeros(n, np.int64)
    ae = np.zeros(n, np.int64)
    for ai, (bs, bi, bj, bsi, bsj) in enumerate(per_adapter):
        sel = (hit < 0) & (bs >= score_cutoff)
        hit = np.where(sel, ai, hit)
        score = np.where(sel, bs, score)
        rs = np.where(sel, bsi, rs)
        re_ = np.where(sel, bi, re_)
        as_ = np.where(sel, bsj, as_)
        ae = np.where(sel, bj, ae)

    keep_len = np.where(hit >= 0, rs - 1, lengths.astype(np.int64))
    short = keep_len < min_read_len
    return AdapterResult(hit, score, rs, re_, as_, ae, keep_len, short)


def load_adapter_file(path: str, use_rc: bool = False):
    """Parse a multi-FASTA adapter file (read_fasta,
    clean_adapter.cpp:234-268); use_rc (-b 1) adds each adapter's reverse
    complement after it."""
    ids, seqs = [], []
    with open(path) as f:
        cur_id, cur = None, []
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur_id is not None:
                    seqs.append("".join(cur))
                    ids.append(cur_id)
                cur_id = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
        if cur_id is not None:
            seqs.append("".join(cur))
            ids.append(cur_id)
    if use_rc:
        out_ids, out_seqs = [], []
        comp = str.maketrans("ACGTNacgtn", "TGCANtgcan")
        for i, s in zip(ids, seqs):
            out_ids.append(i)
            out_seqs.append(s)
            out_ids.append(i + " minus-strand")
            out_seqs.append(s.translate(comp)[::-1])
        return out_ids, out_seqs
    return ids, seqs


def run_file(in_path: str, out_path: str, stat_path: str,
             adapter_file: str = "Both-adapter", score_cutoff: int = 12,
             min_read_len: int = 75, use_rc: bool = False,
             device="cuda") -> dict:
    """clean_adapter <in> <out> <stat>: the trimmed reads as one-line
    FASTQ (gzip, compared on its decompressed bytes) and the .stat."""
    dev = resolve_device(device)
    if adapter_file in DEFAULT_ADAPTERS:
        ids = [x[0] for x in DEFAULT_ADAPTERS[adapter_file]]
        seqs = [x[1] for x in DEFAULT_ADAPTERS[adapter_file]]
    else:
        ids, seqs = load_adapter_file(adapter_file, use_rc)

    batch = fastq.read_batch(in_path, fmt="fq", strict_n=True,
                             keep_heads=True, keep_ascii=True)
    seq = batch.seqs_ascii
    lengths = batch.lengths.astype(np.int64)
    res = clean_adapter_arrays(batch.codes, batch.lengths, seqs,
                               score_cutoff, min_read_len, dev)
    n = batch.n_reads

    raw_reads = n
    raw_bases = int(lengths.sum())
    trimmed = res.hit >= 0
    trimmed_reads = int(trimmed.sum())
    trimmed_bases = int((lengths - res.read_start + 1)[trimmed].sum())
    short_reads = int(res.short.sum())
    short_bases = int(res.keep_len[res.short].clip(0).sum())
    final_len = np.where(res.short, 0, res.keep_len)
    clean_reads = int((~res.short).sum())
    clean_bases = int(final_len[~res.short].sum())

    out = bytearray()
    with spans.span("adapter.format", records=n):
        for i in range(n):
            head = batch.heads[i]
            if trimmed[i]:
                head += (f"   Aligned to adapter {ids[res.hit[i]]}, "
                         f" reads_pos: {res.read_start[i]}-"
                         f"{res.read_end[i]}, "
                         f"adapter_pos: {res.adapter_start[i]}-"
                         f"{res.adapter_end[i]},   score: {res.score[i]}"
                         ).encode()
            if res.short[i]:
                head += b"   RemoveShort"
            l_ = int(final_len[i])
            out += head + b"\n" + seq[i, :l_].tobytes() + b"\n+\n" \
                + batch.quals[i, :l_].tobytes() + b"\n"
    fastq.gz_write_bytes(out_path, bytes(out))

    statio.write_clean_adapter_stat(stat_path, raw_reads, raw_bases,
                                    trimmed_reads, trimmed_bases,
                                    short_reads, short_bases,
                                    clean_reads, clean_bases)
    return dict(raw_reads=raw_reads, clean_reads=clean_reads)
