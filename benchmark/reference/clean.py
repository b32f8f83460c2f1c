"""Plain PyTorch reference of the two cleaners, clean_lowqual and
clean_adapter: every read's record and the .stat of each.

Semantics of the upstream's clean_illumina (fanagislab/DBG_assembly,
clean_illumina/clean_lowqual.cpp, clean_adapter.cpp), as the port states
them:
  * clean_lowqual: a base's error is 10^(-q/10), an N's is 1.0 (its
    quality byte becomes the shift byte); a read whose error sum (left to
    right, in float64) is at most cutoff x length passes; otherwise a
    greedy scan cuts at each base where the error accumulated since the
    last cut exceeds cutoff x the bases since it, and the longest block
    between cuts (strict '>', the final block included) is kept; reads
    shorter than -r are emptied; headers gain "    RQ: <pct>%",
    "  TrimLowQual", "  FilterShort";
  * clean_adapter: an ungapped local alignment of each read against each
    adapter (+1 for a match of two of A, C, G, T, -2 otherwise, floored
    at 0), the best cell by a strict '>' in row-major order, its run
    traced back to the cell after the last zero; the first adapter whose
    best score reaches -s cuts the read before the alignment's start;
    reads shorter than -r are emptied ("RemoveShort").
The scans go over the read positions in turn, each step over every read
at once, on the reads' device.  Nothing here imports the program.
"""

from __future__ import annotations

import torch


def _lexical(x: float) -> str:
    return "%.17g" % x


def _g6(x: float) -> str:
    return "%g" % x


def padded(records: list, device):
    """[N, L] uint8 reads and qualities (0 past a read) and [N] lengths of
    (head, seq, qual) records."""
    n = len(records)
    L = max((len(s) for _, s, _ in records), default=0)
    seq = bytearray(n * L)
    qual = bytearray(n * L)
    for i, (_, s, q) in enumerate(records):
        seq[i * L:i * L + len(s)] = s
        qual[i * L:i * L + len(q)] = q
    lens = torch.tensor([len(s) for _, s, _ in records], dtype=torch.int64)
    as_t = (lambda b: torch.frombuffer(b, dtype=torch.uint8).view(n, L)
            if n * L else torch.zeros((n, L), dtype=torch.uint8))
    return as_t(seq).to(device), as_t(qual).to(device), lens.to(device)


def lowqual(records: list, err_cutoff: float, min_len: int,
            shift: int = 33, device="cpu"):
    """(output records, .stat text) of clean_lowqual."""
    seq, qual, lens = padded(records, device)
    N, L = seq.shape
    pos = torch.arange(L, device=device)
    is_n = (seq == ord("N")) & (pos[None, :] < lens[:, None])
    qual = torch.where(is_n, torch.tensor(shift, dtype=torch.uint8,
                                          device=device), qual)
    # Qual2Err as the C library's pow gives it (clean_lowqual.cpp:219-222)
    table = torch.zeros(256, dtype=torch.float64)
    table[shift:shift + 100] = torch.tensor([10.0 ** (-q / 10.0)
                                             for q in range(100)],
                                            dtype=torch.float64)
    table = table.to(device)
    err = table[qual.long()]
    total = torch.zeros(N, dtype=torch.float64, device=device)
    acc_err = torch.zeros(N, dtype=torch.float64, device=device)
    acc_len = torch.zeros(N, dtype=torch.int64, device=device)
    last_cut = torch.zeros(N, dtype=torch.int64, device=device)
    best_len = torch.zeros(N, dtype=torch.int64, device=device)
    best_start = torch.zeros(N, dtype=torch.int64, device=device)
    for j in range(L):
        inside = j < lens
        e = err[:, j]
        total = torch.where(inside, total + e, total)
        a2 = acc_err + e
        l2 = acc_len + 1
        cut = inside & (a2 > err_cutoff * l2.to(torch.float64))
        blk_len = j - last_cut          # bases last_cut+1 .. j (1-based)
        better = cut & (blk_len > best_len)
        best_len = torch.where(better, blk_len, best_len)
        best_start = torch.where(better, last_cut + 1, best_start)
        acc_err = torch.where(cut, 0.0, torch.where(inside, a2, acc_err))
        acc_len = torch.where(cut, 0, torch.where(inside, l2, acc_len))
        last_cut = torch.where(cut, j + 1, last_cut)
    blk_len = lens - last_cut
    better = blk_len > best_len
    best_len = torch.where(better, blk_len, best_len)
    best_start = torch.where(better, last_cut + 1, best_start)
    trim = total > err_cutoff * lens.to(torch.float64)
    valid = (best_start >= 1) & (best_start <= lens)
    start = torch.where(trim & valid, best_start - 1, 0)
    keep = torch.where(trim, torch.where(valid, best_len, 0),
                       lens).clamp_min(0)
    short = keep < min_len
    final = torch.where(short, 0, keep)

    total, start, final, lens_l = (x.tolist() for x in
                                   (total, start, final, lens))
    trim_l, short_l, keep_l = trim.tolist(), short.tolist(), keep.tolist()
    qual_h = qual.cpu().numpy()
    out = []
    for i, (head, s, _) in enumerate(records):
        n = lens_l[i]
        rq = _lexical(total[i] / n * 100) if n else "nan"
        h = head + b"    RQ: " + rq.encode() + b"%"
        if trim_l[i]:
            h += b"  TrimLowQual"
        if short_l[i]:
            h += b"  FilterShort"
        a, b = start[i], start[i] + final[i]
        out.append((h, s[a:b], qual_h[i, a:b].tobytes()))
    raw_r, raw_b = N, sum(lens_l)
    low_r = sum(trim_l)
    low_b = sum(n - k for n, k, t in zip(lens_l, keep_l, trim_l) if t)
    sh_r = sum(short_l)
    sh_b = sum(k for k, s in zip(keep_l, short_l) if s)
    cl_r = sum(f > 0 for f in final)
    cl_b = sum(final)

    def pct(a, b):
        return _g6(a / b * 100 if b else float("nan"))
    stat = (f"#total_raw_reads:   {raw_r}\n#total_raw_bases:   {raw_b}\n"
            f"#filtered_lowqual_reads: {low_r}\t{pct(low_r, raw_r)}%\n"
            f"#filtered_lowqual_bases: {low_b}\t{pct(low_b, raw_b)}%\n"
            f"#filtered_short_reads: {sh_r}\t{pct(sh_r, raw_r)}%\n"
            f"#filtered_short_bases: {sh_b}\t{pct(sh_b, raw_b)}%\n"
            f"#total_clean_reads: {cl_r}\t{pct(cl_r, raw_r)}%\n"
            f"#total_clean_bases: {cl_b}\t{pct(cl_b, raw_b)}%\n")
    return out, stat


# the shipped adapter sets, clean_illumina/illumina_NEB_adapter*.fa
DEFAULT_ADAPTERS = {
    "Both-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC"),
                     ("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
    "R1-adapter": [("R1", "GATCGGAAGAGCACACGTCTGAACTCCAGTCAC")],
    "R2-adapter": [("R2", "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")],
}

STRICT = torch.full((256,), 4, dtype=torch.uint8)
for _c, _v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    STRICT[_c] = _v


def _align(codes: torch.Tensor, lens: torch.Tensor, adapter: bytes):
    """Best score, its cell (1-based read i, adapter j) and its run's start
    of every read against one adapter."""
    dev = codes.device
    N, L = codes.shape
    a = STRICT[torch.tensor(list(adapter), dtype=torch.long)].to(dev).long()
    M = a.numel()
    score = torch.where((torch.arange(5, device=dev)[:, None] == a[None, :])
                        & (a[None, :] < 4), 1, -2)
    jpos = torch.arange(1, M + 1, device=dev)[None, :]
    dp = torch.zeros((N, M + 1), dtype=torch.int64, device=dev)
    si = torch.zeros_like(dp)
    sj = torch.zeros_like(dp)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    bi, bj, bsi, bsj = (torch.zeros_like(best) for _ in range(4))
    for i in range(1, L + 1):
        s = score[codes[:, i - 1].long()]
        prev = dp[:, :M]
        val = (prev + s).clamp_min(0)
        zero = prev == 0
        nsi = torch.where(zero, i, si[:, :M])
        nsj = torch.where(zero, jpos, sj[:, :M])
        dp = torch.cat([dp[:, :1], val], 1)
        si = torch.cat([si[:, :1], nsi], 1)
        sj = torch.cat([sj[:, :1], nsj], 1)
        rj = torch.argmax(val, 1)                 # first maximal j
        rb = torch.where(i <= lens, val.amax(1), -1)
        up = rb > best
        best = torch.where(up, rb, best)
        bi = torch.where(up, i, bi)
        bj = torch.where(up, rj + 1, bj)
        bsi = torch.where(up, nsi.gather(1, rj[:, None])[:, 0], bsi)
        bsj = torch.where(up, nsj.gather(1, rj[:, None])[:, 0], bsj)
    return best, bi, bj, bsi, bsj


def adapter(records: list, adapters: list, cutoff: int, min_len: int,
            device="cpu"):
    """(output records, .stat text) of clean_adapter; adapters is
    [(id, sequence)] in file order."""
    seq, qual, lens = padded(records, device)
    codes = STRICT.to(device)[seq.long()]
    N = len(records)
    hit = torch.full((N,), -1, dtype=torch.int64, device=device)
    got = [torch.zeros(N, dtype=torch.int64, device=device)
           for _ in range(5)]
    for ai, (_, aseq) in enumerate(adapters):
        res = _align(codes, lens, aseq.encode())
        sel = (hit < 0) & (res[0] >= cutoff)
        hit = torch.where(sel, ai, hit)
        got = [torch.where(sel, r, g) for r, g in zip(res, got)]
    score, r_end, a_end, r_start, a_start = (x.tolist() for x in got)
    hit_l, lens_l = hit.tolist(), lens.tolist()
    out = []
    n_trim = b_trim = n_short = b_short = n_clean = b_clean = 0
    for i, (head, s, q) in enumerate(records):
        keep = r_start[i] - 1 if hit_l[i] >= 0 else lens_l[i]
        short = keep < min_len
        h = head
        if hit_l[i] >= 0:
            n_trim += 1
            b_trim += lens_l[i] - r_start[i] + 1
            h += (f"   Aligned to adapter {adapters[hit_l[i]][0]}, "
                  f" reads_pos: {r_start[i]}-{r_end[i]}, "
                  f"adapter_pos: {a_start[i]}-{a_end[i]},   "
                  f"score: {score[i]}").encode()
        if short:
            h += b"   RemoveShort"
            n_short += 1
            b_short += max(keep, 0)
            keep = 0
        else:
            n_clean += 1
            b_clean += keep
        out.append((h, s[:keep], q[:keep]))
    raw_b = sum(lens_l)
    stat = (f"total_raw_reads:  {N}\ntotal_raw_bases:  {raw_b}\n"
            f"total_adapter_trimmed_reads:  {n_trim}\n"
            f"total_adapter_trimmed_bases:  {b_trim}\t"
            f"{_g6(b_trim / raw_b)}\n"
            f"total_short_trimmed_reads:  {n_short}\n"
            f"total_short_trimmed_bases:  {b_short}\t"
            f"{_g6(b_short / raw_b)}\n"
            f"total_clean_reads:  {n_clean}\n"
            f"total_clean_bases:  {b_clean}\t{_g6(b_clean / raw_b)}\n")
    return out, stat


def fastq(records: list) -> bytes:
    return b"".join(h + b"\n" + s + b"\n+\n" + q + b"\n"
                    for h, s, q in records)
