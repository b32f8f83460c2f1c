"""Device error-correction engine: the 5-phase recipe as torch programs.

Counterpart of dbg_assembly_tpu/correct/device.py.  Every function runs on
the device of its input tensors (a CUDA card, or the CPU when asked).  The
reference corrector (correct_error/correct.cpp:146-635) is a per-read
sequential recipe; here it runs in bulk over a batch of reads:

  stage A (_stage_a): phase 1 table classification as gathers from the
      device-resident 1-bit table; region extraction as run starts over
      k-mer positions; phase 2 fast correction as a candidate x 4 bases x k
      probe tensor with the sequential change budget replayed by a
      cumulative sum; phase 3 region merge, filter and shave over fixed
      region slots.

  stage B (_wave_step, _phase5): phases 4 and 5's branch-and-bound trees
      as a fixed-width masked BEAM SEARCH (_bbt_impl): a beam lane is one
      alive tree path carrying its k-mer and its <= 2 explicit (position,
      base) changes.  One wave = the i-th BBT call of every read, so the
      reference's per-read sequencing (budget, read mutation between
      calls) holds while the active reads of a batch search in lockstep.

Exactness: a read is flagged for HOST FALLBACK when it exceeds the fixed
slot shapes (R_MAX/C_MAX/H_MAX), a beam would hold more than BEAM_W alive
paths, or more reads enter a compacted beam call than it has rows.  Beams
that never exceed BEAM_W equal the reference's BFS (its node cap cannot
trigger on a tree whose level width stays <= BEAM_W), so rows not flagged
are byte-exact, and correct/pipeline.py re-runs flagged rows
on the host engine from the original read.  The constants keep the JAX
package's values: they decide which rows fall back.

K-mers are int64 (2k <= 62).  The table is int32 words, the bit pattern of
little-endian uint32 words; ``(w >> shift) & 1`` with shift in 0..31 reads
the right bit of a negative word as well.  Where JAX needs a stable argsort,
top_k or argmax tie order, the port states the order it keeps.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dna, resolve_device

R_MAX = 24    # low/high region slots per read
C_MAX = 6     # phase-2 candidate slots per read
H_MAX = 12    # merged high-region slots per read
BEAM_W = 8    # BBT beam width (alive paths per search)
BIG = 1 << 20

_CODE_NP = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGTNacgtn", (0, 1, 2, 3, 0, 0, 1, 2, 3, 0)):
    _CODE_NP[_c] = _v
_BASES_NP = np.frombuffer(b"ACGT", np.uint8).copy()

# trips of the beam loop between two host reads of its "all done" flag:
# a done row's state is frozen, so trips past the last row's end are
# masked no-ops (the JAX ``unroll`` argument)
UNROLL = 8

# what the engine did since the last reset_counts(): batches, gap waves,
# beam calls and their loop trips, host reads (device -> host syncs that
# decide control flow), the rows re-run on the host engine and the copies
# of the device's table to the host for them (both counted by
# correct/pipeline.py); the smoke test prints them
counts = {"batches": 0, "waves": 0, "bbt_calls": 0, "trips": 0,
          "host_reads": 0, "fallback": 0, "host_table": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def _tables(device):
    return (torch.from_numpy(_CODE_NP).to(device),
            torch.from_numpy(_BASES_NP).to(device))


def bitmap_device(bitmap: np.ndarray, device="cuda") -> torch.Tensor:
    """The packed 1-bit table as little-endian 32-bit words on ``device``:
    an int32 tensor viewed on the host (2^29 words, 2 GiB, at k = 17)."""
    words = np.ascontiguousarray(bitmap).view("<i4")
    return torch.from_numpy(words).to(resolve_device(device))


def _word_bit(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit idx of the table, 0 or 1 in w's dtype, from w = its word
    (words[idx >> 5]): byte b of a little-endian word w is (w >> 8b) &
    0xFF, and bits within a byte are MSB-first (get_freq,
    correct_error/seqKmer.cpp:102-106).  The one reader of the layout on
    the device."""
    return (w >> (8 * ((idx >> 3) & 3) + (7 - (idx & 7)))) & 1


def _probe(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Table lookup: int64 k-mers -> bool."""
    return _word_bit(words[idx >> 5], idx).bool()


def _put(dst: torch.Tensor, index: tuple, vals) -> None:
    """dst[index] = vals, where the index names distinct elements of dst.
    JAX's ``.at[...].set(mode="drop")`` sends masked rows out of range;
    the callers here drop them from the index first.  Duplicate
    destinations would leave index_put_'s order to decide, so every caller
    states why there are none, and the tests check it."""
    dst[index] = vals


def _front(mask: torch.Tensor) -> torch.Tensor:
    """Column order that brings each row's True entries to the front in
    column order, the rest after them in column order: JAX's stable
    ``argsort(~mask)``.  torch sorts uint8, not bool, so the key is cast."""
    return torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices


# ===========================================================================
# Stage A: classification + regions + phase 2 + phase 3
# ===========================================================================

def _stage_a(ascii_seq, codes, lengths, words, *, k: int, m: int,
             max_change: int):
    """Phases 1-3 of a batch.  ascii_seq/codes [N, L] uint8, lengths [N].
    Returns (new_ascii [N, L] uint8, one_score [N] int32, hs1/he1 [N, H_MAX]
    int32 1-based shaved high regions, num_h [N] int32, fallback [N])."""
    N, L = codes.shape
    P = L - k + 1
    dev = codes.device
    _, bases_ascii = _tables(dev)
    kn = lengths.to(torch.int64) - k + 1               # valid k-mer count

    codes_sq = torch.where(codes > 3, 0, codes)
    kmers = dna.rolling_kmers(codes_sq, k)             # [N, P] int64
    pos = torch.arange(P, device=dev)[None, :]
    valid = pos < kn[:, None]
    bits = _probe(words, kmers) & valid                # [N, P] phase 1

    # ---- region extraction (get_cont_kmerfreq_region, correct.cpp:16-69)
    prev = torch.cat([~bits[:, :1], bits[:, :-1]], dim=1)
    first = valid & ((pos == 0) | (bits != prev))
    num_c = first.sum(1)
    starts0 = _front(first)[:, :R_MAX]                 # 0-based kmer index
    r_i = torch.arange(R_MAX, device=dev)[None, :]
    reg_valid = r_i < num_c[:, None]
    nxt = torch.cat([starts0[:, 1:], kn[:, None]], dim=1)
    ends0 = torch.where(r_i == num_c[:, None] - 1, kn[:, None] - 1, nxt - 1)
    ends0 = torch.where(reg_valid, ends0, 0)
    starts0 = torch.where(reg_valid, starts0, 0)
    status = bits.gather(1, starts0) & reg_valid
    fallback = num_c > R_MAX

    # ---- phase 2: fast single-base correction (correct.cpp:74-107,171-192)
    cand = (reg_valid & (r_i >= 1) & (r_i <= num_c[:, None] - 2)
            & ~status & (ends0 - starts0 + 1 == k))
    fallback = fallback | (cand.sum(1) > C_MAX)
    corder = _front(cand)[:, :C_MAX]
    c_has = cand.gather(1, corder)                     # [N, C]
    c_s0 = starts0.gather(1, corder)
    c_e0 = ends0.gather(1, corder)                     # = s0 + k - 1
    err_col = c_e0.clamp(0, L - 1)
    orig_ascii = ascii_seq.gather(1, err_col)          # [N, C]

    C = corder.shape[1]
    j0 = torch.arange(k, device=dev)[None, None, :]    # [1, 1, k]
    kcol = (c_s0[:, :, None] + j0).clamp(0, P - 1)
    km = kmers.gather(1, kcol.reshape(N, C * k)).reshape(N, C, k)
    shift = 2 * j0
    cleared = km & ~(3 << shift)
    bases = torch.arange(4, device=dev)[None, None, :, None]
    kmod = cleared[:, :, None, :] | (bases << shift[:, :, None, :])
    hits = _probe(words, kmod)                         # [N, C, 4, k]
    diff = bases_ascii[None, None, :] != orig_ascii[:, :, None]
    succ_b = hits.all(3) & diff                        # [N, C, 4]
    succ = succ_b.any(2) & c_has
    # torch.argmax returns the first maximum, as JAX's does; it takes no
    # bool, hence the cast
    first_b = succ_b.to(torch.uint8).argmax(2)         # first base
    before = succ.cumsum(1) - succ.to(torch.int64)
    accepted = succ & (before < max_change)
    one_score = accepted.sum(1).to(torch.int32)

    # write accepted bases into the read and mark their regions high; a
    # row's accepted candidates are distinct regions, so no two writes
    # share a destination
    rows = torch.arange(N, device=dev)[:, None].expand(N, C)[accepted]
    new_ascii = ascii_seq.clone()
    _put(new_ascii, (rows, err_col[accepted]), bases_ascii[first_b[accepted]])
    status = status.clone()
    _put(status, (rows, corder[accepted]), True)

    # ---- phase 3: merge + filter + shave (correct.cpp:112-142,201-211)
    s1 = status & reg_valid
    zero = torch.zeros((N, 1), dtype=torch.bool, device=dev)
    s1_prev = torch.cat([zero, s1[:, :-1]], dim=1)
    s1_next = torch.cat([s1[:, 1:], zero], dim=1)
    hfirst = s1 & ~s1_prev
    hlast = s1 & ~s1_next
    n_runs = hfirst.sum(1)
    run_s0 = starts0.gather(1, _front(hfirst))         # [N, R]
    run_e0 = ends0.gather(1, _front(hlast))
    run_ok = (r_i < n_runs[:, None]) & (run_e0 - run_s0 + 1 >= m)
    fallback = fallback | (run_ok.sum(1) > H_MAX)
    qorder = _front(run_ok)[:, :H_MAX]
    num_h = run_ok.sum(1).to(torch.int32)
    hs1 = run_s0.gather(1, qorder) + 1                 # 1-based kmer
    he1 = run_e0.gather(1, qorder) + 1
    ec = m // 3
    hs1 = torch.where(hs1 != 1, hs1 + ec, hs1)
    he1 = torch.where(he1 != kn[:, None], he1 - ec, he1)
    h_ok = torch.arange(H_MAX, device=dev)[None, :] < num_h[:, None]
    hs1 = torch.where(h_ok, hs1, 0).to(torch.int32)
    he1 = torch.where(h_ok, he1, 0).to(torch.int32)
    return new_ascii, one_score, hs1, he1, num_h, fallback


# ===========================================================================
# Stage B: the fixed-width beam-search BBT
# (correct_multi_bases_rightward/leftward, correct.cpp:380-635)
# ===========================================================================

def _bbt_impl(ascii_seq, lengths, words, active, check_start, check_end,
              max_allowed, last_change_init, *, k: int, rightward: bool,
              is_modify_trimmed: bool, unroll: int = UNROLL):
    """One batched BBT call: every active read searches in lockstep.

    The children are probed ONE WORD a lane: a lane's 4 rightward children
    are consecutive k-mer values sharing one 32-bit table word, and since
    every correction table is RC-closed (the loaders OR in the
    reverse-complement bits, main_parallel_senior.cpp:310-329), the 4
    leftward children equal rc-space values (rc_kmer<<2 | comp(j)) that
    share one word too: one gather a lane instead of four.  Each lane
    carries its k-mer's reverse complement (rkmer) for the leftward key.

    check_start/check_end: 1-based base positions (reference cycle range).
    Returns (new_ascii, num_corrected, len_need_trim, last_change,
    overflow).
    """
    N, L = ascii_seq.shape
    if L > 1022:
        raise ValueError(f"read length {L} exceeds the 10-bit change-slot "
                         "position packing (max 1022)")
    W = BEAM_W
    dev = ascii_seq.device
    mask = (1 << (2 * k)) - 1
    code_tab, bases_ascii = _tables(dev)
    i32 = torch.int32
    Lr = lengths.to(i32)
    cs = check_start.to(i32)
    ce = check_end.to(i32)
    ma = max_allowed.clamp(0, 2).to(i32)[:, None, None]

    # anchor: the k-1 bases flanking the walk start (correct.cpp:383,517),
    # gathered at once and packed by a sum of disjoint bit fields
    a0 = (cs - k) if rightward else cs         # 0-based first anchor base
    cols = (a0[:, None].to(torch.int64)
            + torch.arange(k - 1, device=dev)[None, :]).clamp(0, L - 1)
    anc = code_tab[ascii_seq.gather(1, cols).long()].to(torch.int64)
    anchor = (anc << (2 * torch.arange(k - 2, -1, -1, device=dev))).sum(1)
    root = anchor if rightward else (anchor << 2)

    lane = torch.arange(W, device=dev)[None, :]
    kmer = root[:, None].expand(N, W).clone()
    rkmer = dna.revcomp_kbit(root, k)[:, None].expand(N, W).clone()
    change = torch.where(lane == 0, 0, BIG).to(i32).expand(N, W).clone()
    alive = (lane == 0) & active[:, None]
    # the <= 2 explicit changes of a path ride in ONE packed int32 a lane:
    # position 10 bits + base 2 bits a slot
    chg = torch.zeros((N, W), dtype=i32, device=dev)
    cp = cs.clone()
    span_empty = (cs > ce) if rightward else (cs < ce)
    done = ~active | span_empty
    ovf = torch.zeros(N, dtype=torch.bool, device=dev)

    jj = torch.arange(4, device=dev)[None, None, :]
    lane_w = torch.arange(1, W + 1, device=dev)[None, :]   # rank of a lane
    lane_ranks = lane_w.expand(N, W).to(torch.float32).contiguous()
    # alive-prefix ranks as a product with an upper-triangular ones matrix:
    # exact (sums of at most 4W ones, in float32 or TF32), where torch's
    # scan kernel over a 32-wide inner axis took 0.54 ms a call at 65 536
    # rows on an H100 (PERF.md, PR 5)
    tri = torch.ones((4 * W, 4 * W), device=dev).triu()
    step = 1 if rightward else -1

    def one_step():
        nonlocal kmer, rkmer, change, alive, chg, cp, done, ovf
        running = ~done
        col = (cp - 1).to(torch.int64).clamp(0, L - 1)
        rchar = ascii_seq.gather(1, col[:, None])[:, 0]
        if rightward:
            ck = ((kmer[:, :, None] << 2) | jj) & mask
        else:
            ck = (kmer[:, :, None] >> 2) | (jj << (2 * (k - 1)))
        same = bases_ascii[None, None, :] == rchar[:, None, None]
        cchange = change[:, :, None] + (~same).to(i32)
        # the children's bits, in the word of the lane's key (a multiple
        # of 4): bit key | j rightward, key | comp(j) leftward
        wkey = ((kmer if rightward else rkmer) << 2) & mask
        w = words[wkey >> 5]
        jc = jj if rightward else 3 - jj
        hits = _word_bit(w[:, :, None], wkey[:, :, None] | jc).bool()
        calive = (alive[:, :, None] & (cchange <= ma) & hits
                  & running[:, None, None])
        fa = calive.reshape(N, 4 * W)
        csum = fa.to(torch.float32) @ tri              # alive-prefix rank
        n_alive = csum[:, -1].to(i32)
        any_child = n_alive > 0
        ovf = ovf | (running & (n_alive > W))
        progress = running & any_child

        # compact the alive children into W lanes: lane l takes the
        # (l+1)-th alive candidate, found by a binary search of the rank.
        # JAX writes this as a one-hot masked sum over the 4W candidates
        # (gather-free for the TPU); a gather picks the same value, and a
        # lane with no candidate gets 0 as the masked sum gives it
        src = torch.searchsorted(csum, lane_ranks)
        new_alive = lane_w <= n_alive[:, None]
        src = src.clamp(max=4 * W - 1)
        par = src >> 2                                 # parent lane
        pj = torch.where(new_alive, src & 3, 0).to(i32)

        def pick(vals):
            return torch.where(new_alive, vals.gather(1, par), 0)

        new_kmer = torch.where(new_alive, ck.reshape(N, 4 * W).gather(1, src),
                               0)
        jr = 3 - pj.to(torch.int64)                    # complement of base
        prk = rkmer.gather(1, par)
        if rightward:
            rk = (prk >> 2) | (jr << (2 * (k - 1)))
        else:
            rk = ((prk << 2) | jr) & mask
        new_rkmer = torch.where(new_alive, rk, 0)
        was_same = new_alive & (bases_ascii[pj.long()] == rchar[:, None])
        p_change = pick(change)
        p_chg = pick(chg)
        new_change = torch.where(new_alive,
                                 p_change + (~was_same).to(i32), BIG)
        slot = p_change.clamp(0, 1)                    # 0 or 1
        wr = ~was_same
        rec = cp[:, None] | (pj << 10)                 # pos|base
        lo = torch.where(wr & (slot == 0), rec, p_chg & 0xFFF)
        hi = torch.where(wr & (slot == 1), rec, (p_chg >> 12) & 0xFFF)
        new_chg = lo | (hi << 12)

        pm = progress[:, None]
        kmer = torch.where(pm, new_kmer, kmer)
        change = torch.where(pm, new_change, change)
        alive = torch.where(pm, new_alive, alive)
        chg = torch.where(pm, new_chg, chg)
        rkmer = torch.where(pm, new_rkmer, rkmer)
        cp_next = torch.where(progress, cp + step, cp)
        out_of_span = (cp_next > ce) if rightward else (cp_next < ce)
        done = done | (running & ~any_child) | (progress & out_of_span)
        cp = cp_next

    # lax.while_loop(any(~done)) as a host loop: the flag is read once
    # every `unroll` trips
    counts["bbt_calls"] += 1
    while True:
        counts["host_reads"] += 1
        if bool(done.all()):
            break
        for _ in range(unroll):
            one_step()
        counts["trips"] += unroll

    ch = torch.where(alive, change, BIG)
    min_change = ch.min(1).values
    best = (ch == min_change[:, None]) & alive
    min_path = best.sum(1)
    sel_lane = best.to(torch.uint8).argmax(1)          # first such lane
    lnt = (ce - cp + 1) if rightward else (cp - ce + 1)
    lnt = torch.where(active, lnt.clamp(min=0), 0).to(i32)
    ok_trim = (lnt == 0) if not is_modify_trimmed else \
        torch.ones_like(active)
    applied = active & (min_path == 1) & ok_trim & (min_change < BIG)
    num = torch.where(applied, min_change, 0).to(i32)

    sel_chg = chg.gather(1, sel_lane[:, None])[:, 0]
    sp = torch.stack([sel_chg & 1023, (sel_chg >> 12) & 1023], dim=1)
    sb = torch.stack([(sel_chg >> 10) & 3, (sel_chg >> 22) & 3], dim=1)
    used = torch.arange(2, device=dev)[None, :] < num[:, None]
    # a path's two changes sit at distinct positions (one a cycle), so no
    # write shares a destination
    wmask = applied[:, None] & used
    rows = torch.arange(N, device=dev)[:, None].expand(N, 2)[wmask]
    wcol = (sp[wmask] - 1).to(torch.int64).clamp(0, L - 1)
    new_ascii = ascii_seq.clone()
    _put(new_ascii, (rows, wcol), bases_ascii[sb[wmask].long()])

    # last_change bookkeeping (correct.cpp:471-477,599-607): only updated
    # while it still equals the caller's sentinel (read_len+1 rightward /
    # 0 leftward); back-walk order makes it the extreme change position
    wrote = applied & (num > 0)
    lci = last_change_init.to(i32)
    if rightward:
        extreme = torch.where(used, sp, -BIG).max(1).values
        upd = wrote & (lci == Lr + 1)
    else:
        extreme = torch.where(used, sp, BIG).min(1).values
        upd = wrote & (lci == 0)
    last_change = torch.where(upd, extreme, lci).to(i32)
    return new_ascii, num, lnt, last_change, ovf


def _bbt_compact(ascii_seq, lengths, words, active, check_start, check_end,
                 max_allowed, last_change_init, *, k: int, rightward: bool,
                 is_modify_trimmed: bool, compact_c: int,
                 unroll: int = UNROLL):
    """Active-row compaction around _bbt_impl: gather the first compact_c
    active reads into a compact batch, run the beam loop there, scatter the
    results back.  Active rows beyond compact_c are flagged for HOST
    FALLBACK."""
    N, L = ascii_seq.shape
    C = min(compact_c, N)
    # JAX takes lax.top_k(active, C), whose ties go to the lower index:
    # the active rows in order, then the inactive ones in order.
    # torch.topk promises no order among ties; a stable sort keeps it
    rows_sel = _front(active[None, :])[0, :C]
    act_c = active[rows_sel]
    dropped = active & (active.to(torch.int32).cumsum(0) > C)

    asc_o, num_c, lnt_c, lch_c, ovf_c = _bbt_impl(
        ascii_seq[rows_sel], lengths[rows_sel], words, act_c,
        check_start[rows_sel], check_end[rows_sel], max_allowed[rows_sel],
        last_change_init[rows_sel], k=k, rightward=rightward,
        is_modify_trimmed=is_modify_trimmed, unroll=unroll)

    # scatter back to the active rows: rows_sel holds distinct rows
    wrow = (rows_sel[act_c],)
    dev = ascii_seq.device
    new_ascii = ascii_seq.clone()
    _put(new_ascii, wrow, asc_o[act_c])
    num = torch.zeros(N, dtype=torch.int32, device=dev)
    _put(num, wrow, num_c[act_c])
    lnt = torch.zeros(N, dtype=torch.int32, device=dev)
    _put(lnt, wrow, lnt_c[act_c])
    lch = last_change_init.to(torch.int32).clone()
    _put(lch, wrow, lch_c[act_c])
    ovf = dropped.clone()       # dropped rows are not among rows_sel's
    _put(ovf, wrow, ovf_c[act_c])
    return new_ascii, num, lnt, lch, ovf


# ===========================================================================
# Phase 5 region selection (get_max_highFreq_region, correct.cpp:338-374)
# ===========================================================================

def _max_combined(hs1, he1, num_h, fail):
    """fail: [N, H_MAX], True at high-region index h if the gap AFTER
    region h failed (phase 4); index num_h-1 is forced failed."""
    N = hs1.shape[0]
    dev = hs1.device
    h_i = torch.arange(H_MAX, device=dev)[None, :]
    h_ok = h_i < num_h[:, None]
    fail = (fail | (h_i == num_h[:, None] - 1)) & h_ok
    # segment start: region 0 or right after a failed region
    prev_fail = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=dev),
                           fail[:, :-1]], dim=1)
    seg_first = h_ok & prev_fail
    # start position of the segment containing h: cummax of start markers
    seg_start = torch.where(seg_first, hs1, -BIG).cummax(1).values
    comb_len = torch.where(fail, he1 - seg_start + 1, -BIG)
    best = comb_len.argmax(1, keepdim=True)            # first strict max
    return seg_start.gather(1, best)[:, 0], he1.gather(1, best)[:, 0]


# ===========================================================================
# One batch, all phases
# ===========================================================================

def correct_batch_device(ascii_np, codes_np, lengths_np, words, params,
                         unroll: int = UNROLL):
    """Run the full 5-phase recipe for one read batch on the device of
    ``words`` (bitmap_device).

    Returns numpy (one, multi, deleted, trim_left, trim_right, ascii_mod,
    fallback); fallback rows must be re-run on the host engine from the
    ORIGINAL read.
    """
    p = params.resolved()
    k = p.ksize
    m = p.high_freq_reg_len
    mc = p.max_change
    dev = words.device

    ascii_seq = torch.from_numpy(np.ascontiguousarray(ascii_np)).to(dev)
    codes = torch.from_numpy(np.ascontiguousarray(codes_np)).to(dev)
    lengths = torch.from_numpy(
        np.ascontiguousarray(lengths_np, np.int32)).to(dev)
    N = ascii_seq.shape[0]
    counts["batches"] += 1

    ascii_seq, one, hs1, he1, num_h, fallback = _stage_a(
        ascii_seq, codes, lengths, words, k=k, m=m, max_change=mc)

    accum = one
    multi = torch.zeros(N, dtype=torch.int32, device=dev)
    fail = torch.zeros((N, H_MAX), dtype=torch.bool, device=dev)

    # active-row compaction widths (the JAX package's): overflow beyond the
    # compact width falls back to the host engine
    wave_c = max(N // 4, 256)
    p5_c = max(N // 2, 256)

    # ---- phase 4 waves: gap i between high regions i and i+1 (one host
    # read for the wave count)
    n_waves = max(int(num_h.max()) - 1, 0) if N else 0
    counts["host_reads"] += 1
    counts["waves"] += n_waves
    for i in range(n_waves):
        ascii_seq, accum, multi, fail, fallback = _wave_step(
            ascii_seq, lengths, words, hs1, he1, num_h, accum, multi, fail,
            fallback, i, mc, k=k, compact_c=wave_c, unroll=unroll)

    (ascii_seq, multi, deleted, trim_left, trim_right,
     fallback) = _phase5(ascii_seq, lengths, words, hs1, he1, num_h, accum,
                         multi, fail, fallback, k=k, mc=mc,
                         ft=p.further_trim, min_len=p.min_read_len,
                         compact_c=p5_c, unroll=unroll)
    return tuple(t.cpu().numpy() for t in (
        one, multi, deleted, trim_left, trim_right, ascii_seq, fallback))


def _phase5(ascii_seq, lengths, words, hs1, he1, num_h, accum, multi, fail,
            fallback, *, k: int, mc: int, ft: int, min_len: int,
            compact_c: int | None = None, unroll: int = UNROLL):
    """Phase 5 (correct.cpp:273-334): head and tail BBT from the maximal
    combined high region, then Further_trim_len end safety.  compact_c:
    the compaction width of the head and tail beam calls (None: full
    width)."""
    N = ascii_seq.shape[0]
    dev = ascii_seq.device
    i32 = torch.int32

    def bbt(a, act, cs, ce, ma, lci, rightward):
        kw = dict(k=k, rightward=rightward, is_modify_trimmed=True,
                  unroll=unroll)
        if compact_c is not None:
            return _bbt_compact(a, lengths, words, act, cs, ce, ma, lci,
                                compact_c=compact_c, **kw)
        return _bbt_impl(a, lengths, words, act, cs, ce, ma, lci, **kw)

    Lr = lengths.to(i32)
    max_s1, max_e1 = _max_combined(hs1, he1, num_h, fail)
    ok = ~fallback & (num_h > 0)

    # head (correct.cpp:273-290)
    act_h = ok & (max_s1 > 1)
    can_h = act_h & (accum < mc)
    ascii_seq, numh, tl_bbt, left_last, ovf = bbt(
        ascii_seq, can_h, (max_s1 - 1).clamp(min=1), torch.ones_like(max_s1),
        mc - accum, torch.zeros(N, dtype=i32, device=dev), rightward=False)
    fallback = fallback | ovf
    got_h = can_h & (numh > 0)
    multi = multi + torch.where(got_h, numh, 0)
    accum = accum + torch.where(got_h, numh, 0)
    trim_left = torch.where(got_h, tl_bbt,
                            torch.where(act_h, max_s1 - 1, 0)).to(i32)
    left_last = torch.where(got_h, left_last, 0)

    # tail (correct.cpp:292-312)
    high_end = max_e1 + k - 1
    act_t = ok & (high_end < Lr)
    can_t = act_t & (accum < mc)
    ascii_seq, numt, tr_bbt, right_last, ovf = bbt(
        ascii_seq, can_t, torch.minimum(high_end + 1, Lr), Lr, mc - accum,
        Lr + 1, rightward=True)
    fallback = fallback | ovf
    got_t = can_t & (numt > 0)
    multi = multi + torch.where(got_t, numt, 0)
    accum = accum + torch.where(got_t, numt, 0)
    trim_right = torch.where(got_t, tr_bbt,
                             torch.where(act_t, Lr - high_end, 0)).to(i32)
    right_last = torch.where(got_t, right_last, Lr + 1)

    # further end trimming (correct.cpp:317-328)
    tl_more = (trim_left > 0) | ((left_last > 0) & (left_last <= ft))
    trim_left = torch.where(tl_more & ok, (trim_left + ft).minimum(Lr),
                            trim_left)
    tr_more = (trim_right > 0) | ((right_last < Lr + 1)
                                  & (right_last >= Lr - ft + 1))
    trim_right = torch.where(tr_more & ok, (trim_right + ft).minimum(Lr),
                             trim_right)

    trim_left = torch.where(ok, trim_left, 0).to(i32)
    trim_right = torch.where(ok, trim_right, 0).to(i32)
    deleted = torch.where(num_h == 0, 1,
                          (Lr - trim_left - trim_right < min_len).to(i32))
    return (ascii_seq, multi.to(i32), deleted.to(i32), trim_left,
            trim_right, fallback)


def _wave_step(ascii_seq, lengths, words, hs1, he1, num_h, accum, multi,
               fail, fallback, i: int, mc: int, *, k: int,
               compact_c: int | None = None, unroll: int = UNROLL):
    """Gap wave i: rightward BBT, then leftward for the failures
    (correct.cpp:222-263).  compact_c: the compaction width of the beam
    calls (None: full width)."""
    N = ascii_seq.shape[0]
    i32 = torch.int32

    def bbt(a, act, cs, ce, ma, rightward):
        kw = dict(k=k, rightward=rightward, is_modify_trimmed=False,
                  unroll=unroll)
        lci = torch.full((N,), -1, dtype=i32, device=a.device)
        if compact_c is not None:
            return _bbt_compact(a, lengths, words, act, cs, ce, ma, lci,
                                compact_c=compact_c, **kw)
        return _bbt_impl(a, lengths, words, act, cs, ce, ma, lci, **kw)

    ci = min(max(i, 0), H_MAX - 1)
    cn = min(max(i + 1, 0), H_MAX - 1)
    gap_exists = i <= num_h - 2
    budget_ok = accum < mc
    act = gap_exists & budget_ok & ~fallback
    he_i = he1[:, ci]
    hs_n = hs1[:, cn]

    cs_r = he_i + k                    # high_end+1 where high_end=he1+k-1
    ce_r = hs_n + k - 2                # low region's last base
    ascii_seq, numr, lntr, _, ovf = bbt(ascii_seq, act, cs_r, ce_r,
                                        mc - accum, rightward=True)
    fallback = fallback | ovf
    ok_r = act & (lntr == 0) & (numr > 0)
    multi = multi + torch.where(ok_r, numr, 0)
    accum = accum + torch.where(ok_r, numr, 0)

    act_l = act & ~ok_r
    ascii_seq, numl, lntl, _, ovf = bbt(ascii_seq, act_l, hs_n - 1, he_i + 1,
                                        mc - accum, rightward=False)
    fallback = fallback | ovf
    ok_l = act_l & (lntl == 0) & (numl > 0)
    multi = multi + torch.where(ok_l, numl, 0)
    accum = accum + torch.where(ok_l, numl, 0)

    failed = gap_exists & (~budget_ok | (act_l & ~ok_l))
    fail = fail.clone()
    fail[:, ci] |= failed
    return ascii_seq, accum.to(i32), multi.to(i32), fail, fallback
