"""Frozen copy of the port's host correction engine, the reference for
correct_error_reads' corrected reads.

The five-phase k-mer-spectrum correction of the upstream's
correct_error_reads (fanagislab/DBG_assembly, correct_error/
correct.cpp:146-335): classify the read's k-mers as high or low against
the 1-bit table; fast-correct interior low runs of exactly k; merge high
runs and shave their edges; branch-and-bound-tree corrections between
high regions, then at the head and the tail; further end trimming.  It is
a copy, kept here so that no change to the program can change the
yardstick: it imports nothing of the program, and reads a table that the
benchmark builds itself (reference/kmers.py).  Phases 2-5 run read by
read in Python, so the benchmark corrects a sample of reads with it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = "ACGTN"
_CODE = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGTNacgtn", (0, 1, 2, 3, 0, 0, 1, 2, 3, 0)):
    _CODE[_c] = _v


@dataclass
class CorrectParams:
    ksize: int = 17
    high_freq_reg_len: int = 0       # -m; 0 -> 17
    max_change: int = 2              # -c
    further_trim: int = 0            # -x; 0 -> 17
    max_bbt_nodes: int = 5_000_000   # -n
    min_read_len: int = 75           # -r

    def resolved(self):
        p = CorrectParams(**self.__dict__)
        # the upstream sets these globals to the compiled KmerSize (17)
        # before it parses the flags, so -k does not change the -m / -x
        # defaults (main_parallel_senior.cpp:52-55)
        if p.high_freq_reg_len == 0:
            p.high_freq_reg_len = 17
        if p.further_trim == 0:
            p.further_trim = 17
        return p


def phase1_bits(read: bytes, bitmap: np.ndarray, k: int) -> np.ndarray:
    """High (1) or low (0) of each k-mer of the read, N read as A."""
    codes = _CODE[np.frombuffer(read, np.uint8)].astype(np.uint64)
    P = len(codes) - k + 1
    if P <= 0:
        return np.zeros(0, np.uint8)
    km = np.zeros(P, np.uint64)
    for i in range(k):
        km = (km << np.uint64(2)) | codes[i:i + P]
    return ((bitmap[(km >> np.uint64(3)).astype(np.int64)]
             >> (np.uint64(7) - (km & np.uint64(7))).astype(np.uint8))
            & 1).astype(np.uint8)


def correct_record(head: bytes, read: bytes, bitmap: np.ndarray,
                   p: CorrectParams) -> bytes:
    """One read's two lines of <file>.correct.fa.gz
    (main_parallel_senior.cpp:507-679): '>' + name, the five
    annotations, then the corrected and trimmed read, empty if deleted."""
    p = p.resolved()
    L = len(read)
    buf = bytearray(read)
    if L >= p.ksize:
        one, multi, deleted, tl, tr = ReadCorrector(bitmap, p) \
            .correct_one_read(buf, phase1_bits(read, bitmap, p.ksize))
    else:
        one = multi = tl = tr = 0
        deleted = 1
    if head[:1] == b"@":
        head = b">" + head[1:]
    out = b"" if deleted else bytes(buf[tl:L - tr])
    return (head + f"\tModifiedBaseNum: {one + multi}"
            f"\tFinalReadLength: {len(out)}"
            f"\tLeftEndTrim: {tl}\tRightEndTrim: {tr}"
            f"\tIsDeleted: {deleted}".encode() + b"\n" + out + b"\n")


def _regions_from_bits(bits) -> list[tuple[int, int, int]]:
    """get_cont_kmerfreq_region (correct.cpp:16-69): 1-based [start,end,status]
    runs over k-mer positions."""
    regs = []
    n = len(bits)
    i = 0
    while i < n:
        s = i
        while i < n and bits[i] == 0:
            i += 1
        if i > s:
            regs.append([s + 1, i, 0])
        s = i
        while i < n and bits[i] == 1:
            i += 1
        if i > s:
            regs.append([s + 1, i, 1])
    return regs


_CODE_LIST = [int(x) for x in _CODE]


def _seq2bit_str(read: bytearray, start: int, length: int) -> int:
    """substr + seq2bit with the k-mer alphabet (N->0)."""
    v = 0
    for c in read[start:start + length]:
        v = (v << 2) | _CODE_LIST[c]
    return v


class ReadCorrector:
    """Per-read phases 2-5 (sequential semantics)."""

    def __init__(self, bitmap: np.ndarray, params: CorrectParams):
        self.bm = bitmap
        self.p = params.resolved()
        self.nodes_overflowed = False

    def _freq(self, kbit: int) -> int:
        return (self.bm[kbit >> 3] >> (7 - (kbit & 7))) & 1

    def _freq_at(self, read: bytearray, pos0: int) -> int:
        return self._freq(_seq2bit_str(read, pos0, self.p.ksize))

    # -------------------------------------------------------- fast corrector
    def correct_one_base(self, read: bytearray, error_pos: int,
                         check_start: int, check_end: int) -> int:
        """Parity: correct.cpp:74-107 (first qualifying base wins)."""
        k = self.p.ksize
        error_base = read[error_pos - 1]
        check_num = check_end - check_start + 1
        for i in range(4):
            if error_base != ord(BASES[i]):
                read[error_pos - 1] = ord(BASES[i])
                high = 0
                for j in range(check_start - 1, check_end):
                    if self._freq_at(read, j) == 1:
                        high += 1
                    else:
                        break
                if high == check_num:
                    return 1
        read[error_pos - 1] = error_base
        return 0

    # ------------------------------------------------------------ BBT walks
    def _bbt(self, read: bytearray, check_start: int, check_end: int,
             rightward: bool, is_modify_trimmed: int, max_allowed: int,
             last_change_init: int):
        """correct_multi_bases_rightward/leftward (correct.cpp:380-635).

        Returns (num_corrected, len_need_trim, last_change_pos).
        """
        k = self.p.ksize
        if max_allowed > 2:
            max_allowed = 2
        if rightward:
            start_point_bit = _seq2bit_str(read, check_start - k, k - 1)
        else:
            start_point_bit = _seq2bit_str(read, check_start, k - 1)

        # node = (pointer, base, change, same, kmer)
        # The reference rebuilds each candidate k-mer by walking parent
        # pointers (get_kmer_rightward/leftward, correct.cpp:489-508,
        # 619-635); caching the sliding k-mer per node yields identical
        # values in O(1) per child (child = parent k-mer shifted by one
        # base), which the unit test below verifies against the walk.
        mask = (1 << (2 * k)) - 1
        if rightward:
            # root kmer positions: the k-1 anchor bases; a child's kmer is
            # anchor<<2|base for depth-1 nodes == (root_kmer<<2|base)&mask
            root_kmer = start_point_bit
        else:
            root_kmer = start_point_bit << 2  # low k-1 bases at high side
        nodes = [(0, 0, 0, 0, root_kmer)]
        cur = [0]
        node_pos = 0
        cycle = check_start
        max_nodes = self.p.max_bbt_nodes
        bm = self.bm
        while (cycle <= check_end) if rightward else (cycle >= check_end):
            tmp = []
            read_c = read[cycle - 1]
            for parent in cur:
                pn = nodes[parent]
                pchange = pn[2]
                pk = pn[4]
                for j in range(4):
                    if rightward:
                        kbit = ((pk << 2) | j) & mask
                    else:
                        kbit = (pk >> 2) | (j << (2 * (k - 1)))
                    same = 1 if ord(BASES[j]) == read_c else 0
                    change = pchange if same else pchange + 1
                    if change <= max_allowed and \
                            (bm[kbit >> 3] >> (7 - (kbit & 7))) & 1:
                        nodes.append((parent, j, change, same, kbit))
                        node_pos += 1
                        tmp.append(node_pos)
            if len(tmp) >= 1 and node_pos < max_nodes:
                cur = tmp
            else:
                if node_pos >= max_nodes:
                    self.nodes_overflowed = True
                break
            cycle += 1 if rightward else -1

        min_change = nodes[cur[0]][2]
        min_pos = cur[0]
        min_path = 0
        for cp in cur:
            c = nodes[cp][2]
            if c < min_change:
                min_change = c
                min_pos = cp
                min_path = 1
            elif c == min_change:
                min_path += 1

        if rightward:
            len_need_trim = check_end - cycle + 1
        else:
            len_need_trim = cycle - check_end + 1

        num_corrected = 0
        last_change = last_change_init
        if min_path == 1 and (len_need_trim == 0
                              or (len_need_trim > 0 and is_modify_trimmed)):
            num_corrected = min_change
            read_len = len(read)
            pos = min_pos
            rp = cycle - 1 if rightward else cycle + 1
            while pos > 0:
                ptr, base, _, same, _k = nodes[pos]
                if not same:
                    read[rp - 1] = ord(BASES[base])
                    if rightward:
                        if last_change == read_len + 1:
                            last_change = rp
                    else:
                        if last_change == 0:
                            last_change = rp
                pos = ptr
                rp += -1 if rightward else 1
        return num_corrected, len_need_trim, last_change

    def _kmer_rightward(self, cur_base: int, nodes, pos: int,
                        start_point_bit: int) -> int:
        """Parity: get_kmer_rightward (correct.cpp:489-508)."""
        k = self.p.ksize
        kbit = cur_base << 62
        i = 1
        while pos > 0 and i < k:
            kbit = (kbit >> 2) | (nodes[pos][1] << 62)
            pos = nodes[pos][0]
            i += 1
        spb = start_point_bit
        while i < k:
            kbit = (kbit >> 2) | ((spb & 3) << 62)
            spb >>= 2
            i += 1
        return kbit >> (64 - k * 2)

    def _kmer_leftward(self, cur_base: int, nodes, pos: int,
                       start_point_bit: int) -> int:
        """Parity: get_kmer_leftward (correct.cpp:619-635)."""
        k = self.p.ksize
        kbit = cur_base
        i = 1
        while pos > 0 and i < k:
            kbit = (kbit << 2) | nodes[pos][1]
            pos = nodes[pos][0]
            i += 1
        if i < k:
            kbit = (kbit << ((k - i) * 2)) | (start_point_bit >> ((i - 1) * 2))
        return kbit

    # --------------------------------------------------------- orchestration
    def correct_one_read(self, read: bytearray, bits: np.ndarray):
        """Parity: correct_one_read (correct.cpp:146-335).

        bits: precomputed phase-1 high/low flags for this read's k-mer
        positions (original read content).  Returns
        (one_score, multi_score, is_deleted, trim_left, trim_right).
        """
        p = self.p
        k = p.ksize
        read_len = len(read)
        accum = 0
        one_score = 0
        multi_score = 0
        right_last = read_len + 1
        trim_right = 0
        left_last = 0
        trim_left = 0

        regs = _regions_from_bits(bits)
        num_c = len(regs)

        # phase 2: fast single-base correction of interior length-k low runs
        for i in range(1, num_c - 1):
            if regs[i][2] != 0:
                continue
            if accum >= p.max_change:
                break
            size = regs[i][1] - regs[i][0] + 1
            corrected = 0
            if size == k:
                corrected = self.correct_one_base(read, regs[i][1],
                                                  regs[i][0], regs[i][1])
            if corrected:
                one_score += 1
                regs[i][2] = 1
                accum += 1

        # phase 3: merge + filter high regions (get_high_freq_region,
        # correct.cpp:112-142)
        highs = []
        i = 0
        while i < num_c:
            while i < num_c and regs[i][2] == 0:
                i += 1
            s = i
            while i < num_c and regs[i][2] == 1:
                i += 1
            if i > s and regs[i - 1][1] - regs[s][0] + 1 >= \
                    p.high_freq_reg_len:
                highs.append([regs[s][0], regs[i - 1][1], 1])
        num_h = len(highs)

        # edge shaving (correct.cpp:201-211)
        edge_cut = p.high_freq_reg_len // 3
        kmer_num = read_len - k + 1
        for h in highs:
            if h[0] != 1:
                h[0] += edge_cut
            if h[1] != kmer_num:
                h[1] -= edge_cut

        if num_h == 0:
            return one_score, multi_score, 1, trim_left, trim_right

        # phase 4: BBT between consecutive high regions
        fail_ids = []
        if num_h >= 2:
            for i in range(num_h - 1):
                if accum >= p.max_change:
                    for kk in range(i, num_h - 1):
                        fail_ids.append(kk)
                    break
                high_end = highs[i][1] + k - 1
                low_end = highs[i + 1][0] - 1 + k - 1
                num, t_right, _ = self._bbt(read, high_end + 1, low_end,
                                            True, 0, p.max_change - accum, -1)
                if t_right == 0 and num > 0:
                    multi_score += num
                    accum += num
                if t_right > 0 or num == 0:
                    high_start = highs[i + 1][0]
                    low_start = highs[i][1] + 1
                    num, t_left, _ = self._bbt(read, high_start - 1,
                                               low_start, False, 0,
                                               p.max_change - accum, -1)
                    if t_left == 0 and num > 0:
                        multi_score += num
                        accum += num
                    else:
                        fail_ids.append(i)

        # get_max_highFreq_region (correct.cpp:338-374)
        fail_ids.append(num_h - 1)
        combined = []
        cur_start = highs[0][0]
        for fid in fail_ids:
            combined.append((cur_start, highs[fid][1]))
            if fid != num_h - 1:
                cur_start = highs[fid + 1][0]
        max_len = 0
        max_id = 0
        for idx, (s, e) in enumerate(combined):
            if e - s + 1 > max_len:
                max_len = e - s + 1
                max_id = idx
        max_start, max_end = combined[max_id]

        # phase 5: head
        if max_start > 1:
            if accum < p.max_change:
                num, trim_left, left_last = self._bbt(
                    read, max_start - 1, 1, False, 1,
                    p.max_change - accum, 0)
                if num > 0:
                    multi_score += num
                    accum += num
                else:
                    trim_left = max_start - 1
                    left_last = 0
            else:
                trim_left = max_start - 1
                left_last = 0

        # phase 5: tail
        high_end = max_end + k - 1
        if high_end < read_len:
            if accum < p.max_change:
                num, trim_right, right_last = self._bbt(
                    read, high_end + 1, read_len, True, 1,
                    p.max_change - accum, read_len + 1)
                if num > 0:
                    multi_score += num
                    accum += num
                else:
                    trim_right = read_len - high_end
                    right_last = read_len + 1
            else:
                trim_right = read_len - high_end
                right_last = read_len + 1

        # further end trimming (correct.cpp:317-328)
        ft = p.further_trim
        if trim_left > 0 or (left_last > 0 and left_last <= ft):
            trim_left += ft
            if trim_left > read_len:
                trim_left = read_len
        if trim_right > 0 or (read_len + 1 > right_last >=
                              read_len - ft + 1):
            trim_right += ft
            if trim_right > read_len:
                trim_right = read_len

        deleted = 1 if (read_len - trim_left - trim_right
                        < p.min_read_len) else 0
        return one_score, multi_score, deleted, trim_left, trim_right
