"""Checks of what the upstream's map_pair and link_scaffold guarantee of
the records they write, with no replay of either tool: each from the
outputs, the command's own inputs and the cell's reads, limit 0.

map_pair (map_pair.cpp:152-354; map_func.cpp:241-299):
  * map_lines_misaligned: a mapped mate's line names a read of its
    length and a contig of its length; its read span and contig span are
    in range and equally long (the extension is ungapped); its identity
    is 1 - mismatches / span length, the mismatches recounted here
    between the read (reverse-complemented where R) and the contig over
    those spans, in the upstream's rounding (ratio in float32, difference
    in double, stored as float, printed %g times 100), and at least -i;
  * map_stat_totals_differ: the .stat's total is the pairs whose mates
    are both at least -r long; its four classes sum to it; the diff, same
    and gap classes are the line counts of .2ctg, .1ctg and .gap.

link_scaffold (link_scaffold.cpp:242-463; link_func.cpp:477-785):
  * scaffold_contigs_repeated: every contig of the input (a record with
    a sequence: the reader drops an empty one) is named once across
    .scaffold.pos.tab and .scaffold_repeat.pos.tab, and nothing else is
    named (the readout walks every contig slot, marks what it walks, and
    sends the repeat nodes it removed to the repeat file, so no contig is
    missing);
  * scaffold_sequence_differs: each scaffold's sequence, in both
    sequence files, is its .pos.tab blocks in order, a contig reverse-
    complemented where R, a gap of as many N as the block states;
  * scaffold_links_unsupported: every link kept in .links.uniq has a
    pair count of at least -n, and the round's 2ctg files hold at least
    that many lines joining its two contigs (in any orientation);
  * scaffold_gaps_unsupported: between every two neighbouring contigs of
    a scaffold in .scaffold.pos.tab, in the orientations it gives them,
    at least -n of the round's 2ctg lines place the second after the
    first in those orientations, and the gap block is the truncated
    integer mean of those lines' gaps (at least 1).  Each line's
    placement and gap are the upstream's per-orientation rules
    (link_func.cpp:226-324 for pairs, :329-426 for mate pairs) from the
    insert, the contig lengths and the mates' contig coordinates, the
    gap kept where -insert/2 < gap <= insert and a link's mean over its
    first 1023 lines (link_func.cpp:430-473), in the order of the 2ctg
    list.
"""

from __future__ import annotations

import numpy as np

from .scaffold import fasta_records

BLOCK = 32768
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b


def _mates(data: bytes) -> tuple[list, int]:
    """The 10-field mate records of a map_pair file's lines (two a line
    in .2ctg and .1ctg, one in .gap), and the count of malformed lines."""
    out, bad = [], 0
    for line in data.split(b"\n"):
        if not line or line[:1] == b"#":
            continue
        f = line.split(b"\t")
        if len(f) == 20:
            out += (f[:10], f[10:])
        elif len(f) == 10:
            out.append(f)
        else:
            bad += 1
    return out, bad


def _identity(mism: np.ndarray, span: np.ndarray):
    """The identities and their printed form, in the upstream's
    rounding."""
    ident = (1.0 - (mism.astype(np.float32) / span.astype(np.float32))
             .astype(np.float64)).astype(np.float32)
    return ident, [b"%g%%" % x for x in (ident * np.float32(100)).tolist()]


def map_lines(files: list, contigs: dict, read_rows, min_identity: float
              ) -> int:
    """Mate records of ``files`` (decompressed .2ctg, .1ctg, .gap) that
    break the alignment guarantee.  contigs: id -> sequence of the FASTA
    the command read; read_rows(ids) -> ([M, L] ASCII, [M] lengths), a
    length of -1 for an id that names no read of the cell."""
    mates, bad = [], 0
    for data in files:
        got, malformed = _mates(data)
        mates += got
        bad += malformed
    for o in range(0, len(mates), BLOCK):
        bad += _map_block(np.array(mates[o:o + BLOCK], dtype=bytes),
                          contigs, read_rows, min_identity)
    return bad


def _map_block(mates: np.ndarray, contigs: dict, read_rows,
               min_identity) -> int:
    """Records of ``mates``, an [M, 10] array of their fields, that break
    the guarantee; all M where a number field is no number."""
    M = mates.shape[0]
    seqs, rlen = read_rows(mates[:, 0].tolist())
    try:
        num = mates[:, [1, 2, 3, 5, 6, 7]].astype(np.int64)
    except ValueError:
        return M
    given_rlen, rs, re, given_clen, cs, ce = num.T
    # each contig named once: its length and its place in one buffer
    names, which = np.unique(mates[:, 4], return_inverse=True)
    ctg = [contigs.get(c) for c in names.tolist()]
    known = np.array([c is not None for c in ctg])[which]
    clen = np.where(known, np.array([len(c or b"") for c in ctg],
                                    np.int64)[which], -1)
    starts = np.zeros(len(ctg), np.int64)
    np.cumsum([len(c or b"") for c in ctg][:-1], out=starts[1:])
    joined = np.frombuffer(b"".join(c or b"" for c in ctg) or b"\0",
                           np.uint8)
    fwd = mates[:, 8] == b"F"
    ok = ((rlen >= 0) & (rlen == given_rlen) & known
          & (clen == given_clen) & (1 <= rs) & (rs <= re) & (re <= rlen)
          & (1 <= cs) & (cs <= ce) & (ce <= clen) & (re - rs == ce - cs)
          & (fwd | (mates[:, 8] == b"R")))
    span = np.where(ok, re - rs + 1, 1)
    width = int(span.max())
    t = np.arange(width)[None, :]
    inside = t < span[:, None]
    # the read along the contig: forward from rs, or the reverse
    # complement of read[rs - 1 : re] read from its end
    col = np.where(fwd[:, None], rs[:, None] - 1 + t, re[:, None] - 1 - t)
    col = np.clip(col, 0, seqs.shape[1] - 1)
    along = np.take_along_axis(seqs, col, axis=1)
    along = np.where(fwd[:, None], along, _COMP[along])
    at = np.clip(starts[which][:, None] + cs[:, None] - 1 + t, 0,
                 len(joined) - 1)
    mism = ((along != joined[at]) & inside).sum(1)
    ident, text = _identity(mism, span)
    ok &= ident.astype(np.float64) >= min_identity
    ok &= np.array(text, dtype=bytes) == mates[:, 9]
    return int((~ok).sum())


def _stat_numbers(text: bytes) -> list:
    out = []
    for line in text.split(b"\n"):
        if b":" in line:
            try:
                out.append(int(line.split(b":")[1].split()[0]))
            except (ValueError, IndexError):
                out.append(-1)
    return out


def _records(data: bytes) -> int:
    return sum(1 for x in data.split(b"\n") if x and x[:1] != b"#")


def map_stat(stat: bytes, twoctg: bytes, onectg: bytes, gap: bytes,
             pairs: int) -> int:
    """Relations of the .stat that fail: its total against ``pairs``, the
    classes' sum against the total, and diff, same and gap against the
    files' line counts."""
    nums = _stat_numbers(stat)
    if len(nums) != 5:
        return 5
    total, diff, same, gaps, none = nums
    return sum((total != pairs, diff + same + gaps + none != total,
                diff != _records(twoctg), same != _records(onectg),
                gaps != _records(gap)))


def _pos_blocks(data: bytes) -> dict:
    """scaffold name -> its blocks (name, size, direction) in order."""
    out: dict = {}
    cur = None
    for line in data.split(b"\n"):
        if line[:1] == b">":
            cur = out.setdefault(line[1:].split()[0] if len(line) > 1
                                 else b"", [])
        elif line and cur is not None:
            f = line.split(b"\t")
            cur.append((f[1], f[4], f[5]) if len(f) == 6 else None)
    return out


def scaffold_contigs(contig_fa: bytes, pos: bytes, repeat_pos: bytes) -> int:
    """Contigs of the input named other than once across both .pos.tab
    files, and names there that are no input contig."""
    want = {i for i, s in fasta_records(contig_fa) if s}
    seen: dict = {}
    for blocks in list(_pos_blocks(pos).values()) \
            + list(_pos_blocks(repeat_pos).values()):
        for b in blocks:
            if b is None:
                seen[None] = seen.get(None, 0) + 1
            elif b[0] != b"gap":
                seen[b[0]] = seen.get(b[0], 0) + 1
    return (sum(abs(seen.get(c, 0) - 1) for c in want)
            + sum(n for c, n in seen.items() if c not in want))


def _revcomp(s: bytes) -> bytes:
    return s.translate(bytes(_COMP))[::-1]


def scaffold_sequences(contig_fa: bytes, seq_fa: bytes, pos: bytes) -> int:
    """Scaffolds whose sequence is not their .pos.tab blocks; a scaffold
    that one of the two files lacks counts too."""
    contigs = dict(fasta_records(contig_fa))
    seqs = {}
    for name, s in fasta_records(seq_fa):
        seqs[name] = s
    blocks = _pos_blocks(pos)
    bad = len(set(seqs) ^ set(blocks))
    for name in set(seqs) & set(blocks):
        parts = []
        for b in blocks[name]:
            if b is None or not b[1].isdigit():
                parts = None
                break
            if b[0] == b"gap":
                parts.append(b"N" * int(b[1]))
            elif b[0] in contigs and b[2] in (b"F", b"R"):
                c = contigs[b[0]]
                parts.append(c if b[2] == b"F" else _revcomp(c))
            else:
                parts = None
                break
        bad += parts is None or b"".join(parts) != seqs[name]
    return bad


def _number(name: bytes) -> int:
    try:
        return int(name.rsplit(b"_", 1)[-1])
    except ValueError:
        return -1


def scaffold_links(links_uniq: bytes, twoctg: list, cut: int) -> int:
    """Links of .links.uniq with fewer than ``cut`` pairs, or more pairs
    than 2ctg lines joining their two contigs.  A node is a contig's
    forward (odd, its number) or reverse (even, the number + 1) slot."""
    joined: dict = {}
    for data in twoctg:
        for line in data.split(b"\n"):
            f = line.split(b"\t")
            if len(f) == 20 and line[:1] != b"#":
                key = frozenset((_number(f[4]), _number(f[14])))
                joined[key] = joined.get(key, 0) + 1
    bad = 0
    for line in links_uniq.split(b"\n")[1:]:
        f = line.split(b"\t")
        if len(f) < 3:
            continue
        src = int(f[0])
        for link in f[3:]:
            dst, pairs = (int(x) for x in link.split(b",")[:2])
            key = frozenset((src - 1 + src % 2, dst - 1 + dst % 2))
            bad += pairs < cut or joined.get(key, 0) < pairs
    return bad


# A 2ctg line, by its mates' directions (pairs, -m 0), places one contig
# after the other, each in an orientation, with a gap from the insert I,
# the contig lengths L1, L2 and the mates' contig starts and ends: (first
# mate's contig, its orientation, the second's, its orientation) ->
# (contig before, orientation, contig after, orientation, gap).  Mate
# pairs (-m 1) follow the same rules with both directions flipped.
def _placement(d1, d2, c1, c2, L1, L2, c1s, c1e, c2s, c2e, insert):
    if d1 == b"F" and d2 == b"R":
        return c1, b"F", c2, b"F", insert - (L1 - c1s) - c2e
    if d1 == b"R" and d2 == b"F":
        return c2, b"F", c1, b"F", insert - (L2 - c2s) - c1e
    if d1 == b"F" and d2 == b"F":
        return c1, b"F", c2, b"R", insert - (L1 - c1s) - (L2 - c2s)
    if d1 == b"R" and d2 == b"R":
        return c1, b"R", c2, b"F", insert - c1e - c2e
    return None


_FLIP = {b"F": b"R", b"R": b"F"}
LINK_CAP = 1023


def _link_key(a, da, b, db) -> tuple:
    """One key for 'a (da) then b (db)' and the same join read from the
    other strand, 'b (flipped) then a (flipped)'."""
    return min((a, da, b, db), (b, _FLIP[db], a, _FLIP[da]))


def _trunc_mean(total: int, n: int) -> int:
    q = abs(total) // n
    return q if total >= 0 else -q


def scaffold_gaps(contig_fa: bytes, pos: bytes, twoctg: list, insert: int,
                  cut: int, is_mate: bool = False) -> int:
    """Neighbouring contigs of .scaffold.pos.tab whose order and
    orientations fewer than ``cut`` 2ctg lines support, or whose gap block
    is not those lines' mean gap; a scaffold whose blocks do not
    alternate contig and gap counts once."""
    lengths = {name: len(s) for name, s in fasta_records(contig_fa)}
    lo = -(insert // 2)
    links: dict = {}                   # key -> [lines, summed gap]
    for data in twoctg:
        for line in data.split(b"\n"):
            f = line.split(b"\t")
            if len(f) != 20 or line[:1] == b"#":
                continue
            d1, d2 = f[8], f[18]
            if is_mate:
                d1, d2 = _FLIP.get(d1), _FLIP.get(d2)
            try:
                at = _placement(d1, d2, f[4], f[14], lengths[f[4]],
                                lengths[f[14]], int(f[6]), int(f[7]),
                                int(f[16]), int(f[17]), insert)
            except (KeyError, ValueError):
                continue
            if at is None or not lo < at[4] <= insert:
                continue
            e = links.setdefault(_link_key(*at[:4]), [0, 0])
            if e[0] < LINK_CAP:
                e[0] += 1
                e[1] += at[4]
    bad = 0
    for blocks in _pos_blocks(pos).values():
        if any(b is None for b in blocks) or len(blocks) % 2 == 0 or any(
                (b[0] == b"gap") != (j % 2 == 1)
                for j, b in enumerate(blocks)):
            bad += 1
            continue
        for j in range(0, len(blocks) - 2, 2):
            (a, _, da), (_, size, _), (b, _, db) = blocks[j:j + 3]
            n, total = links.get(_link_key(a, da, b, db)
                                 if da in _FLIP and db in _FLIP else None,
                                 (0, 0))
            bad += n < cut or size != b"%d" % max(_trunc_mean(total, n)
                                                  if n else 0, 1)
    return bad
