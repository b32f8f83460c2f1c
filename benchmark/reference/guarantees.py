"""Checks of what the upstream's correction and contig tools guarantee of
every record they write, worked out from the inputs and the benchmark's
own k-mer tables, with no replay of either tool.

The byte-exact comparisons (reference/correct.py, reference/contig.py)
replay the port's own reading of the upstream; these hold the outputs to
properties that follow from the upstream's design as SURVEY.md sets it out
(correct.cpp:146-335, main_parallel_senior.cpp:507-679; contig.cpp:107-205,
779-1046), on every read and every contig:

correction (correct_error_reads, 1-bit table, -j 0):
  * a read whose k-mers are all in the table is written unchanged, with
    no change, no trim and not deleted; every other read is changed,
    trimmed or deleted (the five phases touch a read only at a low k-mer,
    and a low k-mer is never kept untouched);
  * a kept read is its input cut by LeftEndTrim and RightEndTrim, at least
    -r bases long, differing from the input in at most ModifiedBaseNum
    bases, and ModifiedBaseNum is at most -c; a deleted read is empty;
  * .correct.stat's totals are those of the records (the split between
    the fast and the tree method is not in the records and is not read).

contigs (debruijn_contig):
  * every k-mer of a contig is a node, and each step from one k-mer to the
    next follows a link whose counter is above -D (contig.cpp:132);
  * no node inside a contig is inside another (the readout deletes the
    linear nodes it walks; the end k-mers, where a walk stopped, may be
    shared);
  * a contig's avgDepth is the mean of its steps' link counters, and its
    depth record gives each base its step's counter, the seed k-mer's
    bases the average (contig.cpp:972-989);
  * ids run 1, 3, 5, ... in order of length, longest first; a contig of
    .contig.seq.fa is at least -M long, one of .contig.small.fa shorter;
    its header's length is its own; its depth record has its name and a
    byte for each base.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import CODE

ROWS = 65536


def _kmer_bits(seq_ascii: torch.Tensor, table: torch.Tensor, k: int):
    """[N, L-k+1] bool: each forward k-mer of the reads (N read as A) is
    set in the 1-bit table."""
    codes = CODE.to(table.device)[seq_ascii.to(table.device).long()].long()
    P = codes.shape[1] - k + 1
    km = torch.zeros((codes.shape[0], P), dtype=torch.int64,
                     device=table.device)
    for i in range(k):
        km = (km << 2) | codes[:, i:i + P]
    return ((table[km >> 3].long() >> (7 - (km & 7))) & 1).bool()


def solid_reads(seqs: torch.Tensor, table: torch.Tensor, k: int):
    """[N] bool numpy: every k-mer of the read is in the table."""
    out = [_kmer_bits(seqs[o:o + ROWS], table, k).all(1).cpu()
           for o in range(0, seqs.shape[0], ROWS)]
    return torch.cat(out).numpy()


def _annotations(head: bytes):
    """(name, ModifiedBaseNum, FinalReadLength, LeftEndTrim, RightEndTrim,
    IsDeleted) of a correction header, None where it does not parse."""
    parts = head.split(b"\t")
    keys = (b"ModifiedBaseNum: ", b"FinalReadLength: ", b"LeftEndTrim: ",
            b"RightEndTrim: ", b"IsDeleted: ")
    if len(parts) != 6:
        return None
    vals = []
    for key, part in zip(keys, parts[1:]):
        if not part.startswith(key):
            return None
        try:
            vals.append(int(part[len(key):]))
        except ValueError:
            return None
    return (parts[0], *vals)


def correction(lines: list, seqs: np.ndarray, names: list, solid,
               max_change: int, min_len: int, stat: bytes) -> dict:
    """Counts of the records of one <file>.correct.fa.gz (``lines``, split
    on newlines) that break a guarantee, and of the .correct.stat lines
    that differ from the records' totals.  seqs [N, L] ASCII inputs,
    names their '>' headers, solid from solid_reads."""
    n, L = seqs.shape
    untouched_differ = 0
    malformed = 0
    tot = dict(res_reads=0, res_bases=0, trimmed_reads=0, trimmed_bases=0,
               deleted=0, score=0)
    for i in range(n):
        j = 2 * i
        ann = _annotations(lines[j]) if j + 1 < len(lines) else None
        if ann is None or ann[0] != names[i]:
            malformed += 1
            untouched_differ += 1
            continue
        _, score, final, tl, tr, deleted = ann
        out = lines[j + 1]
        untouched = (score == 0 and tl == 0 and tr == 0 and deleted == 0
                     and out == seqs[i].tobytes())
        untouched_differ += bool(solid[i]) != untouched
        if deleted:
            tot["deleted"] += 1
            malformed += out != b"" or final != 0
            continue
        bad = (final != len(out) or final != L - tl - tr or final < min_len
               or tl < 0 or tr < 0 or not 0 <= score <= max_change)
        if not bad:
            got = np.frombuffer(out, np.uint8)
            bad = int((got != seqs[i, tl:L - tr]).sum()) > score
        malformed += bad
        tot["res_reads"] += 1
        tot["res_bases"] += final
        tot["trimmed_reads"] += tl > 0 or tr > 0
        tot["trimmed_bases"] += tl + tr
        tot["score"] += score
    malformed += len(lines) != 2 * n + 1
    raw = n * L
    filt = (raw - tot["res_bases"]) / raw if raw else float("nan")
    corr = tot["score"] / tot["res_bases"] if tot["res_bases"] \
        else float("nan")
    want = [f"num_raw_reads {n}", f"num_raw_bases {raw}",
            f"num_result_reads {tot['res_reads']}",
            f"num_result_bases {tot['res_bases']}", "",
            f"num_trimmed_reads {tot['trimmed_reads']}",
            f"num_trimmed_bases {tot['trimmed_bases']}",
            f"num_deleted_reads {tot['deleted']}", "",
            None, None,                  # the fast / tree split: not read
            f"num_corrected_bases_by_two_methods {tot['score']}", "",
            "filter_ratio: (num_raw_bases - num_res_bases) / num_raw_bases "
            "%g" % filt,
            "correct_ratio: total_all_base_correct_score / num_res_bases "
            "%g" % corr, ""]
    got = stat.decode(errors="replace").split("\n")
    stat_differ = abs(len(got) - len(want)) + sum(
        w is not None and g != w for g, w in zip(got, want))
    return {"untouched_reads_differ": untouched_differ,
            "corrected_reads_malformed": malformed,
            "correct_stat_totals_differ": stat_differ}


def _fasta(data: bytes) -> list:
    """(header line, sequence) of each two-line record."""
    lines = data.split(b"\n")
    return [(lines[i], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


def _avg_depth(fields: list):
    """The header's avgDepth, None where it has none."""
    for f in fields:
        if f.startswith(b"avgDepth: "):
            try:
                return float(f[10:])
            except ValueError:
                return None
    return None


def _depth_byte(d: int) -> int:
    """A depth as its byte: 10 and 62 ('\\n', '>') one lower
    (contig.cpp:849-851)."""
    d &= 0xFF
    return d - 1 if d in (10, 62) else d


def _depth_bytes(d: np.ndarray) -> np.ndarray:
    """_depth_byte of each."""
    d = d.astype(np.int64) & 0xFF
    return d - ((d == 10) | (d == 62))


def _depth_differs(steps: np.ndarray, m: np.ndarray, dbytes: bytes,
                   k: int) -> bool:
    """Whether a contig's header average and depth record disagree with
    the link counters of its steps: the average is their mean; the record
    gives each base left of the seed k-mer the counter of the step out of
    its k-mer, the seed's k bases the average's integer part, and each
    base right of it the counter of the step into its k-mer
    (contig.cpp:972-989); the seed may sit anywhere.  m: the steps'
    counters as bytes."""
    got = np.frombuffer(dbytes, np.uint8).astype(np.int64)
    n = len(m)
    if len(got) != n + k:
        return True
    seed = _depth_byte(int(steps.sum() / n))
    same = got[:n] == m
    a = n if same.all() else int(np.argmin(same))       # common prefix
    same = got[k:][::-1] == m[::-1]
    b = n if same.all() else int(np.argmin(same))       # common suffix
    for j in range(max(0, n - b), min(a, n) + 1):
        if (got[j:j + k] == seed).all():
            return False
    return True


def contigs(seq_fa: bytes, small_fa: bytes, seq_depth: bytes,
            small_depth: bytes, kmers: np.ndarray, lcnt: np.ndarray,
            rcnt: np.ndarray, k: int, cutoff: int, min_len: int,
            device) -> dict:
    """Counts of contig steps that no link above ``cutoff`` supports,
    nodes inside two contigs, contigs whose depths are not their links',
    and malformed records, over both FASTA files; kmers (sorted), lcnt,
    rcnt: the reference's node table."""
    malformed = 0
    recs = []                  # (id, sequence, avgDepth, depth record)
    for data, depth, big in ((seq_fa, seq_depth, True),
                             (small_fa, small_depth, False)):
        fa = _fasta(data)
        dp = _fasta(depth)
        malformed += len(fa) != len(dp)
        for (head, seq), (dname, dbytes) in zip(fa, dp):
            fields = head.split(b"\t")
            ok = (fields[0].startswith(b">ctg_") and len(fields) > 1
                  and fields[1] == b"length: %d" % len(seq)
                  and dname == fields[0] and len(dbytes) == len(seq)
                  and (len(seq) >= min_len) == big)
            try:
                cid = int(fields[0][5:])
            except ValueError:
                ok, cid = False, -1
            malformed += not ok
            recs.append((cid, seq, _avg_depth(fields), dbytes))
    recs.sort(key=lambda r: r[0])
    malformed += sum(r[0] != 2 * i + 1 for i, r in enumerate(recs))
    malformed += sum(len(a[1]) < len(b[1]) for a, b in zip(recs, recs[1:]))
    # a contig takes a step each way from its seed k-mer
    short = sum(len(r[1]) < k + 2 for r in recs)
    recs = [r for r in recs if len(r[1]) >= k + 2]
    if not recs:
        return {"contig_steps_unsupported": short, "contig_nodes_shared": 0,
                "contig_depths_differ": 0,
                "contig_records_malformed": malformed}

    flat = torch.from_numpy(np.frombuffer(b"".join(r[1] for r in recs),
                                          np.uint8).copy()).to(device)
    lens = torch.tensor([len(r[1]) for r in recs], device=device)
    ends = torch.cumsum(lens, 0)
    owner = torch.repeat_interleave(torch.arange(len(recs), device=device),
                                    lens)
    acgt = (flat == 65) | (flat == 67) | (flat == 71) | (flat == 84)
    codes = CODE.to(device)[flat.long()].long()
    T = flat.numel()
    P = T - k + 1
    fwd = torch.zeros(P, dtype=torch.int64, device=device)
    rc = torch.zeros(P, dtype=torch.int64, device=device)
    for i in range(k):
        ci = codes[i:i + P]
        fwd = (fwd << 2) | ci
        rc = (rc >> 2) | ((3 - ci) << (2 * (k - 1)))
    pos = torch.arange(P, device=device)
    end_of = ends[owner[:P]]
    window = pos + k <= end_of                 # inside one contig
    step = pos + k < end_of                    # a next base in the contig
    clean = torch.nn.functional.pad(
        (~acgt).to(torch.int32).cumsum(0), (1, 0))
    clean = (clean[k:] - clean[:P]) == 0
    canon = torch.minimum(fwd, rc)
    table = torch.from_numpy(kmers.view(np.int64)).to(device)
    at = torch.searchsorted(table, canon).clamp_max(table.numel() - 1)
    is_node = (table[at] == canon) & clean
    nxt = torch.cat([codes[k:], codes.new_zeros(1)])[:P]
    lc = torch.from_numpy(lcnt).to(device)
    rcc = torch.from_numpy(rcnt).to(device)
    # the link from a k-mer to the next: the node's right counter of the
    # next base, or, where the node is the reverse complement, its left
    # counter of that base's complement
    count = torch.where(fwd <= rc, rcc[at, nxt], lc[at, 3 - nxt])
    count = torch.where(is_node, count, 0)
    nxt_ok = torch.cat([acgt[k:], acgt.new_zeros(1)])[:P]
    bad_node = window & ~is_node
    bad_step = step & is_node & ((count <= cutoff) | ~nxt_ok)
    unsupported = short + int(bad_node.sum()) + int(bad_step.sum())

    # a contig's end k-mers are the branch or missing nodes its walks
    # stopped at, which other contigs may share; every other k-mer is a
    # linear node that the readout deleted as it went
    starts = ends - lens
    keep = step & is_node & (pos != starts[owner[:P]])
    pair = torch.unique(torch.stack([at[keep], owner[:P][keep]], 1), dim=0)
    _, per_node = torch.unique(pair[:, 0], return_counts=True)
    shared = int((per_node > 1).sum())

    counts = count[step].cpu().numpy()
    mapped = _depth_bytes(counts)
    nsteps = (lens - k).cpu().numpy()
    depths = 0
    off = 0
    for (_, _, avg, dbytes), n in zip(recs, nsteps.tolist()):
        steps = counts[off:off + n]
        m = mapped[off:off + n]
        off += n
        depths += bool(avg is None or avg != int(steps.sum()) / n
                       or _depth_differs(steps, m, dbytes, k))
    return {"contig_steps_unsupported": unsupported,
            "contig_nodes_shared": shared,
            "contig_depths_differ": depths,
            "contig_records_malformed": malformed}
