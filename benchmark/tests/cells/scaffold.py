"""Tests of the ``scaffold`` traffic (contigs in set-up; map_pair and
link_scaffold at insert 400, then at 800 on the round-1 scaffolds): its
tiny twin, its faults, its guarantee faults, its control and the span
metrics a run of it reads."""

import numpy as np


def tiny(load):
    """The E. coli configuration cut to a 100 000 bp genome at depth 8,
    a size at which the control's identities differ on the test's seed
    (3 lines; at 30 000 bp and depth 6 none do); the set-up's contigs at
    ``-i 0.001``, the small initial hash."""
    ecoli = load("configs", "ecoli_mg1655_scaffold.json")
    ecoli.update(name="tiny_ecoli_scaffold", genome_length=100000)
    for lib in ecoli["libraries"]:
        lib["depth"] = 8
    mix = load("traffic", "scaffold.json")
    args = mix["setup"][0]["args"]
    args[args.index("-i") + 1] = "0.001"
    mix["warmup_reads"] = 100
    return {"tiny.scaffold": (ecoli, mix)}


def _patch_pair_dropped(mp):
    """The last pair of each .2ctg file left out."""
    from dbg_assembly_tpu_torch.io import fastq
    real = fastq.gz_write_bytes

    def dropped(path, data, *a, **kw):
        if path.endswith(".map_pair.2ctg.gz"):
            data = data[:data.rindex(b"\n", 0, len(data) - 1) + 1]
        return real(path, data, *a, **kw)
    mp.setattr(fastq, "gz_write_bytes", dropped)


def _patch_map_half(mp):
    """Only the first half of each mate's reads mapped and written, as if
    the mapper's loop stopped halfway through its chunks."""
    from dbg_assembly_tpu_torch.scaffold import index
    real = index.map_reads

    def half(*a, **kw):
        r = real(*a, **kw)
        r.mapped[len(r.mapped) // 2:] = False
        return r
    mp.setattr(index, "map_reads", half)


def _patch_seed_spacing(mp):
    """Seeds taken at S + 1 k-mers apart."""
    from dbg_assembly_tpu_torch.scaffold import index
    real = index._map_kernel
    mp.setattr(index, "_map_kernel", lambda ix, codes, ascii_seq, lengths,
               ss, identity, k, S: real(ix, codes, ascii_seq, lengths, ss,
                                        identity, k, S + 1))


def _patch_gap_size(mp):
    """One N more in a scaffold's first gap."""
    from dbg_assembly_tpu_torch.scaffold import scaffold
    real = scaffold.generate_scaffold

    def longer(contig_seqs, combined):
        ids, seq, directs = real(contig_seqs, combined)
        if "N" in directs:
            at = seq.index(b"N")
            seq = seq[:at] + b"N" + seq[at:]
        return ids, seq, directs
    mp.setattr(scaffold, "generate_scaffold", longer)


def _patch_gap_block(mp):
    """Every gap of a scaffold one N longer, in its sequence and its
    .pos.tab block alike, so that only the 2ctg lines can tell."""
    from dbg_assembly_tpu_torch.scaffold import scaffold
    real = scaffold.generate_scaffold

    def longer(contig_seqs, combined):
        return real(contig_seqs, [v + 1 if i % 2 else v
                                  for i, v in enumerate(combined)])
    mp.setattr(scaffold, "generate_scaffold", longer)


FAULTS = [
    ("tiny.scaffold", "state unchanged: a mapped pair dropped",
     _patch_pair_dropped, "map_lines_differ"),
    ("tiny.scaffold", "half the batch: only the first half of the map "
     "chunks written", _patch_map_half, "map_lines_differ"),
    ("tiny.scaffold", "an answer altered: the seed's spacing off by one",
     _patch_seed_spacing, "map_lines_differ"),
    ("tiny.scaffold", "an answer altered: a gap size off by one",
     _patch_gap_size, "scaffold_seq_lines_differ"),
]

GUARANTEE_FAULTS = [
    ("tiny.scaffold", _patch_pair_dropped, "map_stat_totals_differ"),
    ("tiny.scaffold", _patch_gap_size, "scaffold_sequence_differs"),
    ("tiny.scaffold", _patch_gap_block, "scaffold_gaps_unsupported"),
]

GUARANTEE = "map_lines_misaligned"


def control(monkeypatch):
    """A mate's identity as 1 - mismatches / length in float64, printed
    from it, where the upstream rounds the ratio through float32 and
    stores a float (index.py's "float parity" line): patched in, no
    arguments appended."""
    from dbg_assembly_tpu_torch.io import stat
    from dbg_assembly_tpu_torch.scaffold import index, map_pair
    real = index.map_reads

    def in_double(*a, **kw):
        r = real(*a, **kw)
        span = (r.read_end - r.read_start + 1).astype(np.float64)
        mism = np.rint((1.0 - r.identity.astype(np.float64)) * span)
        r.identity = 1.0 - mism / np.maximum(span, 1)
        return r
    monkeypatch.setattr(index, "map_reads", in_double)

    def line(rid, rlen, r, i, ids, clens):
        return (rid + b"\t" + b"\t".join(str(int(x)).encode() for x in (
            rlen, r.read_start[i], r.read_end[i])) + b"\t"
            + ids[int(r.contig[i])] + b"\t" + b"\t".join(
                str(int(x)).encode() for x in (
                    clens[int(r.contig[i])], r.contig_start[i],
                    r.contig_end[i])) + b"\t"
            + (b"F" if r.direct[i] else b"R") + b"\t"
            + stat.fmt_g6(float(r.identity[i]) * 100).encode() + b"%")
    monkeypatch.setattr(map_pair, "_fmt_line", line)
    return None


SPAN_METRICS = {
    "tiny.scaffold": ["span_s.parse", "span_s.gzip", "span_s.parse.scaffold",
                      "span_s.map_index", "span_s.map_kernel",
                      "span_s.map_format"],
}
