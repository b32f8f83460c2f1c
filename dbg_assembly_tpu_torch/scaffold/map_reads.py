"""map_reads: single reads aligned to contigs in two parts.

Counterpart of dbg_assembly_tpu/scaffold/map_reads.py.  Parity:
link_scaffold/map_reads.cpp.  Maps the left part of each read; when mapped
and bases remain, attempts a second alignment of the remaining right part
starting after the first alignment's end (:480-498).  Reads whose two parts
hit different contigs go to .map_reads.2ctg.gz (with their sequences in
.2ctg.gz.reads.fa.gz for gap filling, :364); one-part-only hits go to
.map_reads.1ctg.gz; same-contig double hits are counted as errors and
written nowhere.  The .gz files are written at zlib level 6, as the JAX
package writes them; they are compared on their decompressed bytes.
"""

from __future__ import annotations

import os

import numpy as np

from .. import resolve_device
from ..io import fastq, stat as statio
from ..io.lib import read_file_list
from . import index as ixmod
from .map_pair import HEADER_ONE, HEADER_PAIR, _fmt_line, _read_id, \
    read_contig_fasta


def run(contig_fa: str, lib_path: str, out_dir: str, ksize: int = 31,
        seed_kmer_num: int = 5, min_ctg_len: int = 125,
        min_read_len: int = 250, min_identity: float = 0.97,
        fmt: int = 1, engine: str = "torch", device="cuda") -> list[dict]:
    """map_reads over every file of the .lib list.  engine "torch" builds
    the index and maps on ``device``; "native" runs the C++ engine.
    Returns each file's counts (total, diff, same, none, err)."""
    dev = resolve_device(device) if engine == "torch" else None
    files = read_file_list(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    # the list names each input by its whole .lib entry, not its basename
    # (map_reads.cpp; the outputs themselves use the basename)
    with open(lib_path + ".map_reads.2ctg.lib", "w") as f:
        for p in files:
            f.write(f"{out_dir}/{p}.map_reads.2ctg.gz\n")

    ids, seqs = read_contig_fasta(contig_fa)
    seqs = [s if len(s) >= min_ctg_len else b"" for s in seqs]
    ix = ixmod.build(seqs, ksize, engine=engine, device=dev)
    clens = np.array([len(s) for s in seqs], dtype=np.int64)

    return [_map_one_file(path, ix, ids, clens, out_dir, ksize,
                          seed_kmer_num, min_read_len, min_identity, fmt)
            for path in files]


def _map_one_file(path: str, ix, ids, clens, out_dir: str, ksize: int,
                  seed_kmer_num: int, min_read_len: int,
                  min_identity: float, fmt: int) -> dict:
    lead = b"@" if fmt == 1 else b">"
    b = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                         strict_n=False, keep_heads=True, keep_ascii=True)
    n = b.n_reads
    lengths = b.lengths.astype(np.int64)

    r1 = ixmod.map_reads(ix, b.codes, b.seqs_ascii, b.lengths,
                         seed_kmer_num, min_identity)
    # the second alignment only for mapped reads with enough bases left;
    # elsewhere an empty range (start past the read's last window)
    want2 = r1.mapped & (r1.read_end < lengths) & \
        ((lengths - r1.read_end) >= ksize + seed_kmer_num)
    ss2 = np.where(want2, r1.read_end.astype(np.int64) + 1, lengths + 1)
    r2 = ixmod.map_reads(ix, b.codes, b.seqs_ascii, b.lengths,
                         seed_kmer_num, min_identity, search_start=ss2)
    r2_mapped = r2.mapped & want2

    out_diff = bytearray(HEADER_PAIR)
    out_seq = bytearray()
    out_same = bytearray(HEADER_ONE)
    total = diff = same = none = err = 0
    for i in range(n):
        if lengths[i] < min_read_len:
            continue
        total += 1
        rid = _read_id(b.heads[i], lead)
        if r1.mapped[i]:
            if r2_mapped[i]:
                if int(r1.contig[i]) != int(r2.contig[i]):
                    diff += 1
                    l1 = _fmt_line(rid, int(lengths[i]), r1, i, ids, clens)
                    l2 = _fmt_line(rid, int(lengths[i]), r2, i, ids, clens)
                    out_diff += l1 + b"\t" + l2 + b"\n"
                    out_seq += (b">" + rid + b"\n"
                                + b.seqs_ascii[i, :int(lengths[i])].tobytes()
                                + b"\n")
                else:
                    err += 1
            else:
                same += 1
                out_same += _fmt_line(rid, int(lengths[i]), r1, i, ids,
                                      clens) + b"\n"
        else:
            none += 1

    base = os.path.basename(path)
    for suf, data in ((".map_reads.2ctg.gz", out_diff),
                      (".map_reads.2ctg.gz.reads.fa.gz", out_seq),
                      (".map_reads.1ctg.gz", out_same)):
        fastq.gz_write_bytes(f"{out_dir}/{base}{suf}", bytes(data), level=6)

    def pct(a):
        return statio.fmt_g6(a / total * 100 if total else float("nan"))
    with open(f"{out_dir}/{base}.map_reads.stat", "w") as f:
        f.write(f"\ttotal_read_num: {total}\n")
        f.write(f"\tmap_ctg_diff_num: {diff}  {pct(diff)}%\n")
        f.write(f"\tmap_ctg_same_num: {same}  {pct(same)}%\n")
        f.write(f"\tmap_no_no_num: {none}  {pct(none)}%\n")
        f.write(f"\terror_map_num: {err}  {pct(err)}%\n")
    return dict(total=total, diff=diff, same=same, none=none, err=err)
