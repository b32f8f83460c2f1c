"""map_pair: paired reads aligned to contigs and routed by where they map.

Counterpart of dbg_assembly_tpu/scaffold/map_pair.py.  Parity:
link_scaffold/map_pair.cpp:50-354.  Maps read1 and read2 of each pair
independently (the first qualifying seed wins) and routes the pairs to
.map_pair.2ctg.gz (different contigs), .1ctg.gz (same contig) and .gap.gz
(one end unmapped), plus .map_pair.stat, writing the 20-column TSV
(:202-206) and the .map_pair.2ctg.lib list file (:89-95).  The .gz files
are written at zlib level 1: they are compared and consumed on their
decompressed bytes.

Spans, a pair of files each, on the command thread: ``map_pair.parse``
(both files' decode), ``map_pair.format`` (the per-pair loop) and
``map_pair.write`` (the three .gz files, each in its ``io.gzip``, and the
.stat); the index and the mapper hold ``scaffold.index`` and
``scaffold.map`` (index.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import resolve_device, spans
from ..io import fastq, stat as statio
from ..io.lib import read_file_list
from . import index as ixmod

HEADER_PAIR = (b"#read_id\tread_length\talign_read_start\talign_read_end\t"
               b"contig_id\tcontig_length\talign_contig_start\t"
               b"align_contig_end\talign_direct\talign_identity%\tread_id\t"
               b"read_length\talign2_read_start\talign2_read_end\t"
               b"contig2_id\tcontig2_length\talign2_contig_start\t"
               b"align2_contig_end\talign2_direct\talign2_identity%\n")
HEADER_ONE = (b"#read_id\tread_length\talign_read_start\talign_read_end\t"
              b"contig_id\tcontig_length\talign_contig_start\t"
              b"align_contig_end\talign_direct\talign_identity%\n")


def read_contig_fasta(path: str):
    """Parity: map_func.cpp:81-116: ids (first token) and sequences, by
    index; a record with no sequence is dropped, except the last."""
    ids, seqs = [], []
    cur_id = None
    cur = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line[:1] == b">":
                if cur_id is not None and sum(len(c) for c in cur) > 0:
                    ids.append(cur_id)
                    seqs.append(b"".join(cur))
                cur_id = line[1:].split()[0] if len(line) > 1 else b""
                cur = []
            elif line:
                cur.append(line)
    if cur_id is not None:
        ids.append(cur_id)
        seqs.append(b"".join(cur))
    return ids, seqs


def _read_id(head: bytes, lead: bytes) -> bytes:
    """Parity: split on the {lead, space, tab} delimiter set with compression
    (map_pair.cpp:241-246 via split(), map_func.cpp:33-53)."""
    for d in (lead, b"\t"):
        head = head.replace(d, b" ")
    toks = [t for t in head.split(b" ") if t]
    rid = toks[0] if toks else b""
    if len(toks) > 1:
        rid += b"-" + toks[1]
    return rid


def _fmt_line(rid, rlen, r: ixmod.MapResult, i, ids, clens) -> bytes:
    # C++ streams align_identity*100 computed in float32 (map_pair.cpp:320)
    ident = statio.fmt_g6(float(np.float32(r.identity[i]) * np.float32(100)))
    d = b"F" if r.direct[i] else b"R"
    return (rid + b"\t" + str(rlen).encode() + b"\t"
            + str(int(r.read_start[i])).encode() + b"\t"
            + str(int(r.read_end[i])).encode() + b"\t"
            + ids[int(r.contig[i])] + b"\t"
            + str(int(clens[int(r.contig[i])])).encode() + b"\t"
            + str(int(r.contig_start[i])).encode() + b"\t"
            + str(int(r.contig_end[i])).encode() + b"\t"
            + d + b"\t" + ident.encode() + b"%")


def run(contig_fa: str, lib_path: str, out_dir: str, ksize: int = 31,
        seed_kmer_num: int = 5, min_ctg_len: int = 125,
        min_read_len: int = 250, min_identity: float = 0.97,
        fmt: int = 1, mesh_devices: int = 0, engine: str = "torch",
        device="cuda") -> list[dict]:
    """map_pair over every pair of files in the .lib list.  engine "torch"
    builds the index and maps on ``device``; "native" runs the C++ engine.
    mesh_devices > 0 maps the read batches sharded over that many slots on
    ``device`` (scaffold/sharded.py), the index on each slot, which implies
    the torch engine.  Returns each pair's counts (total, diff, same, gap,
    none)."""
    mesh = None
    if mesh_devices:
        from ..parallel import mesh as meshmod
        mesh = meshmod.data_mesh(mesh_devices, device)
        engine = "torch"
    dev = resolve_device(device) if engine == "torch" else None
    files = read_file_list(lib_path)
    os.makedirs(out_dir, exist_ok=True)

    with open(lib_path + ".map_pair.2ctg.lib", "w") as f:
        for i in range(0, len(files), 2):
            f.write(f"{out_dir}/{files[i]}.map_pair.2ctg.gz\n")

    ids, seqs = read_contig_fasta(contig_fa)
    seqs = [s if len(s) >= min_ctg_len else b"" for s in seqs]
    ix = ixmod.build(seqs, ksize, engine=engine, device=dev)
    if mesh is not None:
        from .sharded import replicate
        ix = replicate(mesh, ix)
    clens = np.array([len(s) for s in seqs], dtype=np.int64)

    return [_map_pair_files(files[fi], files[fi + 1], ix, ids, clens,
                            out_dir, seed_kmer_num, min_read_len,
                            min_identity, fmt, mesh)
            for fi in range(0, len(files), 2)]


def _map_pair_files(f1: str, f2: str, ix, ids, clens, out_dir: str,
                    seed_kmer_num: int, min_read_len: int,
                    min_identity: float, fmt: int, mesh=None) -> dict:
    """mesh: map on its slots, ix then the index's replicas
    (sharded.replicate)."""
    lead = b"@" if fmt == 1 else b">"

    def decode(f):
        return fastq.read_batch(f, fmt="fq" if fmt == 1 else "fa",
                                strict_n=False, keep_heads=True,
                                keep_ascii=True)
    # the pair's files decode at once, read2 on a helper thread (zlib and
    # the parser release the GIL)
    with spans.span("map_pair.parse", bytes=os.path.getsize(f1)
                    + os.path.getsize(f2)), \
            ThreadPoolExecutor(max_workers=1) as ex:
        fut2 = ex.submit(decode, f2)
        b1 = decode(f1)
        b2 = fut2.result()
        spans.add(reads=b1.n_reads + b2.n_reads)
    n = min(b1.n_reads, b2.n_reads)

    len1 = b1.lengths.astype(np.int64)
    len2 = b2.lengths.astype(np.int64)
    keep = (len1[:n] >= min_read_len) & (len2[:n] >= min_read_len)

    if mesh is not None:
        from .sharded import map_reads_sharded

        def mapper(*args):
            return map_reads_sharded(mesh, ix, *args)
    else:
        def mapper(*args):
            return ixmod.map_reads(ix, *args)
    r1 = mapper(b1.codes[:n], b1.seqs_ascii[:n], b1.lengths[:n],
                seed_kmer_num, min_identity)
    r2 = mapper(b2.codes[:n], b2.seqs_ascii[:n], b2.lengths[:n],
                seed_kmer_num, min_identity)

    out_diff = bytearray(HEADER_PAIR)
    out_same = bytearray(HEADER_ONE)   # reference quirk: 10-col header on
    out_gap = bytearray(HEADER_ONE)    # the 1ctg stream (map_pair.cpp:204)

    total = diff = same = gap = none = 0
    with spans.span("map_pair.format"):
        for i in range(n):
            if not keep[i]:
                continue
            total += 1
            m1 = bool(r1.mapped[i])
            m2 = bool(r2.mapped[i])
            rid1 = _read_id(b1.heads[i], lead)
            rid2 = _read_id(b2.heads[i], lead)
            if m1 and m2:
                l1 = _fmt_line(rid1, int(len1[i]), r1, i, ids, clens)
                l2 = _fmt_line(rid2, int(len2[i]), r2, i, ids, clens)
                if int(r1.contig[i]) != int(r2.contig[i]):
                    diff += 1
                    out_diff += l1 + b"\t" + l2 + b"\n"
                else:
                    same += 1
                    out_same += l1 + b"\t" + l2 + b"\n"
            elif m1 or m2:
                gap += 1
                if m1:
                    out_gap += _fmt_line(rid1, int(len1[i]), r1, i, ids,
                                         clens) + b"\n"
                if m2:
                    out_gap += _fmt_line(rid2, int(len2[i]), r2, i, ids,
                                         clens) + b"\n"
            else:
                none += 1
        spans.add(pairs=total, diff=diff, same=same, gap=gap, none=none)

    base = os.path.basename(f1)
    with spans.span("map_pair.write"):
        for suf, data in ((".map_pair.2ctg.gz", out_diff),
                          (".map_pair.1ctg.gz", out_same),
                          (".map_pair.gap.gz", out_gap)):
            fastq.gz_write_bytes(f"{out_dir}/{base}{suf}", bytes(data))
        statio.write_map_pair_stat(f"{out_dir}/{base}.map_pair.stat",
                                   total, diff, same, gap, none)
    return dict(total=total, diff=diff, same=same, gap=gap, none=none)
