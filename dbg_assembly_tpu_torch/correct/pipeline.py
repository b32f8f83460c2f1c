"""correct_error_reads and correct_error: a k-mer table in,
corrected one-line FASTA out.

Counterpart of dbg_assembly_tpu/correct/pipeline.py.  Parity:
main_parallel_senior.cpp:142-269,507-679 — per input file writes
<file>.correct.fa.gz (header + "\\tModifiedBaseNum/FinalReadLength/
LeftEndTrim/RightEndTrim/IsDeleted" annotations, deleted reads emitted with
an empty sequence line) and <file>.correct.stat; the 8-bit correct_error
(correct.cpp:639-848) writes <file>.cor and <file>.cor.stat.  The .gz files
are written at zlib level 1: they are compared and consumed on their
decompressed bytes, so the level only trades size for time.

Engines: "torch" (the device engine, correct/device.py, on ``device``,
with host fallback for the rows it flags), "native" (the shared C++ batch
corrector, native/correct_engine.cpp), "python" (the host engine,
correct/engine.py).  "auto" is "torch".  A mesh of N slots (mesh_devices)
runs the torch engine with the table sharded and the reads data-parallel
(correct/sharded.py).
"""

from __future__ import annotations

import numpy as np

from .. import dna, resolve_device, spans
from ..io import cz as czio
from ..io import fastq, stat as statio
from ..kmer import count as kc
from . import device as dev_engine
from .engine import CorrectParams, ReadCorrector, classify_regions_batch

# reads a device batch.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# PR 5) the device engine took 10.2 / 3.6 / 0.96 / 0.63 s for a file of
# 613 333 reads of 150 bp at 16 384 / 65 536 / 262 144 / all reads a chunk,
# with 2.5 / 3.5 / 7.5 / 14.6 GB of peak device memory.  Beam trips are
# bound by their launches, so fewer, wider chunks win; this width keeps the
# peak bounded whatever the file's size
DEFAULT_CHUNK = 262_144


def load_bitmap(cz_path: str, ksize: int) -> np.ndarray:
    """Load the 1-bit .cz table and OR in reverse-complement bits
    (make_kmerFreq_1bit_table_from_1BitGz + thread_setrevcompkmer,
    main_parallel_senior.cpp:334-408,310-329)."""
    return kc.expand_bitmap_rc(czio.read_cz_bits(cz_path, ksize), ksize)


def load_bitmap_8bit(cz_path: str, ksize: int,
                     low_freq_cutoff: int = 10) -> np.ndarray:
    """Load an 8-bit .cz table into a high-frequency bitmap with RC bits set
    (make_kmerFreq_1bit_table_from_8BitGz, correct_error/main.cpp:161-220:
    high iff count > cutoff, strict '>')."""
    freqs = czio.read_cz_bytes(cz_path, ksize)
    hi = np.flatnonzero(freqs > low_freq_cutoff).astype(np.uint64)
    bitmap = np.zeros((1 << (2 * ksize)) // 8, dtype=np.uint8)
    for idx in (hi, dna.revcomp_kbit(hi, ksize)):
        np.bitwise_or.at(bitmap, (idx // 8).astype(np.int64),
                         (np.uint8(1) << (7 - (idx % 8)).astype(np.uint8)))
    return bitmap


def correct_batch_torch(batch, bitmap: np.ndarray, p: CorrectParams,
                        words=None, chunk: int = DEFAULT_CHUNK,
                        device="cuda", mesh=None):
    """The device engine over a whole batch, ``chunk`` reads at a time,
    with host fallback: every row the engine flags is re-run on the host
    engine from the ORIGINAL read, which keeps the output byte-exact.
    words: the table already on the device (device.bitmap_device), else it
    is uploaded here.  The last chunk is not padded to ``chunk`` rows
    (torch compiles nothing per shape).  mesh: the sharded engine
    (sharded.correct_batch_sharded), ``words`` then the table's slots
    (sharded.shard_bitmap) and a chunk ``chunk`` reads a slot."""
    if mesh is not None:
        from . import sharded
        if words is None:
            words = sharded.shard_bitmap(mesh, bitmap)
        chunk *= mesh.n

        def engine(*rows):
            return sharded.correct_batch_sharded(mesh, *rows, words, p)
    else:
        if words is None:
            words = dev_engine.bitmap_device(bitmap, resolve_device(device))

        def engine(*rows):
            return dev_engine.correct_batch_device(*rows, words, p)
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int32)
    ones = np.zeros(n, np.int32)
    multis = np.zeros(n, np.int32)
    deleteds = np.zeros(n, np.int32)
    tls = np.zeros(n, np.int32)
    trs = np.zeros(n, np.int32)
    reads_mod = np.ascontiguousarray(batch.seqs_ascii).copy()

    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        (o, m, d, tl, tr, am, fb) = engine(
            batch.seqs_ascii[off:end], batch.codes[off:end],
            lengths[off:end])
        ones[off:end] = o
        multis[off:end] = m
        deleteds[off:end] = d
        tls[off:end] = tl
        trs[off:end] = tr
        reads_mod[off:end] = am
        # host fallback for flagged rows, from the ORIGINAL read
        flagged = np.flatnonzero(fb)
        if len(flagged) == 0:
            continue
        with spans.span("correct.fallback", rows=len(flagged)):
            for i in flagged:
                gi = off + int(i)
                L = int(lengths[gi])
                read = bytearray(batch.seqs_ascii[gi, :L].tobytes())
                corr = ReadCorrector(bitmap, p)
                bits_i = classify_regions_batch(
                    batch.codes[gi:gi + 1], lengths[gi:gi + 1], bitmap,
                    p.ksize)[0]
                (ones[gi], multis[gi], deleteds[gi], tls[gi],
                 trs[gi]) = corr.correct_one_read(
                    read, bits_i[:max(L - p.ksize + 1, 0)])
                reads_mod[gi, :L] = np.frombuffer(bytes(read), np.uint8)
                dev_engine.counts["fallback"] += 1
    return ones, multis, deleteds, tls, trs, reads_mod


def _engine(requested: str = "auto") -> str:
    """'torch' | 'native' | 'python'; 'auto' is the device engine."""
    if requested not in ("auto", "torch", "native", "python"):
        raise ValueError(f"unknown correction engine {requested!r}")
    return "torch" if requested == "auto" else requested


def _correct_rows(batch, bitmap: np.ndarray, p: CorrectParams, engine: str,
                  mesh, device, words, chunk: int):
    """(ones, multis, deleteds, left trims, right trims, corrected reads)
    of every read of ``batch`` on the named engine."""
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int64)
    if engine == "torch" and n > 0:
        # the torch engine classifies regions on the device (_stage_a) and
        # its host fallback re-derives bits per flagged read
        return correct_batch_torch(batch, bitmap, p, words=words,
                                   chunk=chunk, device=device, mesh=mesh)
    bits = None if engine == "torch" else classify_regions_batch(
        batch.codes, batch.lengths, bitmap, p.ksize)
    if engine == "native" and n > 0:
        from .. import native as nat
        Lmax = batch.seqs_ascii.shape[1]
        flat = np.ascontiguousarray(batch.seqs_ascii).reshape(-1)
        offsets = np.arange(n, dtype=np.int64) * Lmax
        ones, multis, deleteds, tls, trs = nat.correct_batch(
            flat, offsets, lengths.astype(np.int32), bits, bitmap, p)
        return ones, multis, deleteds, tls, trs, flat.reshape(n, Lmax)
    corr = ReadCorrector(bitmap, p)
    ones = np.zeros(n, np.int32)
    multis = np.zeros(n, np.int32)
    deleteds = np.zeros(n, np.int32)
    tls = np.zeros(n, np.int32)
    trs = np.zeros(n, np.int32)
    reads_mod = batch.seqs_ascii
    for i in range(n):
        L = int(lengths[i])
        read = bytearray(batch.seqs_ascii[i, :L].tobytes())
        if L >= p.ksize:
            (ones[i], multis[i], deleteds[i], tls[i],
             trs[i]) = corr.correct_one_read(
                read, bits[i, :max(L - p.ksize + 1, 0)])
        else:
            deleteds[i] = 1
        reads_mod[i, :L] = np.frombuffer(bytes(read), np.uint8)
    return ones, multis, deleteds, tls, trs, reads_mod


def correct_file(path: str, bitmap: np.ndarray, params: CorrectParams,
                 fmt: int = 1, engine: str = "auto", mesh=None,
                 device="cuda", words=None,
                 chunk: int = DEFAULT_CHUNK) -> dict:
    """Correct one read file and write its .correct.fa.gz and
    .correct.stat.  engine as in the module docstring; device, words (the
    table on the device, or its slots with a mesh) and mesh serve the
    torch engine."""
    engine = _engine(engine)
    p = params.resolved()
    batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                             strict_n=False, keep_heads=True,
                             keep_ascii=True)
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int64)
    with spans.span("correct.engine", reads=n):
        (ones, multis, deleteds, tls, trs,
         reads_mod) = _correct_rows(batch, bitmap, p, engine, mesh, device,
                                    words, chunk)

    num_res_reads = 0
    num_res_bases = 0
    num_trimmed_reads = 0
    num_trimmed_bases = 0
    num_deleted_reads = 0
    one_total = 0
    multi_total = 0
    out = bytearray()
    with spans.span("correct.format", records=n):
        for i in range(n):
            L = int(lengths[i])
            head = batch.heads[i]
            if fmt == 1 and head[:1] == b"@":
                head = b">" + head[1:]
            one, multi, deleted, tl, tr = (int(ones[i]), int(multis[i]),
                                           int(deleteds[i]), int(tls[i]),
                                           int(trs[i]))
            score = one + multi
            final_len = L - tl - tr
            if not deleted:
                one_total += one
                multi_total += multi
                read = reads_mod[i, tl:tl + final_len].tobytes()
                if tl > 0 or tr > 0:
                    num_trimmed_reads += 1
                    num_trimmed_bases += tl + tr
                num_res_reads += 1
                num_res_bases += final_len
            else:
                num_deleted_reads += 1
                read = b""
            out += (head + f"\tModifiedBaseNum: {score}"
                    f"\tFinalReadLength: {len(read)}"
                    f"\tLeftEndTrim: {tl}\tRightEndTrim: {tr}"
                    f"\tIsDeleted: {deleted}".encode()
                    + b"\n" + read + b"\n")

    out_path = path + ".correct.fa.gz"
    fastq.gz_write_bytes(out_path, bytes(out))
    statio.write_correct_stat(path + ".correct.stat", n,
                              int(lengths.sum()), num_res_reads,
                              num_res_bases, num_trimmed_reads,
                              num_trimmed_bases, num_deleted_reads,
                              one_total, multi_total)
    return {"out": out_path, "stat": path + ".correct.stat",
            "res_reads": num_res_reads, "deleted": num_deleted_reads}


def run(cz_path: str, lib_path: str, params: CorrectParams | None = None,
        fmt: int = 1, engine: str = "auto", mesh_devices: int = 0,
        device="cuda") -> list[dict]:
    """correct_error_reads over every file of the .lib list.  The torch
    engine puts the table on ``device`` once for all files.  mesh_devices
    > 0 shards it over that many slots on ``device`` (the k > 17 capacity
    path), which implies the torch engine."""
    from ..contig.pipeline import read_file_list

    mesh = None
    if mesh_devices:
        from ..parallel import mesh as meshmod
        from .sharded import shard_bitmap
        mesh = meshmod.data_mesh(mesh_devices, device)
        engine = "torch"
    engine = _engine(engine)
    dev = resolve_device(device) if engine == "torch" else None
    if params is None:
        params = CorrectParams()
    with spans.span("correct.table_load"):
        bitmap = load_bitmap(cz_path, params.ksize)
        spans.add(bytes=bitmap.nbytes)
    words = None
    if mesh is not None or dev is not None:
        with spans.span("correct.table_upload", bytes=bitmap.nbytes):
            words = (shard_bitmap(mesh, bitmap) if mesh is not None
                     else dev_engine.bitmap_device(bitmap, dev))
    return [correct_file(path, bitmap, params, fmt, engine, mesh, dev,
                         words)
            for path in read_file_list(lib_path)]


def correct_file_8bit(path: str, bitmap: np.ndarray, params: CorrectParams,
                      fmt: int = 1) -> dict:
    """correct_error (8-bit table) variant, on the host engine.

    Parity: correct_error/parse_one_reads_fq_file / _fa_file
    (correct.cpp:639-848): outputs <reads>.cor (gz) with the
    " score: N  left_trim: N" header annotation, deleted reads as an empty
    line, and <reads>.cor.stat with the older key names.  Defaults differ
    from the senior program: HighFreqRegLenCutoff IS recomputed from -k
    (main.cpp:93-95), Further_trim_len default is the compiled 17/2=8.
    """
    p = params.resolved()
    batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                             strict_n=False, keep_heads=True,
                             keep_ascii=True)
    n = batch.n_reads
    lengths = batch.lengths.astype(np.int64)
    bits = classify_regions_batch(batch.codes, batch.lengths, bitmap,
                                  p.ksize)
    corr = ReadCorrector(bitmap, p)

    stats = dict(raw_reads=n, raw_bases=int(lengths.sum()), res_reads=0,
                 res_bases=0, trimmed_reads=0, trimmed_bases=0,
                 deleted_reads=0, one=0, multi=0)
    out = bytearray()
    for i in range(n):
        L = int(lengths[i])
        head = batch.heads[i]
        if fmt == 1 and head[:1] == b"@":
            head = b">" + head[1:]
        read = bytearray(batch.seqs_ascii[i, :L].tobytes())
        if L >= p.ksize:
            one, multi, deleted, tl, tr = corr.correct_one_read(
                read, bits[i, :max(L - p.ksize + 1, 0)])
        else:
            one, multi, deleted, tl, tr = 0, 0, 1, 0, 0
        score = one + multi
        final_len = L - tl - tr
        if not deleted:
            stats["one"] += one
            stats["multi"] += multi
            if tl > 0 or tr > 0:
                read = read[tl:tl + final_len]
                stats["trimmed_reads"] += 1
                stats["trimmed_bases"] += tl + tr
            stats["res_reads"] += 1
            stats["res_bases"] += final_len
            out += (head + f" score: {score}  left_trim: {tl}".encode()
                    + b"\n" + bytes(read) + b"\n")
        else:
            stats["deleted_reads"] += 1
            out += (head + f" score: {score}  left_trim: {tl}".encode()
                    + b"\n\n")
    fastq.gz_write_bytes(path + ".cor", bytes(out))

    all_score = stats["one"] + stats["multi"]
    filt = (stats["raw_bases"] - stats["res_bases"]) / stats["raw_bases"] \
        if stats["raw_bases"] else float("nan")
    corr_ratio = all_score / stats["res_bases"] if stats["res_bases"] \
        else float("nan")
    with open(path + ".cor.stat", "w") as f:
        f.write(f"num_raw_reads {stats['raw_reads']}\n")
        f.write(f"num_raw_bases {stats['raw_bases']}\n")
        f.write(f"num_result_reads {stats['res_reads']}\n")
        f.write(f"num_result_bases {stats['res_bases']}\n")
        f.write(f"\nnum_trimmed_reads {stats['trimmed_reads']}\n")
        f.write(f"num_trimmed_bases {stats['trimmed_bases']}\n")
        f.write(f"num_deleted_reads {stats['deleted_reads']}\n")
        f.write(f"\nnum_corrected_bases_by_Fast_method {stats['one']}\n")
        f.write(f"num_corrected_bases_by_BBtree_method {stats['multi']}\n")
        f.write(f"num_corrected_bases_by_two_methods {all_score}\n")
        f.write("\nlow_quality_bases_filter_ratio "
                f"{statio.fmt_g6(filt)}\n")
        f.write("estimated_raw_base_error_ratio "
                f"{statio.fmt_g6(corr_ratio)}\n")
    return {"out": path + ".cor", "stat": path + ".cor.stat"}


def run_8bit(cz_path: str, lib_path: str, ksize: int = 17,
             low_freq_cutoff: int = 10, max_change: int = 2,
             high_freq_reg_len: int = 0, further_trim: int = 0,
             min_read_len: int = 50, max_bbt_nodes: int = 15_000_000,
             fmt: int = 1, join: bool = True) -> list[dict]:
    """correct_error (v2.2, 8-bit table) pipeline.  -m 0 resolves to the
    RUNTIME k (main.cpp:93-95), -x 0 to the compiled 17/2 = 8."""
    from ..contig.pipeline import read_file_list
    from ..utils.helpers import merge_corrected_pair

    params = CorrectParams(
        ksize=ksize,
        high_freq_reg_len=high_freq_reg_len or ksize,
        max_change=max_change,
        further_trim=further_trim or 8,
        max_bbt_nodes=max_bbt_nodes,
        min_read_len=min_read_len)
    bitmap = load_bitmap_8bit(cz_path, ksize, low_freq_cutoff)
    files = read_file_list(lib_path)
    results = [correct_file_8bit(path, bitmap, params, fmt)
               for path in files]
    if join:
        for i in range(0, len(files) - 1, 2):
            merge_corrected_pair(files[i] + ".cor", files[i + 1] + ".cor")
    return results
