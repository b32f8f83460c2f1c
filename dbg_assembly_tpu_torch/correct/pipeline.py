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

The 1-bit table's reverse-complement bits are ORed in on the host
(load_bitmap), but where the torch engine puts the table on one device:
there the raw bits are uploaded and the kernel ops/rc_expand.py expands
them in place, and the host fallback reads the device's table, copied back
the first time a row falls back (_host_table).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import dna, resolve_device, spans
from ..io import cz as czio, fastq, stat as statio
from ..io.lib import read_file_list
from ..kmer import count as kc
from ..ops import rc_expand
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
        kc.bitmap_set(bitmap, idx)
    return bitmap


def correct_batch_torch(batch, bitmap: np.ndarray, p: CorrectParams,
                        words=None, chunk: int = DEFAULT_CHUNK,
                        device="cuda", mesh=None):
    """The device engine over a whole batch, ``chunk`` reads at a time,
    with host fallback: every row the engine flags is re-run on the host
    engine from the ORIGINAL read, which keeps the output byte-exact.
    words: the table already on the device (device.bitmap_device), else it
    is uploaded here; with words given, ``bitmap`` may be a function that
    returns the host table (_host_table), called when a row falls back.
    The last chunk is not padded to ``chunk`` rows (torch compiles nothing
    per shape).  mesh: the sharded engine
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
    outs = _outputs(n, np.ascontiguousarray(batch.seqs_ascii).copy())
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        *res, fb = engine(batch.seqs_ascii[off:end], batch.codes[off:end],
                          lengths[off:end])
        for out, r in zip(outs, res):
            out[off:end] = r
        flagged = off + np.flatnonzero(fb)
        if len(flagged) == 0:
            continue
        with spans.span("correct.fallback", rows=len(flagged)):
            _host_correct(batch, flagged,
                          bitmap() if callable(bitmap) else bitmap, p, outs)
            dev_engine.counts["fallback"] += len(flagged)
    return outs


def _outputs(n: int, reads_mod: np.ndarray) -> tuple:
    """(ones, multis, deleteds, left trims, right trims, corrected reads)
    of n reads: five int32 zero arrays and ``reads_mod``."""
    return tuple(np.zeros(n, np.int32) for _ in range(5)) + (reads_mod,)


def _host_correct(batch, rows: np.ndarray, bitmap: np.ndarray,
                  p: CorrectParams, outs: tuple) -> None:
    """The host engine (engine.py) over ``rows`` of ``batch``, each read
    from its ORIGINAL bytes, into those rows of ``outs`` (_outputs).  A
    read shorter than k has no k-mer, hence no high region: the corrector
    returns it deleted and unchanged."""
    bits = classify_regions_batch(batch.codes[rows], batch.lengths[rows],
                                  bitmap, p.ksize)
    corr = ReadCorrector(bitmap, p)
    *scores, reads_mod = outs
    for i, b in zip(rows, bits):
        L = int(batch.lengths[i])
        read = bytearray(batch.seqs_ascii[i, :L].tobytes())
        res = corr.correct_one_read(read, b[:max(L - p.ksize + 1, 0)])
        for out, v in zip(scores, res):
            out[i] = v
        reads_mod[i, :L] = np.frombuffer(bytes(read), np.uint8)


def _engine(requested: str = "auto") -> str:
    """'torch' | 'native' | 'python'; 'auto' is the device engine."""
    if requested not in ("auto", "torch", "native", "python"):
        raise ValueError(f"unknown correction engine {requested!r}")
    return "torch" if requested == "auto" else requested


def _correct_rows(batch, bitmap: np.ndarray, p: CorrectParams, engine: str,
                  mesh=None, device=None, words=None,
                  chunk: int = DEFAULT_CHUNK):
    """(ones, multis, deleteds, left trims, right trims, corrected reads)
    of every read of ``batch`` on the named engine."""
    n = batch.n_reads
    if n == 0:
        return _outputs(0, batch.seqs_ascii)
    if engine == "torch":
        # the torch engine classifies regions on the device (_stage_a);
        # its host fallback classifies the rows it flags
        return correct_batch_torch(batch, bitmap, p, words=words,
                                   chunk=chunk, device=device, mesh=mesh)
    if engine == "native":
        from .. import native as nat
        bits = classify_regions_batch(batch.codes, batch.lengths, bitmap,
                                      p.ksize)
        Lmax = batch.seqs_ascii.shape[1]
        flat = np.ascontiguousarray(batch.seqs_ascii).reshape(-1)
        offsets = np.arange(n, dtype=np.int64) * Lmax
        ones, multis, deleteds, tls, trs = nat.correct_batch(
            flat, offsets, batch.lengths.astype(np.int32), bits, bitmap, p)
        return ones, multis, deleteds, tls, trs, flat.reshape(n, Lmax)
    outs = _outputs(n, batch.seqs_ascii)
    _host_correct(batch, np.arange(n), bitmap, p, outs)
    return outs


def _write_records(batch, outs: tuple, fmt: int, annotate) -> tuple:
    """The corrected reads' records and their tallies.  A record is the
    read's header (FASTQ's '@' as '>'), annotate(score, final length,
    left trim, right trim, deleted), and the read trimmed (empty if
    deleted), a line each.  The tallies are write_correct_stat's."""
    lengths = batch.lengths.tolist()
    reads_mod = outs[5]
    res_reads = res_bases = trimmed_reads = trimmed_bases = deleted_reads \
        = fast_score = bbt_score = 0
    out = bytearray()
    for i, (head, L, one, multi, deleted, tl, tr) in enumerate(zip(
            batch.heads, lengths, *(o.tolist() for o in outs[:5]))):
        if fmt == 1 and head[:1] == b"@":
            head = b">" + head[1:]
        final_len = L - tl - tr
        if not deleted:
            fast_score += one
            bbt_score += multi
            read = reads_mod[i, tl:tl + final_len].tobytes()
            if tl > 0 or tr > 0:
                trimmed_reads += 1
                trimmed_bases += tl + tr
            res_reads += 1
            res_bases += final_len
        else:
            deleted_reads += 1
            read = b""
        out += (head + annotate(one + multi, len(read), tl, tr,
                                deleted).encode()
                + b"\n" + read + b"\n")
    return bytes(out), dict(
        raw_reads=len(lengths), raw_bases=sum(lengths), res_reads=res_reads,
        res_bases=res_bases, trimmed_reads=trimmed_reads,
        trimmed_bases=trimmed_bases, deleted_reads=deleted_reads,
        fast_score=fast_score, bbt_score=bbt_score)


def correct_file(path: str, bitmap: np.ndarray, params: CorrectParams,
                 fmt: int = 1, engine: str = "auto", mesh=None,
                 device="cuda", words=None,
                 chunk: int = DEFAULT_CHUNK) -> dict:
    """Correct one read file and write its .correct.fa.gz and
    .correct.stat.  engine as in the module docstring; device, words (the
    table on the device, or its slots with a mesh) and mesh serve the
    torch engine; with words given, ``bitmap`` may be a function that
    returns the host table (correct_batch_torch)."""
    engine = _engine(engine)
    p = params.resolved()
    batch = fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                             strict_n=False, keep_heads=True,
                             keep_ascii=True)
    n = batch.n_reads
    with spans.span("correct.engine", reads=n):
        outs = _correct_rows(batch, bitmap, p, engine, mesh, device, words,
                             chunk)
    with spans.span("correct.format", records=n):
        out, tallies = _write_records(
            batch, outs, fmt,
            lambda score, final, tl, tr, deleted: (
                f"\tModifiedBaseNum: {score}\tFinalReadLength: {final}"
                f"\tLeftEndTrim: {tl}\tRightEndTrim: {tr}"
                f"\tIsDeleted: {deleted}"))
    out_path = path + ".correct.fa.gz"
    fastq.gz_write_bytes(out_path, out)
    statio.write_correct_stat(path + ".correct.stat", **tallies)
    return {"out": out_path, "stat": path + ".correct.stat",
            "res_reads": tallies["res_reads"],
            "deleted": tallies["deleted_reads"]}


def run(cz_path: str, lib_path: str, params: CorrectParams | None = None,
        fmt: int = 1, engine: str = "auto", mesh_devices: int = 0,
        device="cuda") -> list[dict]:
    """correct_error_reads over every file of the .lib list.  The torch
    engine puts the table on ``device`` once for all files, its raw bits
    expanded there (_expand_table), and hands the host fallback the
    device's table (_host_table).  mesh_devices > 0 shards the host-expanded
    table over that many slots on ``device`` (the k > 17 capacity path: a
    bit's rc may lie in another slot), which implies the torch engine."""
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
    words = None
    if dev is not None and mesh is None:
        # the table on one device: its rc bits are ORed in there
        with spans.span("correct.table_load"):
            raw = czio.read_cz_bits(cz_path, params.ksize)
            spans.add(bytes=raw.nbytes)
        with spans.span("correct.table_upload", bytes=raw.nbytes):
            words = _expand_table(
                dev_engine.bitmap_device(raw, dev), params.ksize)
        del raw
        bitmap = _host_table(words)
    else:
        with spans.span("correct.table_load"):
            bitmap = load_bitmap(cz_path, params.ksize)
            spans.add(bytes=bitmap.nbytes)
        if mesh is not None:
            with spans.span("correct.table_upload", bytes=bitmap.nbytes):
                words = shard_bitmap(mesh, bitmap)
    return [correct_file(path, bitmap, params, fmt, engine, mesh, dev,
                         words)
            for path in read_file_list(lib_path)]


def _expand_table(words: torch.Tensor, ksize: int) -> torch.Tensor:
    """The uploaded raw table (device.bitmap_device) with its rc bits ORed
    in on its device (ops/rc_expand.py: in place on the card, a new tensor
    on the CPU), the device synchronised at the end, so that the kernel's
    time is the span's."""
    with spans.span("correct.table_expand", words=words.numel()):
        launched = rc_expand.launches
        words = rc_expand.rc_expand(words, ksize)
        if words.is_cuda:
            torch.cuda.synchronize(words.device)
        spans.add(launches=rc_expand.launches - launched)
    return words


def _host_table(words: torch.Tensor):
    """A function that returns the device's expanded table as host bytes,
    for the host fallback: copied from the device at its first call, once
    a run, and kept (a run with no fallback never copies it)."""
    @functools.cache
    def fetch() -> np.ndarray:
        with spans.span("correct.host_table", bytes=words.numel() * 4):
            dev_engine.counts["host_table"] += 1
            return words.cpu().numpy().view(np.uint8)
    return fetch


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
    outs = _correct_rows(batch, bitmap, p, "python")
    out, tallies = _write_records(
        batch, outs, fmt,
        lambda score, final, tl, tr, deleted: (
            f" score: {score}  left_trim: {tl}"))
    fastq.gz_write_bytes(path + ".cor", out)
    statio.write_cor_stat(path + ".cor.stat", **tallies)
    return {"out": path + ".cor", "stat": path + ".cor.stat"}


def run_8bit(cz_path: str, lib_path: str, ksize: int = 17,
             low_freq_cutoff: int = 10, max_change: int = 2,
             high_freq_reg_len: int = 0, further_trim: int = 0,
             min_read_len: int = 50, max_bbt_nodes: int = 15_000_000,
             fmt: int = 1, join: bool = True) -> list[dict]:
    """correct_error (v2.2, 8-bit table) pipeline.  -m 0 resolves to the
    RUNTIME k (main.cpp:93-95), -x 0 to the compiled 17/2 = 8."""
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
