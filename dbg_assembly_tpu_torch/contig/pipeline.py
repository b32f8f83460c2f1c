"""debruijn_contig stage: graph build on the device + contig readout.

Counterpart of dbg_assembly_tpu/contig/pipeline.py.  CLI
parity with DBG_contig/main.cpp:162-212; writes the full artifact set:
.contig.seq.fa/.seq.depth, .small.*, .tip.fa, .lowedge.fa, .bubble.fa,
.kmer.freq.  Two readouts: "exact" replays the reference serially in
native/assemble_engine.cpp (byte-exact files); "doubling" prunes in bulk
and resolves chains by pointer doubling on the device
(contig/pointer_doubling.py; the same records, length ties may be ordered
differently).  A mesh of N slots (mesh_devices) runs the distributed stage:
the owner-routed ingest and the mesh contig stage, whose files equal the
doubling readout's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import spans
from ..io import fastq
from ..io.lib import read_file_list
from .graph import GraphBuilder
from .pointer_doubling import assemble_doubling
from .refassemble import (AssembleParams, RefAssembler, _cap,
                          compute_hash_schedule, initial_hash_size)
from .runlog import ContigRunLog, count_end_marks


def _read(path: str, fmt: int):
    return fastq.read_batch(path, fmt="fq" if fmt == 1 else "fa",
                            keep_heads=False)


def _ingest(files, fmt, ksize, max_read_len, device, ranges=None,
            lengths_sink=None, mesh=None):
    """Feed all files into a GraphBuilder on ``device`` (or sharded over
    the slots of ``mesh``); the next file is
    parsed on a host thread while the device ingests this one.  ranges:
    per-file (start, end) GLOBAL read-ordinal windows for the degrade
    re-pass (DBGgraph.cpp:337-351 ignore-remaining-reads policy): every
    range is a file prefix, and the builder's ordinals stay pinned to the
    original numbering.  lengths_sink: collects the per-file truncated
    length arrays of the reads ingested (for the run log)."""
    gb = GraphBuilder(ksize, max_read_len, device=device, mesh=mesh)
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_read, files[0], fmt) if files else None
        for i in range(len(files)):
            with spans.span("contig.parse_wait"):
                batch = fut.result()
            if i + 1 < len(files):
                fut = ex.submit(_read, files[i + 1], fmt)
            codes, lengths = batch.codes, batch.lengths
            if ranges is not None:
                s, e = ranges[i]
                gb.read_seq = s
                codes, lengths = codes[:e - s], lengths[:e - s]
            gb.new_file()
            if lengths_sink is not None:
                lengths_sink.append(
                    np.minimum(lengths, max_read_len).astype(np.int32))
            gb.add(codes, lengths)
    return gb


def run(lib_file: str, prefix: str, ksize: int = 31, fmt: int = 1,
        max_read_len: int = 250, params: AssembleParams | None = None,
        readout: str = "exact", log_stream=None, log_threads: int = 10,
        log_buffer: int = 10_000, log_doublings: int = 10,
        mesh_devices: int = 0, device="cuda"):
    """Build the graph of every file in the .lib list on ``device``, prune
    it and read the contigs out.  readout="exact" replays the reference
    (byte-exact files); readout="doubling" runs the bulk pruning and the
    pointer-doubling readout, its chains resolved on ``device``
    (record-exact; file order may differ on length ties).
    log_stream: emit the reference-parity run log there (its heartbeat
    cadence follows log_buffer = -b, log_threads = -t).
    mesh_devices > 0 runs the distributed stage over that many slots on
    ``device`` (parallel/mesh.data_mesh): the owner-routed ingest and the
    mesh contig stage (contig/mesh_assemble.py), which implies the
    doubling readout and writes its files.

    Hash enlargement parity: when the distinct-node count exceeds the
    initial capacity (-i x load factor), the reference grows its table x2
    between ingest buffers (kmerSet.cpp:132-189) and, past -e doublings,
    stops ingesting (DBGgraph.cpp:337-351).  Both are emulated: a schedule
    from first-occurrence read ordinals, a re-ingest of exactly the
    reference's read subset on degrade, and the epoch-aware native layout."""
    if readout not in ("exact", "doubling"):
        raise ValueError(f"readout must be 'exact' or 'doubling', not "
                         f"{readout!r}")
    mesh = None
    if mesh_devices:
        from ..parallel import mesh as meshmod
        mesh = meshmod.data_mesh(mesh_devices, device)
        readout = "doubling"
    if params is None:
        params = AssembleParams(ksize=ksize)
    params.ksize = ksize
    params.buffer_reads = log_buffer
    params.max_doublings = log_doublings
    files = read_file_list(lib_file)
    log = None
    if log_stream is not None:
        log = ContigRunLog(log_stream, params, prefix, fmt, max_read_len,
                           threads=log_threads, buffer_reads=log_buffer,
                           max_doublings=log_doublings)
        log.parameters()
        log.hash_init()

    file_lengths: list | None = [] if log else None
    with spans.span("contig.ingest"):
        gb = _ingest(files, fmt, ksize, max_read_len, device,
                     lengths_sink=file_lengths, mesh=mesh)
    with spans.span("contig.finalize"):
        table = gb.finalize()

    # ---- enlargement / degrade schedule
    schedule = None
    epoch_occ = None
    normal = table.kmers != np.uint64(0)
    if int(normal.sum()) > _cap(initial_hash_size(params),
                                params.load_factor):
        with spans.span("contig.schedule"):
            first_read = gb.stream_to_read(table.first_idx[normal])
            schedule = compute_hash_schedule(first_read, gb.file_starts,
                                             gb.read_seq, params)
            if schedule.ingest_ranges is not None:
                # degrade: re-ingest exactly the reference's read subset
                file_lengths = [] if log else None
                gb = _ingest(files, fmt, ksize, max_read_len, device,
                             ranges=schedule.ingest_ranges,
                             lengths_sink=file_lengths, mesh=mesh)
                table = gb.finalize()
                normal = table.kmers != np.uint64(0)
                first_read = gb.stream_to_read(table.first_idx[normal])
                schedule = compute_hash_schedule(first_read, gb.file_starts,
                                                 gb.read_seq, params)
            if readout == "exact":
                # per-epoch occurrence counts for the count_conflict
                # parity: one truncated recount per enlargement boundary
                # (the doubling readout lays out the initial table only)
                epoch_occ = [
                    _occurrences_before(files, fmt, ksize, max_read_len,
                                        schedule.ingest_ranges, q, table,
                                        device)
                    for q in schedule.enlarge_reads] or None

    if log:
        _emit_file_log(log, files, file_lengths, ksize, schedule, gb)

    with spans.span("contig.readout"):
        if readout == "doubling":
            if mesh is not None:
                from .mesh_assemble import assemble_doubling_mesh
                stats = assemble_doubling_mesh(table, params, prefix, mesh)
            else:
                stats = assemble_doubling(table, params, prefix, device)
            if log:
                log.hash_params(stats.hash_size, stats.total_nodes,
                                stats.hash_conflicts_occ)
        else:
            with spans.span("contig.readout.layout"):
                asm = RefAssembler(table, params, schedule, epoch_occ)
            if log:
                log.hash_params(asm.size, asm.n_nodes,
                                asm.stats.hash_conflicts_occ)
            with spans.span("contig.readout.replay"):
                stats = asm.run(prefix)
        if log:
            log.links(stats)
            log.pruning(stats)
            brk, bra = count_end_marks(prefix)
            log.readout(stats, brk, bra)
    return stats


def _occurrences_before(files, fmt, ksize, max_read_len, ranges, q, table,
                        device):
    """Per-table-row canonical k-mer occurrence counts over the reads with
    global ordinal < q (for the epoch-wise count_conflict emulation)."""
    from ..kmer import count as kc

    counter = kc.KmerCounter(ksize, device=device)
    seq = 0
    for i, path in enumerate(files):
        batch = _read(path, fmt)
        codes, lengths = batch.codes, batch.lengths
        n = len(codes)
        s, e = (seq, seq + n) if ranges is None else ranges[i]
        lo, hi = max(s, seq), min(e, seq + n, q)
        if hi > lo:
            counter.add(codes[lo - seq:hi - seq][:, :max_read_len],
                        np.minimum(lengths[lo - seq:hi - seq], max_read_len))
        seq += n
        if seq >= q:
            break
    uniq, counts, _ = counter.finalize()
    out = np.zeros(len(table.kmers), np.int64)
    idx = np.searchsorted(table.kmers, uniq)
    ok = idx < len(table.kmers)
    ok &= table.kmers[np.minimum(idx, len(table.kmers) - 1)] == uniq
    out[idx[ok]] = counts[ok]
    return out


def _emit_file_log(log, files, file_lengths, ksize, schedule, gb):
    """Replay the per-file heartbeat groups, injecting the enlargement /
    degrade lines at their buffer boundaries."""
    enlarges = {}
    alerts = {}
    if schedule is not None:
        enlarges = dict(zip(schedule.enlarge_reads, schedule.sizes[1:]))
        alerts = dict(schedule.alerts)
    for i, path in enumerate(files):
        log.file_start(path)
        log.file_blocks(file_lengths[i], ksize, file_start=gb.file_starts[i],
                        enlarges=enlarges, alerts=alerts)
        log.file_end()
