#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbg_assembly_tpu_torch) on one card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA card must be present; prints the nvidia-smi name and
     power limit and the CUDA version;
  2. build: the chop kernel (ops/csrc/chop.cu), the radix sort
     (ops/csrc/radix_sort.cu) and the seven triage probes
     (ops/csrc/probe_*.cu), one nvcc each, and native/ (make), all started
     together; prints ptxas's registers, shared memory and spills per
     kernel;
  3. the triage entry point on the card (tools/triage.py): every probe
     kernel and the chop, each in its own process, must equal its plain
     version and the JAX triage's numpy expectation exactly; each process
     starts with its counts at 0 and reports its launches;
  4. probes vs plain on the card: each probe kernel against its plain
     version on the probe's own input, exact, timed with CUDA events beside
     its plain version and, where one PyTorch call computes it, that call;
  5. kernel vs plain on the card: chop against chop_plain on the same CUDA
     tensors, both modes, exact equality (k 16/17/31, ragged reads, reads
     shorter than k, and the main path's 100 000 x 150 batch at k = 31,
     timed with CUDA events);
  6. the slice at E. coli scale: a 4.6 Mb simulated genome, 150 bp pairs at
     40x, written as two FASTQ files;
  7. sort vs plain on the card: the radix sort against sort_plain on the
     same CUDA tensors, keys and index exactly equal: n = 0, 1, 1000, all
     keys equal, keys with the sentinel, key_bits 34/35/62/63, n at the
     kernel's tile boundaries, and the main path's shapes, timed with CUDA
     events in turns plain/kernel/kernel/plain beside torch.sort(keys,
     stable=True): kmerfreq's batch (200 000 x 134 windows at k = 17, keys
     only), ingest's batch (100 000 x 120 at k = 31, with index) and an
     8-part merge of the library's first 8 ingest batches (with index);
  8. the three stage runs through cli.main: ``kmerfreq -k 17 -m 1``,
     ``debruijn_contig -k 31 -i 0.02 -M 125`` and the same with
     ``--readout doubling``; each kernel's launch count is set to 0 just
     before each run and read just after, and must be > 0 for both kernels
     in every run; wall time and peak device memory per run;
  9. oracles: the doubling run's .seq and .small record multisets,
     .contig.kmer.freq bytes and tip/lowedge/bubble removal counts equal the
     exact run's; the GPU node table at k = 31 and the GPU k = 17 counts
     equal the shared native C++ ingest on the same files;
  10. the doubling stage step by step on that node table (graph set-up,
     links, tips, low edges, bubbles, readout), with the chain resolution
     timed on the card (_succ_resolve) against the native host twins
     (succ_build + resolve_chains_host), their outputs compared, and the
     host memory of collect_heads' scratch.
Bounds (bound_ms) are the larger of the bytes each kernel must move (each
input read once, each output written once) over the published 3.35 TB/s
and its operations over 67 T a second (the published float32 rate outside
the tensor cores; integer ALU work is taken at the same rate).  The last
lines of standard output are the card's nvidia-smi name and power limit,
the kernels' JSON record and {"ok": true, "device": {...}}.  Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
ALU_OPS_PER_S = 67e12          # float32 outside the tensor cores, published
GENOME_LEN = 4_600_000
DEPTH = 40.0
READ_LEN = 150


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work at published
    rates."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


# ---------------------------------------------------------------- phase 3
def phase_triage() -> dict:
    """The triage entry point on the card; returns each probe's launches."""
    from dbg_assembly_tpu_torch.tools import triage
    results = triage.run_all("cuda")
    bad = {n: r["err"] for n, r in results.items() if not r["ok"]}
    if bad:
        raise AssertionError(f"triage rows failed on the card: {bad}")
    _log(f"triage on the card: all {len(results)} rows OK")
    return {n: r["launches"] for n, r in results.items()}


# ---------------------------------------------------------------- phase 4
# one PyTorch call that computes the probe's function on the same input
# (timed as library_ms; the port never calls these)
_PROBE_LIBRARY = {
    "copy_f32": lambda x: torch.mul(x, 2.0),
    "copy_u32": lambda x: torch.add(x, 7),      # wrapping add on the bits
    "grid_block": lambda x: torch.add(x, 1.0),
}


def _probe_ops(name: str, x: torch.Tensor) -> int:
    """Operations of a probe on x: one an element an output, four for the
    shift probe, two a compare-exchange in the sort network."""
    n = x.numel()
    if name == "shift_u32":
        return 4 * n
    if name == "two_out_u32":
        return 2 * n
    if name == "fori_sort_net":
        rows, w = x.shape
        stages = w.bit_length() - 1
        return rows * (w // 2) * stages * (stages + 1) // 2 * 2
    return n


def phase_probes(probes) -> dict:
    """Each probe kernel against its plain version on its own input."""
    out = {}
    for name, p in probes.PROBES.items():
        x = probes.to_torch(p.make_input()).cuda()
        got = p.kernel(x)
        torch.cuda.synchronize()
        want = p.plain(x)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"probe {name} kernel differs from its plain"
                                 f" version on the card: max abs err {err}")
        ms, plain_ms = _turns(f"probe {name} {tuple(x.shape)}",
                              lambda: p.kernel(x), lambda: p.plain(x))
        lib = _PROBE_LIBRARY.get(name)
        library_ms = None
        if lib is not None:
            if not torch.equal(lib(x), want[0]):
                raise AssertionError(f"probe {name}: library call != plain")
            library_ms = _cuda_ms(lambda: lib(x))
        nbytes = x.nbytes + sum(w.nbytes for w in want)
        bound_ms, bound_by = _bound(nbytes, _probe_ops(name, x))
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
    _log("probe kernels == plain versions on the card: "
         + ", ".join(out))
    return out


# ---------------------------------------------------------------- phase 5
def _ragged(rng, N: int, L: int, k: int):
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, N).astype(np.int32)
    lengths[:4] = [0, 1, k - 1, k]
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return (torch.from_numpy(codes).cuda(),
            torch.from_numpy(lengths).cuda())


def _max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over the outputs (float64 for float
    outputs, int64 for integer ones)."""
    err = 0
    for g, w in zip(got, want):
        if w is None:
            if g is not None:
                raise AssertionError("kernel returned an output the plain "
                                     "version does not")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel output {g.dtype} {tuple(g.shape)}"
                                 f" != plain {w.dtype} {tuple(w.shape)}")
        t = torch.float64 if g.is_floating_point() else torch.int64
        err = max(err, (g.to(t) - w.to(t)).abs().max().item()
                  if g.numel() else 0)
    return err


def _cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(name: str, kern, plain) -> tuple[float, float]:
    """CUDA-event ms of kern and plain in turns plain/kernel/kernel/plain;
    returns the means (kernel, plain)."""
    p1, k1, k2, p2 = (_cuda_ms(plain), _cuda_ms(kern), _cuda_ms(kern),
                      _cuda_ms(plain))
    _log(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
         f"{p2:.4f} ms")
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernel(chop) -> dict:
    rng = np.random.default_rng(0)
    err = 0
    for k in (16, 17, 31):
        codes, lengths = _ragged(rng, 333, 157, k)
        for edges in (False, True):
            got = chop.chop(codes, lengths, k, edges)
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(
                got, chop.chop_plain(codes, lengths, k, edges)))
    # the main path's batch: 100 000 reads x 150 bases, k = 31
    N, L, k = 100_000, READ_LEN, 31
    codes = torch.from_numpy(
        rng.integers(0, 4, (N, L)).astype(np.uint8)).cuda()
    lengths = torch.full((N,), L, dtype=torch.int32, device="cuda")
    times = {}
    # bytes: codes and lengths read once, k-mers (and edge codes) written
    nbytes = {e: N * L + 4 * N + N * (L - k + 1) * (10 if e else 8)
              for e in (False, True)}
    for edges in (False, True):
        got = chop.chop(codes, lengths, k, edges)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(
            got, chop.chop_plain(codes, lengths, k, edges)))
        del got
        times[edges] = _turns(
            f"chop {N}x{L} k={k} edges={edges}",
            lambda: chop.chop(codes, lengths, k, edges),
            lambda: chop.chop_plain(codes, lengths, k, edges))
    if err != 0:
        raise AssertionError(f"chop kernel differs from chop_plain on the "
                             f"card: max abs err {err}")
    _log(f"chop kernel == chop_plain on the card (k 16/17/31, both modes, "
         f"ragged + {N}x{L}); max abs err {err}")
    bound_ms, bound_by = _bound(nbytes[True])
    return {"max_abs_err": err, "ms": times[True][0],
            "plain_ms": times[True][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ms_count_mode": times[False][0],
            "plain_ms_count_mode": times[False][1],
            "bound_ms_count_mode": _bound(nbytes[False])[0]}


# ---------------------------------------------------------------- phase 6
def _write_fastq(path: str, mate: int, reads: np.ndarray,
                 quals: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(
            b"@r%d/%d\n%s\n+\n%s\n" % (i + 1, mate, r.tobytes(), q.tobytes())
            for i, (r, q) in enumerate(zip(reads, quals))))


def make_library(workdir: str) -> tuple[str, list[str], int]:
    sys.path.insert(0, ROOT)
    from tools.simulate_reads import make_genome, simulate_pe
    genome = make_genome(GENOME_LEN, seed=42)
    r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, 400, DEPTH, seed=43,
                                 err_start=0.001, err_end=0.001)
    files = []
    for mate, (r, q) in enumerate(((r1, q1), (r2, q2)), start=1):
        files.append(os.path.join(workdir, f"ecoli_sim_{mate}.fq"))
        _write_fastq(files[-1], mate, r, q)
    lib = os.path.join(workdir, "reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in files))
    return lib, files, 2 * len(r1)


# ---------------------------------------------------------------- phase 7
def _sort_check(srt, keys: torch.Tensor, bits: int, index: bool,
                what: str) -> int:
    got = srt.sort(keys, bits, index)
    torch.cuda.synchronize()
    err = _max_abs_err(got, srt.sort_plain(keys, bits, index))
    if err != 0:
        raise AssertionError(f"radix sort differs from sort_plain on the "
                             f"card ({what}): max abs err {err}")
    return err


def phase_sort(srt, chop, files: list[str]) -> dict:
    from dbg_assembly_tpu_torch.contig import graph
    from dbg_assembly_tpu_torch.io import fastq
    gen = torch.Generator(device="cuda").manual_seed(7)

    def draw(n, bits, pool=None):
        hi = (1 << bits) - 1 if bits == 63 else 1 << bits
        if pool is None:
            return torch.randint(0, hi, (n,), generator=gen, device="cuda")
        vals = torch.randint(0, hi, (pool,), generator=gen, device="cuda")
        return vals[torch.randint(0, pool, (n,), generator=gen,
                                  device="cuda")]

    sent = torch.iinfo(torch.int64).max
    cases = [("n=0", torch.empty(0, dtype=torch.int64, device="cuda"), 35),
             ("n=1", draw(1, 34), 35), ("n=1000", draw(1000, 34), 35),
             ("all keys equal", torch.full((100_000,), 12345,
                                           dtype=torch.int64,
                                           device="cuda"), 35)]
    for k in (17, 31):
        keys = draw(200_003, 2 * k, pool=50_000)
        keys[torch.randint(0, len(keys), (20_000,), generator=gen,
                           device="cuda")] = sent
        cases.append((f"sentinel, k={k}", keys, 2 * k + 1))
    for bits in (34, 35, 62, 63):
        cases.append((f"key_bits={bits}", draw(1_000_003, bits,
                                               pool=300_000), bits))
    tile = srt.tile()
    for n in (tile - 1, tile, tile + 1, 3 * tile + 17):
        for bits in (35, 63):
            cases.append((f"n={n} at the tile of {tile}, key_bits={bits}",
                          draw(n, bits, pool=max(n // 4, 1)), bits))
    err = 0
    for what, keys, bits in cases:
        for index in (False, True):
            err = max(err, _sort_check(srt, keys, bits, index, what))
    _log(f"radix sort == sort_plain on the card: n 0/1/1000, all equal, "
         f"sentinel at k 17/31, key_bits 34/35/62/63, n = {tile} - 1, "
         f"{tile}, {tile} + 1, 3 * {tile} + 17; keys and index")

    rng = np.random.default_rng(1)
    # kmerfreq's batch: 200 000 reads of 150 bases at k = 17, keys only
    codes = torch.from_numpy(rng.integers(0, 4, (200_000, READ_LEN))
                             .astype(np.uint8)).cuda()
    lengths = torch.full((200_000,), READ_LEN, dtype=torch.int32,
                         device="cuda")
    keys = chop.chop(codes, lengths, 17)[0].reshape(-1)
    shapes = [("count", keys, 35, False)]
    # ingest's batch: 100 000 x 150 at k = 31, with index
    keys = chop.chop(codes[:100_000], lengths[:100_000], 31)[0].reshape(-1)
    shapes.append(("ingest", keys, 63, True))
    del codes, lengths
    # an 8-part merge: the uniques of the library's first 8 ingest batches
    c = np.concatenate([fastq.read_batch(f).codes for f in files])
    parts = []
    for b in range(8):
        cb = torch.from_numpy(c[b * 100_000:(b + 1) * 100_000]).cuda()
        lb = torch.full((len(cb),), cb.shape[1], dtype=torch.int32,
                        device="cuda")
        parts.append(graph._aggregate_batch(cb, lb, 31, 0)[0])
    del c
    shapes.append(("merge", torch.cat(parts), 62, True))
    del parts
    rec = {}
    for name, keys, bits, index in shapes:
        err = max(err, _sort_check(srt, keys, bits, index, name))
        what = (f"sort {name}: {keys.shape[0]} keys, key_bits {bits}, "
                f"index {index}")
        ms, plain_ms = _turns(what, lambda: srt.sort(keys, bits, index),
                              lambda: srt.sort_plain(keys, bits, index))
        library_ms = _cuda_ms(lambda: torch.sort(keys, stable=True))
        _log(f"{what}: torch.sort(keys, stable=True) {library_ms:.4f} ms")
        # bytes: the keys read once and written once, the index written
        bound_ms, bound_by = _bound(keys.shape[0] * (16 + 8 * index))
        suf = "" if name == "count" else "_" + name
        rec.update({"ms" + suf: ms, "plain_ms" + suf: plain_ms,
                    "bound_ms" + suf: bound_ms, "bound_by" + suf: bound_by,
                    "library_ms" + suf: library_ms,
                    "n" + suf: keys.shape[0]})
    rec["max_abs_err"] = err
    torch.cuda.empty_cache()
    return rec


def _fasta_lengths(path: str) -> np.ndarray:
    lens, cur = [], None
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur is not None:
                    lens.append(cur)
                cur = 0
            else:
                cur += len(line.rstrip(b"\n"))
    if cur is not None:
        lens.append(cur)
    return np.array(lens, np.int64)


def _n50(lens: np.ndarray) -> int:
    s = np.sort(lens)[::-1]
    return int(s[np.searchsorted(np.cumsum(s), s.sum() / 2)]) if len(s) else 0


def _phase_wall(name: str, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    _log(f"{name}: wall {wall:.3f} s, peak device memory {peak} B "
         f"({peak / 2**30:.3f} GiB)")
    return out


# ---------------------------------------------------------------- phase 8
def phase_slice(workdir: str, lib: str, kernels: dict) -> tuple:
    """The three stage runs through cli.main; returns (launches summed
    over the runs per kernel, exact prefix, doubling prefix)."""
    from dbg_assembly_tpu_torch import cli
    prefix = os.path.join(workdir, "asm")
    dprefix = os.path.join(workdir, "asm_doubling")
    contig = ["debruijn_contig", "-k", "31", "-i", "0.02", "-M", "125"]
    runs = [("kmerfreq -k 17 -m 1", ["kmerfreq", "-k", "17", "-m", "1"],
             None),
            ("debruijn_contig -k 31 -i 0.02 -M 125", contig + ["-o", prefix],
             "contig.log"),
            ("debruijn_contig --readout doubling -k 31 -i 0.02 -M 125",
             contig + ["--readout", "doubling", "-o", dprefix],
             "contig_doubling.log")]
    totals = dict.fromkeys(kernels, 0)
    for title, argv, logname in runs:
        argv = argv + [lib, "--device", "cuda"]
        for mod in kernels.values():
            mod.launches = 0
        with contextlib.ExitStack() as stack:
            if logname:
                logf = stack.enter_context(
                    open(os.path.join(workdir, logname), "w"))
                stack.enter_context(contextlib.redirect_stderr(logf))
            _phase_wall(title, lambda: cli.main(argv))
        counts = {name: mod.launches for name, mod in kernels.items()}
        _log(f"{title}: kernel launches {counts}")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{title} never launched the {name} "
                                     "kernel")
            totals[name] += n
    for pre in (prefix, dprefix):
        lens = _fasta_lengths(pre + ".contig.seq.fa")
        total = int(lens.sum())
        _log(f"{os.path.basename(pre)} contigs: {len(lens)}, total length "
             f"{total}, N50 {_n50(lens)} (genome {GENOME_LEN})")
        if not (len(lens) > 0 and 0.5 * GENOME_LEN <= total
                <= 1.2 * GENOME_LEN and _n50(lens) >= 500):
            raise AssertionError("contig set out of the expected range")
    return totals, prefix, dprefix


# ---------------------------------------------------------------- phase 9
def _depth_records(path: str) -> list[bytes]:
    """Depth files are >name\\n<raw bytes>\\n records (the bytes never hold
    a newline)."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        j = data.index(b"\n", i)
        e = data.index(b"\n", j + 1)
        out.append(data[j + 1:e])
        i = e + 1
    return out


def _record_multiset(prefix: str, kind: str) -> list:
    """(header after the id, sequence, depth bytes) of every record: the
    doubling readout writes each record's bytes as the exact one does;
    only the file order of length ties may differ."""
    headers, seqs = [], []
    with open(prefix + f".contig.{kind}.fa", "rb") as f:
        for line in f:
            if line.startswith(b">"):
                headers.append(line.split(b"\t", 1)[1])
            else:
                seqs.append(line.strip())
    deps = _depth_records(prefix + f".contig.{kind}.depth")
    if not len(headers) == len(seqs) == len(deps):
        raise AssertionError(f"{prefix}.contig.{kind}: ragged records")
    return sorted(zip(headers, seqs, deps))


def _n_records(path: str) -> int:
    with open(path, "rb") as f:
        return sum(line.startswith(b">") for line in f)


def _removals(log_path: str) -> dict:
    with open(log_path) as f:
        return dict(re.findall(r"remove total (\w+ (?:number|length)):"
                               r"\s*(\d+)", f.read()))


def phase_doubling_oracle(workdir: str, prefix: str, dprefix: str) -> None:
    for kind in ("seq", "small"):
        a, b = _record_multiset(prefix, kind), _record_multiset(dprefix,
                                                                kind)
        if a != b:
            raise AssertionError(f"doubling .{kind} records != exact")
    with open(prefix + ".contig.kmer.freq", "rb") as f1, \
            open(dprefix + ".contig.kmer.freq", "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("doubling .contig.kmer.freq != exact")
    ex = _removals(os.path.join(workdir, "contig.log"))
    db = _removals(os.path.join(workdir, "contig_doubling.log"))
    if len(ex) != 6 or ex != db:
        raise AssertionError(f"pruning: exact {ex} != doubling {db}")
    for suf in ("tip", "lowedge", "bubble"):
        n = [_n_records(pre + f".contig.{suf}.fa") for pre in (prefix,
                                                               dprefix)]
        if n[0] != n[1]:
            raise AssertionError(f"{suf} records: exact {n[0]} != "
                                 f"doubling {n[1]}")
    _log(f"doubling readout == exact readout: .seq/.small records "
         f"({len(_record_multiset(prefix, 'seq'))} / "
         f"{len(_record_multiset(prefix, 'small'))}), .kmer.freq bytes, "
         f"removals {ex}")


def phase_oracle(files: list[str], lib: str):
    from dbg_assembly_tpu_torch import native
    from dbg_assembly_tpu_torch.contig import pipeline
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.kmer.count import KmerCounter

    gpu = pipeline._ingest(files, 1, 31, 250, "cuda").finalize()
    nat = native.NativeIngest(31)
    pos, batch = 0, 100_000      # GraphBuilder's batches and stream layout
    for path in files:
        b = fastq.read_batch(path)
        if b.codes.shape[1] > 250 or (b.lengths < 31).any():
            raise AssertionError("oracle assumes reads of 31..250 bases")
        for off in range(0, b.n_reads, batch):
            nat.add(b.codes[off:off + batch], b.lengths[off:off + batch],
                    pos)
            pos += len(b.codes[off:off + batch]) * (b.codes.shape[1] - 30)
    kmers, lcnt, rcnt, fidx, counts, total = nat.extract_full()
    nat.close()
    for name, g, w in (("kmers", gpu.kmers, kmers), ("lcnt", gpu.lcnt, lcnt),
                       ("rcnt", gpu.rcnt, rcnt),
                       ("first_idx", gpu.first_idx, fidx),
                       ("counts", gpu.counts, counts)):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"GPU NodeTable.{name} != native ingest")
    if gpu.total_kmers != total:
        raise AssertionError(f"total_kmers {gpu.total_kmers} != {total}")
    _log(f"GPU NodeTable == native ingest: {gpu.n_nodes} nodes, "
         f"{total} k-mers, reads {gpu.total_reads}")

    counter = KmerCounter(17, device="cuda")
    nat = native.NativeIngest(17)
    for path in files:
        b = fastq.read_batch(path)
        counter.add(b.codes, b.lengths)
        nat.add(b.codes, b.lengths, 0)
    gu, gc, gt = counter.finalize()
    nu, nc, nt = nat.extract_counts()
    nat.close()
    if not (gt == nt and np.array_equal(gu, nu)
            and np.array_equal(gc, nc.astype(np.int64))):
        raise AssertionError("GPU k=17 counts != native ingest")
    with open(lib + ".kmer.freq.stat") as f:
        stat = f.read()
    if (f"#Kmer indivdual number: {nt}\n" not in stat
            or f"#Kmer species number: {len(nu)}\n" not in stat):
        raise AssertionError("kmerfreq .stat disagrees with native counts")
    _log(f"GPU k=17 counts == native ingest: {len(nu)} species, {nt} k-mers")
    return gpu


# ---------------------------------------------------------------- phase 10
def _rss() -> int:
    """Resident host memory of this process, bytes."""
    with open("/proc/self/status") as f:
        kb = re.search(r"VmRSS:\s*(\d+) kB", f.read()).group(1)
    return int(kb) * 1024


def phase_doubling_steps(table, workdir: str) -> None:
    """The doubling stage of the smoke's run, step by step on its node
    table, with chain resolution on the card against the host twins."""
    from dbg_assembly_tpu_torch import native
    from dbg_assembly_tpu_torch.contig import pointer_doubling as pd
    from dbg_assembly_tpu_torch.contig.refassemble import AssembleParams
    prefix = os.path.join(workdir, "steps")
    params = AssembleParams(ksize=31, init_hash_size=0.02,
                            contig_len_cutoff=125)
    steps = []

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps.append((name, time.perf_counter() - t))
        return out

    g = step("graph set-up", lambda: pd._Graph(table, params, "cuda"))
    step("links", g.calc_links)
    step("tips", lambda: pd.remove_tips(g, prefix + ".contig.tip.fa"))
    step("low edges", lambda: pd.remove_lowedges(
        g, prefix + ".contig.lowedge.fa"))
    step("bubbles", lambda: pd.remove_bubbles(
        g, prefix + ".contig.bubble.fa"))
    M = g.M
    alive = (~g.deleted[:M]) & g.linear[:M]

    # on the card: the program alone (3 runs), and with its copies
    dev = [torch.from_numpy(a).cuda() for a in (
        g.kmers.view(np.int64), g.l_base[:M], g.r_base[:M], alive)]
    torch.cuda.reset_peak_memory_stats()
    prog = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pd._succ_resolve(*dev, 31)
        torch.cuda.synchronize()
        prog.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    del dev
    t = time.perf_counter()
    succ, e, dist, cyc = pd.resolve_on_device(g, alive)
    t_copies = time.perf_counter() - t
    # the host twins on the same graph
    t = time.perf_counter()
    succ_n = native.succ_build(g.kmers, g.l_base[:M], g.r_base[:M],
                               alive.astype(np.uint8), 31)
    t_sb = time.perf_counter() - t
    t = time.perf_counter()
    e_n, d_n, c_n = native.resolve_chains_host(succ_n)
    t_rc = time.perf_counter() - t
    ok = ~c_n
    if not (np.array_equal(succ, succ_n) and np.array_equal(cyc, c_n)
            and np.array_equal(e[ok], e_n[ok])
            and np.array_equal(dist[ok], d_n[ok])):
        raise AssertionError("device chain resolution != native twins")
    _log(f"chain resolution over {2 * M} states ({int(alive.sum())} alive "
         f"nodes, {int(cyc.sum())} cyclic states): card _succ_resolve "
         f"{', '.join(f'{x:.4f}' for x in prog)} s (peak device memory "
         f"{peak} B), with its copies {t_copies:.4f} s; native succ_build "
         f"{t_sb:.4f} s + resolve_chains_host {t_rc:.4f} s = "
         f"{t_sb + t_rc:.4f} s; outputs equal")

    n = len(succ)
    rss = _rss()
    heads, fb = native.collect_heads(alive.astype(np.uint8), succ,
                                     cyc.astype(np.uint8))
    _log(f"collect_heads over {n} states: scratch allocated "
         f"{8 * n + 8 * (n // 2 + 1)} B, filled {8 * (len(heads) + len(fb))}"
         f" B ({len(heads)} heads, {len(fb)} fallback nodes), resident "
         f"growth {_rss() - rss} B")
    del heads, fb

    step("readout", lambda: pd.read_out_contigs(g, prefix))
    _log("doubling stage by step (s): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in steps)
        + f"; total {sum(sec for _, sec in steps):.3f}")


def _timed(fn, *args) -> float:
    t = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from dbg_assembly_tpu_torch import native
        from dbg_assembly_tpu_torch.ops import build, chop, probes
        from dbg_assembly_tpu_torch.ops import sort as srt
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    smi = _smi()
    _log(smi)
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    # one nvcc per kernel source and make for native/, all at once
    sources = ["chop", "radix_sort", *("probe_" + n for n in probes.PROBES)]
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as ex:
        jobs = {f"{src}.cu (nvcc)": ex.submit(_timed, build.build, src)
                for src in sources}
        jobs["native/ (make)"] = ex.submit(_timed, native.build)
        _log("build: " + ", ".join(f"{name} {fut.result():.2f} s"
                                   for name, fut in jobs.items()))
    for src in sources:
        _log(f"ptxas, {src}.cu: " + " | ".join(build.resources(src)))

    probe_launches = phase_triage()
    probe_recs = phase_probes(probes)
    kern = phase_kernel(chop)

    with tempfile.TemporaryDirectory() as workdir:
        t = time.perf_counter()
        lib, files, n_reads = make_library(workdir)
        _log(f"library: {n_reads} reads of {READ_LEN} bp, genome "
             f"{GENOME_LEN}, {DEPTH}x, {time.perf_counter() - t:.1f} s")
        sort_rec = phase_sort(srt, chop, files)
        launches, prefix, dprefix = phase_slice(
            workdir, lib, {"chop": chop, "radix_sort": srt})
        phase_doubling_oracle(workdir, prefix, dprefix)
        table = phase_oracle(files, lib)
        phase_doubling_steps(table, workdir)

    records = [
        {"name": "chop", "route": "cuda",
         "source": "dbg_assembly_tpu_torch/ops/csrc/chop.cu",
         "replaces": "dbg_assembly_tpu/ops/pallas_chop.py:81",
         "launches": launches["chop"], **kern},
        {"name": "radix_sort", "route": "cuda",
         "source": "dbg_assembly_tpu_torch/ops/csrc/radix_sort.cu",
         "replaces": "dbg_assembly_tpu/ops/pallas_sort.py:236",
         "launches": launches["radix_sort"], **sort_rec}]
    for name, p in probes.PROBES.items():
        records.append({
            "name": f"probe_{name}", "route": "cuda",
            "source": f"dbg_assembly_tpu_torch/ops/csrc/probe_{name}.cu",
            "replaces": p.replaces, "launches": probe_launches[name],
            **probe_recs[name]})
    for rec in records:
        if rec["launches"] <= 0 or rec["max_abs_err"] != 0:
            raise AssertionError(f"kernel {rec['name']}: launches "
                                 f"{rec['launches']}, max abs err "
                                 f"{rec['max_abs_err']}")
    _log(smi)
    _log(json.dumps({"kernels": records}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
