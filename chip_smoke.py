#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbg_assembly_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # and each stage once more, profiled

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA card must be present; prints the nvidia-smi name and
     power limit and the CUDA version;
  2. build: the chop kernel (ops/csrc/chop.cu), the radix sort
     (ops/csrc/radix_sort.cu), the rc expand (ops/csrc/rc_expand.cu) and
     the seven triage probes
     (ops/csrc/probe_*.cu), one nvcc each, and native/ (make), all started
     together; prints ptxas's registers, shared memory and spills per
     kernel;
  3. the triage entry point on the card (tools/triage.py): every probe
     kernel and the chop, each in its own process, must equal its plain
     version and the JAX triage's numpy expectation exactly; each process
     starts with its counts at 0 and reports its launches;
  4. probes vs plain on the card: each probe kernel against its plain
     version on the probe's own input, exact, then, after a warm-up, timed
     with CUDA events in turns plain / kernel / kernel / plain / yardstick
     (the one PyTorch call that computes it, where there is one, else the
     fewest calls that compute its outputs exactly on the int32 bits:
     two_out_u32, shift_u32, bitonic_stage and fori_sort_net; the record
     names its form), 1000 calls a run, and by the profiler's kernel time
     and the host time a call; the launch path's host steps one by one
     for copy_f32, copy_u32 and two_out_u32; the seven redesigned probes
     (copy_f32, grid_block, copy_u32, two_out_u32, shift_u32,
     bitonic_stage, fori_sort_net) also exact, every output, at shapes
     that take their scalar paths (and, for fori_sort_net, every row
     width from 2 to 1024, rows not a multiple of a block's) and, with the
     yardstick, at a shape where bytes decide (256 MiB in, 256 MiB out a
     result), the integer ones on int32 bits over the whole range with
     the values at which their arithmetic wraps, the top bits set (an
     arithmetic >> would show), for bitonic_stage pairs across the sign
     bit at one offset in both halves (a signed min would show) and, for
     fori_sort_net, rows drawn from the four values around the sign bit,
     one row all equal, one sorted and one reversed; timed there against
     their bytes bound;
  5. kernel vs plain on the card: chop against chop_plain on the same CUDA
     tensors, both modes, exact equality, at the shapes its tiling makes
     hard (k 1/16/17/31; one row; N not a multiple of a tile's rows; L 150,
     250 and 157 (odd P); rows of 5003 and 30011 codes (spans not a
     multiple of 16 bytes, segment tiles); codes at an odd address; reads
     shorter than k; reads longer than L; ragged reads at the main path's
     size), then timed with CUDA events in turns plain/kernel/kernel/plain,
     once with torch.profiler (the kernel's own device time) and by the
     host time a call takes to return, at the main path's shapes:
     kmerfreq's batch (200 000 x 150, k = 17, counting), ingest's
     (100 000 x 150, k = 31, edges) and the latter counted; then the rc
     expand against rc_expand_plain and the numpy expand_bitmap_rc,
     exact, at k 3 (its scalar path), 9 and 13 (4 bytes past alignment
     too, every bit set), and on a k = 17 table of about 6 M random
     canonical k-mers, where it is timed (CUDA events, the table restored
     before each launch; the profiler's kernel time) beside its bound,
     the plain twin and the host expand;
  6. the slice at E. coli scale: a 4.6 Mb simulated genome, 150 bp pairs at
     40x, written as two FASTQ files;
  7. sort vs plain on the card: the radix sort against sort_plain on the
     same CUDA tensors, keys and index exactly equal: n = 0, 1, 1000, all
     keys equal, keys with the sentinel, key_bits 34/35/62/63, n at the
     kernel's tile boundaries, and the main path's shapes, timed with CUDA
     events in turns plain/kernel/kernel/plain beside torch.sort(keys,
     stable=True), and the host time a call: kmerfreq's batch
     (200 000 x 134 windows at k = 17, keys only), ingest's batch
     (100 000 x 120 at k = 31, with index) and an 8-part merge of the
     library's first 8 ingest batches (with index);
  8. the three stage runs through cli.main: ``kmerfreq -k 17 -m 1``,
     ``debruijn_contig -k 31 -i 0.02 -M 125`` and the same with
     ``--readout doubling``; each kernel's launch count is set to 0 just
     before each run and read just after, and must be > 0 for both kernels
     in every run; wall time and peak device memory per run; with
     ``--profile``, each run once more under torch.profiler (device busy
     time, idle share, the chop's and the sort's device time);
  9. oracles: the doubling run's .seq and .small record multisets,
     .contig.kmer.freq bytes and tip/lowedge/bubble removal counts equal the
     exact run's; the GPU node table at k = 31 and the GPU k = 17 counts
     equal the shared native C++ ingest on the same files;
  10. the doubling stage step by step on that node table (graph set-up,
     links, tips, low edges, bubbles, readout), with the chain resolution
     timed on the card (_succ_resolve) against the native host twins
     (succ_build + resolve_chains_host), their outputs compared, and the
     host memory of collect_heads' scratch;
  11. (run right after phase 8) correction: ``correct_error_reads -k 17
     -j 1`` on the library with phase 8's table, the torch engine on the
     card, through cli.main: wall, peak device memory, reads a second,
     chunks, waves, beam calls, trips, host reads and the reads re-run on
     the host engine (fallback; the phase fails at a share >= 5 %); the
     same files through ``--engine native`` (the shared C++ engine) must
     give the same .correct.fa.gz (decompressed), .correct.stat,
     .pair.fa.gz, .single.fa.gz and .pair.single.stat bytes.  Then the
     same for a harder library (25 000 pairs at 1 % errors, no share
     limit).  With ``--profile``, the run once more under torch.profiler
     and the device engine alone at several chunk widths.
  12. (run after phase 11) cleaning: phase 6's library copied and soiled
     (``tools/soil.py``: the mate's default adapter over a suffix in 10 % of reads,
     a Phred 2 tail in 10 %, an N in 0.5 %); ``clean_lowqual -e 0.01 -r
     75``, then ``clean_adapter -r 75`` on its output, both files on the
     card through cli.main (at -e 0.001 every read of this library, whose
     qualities are Phred 30 +- 3 with a mean error of 0.0013, is cut below
     75 bases, and clean_adapter's .stat then divides by zero bases, as
     the JAX package's does): wall, reads a second, peak device memory, the
     host loop's steps, reads trimmed and dropped.  Oracle: the first
     40 000 reads of each file through both stages with ``--device cpu``
     and on the card, the decompressed .gz and the .stat bytes equal; and
     torch.argmax on the card returns the first of tied maxima, as the
     adapter DP needs;
  13. mapping and scaffolding: ``map_pair -k 31 -s 5 -l 125 -r 100 -i 0.97``
     of phase 6's files against phase 8's exact ``.contig.seq.fa``, then
     ``link_scaffold -i 400 -n 3`` on its .2ctg file, with ``--engine
     torch`` on the card and with ``--engine native`` (the shared C++
     mapper): every map file (decompressed), the .map_pair.stat and every
     scaffold file equal; the radix sort's launches > 0 in the torch run;
     wall per command, peak device memory, pairs a second, the mapped
     share, scaffold count and N50.  Then the index of those contigs built
     on the card and on the CPU (``sort_plain``): its k-mers, contigs,
     positions, strands and uniqueness exactly equal; and the radix sort
     at the index's shape (its canonical keys, 62 bits, with the index)
     equal to ``sort_plain`` and timed beside it and ``torch.sort``, as in
     phase 7.  ``--profile`` runs the three commands of phases 12 and 13
     once more under torch.profiler, and then step by step (parse, device
     work, whole stage);
  14. long reads: 700 bp single reads of phase 6's genome (1500 bp
     fragments, 8x, 0.1-0.4 % errors); ``map_reads -k 31 -s 5 -l 125 -r 250
     -i 0.97`` against phase 8's exact contigs with ``--engine torch`` on
     the card and with ``--engine native``: every file equal (the .gz
     decompressed), the radix sort's launches > 0 in the torch run; then
     ``link_contig -n 3`` and ``link_supertig -n 3`` on the torch run's
     .2ctg list; wall per command, reads a second, peak device memory, the
     .stat's four shares, the scafftig and supertig counts and N50;
  15. the whole workflow: (a) workflow.run_full on phase 12's soiled pair
     (insert 400) on the card with PipelineConfig(map_min_read=100) (the
     default 250 maps no 150 bp read): the whole wall and each stage's
     (clean, kmerfreq, correct, contig, map, scaffold) wall, share and peak
     device memory, the contig and scaffold counts and N50s; its 01.clean
     files equal phase 12's card outputs, and the chop and the sort launch
     (their counts join the JSON record as launches_pipeline); (b) on a
     small library (200 kb, 150 bp, 20x, inserts 400 and 800, seed 7) the
     ``pipeline -k 13 -p recipe.para`` command, and run_full at k 13 with
     map_min_read 100, each on the card and with ``--device cpu``: every
     file under the two work dirs equal.  ``--profile`` adds (a) once more
     under torch.profiler and its kmerfreq step by step.
  16. the mesh (after phase 10): D = 4 shard slots on the machine's cards
     (parallel/mesh.data_mesh; on one card all four share it), the layout
     printed, each run against the single-device run an earlier phase
     made: (a) ``debruijn_contig -k 31 -i 0.02 -M 125 --mesh 4`` == phase
     8's ``--readout doubling`` files and run log, and its node table
     (GraphBuilder(mesh)) == phase 9's; (b) ``correct_error_reads -k 17 -j
     1 --mesh 4`` (the 2 GiB table as four slots) == phase 11's torch
     engine outputs, with the fallback share; (c) ``map_pair ... --mesh
     4`` == phase 13's torch engine files; (d) count_halo_sharded of the
     genome as one sequence (k 31, 4 tiles) == its single-device count;
     (e) phase 15 (b)'s 200 kb workflow (run_full, ``--readout
     doubling``) with mesh_devices=4 == mesh_devices=0 on the card, every
     file.  Each run prints its wall, peak device memory, the chop's and
     the sort's launches (> 0 where the path runs them: both in (a), (d)
     and (e), the sort in (c)) and the bytes the collectives moved
     between slots; ``--profile`` adds (a) under torch.profiler, with the
     device-to-device copies and concatenations of the exchange.  Then
     the chop and the radix sort at the shapes the 4-slot ingest gives
     them (one slot's quarter of an ingest batch, its owner bucketing on
     3 bits, one owner's arrivals), each == its plain version and timed.
  17. multi-process ingest and the last counting and contig-stage
     functions (run after phase 16): (a) tools/launch_distributed.py over
     nccl, one process of 4 slots on the card, on phase 6's pair (-k 31
     --max-read-len 150 --batch-reads 100000), and (b) over gloo, two
     processes of 2 slots on the one card (device tensors staged through
     host memory): each rank's wall, peak device memory, launches
     (the chop's and the sort's > 0 on every rank), capacity doublings and
     bytes moved within and across ranks; the union of the .npz shards ==
     phase 9's node table (kmers, lcnt and rcnt, saturated as its) and
     .dist.json's total_kmers == its; (c) count_spectrum_fast on 250 000
     reads x 150 of phase 6's library, k 31, max_freq 255 (the JAX
     benchmark's batch): card == CPU == the capped histogram of
     count_unique_fast's counts, with the last run in bin 255 where the
     batch has no invalid window; CUDA-event ms of the call and of the
     stats tail, k-mers a second; (d) contig_stage_step on phase 9's table
     at cut 2: card == CPU, all six outputs, with its wall.
  18. the host twins of the JAX package (after 17), each against a run an
     earlier phase made: (a) kmerfreq.run(table_format="8bit") and the
     1-bit run at k 15 on the card (the 8-bit table is 1 GiB of host
     memory): the 8-bit table's > 1 bits packed == the 1-bit .cz, its
     nonzero bytes == min(count, 255) of a KmerCounter(15) on the card;
     then the 8-bit tables of phase 11's 25 000-pair library at k 15 and
     at k 8 (where some k-mers count over 255) on the card == with
     --device cpu, byte for byte, and ``correct_error -k 15 -l 1`` (the
     cutoff fits the library's 1.6x depth) on the card's table == on the
     CPU's, every file, with reads kept and bases corrected (wall,
     .cor.stat numbers); (b) ``DBG_PY_ASSEMBLE=1 debruijn_contig -k 31 -i
     0.02 -M 125`` (ingest on the card, the Python walks on the host):
     every file and the run log == phase 8's exact run; the readout's wall
     beside the native readout's on phase 9's table; (c) ``DBG_PY_MAP=1
     map_pair`` with phase 13's flags on the first 25 000 pairs of phase
     6's files (all of them take about 240 s on the host) == the torch
     engine on the card on the same pairs, every file; (d)
     ``DBG_PY_FASTQ=1`` read_batch == the native parser on phase 6's two
     files, every array, with both walls.  Each run prints its wall, the
     peak host memory (VmRSS sampled every 20 ms while it runs, and
     getrusage's lifetime peak) and the chop's and the sort's launches
     (> 0 in (a)'s card runs and (b)).
  19. the driver hooks and the distributed-path tools (run last): (a)
     graft_entry.entry()'s step (count_unique_fast, [256, 150], k 31) on
     the card == with device="cpu", every output exactly, timed with CUDA
     events (20 calls after a warm-up) and by the host ms a call; (b)
     graft_entry.dryrun_multichip(4) (correction, ingest, the mesh contig
     stage, the sharded map_pair == the single-device one, scaffolding),
     its wall; (c) tools/verify_comm_volume.py at its shape (1024 x 150,
     k 31, 8 slots): both ingest steps' bytes between slots equal the kept
     records of the segments that leave their slot, and every byte count,
     dropped and doubling on the card == the CPU's; (d)
     tools/measure_scaling.py at 65 536 reads over 1, 2, 4 and 8 slots on
     the card, both steps timed, its table printed, the exact step's node
     tables equal at every slot count.  Each part prints its wall, peak
     device memory, the chop's and the sort's launches (> 0 in each; the
     record's launches_hooks) and the bytes the collectives moved.
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
import itertools
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
_SIGN = -2 ** 31    # the int32 sign bit: x ^ _SIGN orders int32 as uint32


def _bitonic_flip(x):
    """min of x's halves into the top half, max into the bottom, unsigned:
    the sign bit flipped around a signed minimum / maximum."""
    y, out = x ^ _SIGN, torch.empty_like(x)
    h = x.shape[0] // 2
    torch.minimum(y[:h], y[h:], out=out[:h])
    torch.maximum(y[:h], y[h:], out=out[h:])
    return (out.bitwise_xor_(_SIGN),)


# Where no single call computes a probe: the fewest PyTorch calls that
# compute its outputs exactly on the int32 bits, timed beside it (pair_ms,
# not in the library column), name -> (form, fn); the record names the
# form (pair_form).  torch 2.11 refuses <<, minimum and maximum on a
# uint32 view on the card, so the unsigned reading is made on int32 bits
# (PERF.md section 6).
_PROBE_PAIR = {
    "two_out_u32": ("torch.add, torch.mul",
                    lambda x: (torch.add(x, 1), torch.mul(x, 3))),
    "shift_u32": ("int32: <<, >>, &, |, ^",
                  lambda x: (((x << 2) | ((x >> 30) & 3)) ^ x,)),
    "bitonic_stage": ("sign flip: ^, minimum, maximum, ^", _bitonic_flip),
    "fori_sort_net": ("sign flip: ^, sort, ^", lambda x: (
        torch.sort(x ^ _SIGN, dim=1).values.bitwise_xor_(_SIGN),)),
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


# the redesigned probes at a shape where bytes decide (256 MiB in, 256 MiB
# out a result), and inputs that take their scalar paths: a length not a
# multiple of 4, columns not a multiple of 4, bitonic_stage's half not a
# multiple of 4, a pointer 4 bytes past 16-byte alignment
PROBE_LARGE_SHAPES = {"copy_f32": (524_288, 128), "grid_block": (262_144, 256),
                      "copy_u32": (524_288, 128),
                      "two_out_u32": (524_288, 128),
                      "shift_u32": (524_288, 128),
                      "bitonic_stage": (524_288, 128),
                      "fori_sort_net": (524_288, 128)}
_EDGES_1D = ((3, 5), (1, 1), (8, 128), (1000, 1001))
PROBE_EDGE_SHAPES = {"copy_f32": _EDGES_1D,
                     "grid_block": ((16, 130), (8, 1), (64, 256),
                                    (8, 1024)),
                     "copy_u32": _EDGES_1D, "two_out_u32": _EDGES_1D,
                     "shift_u32": _EDGES_1D,
                     # even row counts: halves of 3, 15 and 499 499
                     # elements take the scalar path even when aligned;
                     # the probe's own shape and (1000, 1001), whose
                     # halves are multiples of 4, the vector path
                     "bitonic_stage": ((2, 3), (6, 5), (998, 1001),
                                       (16, 128), (1000, 1001)),
                     # every row width; w = 2 takes the scalar path even
                     # when aligned, (13, 128) ends inside a block, and
                     # 1024 spans warps (its stages through shared memory)
                     "fori_sort_net": ((1, 2), (3, 4), (5, 8), (7, 16),
                                       (3, 32), (9, 64), (8, 128),
                                       (13, 128), (5, 256), (3, 512),
                                       (256, 1024))}
# uint32 inputs at which the integer probes' arithmetic wraps at 2^32:
# x + 7 from 0xFFFFFFF9, x + 1 at 0xFFFFFFFF, x * 3 from 0x55555556; and
# with the top bits set, where x << 2 drops them and an arithmetic x >> 30
# would bring in ones: 0x80000000, 0xC0000000, 0xFFFFFFFF
PROBE_WRAP_VALUES = (*range(0xFFFFFFF9, 0x1_0000_0000), 0x55555555,
                     0x55555556, 0x80000000, 0xAAAAAAAA, 0xAAAAAAAB,
                     0xC0000000)
# (top, bottom) uint32 pairs across the sign bit, put at one offset in both
# halves of bitonic_stage's input: a signed min or max would swap them
PROBE_STRADDLE = ((0x7FFFFFFF, 0x80000000), (0, 0xFFFFFFFF),
                  (0x80000000, 0x7FFFFFFF), (0xFFFFFFFF, 0))
# uint32 values around the sign bit, from which some of fori_sort_net's
# rows are drawn: duplicates, and pairs across the sign bit in one row,
# where a signed compare would show
PROBE_SIGN_VALUES = (0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001)
PROBE_ITERS = 1000     # calls a timed run: steady at a few µs a call
LARGE_ITERS = 200      # at the large shapes, 36-54 ms a run
SORT_LARGE_ITERS = 50  # fori_sort_net's: its plain int64 sort, 9.4 ms a call


def _int32_bits(values) -> torch.Tensor:
    v = torch.tensor(values, dtype=torch.int64)
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32).cuda()


def _probe_draw(dtype: torch.dtype, n: int, g: torch.Generator,
                half: int = 0):
    """n inputs on the card from generator g: float32 normals, or int32
    bits over the whole uint32 range with PROBE_WRAP_VALUES at both ends
    (as many as fit) and, with ``half``, the PROBE_STRADDLE pairs at
    1..k and half + 1..half + k (k as many as fit below 2 * half: the same
    offset in both halves of x[:2 * half] and of x[1:])."""
    if dtype == torch.float32:
        return torch.randn(n, device="cuda", generator=g)
    x = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                      device="cuda", generator=g)
    wrap = _int32_bits(PROBE_WRAP_VALUES)[:n]
    x[:len(wrap)] = wrap
    x[n - len(wrap):] = wrap
    k = min(len(PROBE_STRADDLE), half - 1)
    if k > 0:
        top, bottom = zip(*PROBE_STRADDLE[:k])
        x[1:1 + k] = _int32_bits(top)
        x[half + 1:half + 1 + k] = _int32_bits(bottom)
    return x


def _hard_rows(x: torch.Tensor, g: torch.Generator) -> None:
    """Rows of x (2-D int32 bits on the card) that a sort finds hard, in
    place, between the first and the last row (which keep the wrap
    values): row 1 and every fourth row after it drawn from
    PROBE_SIGN_VALUES, row 2 all 0x80000000, row 3 sorted as uint32 and
    row 4 reversed, as many as fit."""
    rows, w = x.shape
    r = torch.arange(1, max(rows - 1, 1), 4, device="cuda")
    x[r] = _int32_bits(PROBE_SIGN_VALUES)[torch.randint(
        0, 4, (len(r), w), device="cuda", generator=g)]
    if rows > 3:
        x[2] = _SIGN
    if rows > 4:
        x[3] = torch.sort(x[3] ^ _SIGN).values ^ _SIGN
    if rows > 5:
        x[4] = torch.sort(x[4] ^ _SIGN, descending=True).values ^ _SIGN


def _steady_turns(fns: dict, iters: int = PROBE_ITERS,
                  order=("plain", "kernel", "kernel", "plain",
                         "library")) -> dict:
    """CUDA-event ms a call of each of fns' entries (None to skip), each
    warmed up by ``iters`` calls, then timed in turns of ``order``,
    ``iters`` calls a run; returns name -> the runs' means."""
    for fn in fns.values():
        if fn is not None:
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    runs = {}
    for name in order:
        if fns.get(name) is not None:
            runs.setdefault(name, []).append(_cuda_ms(fns[name], iters))
    return runs


def _host_split(probes, name: str, x: torch.Tensor) -> dict:
    """Host µs a call of each step of probe ``name``'s launch path on its
    input (iters calls each, the card idle at the start of each), beside
    the whole wrapper and the PyTorch calls that compute the same."""
    fn = probes._entry(name)
    outs = [torch.empty_like(x) for _ in range(1 + (name == "two_out_u32"))]
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    steps = {"wrapper": lambda: probes.PROBES[name].kernel(x),
             "checks": lambda: probes._on_card(x, x.dtype),
             "empty_like": lambda: torch.empty_like(x)}
    if len(outs) == 2:
        steps["empty_like x2"] = lambda: (torch.empty_like(x),
                                          torch.empty_like(x))
    steps["current_device"] = torch.cuda.current_device
    steps["raw stream"] = lambda: torch._C._cuda_getCurrentRawStream(dev)
    steps[f"data_ptr x{1 + len(outs)}"] = lambda: (
        x.data_ptr(), *[o.data_ptr() for o in outs])
    steps["ctypes launch"] = lambda: fn(
        x.data_ptr(), *[o.data_ptr() for o in outs], x.numel(), stream)
    if name in _PROBE_LIBRARY:
        steps["torch.mul" if name == "copy_f32" else "torch.add"] = (
            lambda: _PROBE_LIBRARY[name](x))
    if name in _PROBE_PAIR:
        steps["torch.add"] = lambda: torch.add(x, 1)
        steps["torch.mul"] = lambda: torch.mul(x, 3)
        steps["add + mul pair"] = lambda: _PROBE_PAIR[name][1](x)
    return {k: _host_ms(f, PROBE_ITERS) * 1e3 for k, f in steps.items()}


def _straddle_half(name: str, n: int) -> int:
    """The half at which _probe_draw puts PROBE_STRADDLE for probe
    ``name``'s input of n elements (0: none)."""
    return n // 2 if name == "bitonic_stage" else 0


def _probe_edges(probes, name: str) -> None:
    """The kernel == its plain version, every output exactly, at
    PROBE_EDGE_SHAPES, contiguous and 4 bytes past alignment (the scalar
    paths)."""
    p = probes.PROBES[name]
    dtype = probes.to_torch(p.make_input()).dtype
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape in PROBE_EDGE_SHAPES[name]:
        n = shape[0] * shape[1]
        buf = _probe_draw(dtype, n + 1, g, _straddle_half(name, n))
        for x in (buf[:n].view(shape), buf[1:].view(shape)):
            if name == "fori_sort_net":
                _hard_rows(x, g)
            got = p.kernel(x)
            torch.cuda.synchronize()
            err = _max_abs_err(got, p.plain(x))
            if err != 0:
                raise AssertionError(f"probe {name} {shape} at offset "
                                     f"{x.storage_offset()}: kernel != plain"
                                     f", max abs err {err}")


def _probe_large(probes, name: str) -> dict:
    """The kernel at PROBE_LARGE_SHAPES[name] == its plain version and
    torch's call (or the yardstick's calls, _PROBE_PAIR), every output
    exactly; timed in turns beside both."""
    p = probes.PROBES[name]
    shape = PROBE_LARGE_SHAPES[name]
    dtype = probes.to_torch(p.make_input()).dtype
    g = torch.Generator(device="cuda").manual_seed(4)
    n = shape[0] * shape[1]
    x = _probe_draw(dtype, n, g, _straddle_half(name, n)).view(shape)
    if name == "fori_sort_net":
        _hard_rows(x, g)
    lib = _PROBE_LIBRARY.get(name)
    pair = _PROBE_PAIR.get(name, (None, None))[1]
    want = p.plain(x)
    fns = {"plain": lambda: p.plain(x), "kernel": lambda: p.kernel(x),
           "library": lib and (lambda: lib(x)),
           "pair": pair and (lambda: pair(x))}
    err = 0
    for what in ("kernel", "library", "pair"):
        if fns[what] is not None:
            got = fns[what]()
            torch.cuda.synchronize()
            e = _max_abs_err(got if isinstance(got, tuple) else (got,),
                             want)
            if e != 0:
                raise AssertionError(f"probe {name} {shape}: {what} != "
                                     f"plain, max abs err {e}")
            err = max(err, e)
    n_out = len(want)
    del got, want
    runs = _steady_turns(fns, SORT_LARGE_ITERS if name == "fori_sort_net"
                         else LARGE_ITERS,
                         ("plain", "kernel", "kernel", "plain", "library",
                          "pair"))
    bound_ms, bound_by = _bound((1 + n_out) * x.nbytes, _probe_ops(name, x))
    ms = sum(runs["kernel"]) / 2
    rec = {"shape_large": list(shape), "max_abs_err_large": err,
           "ms_large": ms, "ms_large_runs": runs["kernel"],
           "plain_ms_large": sum(runs["plain"]) / 2,
           "library_ms_large": runs["library"][0] if lib else None,
           "bound_ms_large": bound_ms, "bound_by_large": bound_by,
           "share_large": bound_ms / ms}
    if pair:
        rec["pair_ms_large"] = runs["pair"][0]
    _log(f"probe {name} {shape}: kernel {runs['kernel'][0]:.4f} / "
         f"{runs['kernel'][1]:.4f} ms, plain {runs['plain'][0]:.4f} / "
         f"{runs['plain'][1]:.4f} ms, library {rec['library_ms_large']}, "
         f"pair {rec.get('pair_ms_large')}; bound {bound_ms:.4f} ms "
         f"({bound_by}), share {rec['share_large']:.3f}")
    return rec


def phase_probes(probes) -> dict:
    """Each probe kernel against its plain version on its own input, then
    timed in turns beside it and its yardstick (the one PyTorch call that
    computes it, or the fewest calls, _PROBE_PAIR): the CUDA-event ms a
    call, the profiler's kernel time and the host time a call, and the
    launch path's host steps; the seven redesigned also at their edge and
    large shapes."""
    inputs = {name: probes.to_torch(p.make_input()).cuda()
              for name, p in probes.PROBES.items()}
    device_ms = _profiled_each(
        {f"{name}_kernel": (lambda p=p, x=x: p.kernel(x)) for (name, p), x
         in zip(probes.PROBES.items(), inputs.values())}, 100)
    out = {}
    for name, p in probes.PROBES.items():
        x = inputs[name]
        got = p.kernel(x)
        torch.cuda.synchronize()
        want = p.plain(x)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"probe {name} kernel differs from its plain"
                                 f" version on the card: max abs err {err}")
        lib = _PROBE_LIBRARY.get(name)
        if lib is not None and not torch.equal(lib(x), want[0]):
            raise AssertionError(f"probe {name}: library call != plain")
        form, pair = _PROBE_PAIR.get(name, (None, None))
        if pair is not None and _max_abs_err(pair(x), want) != 0:
            raise AssertionError(f"probe {name}: yardstick != plain")
        other = lib or pair
        runs = _steady_turns({"plain": lambda: p.plain(x),
                              "kernel": lambda: p.kernel(x),
                              "library": other and (lambda: other(x))})
        nbytes = x.nbytes + sum(w.nbytes for w in want)
        bound_ms, bound_by = _bound(nbytes, _probe_ops(name, x))
        rec = {"max_abs_err": err, "ms": sum(runs["kernel"]) / 2,
               "ms_runs": runs["kernel"],
               "plain_ms": sum(runs["plain"]) / 2,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": runs["library"][0] if lib else None,
               "device_ms": device_ms[f"{name}_kernel"],
               "host_ms": _host_ms(lambda: p.kernel(x), PROBE_ITERS),
               "library_host_ms": (_host_ms(lambda: lib(x), PROBE_ITERS)
                                   if lib else None)}
        if pair:
            rec["pair_form"] = form
            rec["pair_ms"] = runs["library"][0]
            rec["pair_host_ms"] = _host_ms(lambda: pair(x), PROBE_ITERS)
        _log(f"probe {name} {tuple(x.shape)} ({PROBE_ITERS} calls a run): "
             f"kernel {runs['kernel'][0]:.4f} / {runs['kernel'][1]:.4f} ms, "
             f"plain {runs['plain'][0]:.4f} / {runs['plain'][1]:.4f} ms, "
             f"library {rec['library_ms']}, pair {rec.get('pair_form')} "
             f"{rec.get('pair_ms')}; "
             f"profiler kernel {rec['device_ms']} ms; host "
             f"{rec['host_ms']:.4f} ms a call (library "
             f"{rec['library_host_ms']}, pair {rec.get('pair_host_ms')})")
        if name in PROBE_LARGE_SHAPES:
            _probe_edges(probes, name)
            rec.update(_probe_large(probes, name))
        if name in ("copy_f32", "copy_u32", "two_out_u32"):
            rec["host_split_us"] = _host_split(probes, name, x)
            _log(f"probe {name} launch path, host µs a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in rec["host_split_us"].items()))
        out[name] = rec
    torch.cuda.empty_cache()
    _log("probe kernels == plain versions on the card: "
         + ", ".join(out) + "; " + ", ".join(PROBE_EDGE_SHAPES)
         + " also at their edge shapes (contiguous and 4 bytes past "
         "alignment) and their large shapes, integer ones with the values "
         "that wrap, the top bits and pairs across the sign bit, "
         "fori_sort_net with rows hard for a sort")
    return out


# ---------------------------------------------------------------- phase 5
def _reads(rng, N: int, L: int, k: int, offset: int = 0, full: bool = False,
           lengths=None):
    """An [N, L] batch on the card: ragged reads (some empty, some of k - 1
    or k bases) or, with ``full``, reads of L bases; pad 4 past a read.
    ``offset`` puts the codes that many bytes past a 16-aligned address."""
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    if lengths is None:
        lengths = (np.full(N, L) if full else rng.integers(0, L + 1, N))
        if not full and N >= 8:
            lengths[:4] = [0, 1, k - 1, k]
    lengths = np.asarray(lengths, np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    buf = torch.zeros(codes.size + offset, dtype=torch.uint8, device="cuda")
    dev = buf[offset:].view(N, L)
    dev.copy_(torch.from_numpy(codes))
    return dev, torch.from_numpy(lengths).cuda()


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


def _host_ms(fn, iters: int = 20) -> float:
    """Host time (ms) a call takes to return, the card idle at the start."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return host


def _turns(name: str, kern, plain) -> tuple[float, float]:
    """CUDA-event ms of kern and plain in turns plain/kernel/kernel/plain;
    returns the means (kernel, plain)."""
    p1, k1, k2, p2 = (_cuda_ms(plain), _cuda_ms(kern), _cuda_ms(kern),
                      _cuda_ms(plain))
    _log(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
         f"{p2:.4f} ms")
    return (k1 + k2) / 2, (p1 + p2) / 2


def _profiled_ms(fn, pattern: str, iters: int = 10):
    """Mean device time (ms) of the kernels whose name holds ``pattern``,
    from one torch.profiler run of ``iters`` calls; None when the profiler
    shows no such kernel."""
    return _profiled_each({pattern: fn}, iters)[pattern]


def _profiled_each(fns: dict, iters: int) -> dict:
    """_profiled_ms of each pattern -> fn of ``fns``, from one
    torch.profiler run of ``iters`` calls of each (a profiler run costs
    seconds to start)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    out = {}
    for pattern in fns:
        evs = [e for e in prof.key_averages() if pattern in e.key]
        n = sum(e.count for e in evs)
        us = sum(e.self_device_time_total for e in evs)
        out[pattern] = us / n / 1e3 if n and us else None
    return out


def phase_kernel(chop) -> dict:
    """The chop kernel against chop_plain on the same CUDA tensors, both
    modes, exact, at the shapes its tiling makes hard and at the main
    path's; timed in turns at the main path's three shapes."""
    rng = np.random.default_rng(0)
    lib = chop._lib()
    cases = []
    for k in (1, 16, 17, 31):
        for N, L in ((1, 150), (333, 150), (301, 250), (97, 157), (5, 5003),
                     (3, 30011)):
            # long rows (segment tiles): long reads, one past the row
            lens = (np.r_[L + 3, rng.integers(L // 2, L + 1, N - 1)]
                    if L > 1000 else None)
            for off in (0, 1):
                cases.append((f"{N}x{L} k={k} offset {off}",
                              *_reads(rng, N, L, k, off, full=N == 1,
                                      lengths=lens), k))
        cases.append((f"64x150 reads shorter than k={k}",
                      *_reads(rng, 64, 150, k, lengths=np.minimum(
                          rng.integers(0, 151, 64), k - 1)), k))
        cases.append((f"64x150 lengths 155 > L, k={k}",
                      *_reads(rng, 64, 150, k, lengths=np.full(64, 155)), k))
    cases.append(("100000x150 ragged k=31",
                  *_reads(rng, 100_000, READ_LEN, 31), 31))
    cases.append(("200000x150 ragged k=17",
                  *_reads(rng, 200_000, READ_LEN, 17), 17))
    err = 0
    for what, codes, lengths, k in cases:
        for edges in (False, True):
            N, L = codes.shape
            rows, pw = chop.tile_plan(L, k)
            if lib.chop_smem_bytes(L, k, rows, pw) != \
                    chop.smem_bytes(rows, pw, L, k):
                raise AssertionError(f"chop {what}: shared memory of the "
                                     "tile plan differs from the kernel's")
            got = chop.chop(codes, lengths, k, edges)
            torch.cuda.synchronize()
            e = _max_abs_err(got, chop.chop_plain(codes, lengths, k, edges))
            if e != 0:
                raise AssertionError(f"chop kernel differs from chop_plain "
                                     f"on the card ({what}, edges={edges}):"
                                     f" max abs err {e}")
            err = max(err, e)
    del cases
    _log(f"chop kernel == chop_plain on the card: k 1/16/17/31 x (1x150 "
         f"full, 333x150, 301x250, 97x157, 5x5003, 3x30011; codes at "
         f"offsets 0 and 1), reads shorter than k, lengths > L, ragged "
         f"100000x150 k=31 and 200000x150 k=17; both modes; max abs err "
         f"{err}")

    # the main path's shapes: kmerfreq's batch (counting), ingest's batch
    # (edges) and ingest's batch counted (continuity with earlier runs)
    rec = {"max_abs_err": err, "library_ms": None}
    for suf, N, k, edges in (("_kmerfreq", 200_000, 17, False),
                             ("", 100_000, 31, True),
                             ("_count_mode", 100_000, 31, False)):
        codes, lengths = _reads(rng, N, READ_LEN, k, full=True)
        P = READ_LEN - k + 1
        got = chop.chop(codes, lengths, k, edges)
        torch.cuda.synchronize()
        e = _max_abs_err(got, chop.chop_plain(codes, lengths, k, edges))
        if e != 0:
            raise AssertionError(f"chop kernel differs from chop_plain at "
                                 f"{N}x{READ_LEN} k={k}: max abs err {e}")
        del got
        what = f"chop {N}x{READ_LEN} k={k} edges={edges}"
        ms, plain_ms = _turns(what, lambda: chop.chop(codes, lengths, k,
                                                      edges),
                              lambda: chop.chop_plain(codes, lengths, k,
                                                      edges))
        dev_ms = _profiled_ms(lambda: chop.chop(codes, lengths, k, edges),
                              "chop_kernel")
        host_ms = _host_ms(lambda: chop.chop(codes, lengths, k, edges))
        # bytes: codes and lengths read once, k-mers (and edge codes)
        # written once
        bound_ms, bound_by = _bound(N * READ_LEN + 4 * N
                                    + N * P * (10 if edges else 8))
        rows, pw = chop.tile_plan(READ_LEN, k)
        _log(f"{what}: profiler device time {dev_ms} ms a launch, host "
             f"{host_ms:.4f} ms a call; bound "
             f"{bound_ms:.4f} ms ({bound_by}); tiles of {rows} rows, "
             f"{chop.smem_bytes(rows, pw, READ_LEN, k)} B of shared "
             f"memory a block")
        rec.update({"ms" + suf: ms, "plain_ms" + suf: plain_ms,
                    "bound_ms" + suf: bound_ms, "bound_by" + suf: bound_by,
                    "device_ms" + suf: dev_ms, "host_ms" + suf: host_ms})
        del codes, lengths
    torch.cuda.empty_cache()
    return rec


def _timed_in_place(fn, raw: torch.Tensor, words: torch.Tensor,
                    iters: int) -> float:
    """Mean CUDA-event ms of fn() over iters calls, each on ``words``
    restored from ``raw`` first (the copy outside the events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        words.copy_(raw)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_rc_expand(rce) -> dict:
    """The rc expand kernel against rc_expand_plain on the card, exact, at
    its scalar paths and on a k = 17 table against the numpy expand; then
    timed there in turns beside its bound and the plain twin."""
    from dbg_assembly_tpu_torch import dna
    from dbg_assembly_tpu_torch.kmer import count as kc
    rng = np.random.default_rng(24)
    for what, k, dens, off in (("k=3, two words (scalar path)", 3, 0.3, 0),
                               ("k=9", 9, 0.02, 0),
                               ("k=13", 13, 0.01, 0),
                               ("k=13 at 4 B past alignment", 13, 0.01, 1),
                               ("k=13, every bit", 13, 1.0, 0)):
        raw = np.packbits(rng.random(4 ** k) < dens)
        buf = torch.zeros(4 ** k // 32 + off, dtype=torch.int32,
                          device="cuda")
        words = buf[off:]
        words.copy_(torch.from_numpy(raw.view("<i4")))
        want = rce.rc_expand_plain(words, k)
        got = rce.rc_expand(words, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not np.array_equal(
                got.cpu().numpy().view(np.uint8),
                kc.expand_bitmap_rc(raw, k)):
            raise AssertionError(f"rc_expand kernel differs from the plain "
                                 f"twin or the numpy expand ({what})")
    _log("rc_expand kernel == rc_expand_plain == expand_bitmap_rc on the "
         "card: k 3 (two words), 9, 13 (aligned, 4 B past alignment, every "
         "bit set)")

    # the main path's table: k = 17, 2 GiB, about 6 M canonical k-mers
    k = 17
    t = time.perf_counter()
    idx = rng.integers(0, 4 ** k, 6_000_000).astype(np.uint64)
    raw = np.zeros(4 ** k // 8, np.uint8)
    kc.bitmap_set(raw, np.minimum(idx, dna.revcomp_kbit(idx, k)))
    host_s = _timed(kc.expand_bitmap_rc, raw, k)
    want = kc.expand_bitmap_rc(raw, k)
    _log(f"k=17 table: {time.perf_counter() - t:.1f} s to make, host "
         f"expand_bitmap_rc {host_s:.3f} s")
    raw_dev = torch.from_numpy(raw.view("<i4")).cuda()
    words = raw_dev.clone()
    rce.rc_expand(words, k)
    torch.cuda.synchronize()
    if not np.array_equal(words.cpu().numpy().view(np.uint8), want):
        raise AssertionError("rc_expand kernel differs from the numpy "
                             "expand at k=17")
    plain = rce.rc_expand_plain(raw_dev, k)
    if not torch.equal(plain, words):
        raise AssertionError("rc_expand_plain differs from the kernel at "
                             "k=17")
    set_bits = int(np.unpackbits(raw).sum())
    changed = int((plain != raw_dev).sum())
    del plain, want
    ms = [_timed_in_place(lambda: rce.rc_expand(words, k), raw_dev, words,
                          10) for _ in range(2)]
    plain_ms = [_timed_in_place(lambda: rce.rc_expand_plain(words, k),
                                raw_dev, words, 2) for _ in range(2)]
    dev_ms = _profiled_ms(lambda: (words.copy_(raw_dev),
                                   rce.rc_expand(words, k)),
                          "rc_expand_kernel")
    # bytes: the table read once, each word the expand changes written once
    bound_ms, bound_by = _bound(4 ** k // 8 + 4 * changed)
    _log(f"rc_expand k=17: kernel {ms[0]:.4f} / {ms[1]:.4f} ms, plain "
         f"{plain_ms[0]:.2f} / {plain_ms[1]:.2f} ms, profiler device time "
         f"{dev_ms} ms; bound {bound_ms:.4f} ms ({bound_by}); {set_bits} "
         f"bits set, {changed} words changed; launches {rce.launches}")
    del words, raw_dev
    torch.cuda.empty_cache()
    return {"max_abs_err": 0, "ms_k17": sum(ms) / 2,
            "plain_ms_k17": sum(plain_ms) / 2, "device_ms_k17": dev_ms,
            "bound_ms_k17": bound_ms, "bound_by_k17": bound_by,
            "host_expand_s_k17": host_s, "set_bits_k17": set_bits,
            "words_changed_k17": changed, "library_ms": None}


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
    c = np.concatenate([fastq.read_batch(f, keep_heads=False).codes
                        for f in files])
    parts = []
    for b in range(8):
        cb = torch.from_numpy(c[b * 100_000:(b + 1) * 100_000]).cuda()
        lb = torch.full((len(cb),), cb.shape[1], dtype=torch.int32,
                        device="cuda")
        parts.append(graph._aggregate_batch(cb, lb, 31, 0)[0])
    del c
    shapes.append(("merge", torch.cat(parts), 62, True))
    del parts
    rec = {"max_abs_err": err}
    for name, keys, bits, index in shapes:
        _sort_shape(srt, rec, name, keys, bits, index)
    torch.cuda.empty_cache()
    return rec


def _sort_shape(srt, rec: dict, name: str, keys: torch.Tensor, bits: int,
                index: bool) -> None:
    """The radix sort at one main-path shape: == sort_plain, then timed
    beside it and torch.sort; the numbers go into ``rec`` under the
    shape's suffix."""
    err = _sort_check(srt, keys, bits, index, name)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    what = (f"sort {name}: {keys.shape[0]} keys, key_bits {bits}, "
            f"index {index}")
    ms, plain_ms = _turns(what, lambda: srt.sort(keys, bits, index),
                          lambda: srt.sort_plain(keys, bits, index))
    library_ms = _cuda_ms(lambda: torch.sort(keys, stable=True))
    host_ms = _host_ms(lambda: srt.sort(keys, bits, index))
    _log(f"{what}: torch.sort(keys, stable=True) {library_ms:.4f} ms; host "
         f"{host_ms:.4f} ms a call")
    # bytes: the keys read once and written once, the index written
    bound_ms, bound_by = _bound(keys.shape[0] * (16 + 8 * index))
    suf = "" if name == "count" else "_" + name
    rec.update({"ms" + suf: ms, "plain_ms" + suf: plain_ms,
                "bound_ms" + suf: bound_ms, "bound_by" + suf: bound_by,
                "library_ms" + suf: library_ms, "n" + suf: keys.shape[0],
                "host_ms" + suf: host_ms})


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


def _phase_wall(name: str, fn) -> float:
    """Run fn with the card synchronised around it; log and return its
    wall (s), and log its peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    _log(f"{name}: wall {wall:.3f} s, peak device memory {peak} B "
         f"({peak / 2**30:.3f} GiB)")
    return wall


def _step(steps: list, name: str, fn):
    """Run fn with the card synchronised around it, append (name, seconds)
    to steps and return fn's result."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps.append((name, time.perf_counter() - t))
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


# ---------------------------------------------------------------- phase 11
CORRECT_SUFFIXES = (".correct.fa.gz", ".correct.stat")
PAIR_SUFFIXES = (".correct.fa.gz.pair.fa.gz", ".correct.fa.gz.single.fa.gz",
                 ".correct.fa.gz.pair.single.stat")


def _digest(path: str) -> str:
    """sha256 of a file's bytes, decompressed for a .gz file."""
    import gzip
    import hashlib
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return hashlib.sha256(f.read()).hexdigest()


def _mirror(files: list[str], where: str) -> tuple[str, list[str]]:
    """A .lib of symlinks to ``files`` in ``where``, so that a second
    engine writes its outputs beside its own names."""
    os.makedirs(where, exist_ok=True)
    links = []
    for f in files:
        links.append(os.path.join(where, os.path.basename(f)))
        os.symlink(f, links[-1])
    lib = os.path.join(where, "reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in links))
    return lib, links


def _correct_outputs(files: list[str]) -> dict:
    out = {}
    for i, f in enumerate(files):
        sufs = CORRECT_SUFFIXES + (PAIR_SUFFIXES if i % 2 == 0 else ())
        for suf in sufs:
            out[os.path.basename(f) + suf] = _digest(f + suf)
    return out


def phase_correct(workdir: str, cz: str, name: str, files: list[str],
                  n_reads: int, kernels: dict,
                  max_share: float | None) -> list[str]:
    """``correct_error_reads -k 17 -j 1`` with the torch engine on the card
    through cli.main, then the same files through ``--engine native`` (the
    shared C++ engine); every output's (decompressed) bytes must be equal,
    and the share of reads re-run on the host engine below max_share.
    Returns the torch engine's input names (its outputs sit beside them)."""
    from dbg_assembly_tpu_torch import cli
    from dbg_assembly_tpu_torch.correct import device as cdev
    from dbg_assembly_tpu_torch.correct import pipeline
    from dbg_assembly_tpu_torch.ops import rc_expand as rce
    lib, files = _mirror(files, os.path.join(workdir, name, "torch"))
    nlib, nfiles = _mirror(files, os.path.join(workdir, name, "native"))
    argv = ["correct_error_reads", "-k", "17", "-j", "1", cz]
    for mod in kernels.values():
        mod.launches = 0
    cdev.reset_counts()
    rc0 = rce.launches
    title = f"correct_error_reads -k 17 -j 1 ({name}, torch engine)"
    wall = _phase_wall(title, lambda: cli.main(argv + [lib, "--device",
                                                       "cuda"]))
    c = dict(cdev.counts)
    if rce.launches - rc0 != 1:
        raise AssertionError(f"{name}: the table's rc expand launched "
                             f"{rce.launches - rc0} times, not once")
    share = c["fallback"] / n_reads
    _log(f"{title}: {n_reads} reads, {n_reads / wall:.1f} reads/s; "
         f"{c['batches']} chunks of up to {pipeline.DEFAULT_CHUNK} reads, "
         f"{c['waves']} waves, {c['bbt_calls']} beam calls, {c['trips']} "
         f"trips, {c['host_reads']} host reads; fallback {c['fallback']} "
         f"reads, share {share:.6f}, host table copies "
         f"{c['host_table']}; rc_expand launches 1; kernel launches "
         f"{ {n: m.launches for n, m in kernels.items()} } (none on this "
         "path)")
    _phase_wall(f"correct_error_reads -k 17 -j 1 ({name}, native engine)",
                lambda: cli.main(argv + ["--engine", "native", nlib]))
    got, want = _correct_outputs(files), _correct_outputs(nfiles)
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        raise AssertionError(f"{name}: torch engine outputs != native "
                             f"engine's: {bad}")
    _log(f"{name}: torch engine == native engine on {len(want)} outputs "
         f"({', '.join(sorted(want))})")
    if max_share is not None and share >= max_share:
        raise AssertionError(f"{name}: fallback share {share:.6f} >= "
                             f"{max_share}")
    return files


def make_hard_library(workdir: str) -> tuple[list[str], int]:
    """25 000 pairs from the same genome at 1 % errors, another seed."""
    from tools.simulate_reads import make_genome, simulate_pe
    genome = make_genome(GENOME_LEN, seed=42)
    depth = 25_000.5 * 2 * READ_LEN / GENOME_LEN
    r1, q1, r2, q2 = simulate_pe(genome, READ_LEN, 400, depth, seed=44,
                                 err_start=0.01, err_end=0.01)
    d = os.path.join(workdir, "hard_src")
    os.makedirs(d)
    files = []
    for mate, (r, q) in enumerate(((r1, q1), (r2, q2)), start=1):
        files.append(os.path.join(d, f"hard_{mate}.fq"))
        _write_fastq(files[-1], mate, r, q)
    return files, 2 * len(r1)


def phase_correct_steps(cz: str, files: list[str]) -> None:
    """``--profile``: the correction stage step by step on the torch
    engine's files of phase 11 (host clock, the card synchronised after
    each step), and the device engine alone on the first file at several
    chunk widths (the measurement behind pipeline.DEFAULT_CHUNK)."""
    from dbg_assembly_tpu_torch.correct import device as cdev
    from dbg_assembly_tpu_torch.correct import pipeline
    from dbg_assembly_tpu_torch.correct.engine import CorrectParams
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.utils.helpers import merge_corrected_pair
    p = CorrectParams(ksize=17)
    steps = []

    def step(name, fn):
        return _step(steps, name, fn)

    bitmap = step("load table", lambda: pipeline.load_bitmap(cz, 17))
    words = step("table to the card", lambda: cdev.bitmap_device(bitmap,
                                                                 "cuda"))
    batch = step("parse file 1", lambda: fastq.read_batch(
        files[0], keep_heads=True, keep_ascii=True))
    step("device engine file 1", lambda: pipeline.correct_batch_torch(
        batch, bitmap, p, words=words))
    step("correct_file file 1 (parse, engine, format, write)",
         lambda: pipeline.correct_file(files[0], bitmap, p, words=words))
    step("merge_corrected_pair", lambda: merge_corrected_pair(
        files[0] + ".correct.fa.gz", files[1] + ".correct.fa.gz"))
    _log("correction by step (s): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in steps))
    for chunk in (16_384, 65_536, 262_144, batch.n_reads):
        cdev.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        pipeline.correct_batch_torch(batch, bitmap, p, words=words,
                                     chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        c = cdev.counts
        _log(f"chunk {chunk}: device engine + host fallback on "
             f"{batch.n_reads} reads {wall:.3f} s "
             f"({batch.n_reads / wall:.1f} reads/s), peak device memory "
             f"{torch.cuda.max_memory_allocated()} B, {c['batches']} "
             f"chunks, {c['trips']} trips, {c['host_reads']} host reads, "
             f"fallback {c['fallback']}")
    del words
    torch.cuda.empty_cache()


def phase_profile(workdir: str, lib: str, cz: str, files: list[str],
                  extra: list) -> None:
    """``--profile``: each stage of phases 8 and 11, and the (title, argv)
    runs of ``extra`` (argv a command line, or a function to call), once
    more under torch.profiler: wall, device busy time (the sum of every
    device item's self time), the idle share, the chop's and the sort's
    device time and the largest device items."""
    from torch.profiler import ProfilerActivity, profile
    from dbg_assembly_tpu_torch import cli
    contig = ["debruijn_contig", "-k", "31", "-i", "0.02", "-M", "125"]
    clib, _ = _mirror(files, os.path.join(workdir, "prof_correct"))
    runs = [("kmerfreq -k 17 -m 1",
             ["kmerfreq", "-k", "17", "-m", "1", lib]),
            ("debruijn_contig (exact)",
             contig + ["-o", os.path.join(workdir, "prof"), lib]),
            ("debruijn_contig --readout doubling",
             contig + ["--readout", "doubling", "-o",
                       os.path.join(workdir, "prof_doubling"), lib]),
            ("correct_error_reads -k 17 -j 1",
             ["correct_error_reads", "-k", "17", "-j", "1", cz, clib]),
            *extra]
    for title, argv in runs:
        torch.cuda.synchronize()
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stderr(null), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            if callable(argv):
                argv()
            else:
                cli.main(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        # device-side items only (kernels, copies, sets): a CPU op's self
        # device time repeats its kernels'; the profiler's own buffer
        # requests are not the program's work
        items = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0
                        and e.key != "Activity Buffer Request"),
                       reverse=True)
        busy = sum(ms for ms, _, _ in items)

        def of(*names):
            sel = [(ms, n) for ms, n, key in items
                   if any(x in key for x in names)]
            return sum(ms for ms, _ in sel), sum(n for _, n in sel)

        chop_ms, chop_n = of("chop_kernel")
        sort_ms, sort_n = of("hist_kernel", "scan_kernel", "onesweep_kernel")
        # what an exchange between slots costs: copies between devices, and
        # the concatenations that join the arrivals on one card
        copy_ms, copy_n = of("Memcpy DtoD", "Memcpy PtoP")
        cat_ms, cat_n = of("CatArrayBatchedCopy")
        _log(f"profile {title}: wall {wall:.3f} s (profiled), device busy "
             f"{busy:.3f} ms, idle share {1 - busy / 1e3 / wall:.4f}; chop "
             f"{chop_ms:.3f} ms ({chop_n} launches), radix sort "
             f"{sort_ms:.3f} ms ({sort_n} kernel launches); device-to-device "
             f"copies {copy_ms:.3f} ms ({copy_n}), concatenations "
             f"{cat_ms:.3f} ms ({cat_n}); top: " + "; ".join(
                 f"{key[:60]} {ms:.3f} ms x{n}" for ms, n, key in items[:8]))


# ---------------------------------------------------------------- phase 12
CLEAN_ORACLE_READS = 40_000


def _stat_numbers(path: str) -> dict:
    """The integer fields of a .stat file, by name."""
    with open(path) as f:
        return {m.group(1): int(m.group(2)) for m in re.finditer(
            r"^[#\t]*(\w+):\s+(\d+)", f.read(), re.M)}


def make_soiled(workdir: str, files: list[str]) -> tuple[list[str], int]:
    """Phase 6's files, soiled (``tools/soil.py``), in workdir; and their
    reads."""
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.tools import soil
    out, n = [], 0
    for mate, path in enumerate(files, start=1):
        b = fastq.read_batch(path, keep_heads=False, keep_ascii=True)
        reads, quals = b.seqs_ascii.copy(), b.quals.copy()
        soil.soil(reads, quals, mate, seed=50 + mate)
        out.append(os.path.join(workdir, f"soiled_{mate}.fq"))
        _write_fastq(out[-1], mate, reads, quals)
        n += len(reads)
    return out, n


def _clean_argv(path: str, where: str) -> list[tuple[str, list, str]]:
    """(title, argv, .stat) of the two stages on one file, chained as
    workflow.clean_reads chains them; outputs in ``where``."""
    lq = os.path.join(where, os.path.basename(path) + ".nonLowQual.gz")
    ad = lq + ".nonAdapter.gz"
    return [("clean_lowqual -e 0.01 -r 75",
             ["clean_lowqual", "-e", "0.01", "-r", "75", path, lq,
              lq[:-3] + ".stat"], lq[:-3] + ".stat"),
            ("clean_adapter -r 75",
             ["clean_adapter", "-r", "75", lq, ad, ad[:-3] + ".stat"],
             ad[:-3] + ".stat")]


def phase_clean(workdir: str, files: list[str]) -> list:
    """Both cleaning stages on the soiled library through cli.main on the
    card, then the oracle subset on the CPU and the card.  Returns the
    soiled files."""
    from dbg_assembly_tpu_torch import cli
    from dbg_assembly_tpu_torch.clean import adapter, lowqual
    d = os.path.join(workdir, "clean")
    os.makedirs(d)
    t = time.perf_counter()
    soiled, n_reads = make_soiled(d, files)
    _log(f"soiled library: {n_reads} reads, {time.perf_counter() - t:.1f} s")

    x = torch.randint(0, 3, (200_000, 33), dtype=torch.int32, device="cuda")
    first = torch.where(x == x.amax(1, keepdim=True),
                        torch.arange(33, device="cuda"), 33).amin(1)
    if not torch.equal(torch.argmax(x, 1), first):
        raise AssertionError("torch.argmax does not return the first of "
                             "tied maxima on the card")

    for path in soiled:
        for (title, argv, stat), mod in zip(_clean_argv(path, d),
                                            (lowqual, adapter)):
            mod.reset_counts()
            wall = _phase_wall(f"{title} {os.path.basename(path)}",
                               lambda: cli.main(argv + ["--device", "cuda"]))
            s = _stat_numbers(stat)
            raw = s.get("total_raw_reads")
            trimmed = s.get("filtered_lowqual_reads",
                            s.get("total_adapter_trimmed_reads"))
            short = s.get("filtered_short_reads",
                          s.get("total_short_trimmed_reads"))
            _log(f"{title} {os.path.basename(path)}: {raw} reads, "
                 f"{raw / wall:.1f} reads/s; {mod.counts['chunks']} device "
                 f"batches, {mod.counts['steps']} host-loop steps; trimmed "
                 f"{trimmed}, dropped as short {short}, clean "
                 f"{s.get('total_clean_reads')}")

    # oracle: the first reads of each file on the CPU and on the card
    outs = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        where = os.path.join(d, f"oracle_{name}")
        os.makedirs(where)
        for path in soiled:
            head = os.path.join(where, os.path.basename(path))
            with open(path, "rb") as src, open(head, "wb") as dst:
                dst.writelines(line for _, line in zip(
                    range(4 * CLEAN_ORACLE_READS), src))
            for title, argv, stat in _clean_argv(head, where):
                cli.main(argv + ["--device", dev])
                out = argv[-2]
                outs.setdefault(name, []).extend(
                    [_digest(out), _digest(stat)])
    if outs["cpu"] != outs["card"]:
        raise AssertionError("cleaning on the card != --device cpu on the "
                             "oracle subset")
    _log(f"cleaning on the card == --device cpu: first "
         f"{CLEAN_ORACLE_READS} reads of both files, both stages, "
         f"{len(outs['cpu'])} outputs (.gz decompressed, .stat); "
         f"torch.argmax on the card gives the first of tied maxima")
    return soiled


# ---------------------------------------------------------------- phase 13
MAP_ARGV = ["map_pair", "-k", "31", "-s", "5", "-l", "125", "-r", "100",
            "-i", "0.97"]
SCAFFOLD_SUFFIXES = (".scaffold.links.all", ".scaffold.links.uniq",
                     ".scaffold.seq.fa", ".scaffold.pos.tab",
                     ".scaffold_repeat.seq.fa", ".scaffold_repeat.pos.tab")


def phase_map(workdir: str, files: list[str], contigs: str,
              kernels: dict) -> int:
    """map_pair + link_scaffold with the torch engine on the card and with
    the native engine; every output equal.  Returns the torch run's radix
    sort launches."""
    from dbg_assembly_tpu_torch import cli
    digests, sort_launches = {}, 0
    base = os.path.basename(files[0])
    for engine in ("torch", "native"):
        where = os.path.join(workdir, "map", engine)
        lib, links = _mirror(files, where)
        mdir = os.path.join(where, "out")
        argv = MAP_ARGV + ["-o", mdir, "--engine", engine, "--device",
                           "cuda", contigs, lib]
        for mod in kernels.values():
            mod.launches = 0
        title = f"map_pair ... --engine {engine}"
        wall = _phase_wall(title, lambda: cli.main(argv))
        counts = {n: m.launches for n, m in kernels.items()}
        s = _stat_numbers(os.path.join(mdir, base + ".map_pair.stat"))
        total = s["total_read_pair_num"]
        both = s["map_ctg_diff_num"] + s["map_ctg_same_num"]
        _log(f"{title}: {total} pairs, {total / wall:.1f} pairs/s; both "
             f"ends mapped {both / total:.4f}, reads mapped "
             f"{(2 * both + s['map_ctg_gap_num']) / (2 * total):.4f} "
             f"(diff {s['map_ctg_diff_num']}, same {s['map_ctg_same_num']}"
             f", gap {s['map_ctg_gap_num']}); kernel launches {counts}")
        if engine == "torch":
            sort_launches = counts["radix_sort"]
            if sort_launches <= 0:
                raise AssertionError("map_pair --engine torch never "
                                     "launched the radix sort")
        two = os.path.join(where, "twoctg.lib")
        with open(two, "w") as f:
            f.write(os.path.join(mdir, base + ".map_pair.2ctg.gz") + "\n")
        pre = os.path.join(where, "scf")
        _phase_wall(f"link_scaffold -i 400 -n 3 (after --engine {engine})",
                    lambda: cli.main(["link_scaffold", "-i", "400", "-n",
                                      "3", "-o", pre, "--device", "cuda",
                                      contigs, two]))
        lens = _fasta_lengths(pre + ".insert400.scaffold.seq.fa")
        reps = _fasta_lengths(pre + ".insert400.scaffold_repeat.seq.fa")
        _log(f"scaffolds (--engine {engine}): {len(lens)}, total length "
             f"{int(lens.sum())}, N50 {_n50(lens)}; repeat singlets "
             f"{len(reps)}")
        digests[engine] = {
            suf: _digest(os.path.join(mdir, base + suf))
            for suf in (".map_pair.2ctg.gz", ".map_pair.1ctg.gz",
                        ".map_pair.gap.gz", ".map_pair.stat")}
        digests[engine].update({suf: _digest(pre + ".insert400" + suf)
                                for suf in SCAFFOLD_SUFFIXES})
    if digests["torch"] != digests["native"]:
        bad = [k for k in digests["native"]
               if digests["torch"][k] != digests["native"][k]]
        raise AssertionError(f"map/scaffold --engine torch != native: {bad}")
    _log(f"map_pair + link_scaffold --engine torch == --engine native: "
         f"{len(digests['torch'])} files")
    return sort_launches


def phase_map_index(srt, contigs: str, sort_rec: dict) -> None:
    """The index map_pair builds from ``contigs`` (-k 31 -l 125), on the
    card == on the CPU (sort_plain), every array; and the radix sort at
    its keys' shape checked and timed into ``sort_rec`` (suffix
    _map_index).  map_pair's outputs read a payload only where a k-mer is
    unique, so they cannot show which payload a run kept: this can."""
    from dbg_assembly_tpu_torch.scaffold import index, map_pair
    _, seqs = map_pair.read_contig_fasta(contigs)
    seqs = [s if len(s) >= 125 else b"" for s in seqs]
    card, cpu = (index.build(seqs, 31, device=d) for d in ("cuda", "cpu"))
    fields = ("kmers", "ids", "pos", "direct", "uniq")
    bad = [f for f in fields
           if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f))]
    if bad:
        raise AssertionError(f"contig index on the card != on the CPU: {bad}")
    _log(f"contig index on the card == on the CPU: {cpu.kmers.shape[0]} "
         f"k-mers, {int(cpu.uniq.sum())} unique; {', '.join(fields)} equal")
    concat, codes, offsets, _ = index.device_rows(seqs, "cuda")
    keys = index.window_keys(concat, codes, offsets, 31)[0]
    del card, cpu, concat, codes, offsets
    _sort_shape(srt, sort_rec, "map_index", keys, 62, True)


def phase_clean_map_steps(workdir: str, soiled: list[str],
                          files: list[str], contigs: str) -> None:
    """``--profile``: the stages of phases 12 and 13 on one file step by
    step (host clock, the card synchronised after each step): parse, the
    device work with its copies, and the whole stage; the rest of the
    stage is the host's formatting and writing."""
    from dbg_assembly_tpu_torch.clean import adapter, lowqual
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.scaffold import index, map_pair
    d = os.path.join(workdir, "steps_clean_map")
    os.makedirs(d)
    lq = os.path.join(d, "lq.gz")
    steps = []

    def step(name, fn):
        return _step(steps, name, fn)

    b = step("lowqual: parse", lambda: fastq.read_batch(
        soiled[0], fmt="fq", strict_n=True, keep_heads=True,
        keep_ascii=True))
    step("lowqual: N mask + scan on the card", lambda:
         lowqual.clean_lowqual_arrays(b.quals, b.seqs_ascii, b.lengths, 0.01,
                                      75, device="cuda"))
    step("lowqual: run_file", lambda: lowqual.run_file(
        soiled[0], lq, lq + ".stat", 0.01, 75))
    b = step("adapter: parse", lambda: fastq.read_batch(
        lq, fmt="fq", strict_n=True, keep_heads=True, keep_ascii=True))
    seqs = [s for _, s in adapter.DEFAULT_ADAPTERS["Both-adapter"]]
    step("adapter: DP on the card", lambda: adapter.clean_adapter_arrays(
        b.codes, b.lengths, seqs, 12, 75, device="cuda"))
    step("adapter: run_file", lambda: adapter.run_file(
        lq, lq + ".ad.gz", lq + ".ad.stat", min_read_len=75))
    ids, seqs = step("map: read contigs", lambda:
                     map_pair.read_contig_fasta(contigs))
    seqs = [s if len(s) >= 125 else b"" for s in seqs]
    ix = step("map: index on the card", lambda: index.build(seqs, 31))
    b = step("map: parse file 1", lambda: fastq.read_batch(
        files[0], keep_heads=True, keep_ascii=True))
    step("map: map file 1 on the card", lambda: index.map_reads(
        ix, b.codes, b.seqs_ascii, b.lengths, 5, 0.97))
    clens = np.array([len(s) for s in seqs], np.int64)
    step("map: _map_pair_files (parse 2 files, map, route, format, write)",
         lambda: map_pair._map_pair_files(files[0], files[1], ix, ids, clens,
                                          d, 5, 100, 0.97, 1))
    _log("cleaning and mapping by step (s): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in steps))


# ---------------------------------------------------------------- phase 14
MAP_READS_ARGV = ["map_reads", "-k", "31", "-s", "5", "-l", "125", "-r",
                  "250", "-i", "0.97"]
MAP_READS_SUFFIXES = (".map_reads.2ctg.gz", ".map_reads.1ctg.gz",
                      ".map_reads.2ctg.gz.reads.fa.gz", ".map_reads.stat")


def make_long_reads(workdir: str) -> tuple[str, int]:
    """Long single reads of phase 6's genome, simulated as
    tests/test_golden_linkcontig.py does (700 bp from 1500 bp fragments at
    8x, 0.1-0.4 % errors, mate 1), as one FASTQ file."""
    from tools.simulate_reads import make_genome, simulate_pe
    r1, q1, _, _ = simulate_pe(make_genome(GENOME_LEN, seed=42), 700, 1500,
                               8.0, seed=99, err_start=0.001, err_end=0.004)
    path = os.path.join(workdir, "long_1.fq")
    _write_fastq(path, 1, r1, q1)
    return path, len(r1)


def phase_map_reads(workdir: str, contigs: str, kernels: dict) -> int:
    """map_reads with the torch engine on the card and with the native
    engine, every output equal; then link_contig and link_supertig on the
    torch run's .2ctg list.  Returns the torch run's radix sort
    launches."""
    from dbg_assembly_tpu_torch import cli
    d = os.path.join(workdir, "long")
    t = time.perf_counter()
    fq, n_reads = make_long_reads(workdir)
    _log(f"long reads: {n_reads} reads of 700 bp, "
         f"{time.perf_counter() - t:.1f} s")
    base = os.path.basename(fq)
    digests, sort_launches = {}, 0
    for engine in ("torch", "native"):
        lib, _ = _mirror([fq], os.path.join(d, engine))
        mdir = os.path.join(d, engine, "out")
        for mod in kernels.values():
            mod.launches = 0
        title = f"map_reads {' '.join(MAP_READS_ARGV[1:])} --engine {engine}"
        wall = _phase_wall(title, lambda: cli.main(
            MAP_READS_ARGV + ["-o", mdir, "--engine", engine, "--device",
                              "cuda", contigs, lib]))
        counts = {n: m.launches for n, m in kernels.items()}
        with open(os.path.join(mdir, base + ".map_reads.stat")) as f:
            shares = re.findall(r"(\w+): \d+\s+(\S+)%", f.read())
        s = _stat_numbers(os.path.join(mdir, base + ".map_reads.stat"))
        _log(f"{title}: {s['total_read_num']} reads, "
             f"{s['total_read_num'] / wall:.1f} reads/s; shares (%) "
             + ", ".join(f"{k} {v}" for k, v in shares)
             + f"; kernel launches {counts}")
        digests[engine] = {suf: _digest(os.path.join(mdir, base + suf))
                           for suf in MAP_READS_SUFFIXES}
        if engine == "torch":
            sort_launches = counts["radix_sort"]
            if sort_launches <= 0:
                raise AssertionError("map_reads --engine torch never "
                                     "launched the radix sort")
            if s["map_ctg_diff_num"] <= 0:
                raise AssertionError("map_reads linked no two contigs")
            two = os.path.join(d, "twoctg.lib")
            with open(two, "w") as f:
                f.write(os.path.join(mdir, base + ".map_reads.2ctg.gz")
                        + "\n")
    if digests["torch"] != digests["native"]:
        bad = [k for k in digests["native"]
               if digests["torch"][k] != digests["native"][k]]
        raise AssertionError(f"map_reads --engine torch != native: {bad}")
    _log(f"map_reads --engine torch == --engine native: "
         f"{len(digests['torch'])} files")
    pre = os.path.join(d, "link")
    for cmd, tag in (("link_contig", ".contig_R"),
                     ("link_supertig", ".supertig")):
        _phase_wall(f"{cmd} -n 3", lambda: cli.main(
            [cmd, "-n", "3", "-o", pre, "--device", "cuda", contigs, two]))
        lens = _fasta_lengths(pre + tag + ".seq.fa")
        _log(f"{cmd}: {len(lens)} {tag[1:]} records, total length "
             f"{int(lens.sum())}, N50 {_n50(lens)} (contigs: "
             f"{len(_fasta_lengths(contigs))}, N50 "
             f"{_n50(_fasta_lengths(contigs))})")
        if not len(lens):
            raise AssertionError(f"{cmd} wrote no record")
    return sort_launches


# ---------------------------------------------------------------- phase 15
WORKFLOW_STAGES = (("clean", "dbg_assembly_tpu_torch.clean.lowqual",
                    "run_file"),
                   ("clean", "dbg_assembly_tpu_torch.clean.adapter",
                    "run_file"),
                   ("kmerfreq", "dbg_assembly_tpu_torch.kmer.kmerfreq", "run"),
                   ("correct", "dbg_assembly_tpu_torch.correct.pipeline",
                    "run"),
                   ("contig", "dbg_assembly_tpu_torch.contig.pipeline", "run"),
                   ("map", "dbg_assembly_tpu_torch.scaffold.map_pair", "run"),
                   ("scaffold", "dbg_assembly_tpu_torch.scaffold.scaffold",
                    "run"))


@contextlib.contextmanager
def _stage_clock(stages: dict):
    """Times each stage function the workflow calls (the card synchronised
    around each call) into stages[name] = [wall s, peak device memory B],
    summed over calls (peak: the largest), and puts the functions back
    after."""
    import importlib
    saved = []

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = stages.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - t
            rec[1] = max(rec[1], torch.cuda.max_memory_allocated())
            return out
        return run

    try:
        for name, modname, attr in WORKFLOW_STAGES:
            mod = importlib.import_module(modname)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        yield stages
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _run_workflow(wdir: str, soiled: list[str]) -> dict:
    """workflow.run_full on the soiled pair (insert 400) on the card, with
    map_min_read 100: the default 250 maps no 150 bp read."""
    from dbg_assembly_tpu_torch import workflow
    cfg = workflow.PipelineConfig(map_min_read=100, device="cuda")
    return workflow.run_full([(soiled[0], soiled[1], 400)], cfg, wdir)


def phase_workflow_steps(workdir: str, soiled: list[str],
                         files: list[str]) -> None:
    """``--profile``: the workflow's kmerfreq (-q 10 on the cleaned .gz
    files) step by step, beside phase 8's parse of a plain file (host
    clock, the card synchronised after each step)."""
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.kmer import count, kmerfreq
    clean = os.path.join(workdir, "workflow", "01.clean")
    cleaned = [os.path.join(clean, os.path.basename(p)
                            + ".nonLowQual.gz.nonAdapter.gz") for p in soiled]
    steps = []

    def step(name, fn):
        return _step(steps, name, fn)

    step("parse a plain file (phase 8's input)",
         lambda: fastq.read_batch(files[0], keep_heads=False))
    b = step("parse a cleaned .gz file", lambda: fastq.read_batch(
        cleaned[0], keep_heads=False))
    codes, lens = step("-q 10 split of that file", lambda:
                       kmerfreq.split_reads_by_quality(
                           b.codes, b.lengths, b.quals, 17, 10))
    counter = count.KmerCounter(17, device="cuda")
    step("count that file on the card", lambda: counter.add(codes, lens))
    step("finalize", counter.finalize)
    lib = os.path.join(workdir, "steps_kmerfreq.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))
    step("kmerfreq.run -q 10, both files", lambda: kmerfreq.run(
        lib, ksize=17, qual_cutoff=10, device="cuda"))
    _log("workflow kmerfreq by step (s): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in steps))


def phase_workflow(workdir: str, soiled: list[str], kernels: dict) -> dict:
    """(a) workflow.run_full on phase 12's soiled pair on the card, every
    stage timed; its cleaned files must equal phase 12's card outputs, and
    the chop and the sort must launch.  Returns the run's launches."""
    wdir = os.path.join(workdir, "workflow")
    for mod in kernels.values():
        mod.launches = 0
    stages = {}
    title = ("workflow.run_full (clean, kmerfreq -q 10, correct, contig, "
             "map + scaffold, insert 400, map_min_read 100)")
    with _stage_clock(stages), open(os.devnull, "w") as null, \
            contextlib.redirect_stderr(null):
        t = time.perf_counter()
        out = _run_workflow(wdir, soiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {n: m.launches for n, m in kernels.items()}
    _log(f"{title}: wall {wall:.3f} s; by stage (wall s, share, peak device "
         "memory B): " + "; ".join(
             f"{name} {sec:.3f} {sec / wall:.4f} {peak}"
             for name, (sec, peak) in stages.items())
         + f"; other {wall - sum(s for s, _ in stages.values()):.3f}; "
         f"kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the workflow never launched the {name} "
                                 "kernel")
    for key in ("contigs", "scaffolds"):
        lens = _fasta_lengths(out[key])
        _log(f"workflow {key}: {len(lens)}, total length {int(lens.sum())}, "
             f"N50 {_n50(lens)}")
        if not (len(lens) and 0.5 * GENOME_LEN <= lens.sum()
                <= 1.2 * GENOME_LEN):
            raise AssertionError(f"workflow {key} out of the expected range")
    got, want = {}, {}
    for path in soiled:
        lq = os.path.basename(path) + ".nonLowQual"
        for name in (lq + ".gz", lq + ".stat", lq + ".gz.nonAdapter.gz",
                     lq + ".gz.nonAdapter.stat"):
            got[name] = _digest(os.path.join(wdir, "01.clean", name))
            want[name] = _digest(os.path.join(os.path.dirname(path), name))
    if got != want:
        raise AssertionError("workflow cleaning != phase 12's: "
                             f"{[k for k in want if got[k] != want[k]]}")
    _log(f"workflow 01.clean == phase 12's card outputs: {len(want)} files")
    return launches


def phase_workflow_small(workdir: str) -> None:
    """(b) the pipeline command on a small library (golden.sim_dataset's
    shape: 200 kb, 150 bp, 20x, inserts 400 and 800), with a recipe of two
    rounds, on the card and with --device cpu: every file under the two
    work dirs equal, .gz decompressed, each dir's own path replaced.  The
    command maps reads of at least 250 bases, so at 150 bp its rounds
    link nothing; run_full with map_min_read 100 is compared the same
    way, so the rounds join contigs."""
    import gzip
    from tools.simulate_reads import generate_dataset
    from dbg_assembly_tpu_torch import cli, workflow
    d = os.path.join(workdir, "small")
    libs = generate_dataset(os.path.join(d, "sim"), 200_000, 150, 20.0,
                            (400, 800), seed=7)["libs"]

    def tree(root):
        out = {}
        for sub, _, names in os.walk(root):
            for n in names:
                p = os.path.join(sub, n)
                with (gzip.open(p, "rb") if p.endswith(".gz") else
                      open(p, "rb")) as f:
                    out[os.path.relpath(p, root)] = \
                        f.read().replace(root.encode(), b"<root>")
        return out

    def pipeline(root, dev):
        os.makedirs(root)
        rows = ["#scaf_rank kmer_size seedKmerNum align_ident insert_size "
                "pairNumCut is_mate read_file"]
        for rank, (r1, r2, ins) in enumerate(libs, start=1):
            lib = os.path.join(root, f"raw_{ins}.lib")
            with open(lib, "w") as f:
                f.write(f"{r1}\n{r2}\n")
            rows.append(f"{rank} 31 5 0.97 {ins} 3 0 {lib}")
        para = os.path.join(root, "recipe.para")
        with open(para, "w") as f:
            f.write("\n".join(rows) + "\n")
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            cli.main(["pipeline", "-k", "13", "-w", os.path.join(root, "w"),
                      "-p", para, "--device", dev,
                      *(f"{r1},{r2},{ins}" for r1, r2, ins in libs)])

    def run_full(root, dev):
        cfg = workflow.PipelineConfig(correct_k=13, init_hash_size=0.01,
                                      map_min_read=100, device=dev)
        return workflow.run_full(libs, cfg, root)["scaffolds"]

    for title, fn in (("pipeline -k 13 -p recipe.para", pipeline),
                      ("run_full (k 13, map_min_read 100)", run_full)):
        trees, walls = {}, {}
        for dev in ("cuda", "cpu"):
            root = os.path.join(d, f"{fn.__name__}_{dev}")
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stderr(null):
                t = time.perf_counter()
                res = fn(root, dev)
                walls[dev] = time.perf_counter() - t
            trees[dev] = tree(root)
        bad = sorted(set(trees["cuda"]) ^ set(trees["cpu"])) + [
            k for k in trees["cpu"]
            if k in trees["cuda"] and trees["cuda"][k] != trees["cpu"][k]]
        if bad:
            raise AssertionError(f"{title}: card != --device cpu: {bad}")
        extra = ""
        if res is not None:
            lens = _fasta_lengths(res)
            extra = f"; {len(lens)} scaffolds, N50 {_n50(lens)}"
        _log(f"small workflow, {title}: card {walls['cuda']:.3f} s == "
             f"--device cpu {walls['cpu']:.3f} s on {len(trees['cpu'])} "
             f"files{extra}")


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
        b = fastq.read_batch(path, keep_heads=False)
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
        b = fastq.read_batch(path, keep_heads=False)
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
        return _step(steps, name, fn)

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


# ---------------------------------------------------------------- phase 16
MESH_SLOTS = 4
CONTIG_SUFFIXES = (".contig.kmer.freq", ".contig.tip.fa",
                   ".contig.lowedge.fa", ".contig.bubble.fa",
                   ".contig.seq.fa", ".contig.seq.depth",
                   ".contig.small.fa", ".contig.small.depth")


def _mesh_run(title: str, kernels: dict, fn, need=("chop", "radix_sort"),
              collectives: bool = True):
    """fn with every launch count and the collectives' byte count set to 0
    just before it and read just after: logs its wall, peak device
    memory, launches and bytes moved; the kernels in ``need`` must
    launch, and the collectives must move bytes where ``collectives``.
    Returns (fn's result, launches)."""
    from dbg_assembly_tpu_torch.parallel import mesh as meshmod
    for mod in kernels.values():
        mod.launches = 0
    meshmod.bytes_moved = 0
    out = []
    _phase_wall(title, lambda: out.append(fn()))
    counts = {n: m.launches for n, m in kernels.items()}
    moved = meshmod.bytes_moved
    _log(f"{title}: kernel launches {counts}, the collectives moved {moved} "
         f"B ({moved / 2**30:.3f} GiB)")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{title} never launched the {name} kernel")
    if collectives and moved <= 0:
        raise AssertionError(f"{title}: the collectives moved nothing")
    return out[0], counts


def _tree(root: str) -> dict:
    """sha256 of every file under root by relative path (.gz
    decompressed), root's own path replaced."""
    import gzip
    import hashlib
    out = {}
    for sub, _, names in os.walk(root):
        for n in names:
            p = os.path.join(sub, n)
            with (gzip.open(p, "rb") if p.endswith(".gz") else
                  open(p, "rb")) as f:
                data = f.read().replace(root.encode(), b"<root>")
            out[os.path.relpath(p, root)] = hashlib.sha256(data).hexdigest()
    return out


def phase_mesh(workdir: str, lib: str, files: list[str], n_reads: int,
               table, dprefix: str, cfiles: list[str], contigs: str,
               kernels: dict) -> dict:
    """The distributed path at D = 4 slots on the machine's cards, each
    run against the single-device run an earlier phase made: (a) the
    contig stage == phase 8's doubling files and phase 9's node table;
    (b) correction == phase 11's torch engine outputs; (c) map_pair ==
    phase 13's torch engine files; (d) count_halo_sharded of the genome
    as one sequence == its single-device count; (e) the 200 kb workflow
    with mesh_devices=4 == mesh_devices=0 on the card.  Returns the
    chop's and the sort's launches summed over the runs."""
    from dbg_assembly_tpu_torch import cli, dna, workflow
    from dbg_assembly_tpu_torch.contig import pipeline
    from dbg_assembly_tpu_torch.correct import device as cdev
    from dbg_assembly_tpu_torch.kmer.count import KmerCounter
    from dbg_assembly_tpu_torch.parallel import halo
    from dbg_assembly_tpu_torch.parallel import mesh as meshmod
    from tools.simulate_reads import generate_dataset, make_genome
    mesh = meshmod.data_mesh(MESH_SLOTS)
    _log(f"mesh: {mesh.layout()} ({', '.join(map(str, mesh.devices))})")
    totals = dict.fromkeys(kernels, 0)

    def run(title, fn, **kw):
        res, counts = _mesh_run(title, kernels, fn, **kw)
        for name, n in counts.items():
            totals[name] += n
        return res

    # (a) the contig stage, and its node table
    mprefix = os.path.join(workdir, "asm_mesh")
    with open(os.path.join(workdir, "contig_mesh.log"), "w") as logf, \
            contextlib.redirect_stderr(logf):
        run("(a) debruijn_contig -k 31 -i 0.02 -M 125 --mesh 4",
            lambda: cli.main(["debruijn_contig", "-k", "31", "-i", "0.02",
                              "-M", "125", "--mesh", str(MESH_SLOTS), "-o",
                              mprefix, "--device", "cuda", lib]))
    bad = [s for s in CONTIG_SUFFIXES
           if _digest(mprefix + s) != _digest(dprefix + s)]
    logs = []
    for name in ("contig_mesh.log", "contig_doubling.log"):
        with open(os.path.join(workdir, name)) as f:
            logs.append(re.sub(r"(Run time: )[0-9.e+-]+", r"\1X", f.read())
                        .replace(mprefix, "P").replace(dprefix, "P"))
    if bad or logs[0] != logs[1]:
        raise AssertionError(f"(a) --mesh 4 != --readout doubling: {bad}, "
                             f"run logs equal: {logs[0] == logs[1]}")
    lens = _fasta_lengths(mprefix + ".contig.seq.fa")
    _log(f"(a) --mesh 4 == phase 8's --readout doubling: "
         f"{len(CONTIG_SUFFIXES)} files and the run log; {len(lens)} "
         f"contigs, N50 {_n50(lens)}")
    mt = run("(a) node table through GraphBuilder(mesh)",
             lambda: pipeline._ingest(files, 1, 31, 250, "cuda",
                                      mesh=mesh).finalize())
    fields = ("kmers", "lcnt", "rcnt", "first_idx", "counts")
    bad = [f for f in fields if not np.array_equal(getattr(mt, f),
                                                   getattr(table, f))]
    if bad or (mt.total_kmers, mt.total_reads) != (table.total_kmers,
                                                   table.total_reads):
        raise AssertionError(f"(a) mesh node table != single-device: {bad}")
    _log(f"(a) mesh node table == single-device: {mt.n_nodes} nodes, "
         f"{', '.join(fields)}, totals equal")
    del mt

    # (b) correction with the table in four slots
    cz = lib + ".kmer.freq.cz"
    mlib, mfiles = _mirror(files, os.path.join(workdir, "ecoli", "mesh"))
    cdev.reset_counts()
    run("(b) correct_error_reads -k 17 -j 1 --mesh 4",
        lambda: cli.main(["correct_error_reads", "-k", "17", "-j", "1",
                          "--mesh", str(MESH_SLOTS), cz, mlib, "--device",
                          "cuda"]), need=())
    c = dict(cdev.counts)
    _log(f"(b) {n_reads} reads: {c['batches']} slot batches, {c['waves']} "
         f"waves, {c['bbt_calls']} beam calls, {c['trips']} trips, "
         f"{c['host_reads']} host reads; fallback {c['fallback']} reads, "
         f"share {c['fallback'] / n_reads:.6f} (the chop and the sort are "
         "not on this path)")
    got, want = _correct_outputs(mfiles), _correct_outputs(cfiles)
    if got != want:
        raise AssertionError("(b) --mesh 4 != the torch engine: "
                             f"{[k for k in want if got.get(k) != want[k]]}")
    _log(f"(b) --mesh 4 == phase 11's torch engine on {len(want)} outputs")

    # (c) map_pair with the reads sharded
    where = os.path.join(workdir, "map", "mesh")
    plib, _ = _mirror(files, where)
    mdir = os.path.join(where, "out")
    run("(c) map_pair -k 31 -s 5 -l 125 -r 100 -i 0.97 --mesh 4",
        lambda: cli.main(MAP_ARGV + ["-o", mdir, "--mesh", str(MESH_SLOTS),
                                     "--device", "cuda", contigs, plib]),
        need=("radix_sort",), collectives=False)
    base = os.path.basename(files[0])
    sufs = (".map_pair.2ctg.gz", ".map_pair.1ctg.gz", ".map_pair.gap.gz",
            ".map_pair.stat")
    tdir = os.path.join(workdir, "map", "torch", "out")
    bad = [s for s in sufs if _digest(os.path.join(mdir, base + s))
           != _digest(os.path.join(tdir, base + s))]
    if bad:
        raise AssertionError(f"(c) map_pair --mesh 4 != phase 13's: {bad}")
    _log(f"(c) map_pair --mesh 4 == phase 13's torch engine: {len(sufs)} "
         "files (the index copied to each slot: no collective)")

    # (d) the genome as one sequence, cut along its bases
    genome = dna.ascii_to_codes(make_genome(GENOME_LEN, seed=42))
    codes, lengths = halo.pad_seqs_for_mesh([genome], MESH_SLOTS, 31)
    uniq, counts, _, stats = run(
        f"(d) count_halo_sharded, one sequence of {GENOME_LEN} bases, k 31, "
        f"{MESH_SLOTS} tiles", lambda: halo.count_halo_sharded(
            codes, lengths, ksize=31, mesh=mesh,
            capacity=codes.size // MESH_SLOTS + 64))
    u = torch.cat([x.cpu() for x in uniq]).numpy().view(np.uint64)
    cn = torch.cat([x.cpu() for x in counts]).numpy()
    order = np.argsort(u)
    kc = KmerCounter(31, device="cuda")
    kc.add(genome[None], np.array([len(genome)], np.int32))
    su, sc, total = kc.finalize()
    if not (np.array_equal(u[order], su) and np.array_equal(cn[order], sc)
            and stats["total_kmers"] == total and stats["dropped"] == 0):
        raise AssertionError("(d) count_halo_sharded != single-device count")
    _log(f"(d) count_halo_sharded == KmerCounter on the card: {len(su)} "
         f"species, {total} k-mers, {stats['dropped']} dropped")

    # (e) the small workflow, mesh_devices=4 against 0
    d = os.path.join(workdir, "mesh_small")
    libs = generate_dataset(os.path.join(d, "sim"), 200_000, 150, 20.0,
                            (400, 800), seed=7)["libs"]

    def workflow_run(slots):
        cfg = workflow.PipelineConfig(correct_k=13, init_hash_size=0.01,
                                      map_min_read=100, readout="doubling",
                                      mesh_devices=slots, device="cuda")
        with open(os.devnull, "w") as null, contextlib.redirect_stderr(null):
            return workflow.run_full(libs, cfg, os.path.join(d, f"m{slots}"))

    _phase_wall("(e) run_full, 200 kb, mesh_devices=0, --readout doubling",
                lambda: workflow_run(0))
    run("(e) run_full, 200 kb, mesh_devices=4", lambda: workflow_run(4))
    trees = [_tree(os.path.join(d, f"m{s}")) for s in (0, MESH_SLOTS)]
    bad = sorted(set(trees[0]) ^ set(trees[1])) + [
        k for k in trees[0] if k in trees[1] and trees[0][k] != trees[1][k]]
    if bad:
        raise AssertionError(f"(e) mesh_devices=4 != 0: {bad}")
    _log(f"(e) run_full mesh_devices=4 == mesh_devices=0 on the card: "
         f"{len(trees[0])} files")
    return totals


def phase_mesh_kernels(chop, srt, kern: dict, sort_rec: dict,
                       files: list[str]) -> None:
    """The chop and the radix sort at the shapes the 4-slot ingest gives
    them: one slot's quarter of an ingest batch (the chop with edges), its
    owner bucketing (the sort on the owners' 3 bits, with the index) and
    one owner's arrivals from the four slots (62 bits, with the index),
    each == its plain version and timed beside it; the numbers go into
    the kernels' records under _mesh_slot, _mesh_route and _mesh_owner."""
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.ops.chop import SENTINEL
    c = torch.from_numpy(fastq.read_batch(
        files[0], keep_heads=False).codes[:100_000]).cuda()
    L = c.shape[1]
    lengths = torch.full((c.shape[0],), L, dtype=torch.int32, device="cuda")
    n = c.shape[0] // MESH_SLOTS
    codes, lens = c[:n].contiguous(), lengths[:n]
    got = chop.chop(codes, lens, 31, True)
    torch.cuda.synchronize()
    err = _max_abs_err(got, chop.chop_plain(codes, lens, 31, True))
    if err != 0:
        raise AssertionError(f"chop kernel differs from chop_plain at one "
                             f"slot's {n}x{L}: max abs err {err}")
    what = f"chop {n}x{L} k=31 edges=True (one of {MESH_SLOTS} slots)"
    ms, plain_ms = _turns(what, lambda: chop.chop(codes, lens, 31, True),
                          lambda: chop.chop_plain(codes, lens, 31, True))
    bound_ms, bound_by = _bound(n * L + 4 * n + n * (L - 30) * 10)
    kern.update({"ms_mesh_slot": ms, "plain_ms_mesh_slot": plain_ms,
                 "bound_ms_mesh_slot": bound_ms,
                 "bound_by_mesh_slot": bound_by})
    flat = got[0].reshape(-1)
    owner = torch.where(flat == SENTINEL, MESH_SLOTS, flat % MESH_SLOTS)
    per = torch.bincount(owner, minlength=MESH_SLOTS + 1)[:MESH_SLOTS]
    _log(f"owner shares of one slot's {int(per.sum())} k-mers (k-mer mod "
         f"{MESH_SLOTS}): {(per / per.sum()).tolist()}")
    _sort_shape(srt, sort_rec, "mesh_route", owner, MESH_SLOTS.bit_length(),
                True)
    keys = chop.chop(c, lengths, 31)[0].reshape(-1)
    _sort_shape(srt, sort_rec, "mesh_owner", keys[keys % MESH_SLOTS == 0],
                62, True)
    del c, lengths, codes, lens, got, flat, owner, keys
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 17
LAUNCH_TIMEOUT_S = 600


def _launch_ranks(workdir: str, lib: str, name: str, n_proc: int,
                  local: int, backend: str) -> list[dict]:
    """The multi-process launcher (tools/launch_distributed.py) as n_proc
    processes of ``local`` slots each on this card, at phase 6's pair;
    returns each rank's stats line.  Every process is waited for, and
    killed if it outlives LAUNCH_TIMEOUT_S."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = os.path.join(workdir, name)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dbg_assembly_tpu_torch.tools."
         "launch_distributed", "--coordinator", f"localhost:{port}",
         "--num-processes", str(n_proc), "--process-id", str(pid), "--lib",
         lib, "-k", "31", "--max-read-len", str(READ_LEN), "--batch-reads",
         "100000", "--local-slots", str(local), "--device", "cuda",
         "--backend", backend, "--out", out], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n_proc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    stats = []
    for pid, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"launcher rank {pid} ({backend}) exited "
                                 f"{p.returncode}:\n{log[-3000:]}")
        for line in log.splitlines():
            if "] stats {" in line:
                stats.append(json.loads(line.split(" stats ", 1)[1]))
            else:
                _log(f"  {line}")
    return stats


def _check_shards(title: str, out: str, n_proc: int, table) -> None:
    """The union of the ranks' .npz shards == the node table (counters
    saturated at 255 as NodeTable's), and .dist.json's total == its."""
    z = [np.load(f"{out}.p{pid}.npz") for pid in range(n_proc)
         if os.path.exists(f"{out}.p{pid}.npz")]
    kmers = np.concatenate([x["kmers"] for x in z])
    order = np.argsort(kmers)
    if len(np.unique(kmers)) != len(kmers):
        raise AssertionError(f"{title}: owner shards overlap")
    bad = [] if np.array_equal(kmers[order], table.kmers) else ["kmers"]
    for f in ("lcnt", "rcnt"):
        got = np.minimum(np.concatenate([x[f] for x in z])[order], 255)
        if not np.array_equal(got, getattr(table, f)):
            bad.append(f)
    with open(out + ".dist.json") as f:
        meta = json.load(f)
    if bad or meta["total_kmers"] != table.total_kmers:
        raise AssertionError(f"{title}: shards != phase 9's node table: "
                             f"{bad}, total_kmers {meta['total_kmers']} vs "
                             f"{table.total_kmers}")
    _log(f"{title}: {len(z)} shard files == phase 9's node table "
         f"({len(kmers)} nodes; kmers, lcnt, rcnt), total_kmers "
         f"{meta['total_kmers']}, n_devices {meta['n_devices']}")


def phase_multiprocess(workdir: str, lib: str, files: list[str],
                       table) -> dict:
    """(a) the launcher over nccl, one process of four slots, and (b) over
    gloo, two processes of two slots on the one card, each == phase 9's
    node table; (c) count_spectrum_fast at the JAX benchmark's batch, card
    == CPU == the capped histogram of count_unique_fast's counts (with the
    last-run rule); (d) contig_stage_step on phase 9's table at cut 2,
    card == CPU.  Returns the chop's and the sort's launches in (a)+(b)
    and in (c)."""
    from dbg_assembly_tpu_torch.contig import pointer_doubling as pd
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.kmer import count, stats
    from dbg_assembly_tpu_torch.ops import chop
    from dbg_assembly_tpu_torch.ops import sort as srt
    torch.cuda.empty_cache()
    multi = {"chop": 0, "radix_sort": 0}
    for title, name, n_proc, local, backend in (
            ("(a) launcher, nccl, 1 process x 4 slots", "mp_nccl", 1, 4,
             "nccl"),
            ("(b) launcher, gloo, 2 processes x 2 slots on one card",
             "mp_gloo", 2, 2, "gloo")):
        t = time.perf_counter()
        runs = _launch_ranks(workdir, lib, name, n_proc, local, backend)
        _log(f"{title}: wall {time.perf_counter() - t:.3f} s, the "
             "processes started and joined (peaks below are each rank's)")
        for pid, st in enumerate(runs):
            _log(f"{title}, rank {pid}: wall {st['wall_s']:.3f} s, peak "
                 f"device memory {st['peak_device_bytes']} B, launches "
                 f"{st['launches']}, steps {st['steps']} ({st['empty_steps']}"
                 f" empty), capacity doublings {st['capacity_doublings']}, "
                 f"bytes within the rank {st['bytes_within']}, across ranks "
                 f"{st['bytes_across']}")
            for k, n in st["launches"].items():
                if n <= 0:
                    raise AssertionError(f"{title}: rank {pid} never "
                                         f"launched the {k} kernel")
                multi[k] += n
        _check_shards(title, os.path.join(workdir, name), n_proc, table)

    # (c) the spectrum at the JAX benchmark's batch (bench.py:42-45)
    b = fastq.read_batch(files[0], keep_heads=False)
    codes = torch.from_numpy(b.codes[:250_000]).cuda()
    lengths = torch.from_numpy(b.lengths[:250_000]).cuda()
    chop.launches = srt.launches = 0
    got = count.count_spectrum_fast(codes, lengths, 31, 255)
    torch.cuda.synchronize()
    spec_launches = {"chop": chop.launches, "radix_sort": srt.launches}
    _log(f"(c) count_spectrum_fast, {codes.shape[0]} x {codes.shape[1]}, "
         f"k 31, max_freq 255: launches {spec_launches}")
    if min(spec_launches.values()) <= 0:
        raise AssertionError("(c) count_spectrum_fast launched no kernel")
    cpu = count.count_spectrum_fast(codes.cpu(), lengths.cpu(), 31, 255)
    if not (torch.equal(got[0].cpu(), cpu[0]) and got[1:] == cpu[1:]):
        raise AssertionError("(c) count_spectrum_fast: card != CPU")
    _, counts, _, _ = count.count_unique_fast(codes, lengths, 31)
    c = counts[counts > 0].cpu().numpy()
    want = np.bincount(np.minimum(c, 255), minlength=256)
    n_windows = codes.shape[0] * (codes.shape[1] - 30)
    moved = got[2] == n_windows        # no invalid window: no SENTINEL tail
    if moved:
        want[min(int(c[-1]), 255)] -= 1
        want[255] += 1
    if not np.array_equal(got[0].cpu().numpy(), want):
        raise AssertionError("(c) spectrum != the capped histogram of "
                             "count_unique_fast's counts")
    _log(f"(c) card == CPU == the capped histogram of count_unique_fast's "
         f"counts: {got[1]} species, {got[2]} k-mers" + (
             f"; the batch has no invalid window, so the largest k-mer's "
             f"run ({int(c[-1])}) moved to bin 255 (the last-run rule)"
             if moved else ""))
    ms = _cuda_ms(lambda: count.count_spectrum_fast(codes, lengths, 31, 255),
                  5)
    flat, _ = count.chop_canonical(codes, lengths, 31)
    tail_ms = _cuda_ms(lambda: stats.spectrum_sorted(flat, 255), 5)
    _log(f"(c) count_spectrum_fast {ms:.4f} ms (CUDA events, mean of 5), "
         f"{got[2] / ms * 1e3:.6g} k-mers/s; the stats tail "
         f"(spectrum_sorted) alone {tail_ms:.4f} ms")
    del codes, lengths, flat, counts
    torch.cuda.empty_cache()

    # (d) the device contig stage on phase 9's table (bench.py:247)
    args = [torch.from_numpy(table.kmers.view(np.int64)),
            torch.from_numpy(table.lcnt), torch.from_numpy(table.rcnt)]
    dev_args = [x.cuda() for x in args]
    out = []
    wall = _phase_wall(f"(d) contig_stage_step, {table.n_nodes} nodes, "
                       "cut 2, on the card", lambda: out.append(
                           pd.contig_stage_step(*dev_args, k=31, cut=2)))
    t = time.perf_counter()
    want = pd.contig_stage_step(*args, k=31, cut=2)
    cpu_wall = time.perf_counter() - t
    names = ("l_num", "r_num", "linear", "e", "dist", "cyclic")
    bad = [n for n, g, w in zip(names, out[0], want)
           if not torch.equal(g.cpu(), w)]
    if bad:
        raise AssertionError(f"(d) contig_stage_step: card != CPU: {bad}")
    _log(f"(d) contig_stage_step card == CPU, all six outputs ({wall:.3f} "
         f"s on the card, {cpu_wall:.3f} s on the CPU); linear "
         f"{int(out[0][2].sum())} nodes, cyclic {int(out[0][5].sum())} "
         "states")
    del out, dev_args
    torch.cuda.empty_cache()
    return {"multiprocess": multi, "spectrum": spec_launches}


# ---------------------------------------------------------------- phase 18
MAP_PY_PAIRS = 25_000
class _RssPeak:
    """The largest resident memory of this process (VmRSS) seen while the
    block runs, sampled every 20 ms by a thread, and getrusage's lifetime
    peak after it (the machine's /proc has no VmHWM to reset)."""

    def __enter__(self):
        import threading
        self.start = self.peak = _rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, _rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        import resource
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss())
        self.lifetime = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        return False


def _twin_run(title: str, fn, kernels: dict, totals: dict,
              need=("chop", "radix_sort")):
    """fn() with every kernel count set to 0 just before and read just
    after (each kernel in ``need`` must have launched), timed on the host
    clock with the card synchronised, with its peak host memory; returns
    (fn's result, wall s)."""
    for mod in kernels.values():
        mod.launches = 0
    with _RssPeak() as mem:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = {n: m.launches for n, m in kernels.items()}
    _log(f"{title}: wall {wall:.3f} s, peak host memory {mem.peak} B, "
         f"{mem.peak - mem.start} B over its start (VmRSS sampled every 20 "
         f"ms; getrusage's lifetime peak {mem.lifetime} B), kernel launches "
         f"{counts}")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{title} never launched the {name} kernel")
    for name, n in counts.items():
        totals[name] += n
    return out, wall


def _digest_gz(path: str) -> str:
    """_digest of a gzip stream whatever its name (correct_error's .cor)."""
    import gzip
    import hashlib
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    if not gz:
        return _digest(path)
    with gzip.open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def _flag(name: str):
    """Environment flag ``name`` = 1 inside the block."""
    os.environ[name] = "1"
    try:
        yield
    finally:
        del os.environ[name]


def phase_hosttwins(workdir: str, lib: str, files: list[str],
                    hard_files: list[str], prefix: str, contigs: str,
                    table, kernels: dict) -> dict:
    """The host twins of the JAX package: (a) the 8-bit table at k 15 on
    the card against the 1-bit table and a KmerCounter; the 25 000-pair
    library's 8-bit tables at k 15 and k 8 (counts over 255) on the card
    == --device cpu's, and correct_error -l 1 on the card's k 15 table ==
    on the CPU's; (b) DBG_PY_ASSEMBLE=1 debruijn_contig == phase 8's
    exact run, its readout timed beside the native one; (c) DBG_PY_MAP=1
    map_pair == the torch engine on the card, phase 13's flags, on the
    first MAP_PY_PAIRS pairs; (d) DBG_PY_FASTQ=1 read_batch == the native
    parser.  Returns the chop's and the sort's launches over (a) and
    (b)."""
    from dbg_assembly_tpu_torch import cli
    from dbg_assembly_tpu_torch.contig import refassemble
    from dbg_assembly_tpu_torch.io import cz as czio
    from dbg_assembly_tpu_torch.io import fastq
    from dbg_assembly_tpu_torch.kmer import kmerfreq
    from dbg_assembly_tpu_torch.kmer.count import KmerCounter
    d = os.path.join(workdir, "hosttwins")
    os.makedirs(d)
    totals = dict.fromkeys(kernels, 0)

    # (a) the 8-bit table
    p8, p1 = os.path.join(d, "k15_8bit"), os.path.join(d, "k15_1bit")
    _twin_run("(a) kmerfreq.run(table_format='8bit') k 15",
              lambda: kmerfreq.run(lib, ksize=15, table_format="8bit",
                                   out_prefix=p8, device="cuda"),
              kernels, totals)
    _twin_run("(a) kmerfreq.run k 15 (1-bit)",
              lambda: kmerfreq.run(lib, ksize=15, out_prefix=p1,
                                   device="cuda"), kernels, totals)
    freqs = czio.read_cz_bytes(p8 + ".cz", 15)
    if not np.array_equal(np.packbits(freqs > 1),
                          czio.read_cz_bits(p1 + ".cz", 15)):
        raise AssertionError("(a) the 8-bit table's > 1 bits != the 1-bit "
                             "table")
    with open(p8 + ".stat", "rb") as f1, open(p1 + ".stat", "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("(a) 8-bit .stat != 1-bit .stat")
    counter = KmerCounter(15, device="cuda")
    for path in files:
        b = fastq.read_batch(path, keep_heads=False)
        counter.add(b.codes, b.lengths)
    u, c, _ = counter.finalize()
    if not (np.array_equal(freqs[u.astype(np.int64)], np.minimum(c, 255))
            and np.count_nonzero(freqs) == len(u)):
        raise AssertionError("(a) 8-bit table != min(count, 255) of a "
                             "KmerCounter at k 15")
    _log(f"(a) 8-bit table (4^15 B) == packed 1-bit table at > 1 and == "
         f"min(count, 255) of KmerCounter(15): {len(u)} species, "
         f"{int((freqs == 255).sum())} saturated")
    del freqs, counter, u, c
    # the 25 000-pair library's tables, card == CPU: at k 15 (corrected
    # on below) and at k 8, where some k-mers count over 255
    tabs = {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        hlib, _ = _mirror(hard_files, os.path.join(d, "hard_" + where))
        tabs[where] = hlib
        for k in (15, 8):
            _twin_run(f"(a) kmerfreq.run(table_format='8bit') k {k}, "
                      f"25 000 pairs, --device {dev}",
                      lambda: kmerfreq.run(
                          hlib, ksize=k, table_format="8bit", device=dev,
                          out_prefix=f"{hlib}.k{k}"), kernels, totals,
                      need=("chop", "radix_sort") if where == "card" else ())
    for k in (15, 8):
        for suf in (".cz", ".cz.len", ".stat"):
            if _digest(f"{tabs['card']}.k{k}{suf}") != \
                    _digest(f"{tabs['host']}.k{k}{suf}"):
                raise AssertionError(f"(a) card 8-bit k {k} {suf} != CPU's")
    k8 = czio.read_cz_bytes(tabs["card"] + ".k8.cz", 8)
    if not (k8 == 255).any():
        raise AssertionError("(a) no k-mer of the k 8 table saturated")
    _log(f"(a) 25 000 pairs: card 8-bit tables == --device cpu's at k 15 "
         f"and k 8 (k 8: {int((k8 > 0).sum())} indexes set, "
         f"{int((k8 == 255).sum())} saturated at 255)")
    # correct_error on each table; -l 1 as the library's depth is 1.6x
    cor = {}
    for where in tabs:
        _twin_run(f"(a) correct_error -k 15 -l 1 (25 000 pairs, the "
                  f"{where}'s table)",
                  lambda: cli.main(["correct_error", "-k", "15", "-l", "1",
                                    tabs[where] + ".k15.cz", tabs[where]]),
                  kernels, totals, need=())
        hfiles = [ln.strip() for ln in open(tabs[where]) if ln.strip()]
        cor[where] = [_digest_gz(f + s) for f in hfiles
                      for s in (".cor", ".cor.stat", ".cor.pair.fa.gz",
                                ".cor.single.fa.gz",
                                ".cor.pair.single.stat")
                      if os.path.exists(f + s)]
    if len(cor["card"]) != 7 or cor["card"] != cor["host"]:
        raise AssertionError(f"(a) correct_error on the card's table != on "
                             f"the CPU's ({len(cor['card'])} files)")
    kept = fixed = 0
    for f in hfiles:
        with open(f + ".cor.stat") as sf:
            st = [ln.strip() for ln in sf if ln.strip()]
        kv = dict(ln.rsplit(" ", 1) for ln in st)
        kept += int(kv["num_result_reads"])
        fixed += int(kv["num_corrected_bases_by_two_methods"])
        _log(f"(a) {os.path.basename(f)}.cor.stat: " + ", ".join(st))
    if kept <= 0 or fixed <= 0:
        raise AssertionError(f"(a) correct_error kept {kept} reads, "
                             f"corrected {fixed} bases")
    _log(f"(a) correct_error -l 1 on the card's table == on the CPU's: "
         f"{len(cor['card'])} files; {kept} reads kept, {fixed} bases "
         "corrected")

    # (b) the Python assembler
    pyprefix = os.path.join(d, "asm_py")
    timed = {}
    run_orig = refassemble.RefAssembler.run

    def run_timed(self, prefix):
        t = time.perf_counter()
        st = run_orig(self, prefix)
        timed["readout"] = time.perf_counter() - t
        return st

    refassemble.RefAssembler.run = run_timed
    try:
        with _flag("DBG_PY_ASSEMBLE"), \
                open(os.path.join(d, "contig_py.log"), "w") as logf, \
                contextlib.redirect_stderr(logf):
            _twin_run("(b) DBG_PY_ASSEMBLE=1 debruijn_contig -k 31 -i 0.02 "
                      "-M 125",
                      lambda: cli.main(["debruijn_contig", "-k", "31", "-i",
                                        "0.02", "-M", "125", "-o", pyprefix,
                                        "--device", "cuda", lib]),
                      kernels, totals)
    finally:
        refassemble.RefAssembler.run = run_orig
    bad = [s for s in CONTIG_SUFFIXES
           if _digest(pyprefix + s) != _digest(prefix + s)]
    logs = []
    for path, pre in ((os.path.join(d, "contig_py.log"), pyprefix),
                      (os.path.join(workdir, "contig.log"), prefix)):
        with open(path) as f:
            logs.append(re.sub(r"(Run time: )[0-9.e+-]+", r"\1X", f.read())
                        .replace(pre, "P"))
    if bad or logs[0] != logs[1]:
        raise AssertionError(f"(b) DBG_PY_ASSEMBLE=1 != phase 8's exact run:"
                             f" {bad}, run logs equal: {logs[0] == logs[1]}")
    nprefix = os.path.join(d, "asm_native")
    asm = refassemble.RefAssembler(table, refassemble.AssembleParams(
        ksize=31, init_hash_size=0.02, contig_len_cutoff=125))
    t = time.perf_counter()
    asm.run(nprefix)
    native_s = time.perf_counter() - t
    bad = [s for s in CONTIG_SUFFIXES
           if _digest(nprefix + s) != _digest(prefix + s)]
    if bad:
        raise AssertionError(f"(b) native readout of phase 9's table != "
                             f"phase 8's exact run: {bad}")
    _log(f"(b) DBG_PY_ASSEMBLE=1 == phase 8's exact run: "
         f"{len(CONTIG_SUFFIXES)} files and the run log; readout "
         f"(RefAssembler.run) {timed['readout']:.3f} s in Python, "
         f"{native_s:.3f} s native on phase 9's table ({table.n_nodes} "
         "nodes)")
    del asm

    # (c) the numpy index and mapper, on the first MAP_PY_PAIRS pairs (all
    # 613 333 take about 240 s on the H100 machine's host, 100 000 from 18
    # to 59 s); the torch engine maps the same pairs on the card as the
    # reference
    cut = []
    for path in files:
        cut.append(os.path.join(d, "cut_" + os.path.basename(path)))
        with open(path, "rb") as src, open(cut[-1], "wb") as dst:
            dst.writelines(itertools.islice(src, 4 * MAP_PY_PAIRS))
    sufs = (".map_pair.2ctg.gz", ".map_pair.1ctg.gz", ".map_pair.gap.gz",
            ".map_pair.stat")
    base = os.path.basename(cut[0])
    digests = {}
    for name, flag, need in (("torch", None, ("radix_sort",)),
                             ("python", "DBG_PY_MAP", ())):
        mlib, _ = _mirror(cut, os.path.join(d, "map_" + name))
        mdir = os.path.join(d, "map_" + name, "out")
        with _flag(flag) if flag else contextlib.nullcontext():
            _twin_run(f"(c) {flag + '=1 ' if flag else ''}map_pair -k 31 -s "
                      f"5 -l 125 -r 100 -i 0.97, the first {MAP_PY_PAIRS} "
                      "pairs", lambda: cli.main(MAP_ARGV + [
                          "-o", mdir, "--device", "cuda", contigs, mlib]),
                      kernels, totals, need=need)
        digests[name] = [_digest(os.path.join(mdir, base + s)) for s in sufs]
    if digests["python"] != digests["torch"]:
        raise AssertionError("(c) DBG_PY_MAP=1 map_pair != the torch "
                             "engine's files")
    _log(f"(c) DBG_PY_MAP=1 map_pair == the torch engine on the first "
         f"{MAP_PY_PAIRS} pairs: {len(sufs)} files")

    # (d) the Python FASTQ parser
    for path in files:
        kw = dict(keep_heads=True, keep_ascii=True)
        t = time.perf_counter()
        want = fastq.read_batch(path, **kw)
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        with _flag("DBG_PY_FASTQ"):
            got = fastq.read_batch(path, **kw)
        t_py = time.perf_counter() - t
        bad = [f for f in ("codes", "quals", "lengths", "seqs_ascii")
               if not np.array_equal(getattr(got, f), getattr(want, f))]
        if bad or got.heads != want.heads:
            raise AssertionError(f"(d) DBG_PY_FASTQ=1 != native parser on "
                                 f"{os.path.basename(path)}: {bad}")
        _log(f"(d) DBG_PY_FASTQ=1 read_batch == native on "
             f"{os.path.basename(path)} ({got.n_reads} reads): Python "
             f"{t_py:.3f} s, native {t_native:.3f} s")
        del got, want
    return totals


# ---------------------------------------------------------------- phase 19
SCALING_BATCH = 65536


def phase_hooks(kernels: dict) -> dict:
    """The driver hooks and the two distributed-path tools on the card:
    (a) entry()'s step == the same step with device="cpu" (uniq, counts,
    n_unique, n_valid exactly), timed with CUDA events (20 calls after a
    warm-up) and by the host ms a call; (b) dryrun_multichip(4), its
    wall; (c) verify_comm_volume at its shape (N 1024 x L 150, k 31, 8
    slots): every byte count, dropped and capacity doubling == the same
    tool's run on the CPU in this process (the bytes do not depend on the
    device), then its report, with the model's band on the raw step; (d)
    measure_scaling at SCALING_BATCH reads, its table printed (it raises
    unless the exact step's merged tables are equal at 1, 2, 4 and 8
    slots).  Returns the chop's and the sort's launches over the four
    runs."""
    from dbg_assembly_tpu_torch import graft_entry
    from dbg_assembly_tpu_torch.tools import measure_scaling
    from dbg_assembly_tpu_torch.tools import verify_comm_volume as vcv
    totals = dict.fromkeys(kernels, 0)

    def counted(title: str, fn, collectives: bool = True):
        out, counts = _mesh_run(title, kernels, fn, collectives=collectives)
        for name, n in counts.items():
            totals[name] += n
        return out

    # (a) the flagship step
    step, args = graft_entry.entry()
    got = counted("(a) entry() step, count_unique_fast [256, 150] at k 31",
                  lambda: step(*args), collectives=False)
    cstep, cargs = graft_entry.entry("cpu")
    want = cstep(*cargs)
    if not (torch.equal(got[0].cpu(), want[0])
            and torch.equal(got[1].cpu(), want[1]) and got[2:] == want[2:]):
        raise AssertionError("(a) entry() step on the card != on the CPU")
    ev = _cuda_ms(lambda: step(*args))
    host = _host_ms(lambda: step(*args))
    _log(f"(a) entry() step on the card == on the CPU: {got[2]} unique of "
         f"{got[3]} k-mers; {ev:.4f} ms a call (CUDA events, 20 calls after "
         f"a warm-up), host {host:.4f} ms a call")

    # (b) the distributed dry run, reads to scaffolds
    counted("(b) dryrun_multichip(4)",
            lambda: graft_entry.dryrun_multichip(4))
    _log("(b) dryrun_multichip(4): every stage's check passed")

    # (c) the communication volume, card against CPU
    codes, lengths = vcv.tool_batch()
    card = counted("(c) verify_comm_volume, 8 slots",
                   lambda: vcv.measure(codes, lengths, vcv.TOOL_K, 8,
                                       "cuda"))
    cpu = vcv.measure(codes, lengths, vcv.TOOL_K, 8, "cpu")
    keys = ("bytes", "dropped", "capacity", "capacity_doublings")
    for name in ("graph_ingest_step", "graph_ingest_step_exact"):
        if ({k: card[name][k] for k in keys}
                != {k: cpu[name][k] for k in keys}):
            raise AssertionError(f"(c) {name} on the card {card[name]} != "
                                 f"on the CPU {cpu[name]}")
    if card["record_bytes"] != cpu["record_bytes"]:
        raise AssertionError("(c) routed record bytes differ")
    vcv.report(card)
    _log("(c) verify_comm_volume: every byte count, dropped and doubling "
         "on the card == on the CPU")

    # (d) the ingest step's scaling curve over slots sharing the card
    rows = counted(f"(d) measure_scaling {SCALING_BATCH}",
                   lambda: measure_scaling.run(SCALING_BATCH, "cuda"))
    _log(measure_scaling.table(rows, SCALING_BATCH))
    _log("(d) measure_scaling: the exact step's merged node tables are "
         "equal at 1, 2, 4 and 8 slots")
    return totals


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
        from dbg_assembly_tpu_torch.ops import rc_expand as rce
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
    sources = ["chop", "radix_sort", "rc_expand",
               *("probe_" + n for n in probes.PROBES)]
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as ex:
        jobs = {f"{src}.cu (nvcc)": ex.submit(_timed, build.build, src)
                for src in sources}
        jobs["native/ (make)"] = ex.submit(_timed, native.build)
        _log("build: " + ", ".join(f"{name} {fut.result():.2f} s"
                                   for name, fut in jobs.items()))
    for src in sources:
        _log(f"ptxas, {src}.cu: " + " | ".join(build.resources(src)))

    probe_launches = phase_triage()
    t = time.perf_counter()
    probe_recs = phase_probes(probes)
    _log(f"phase 4: {time.perf_counter() - t:.1f} s")
    kern = phase_kernel(chop)
    rc_rec = phase_rc_expand(rce)

    with tempfile.TemporaryDirectory() as workdir:
        t = time.perf_counter()
        lib, files, n_reads = make_library(workdir)
        _log(f"library: {n_reads} reads of {READ_LEN} bp, genome "
             f"{GENOME_LEN}, {DEPTH}x, {time.perf_counter() - t:.1f} s")
        sort_rec = phase_sort(srt, chop, files)
        kernels = {"chop": chop, "radix_sort": srt}
        launches, prefix, dprefix = phase_slice(workdir, lib, kernels)
        cz = lib + ".kmer.freq.cz"
        cfiles = phase_correct(workdir, cz, "ecoli", files, n_reads,
                               kernels, 0.05)
        hard_files, hard_n = make_hard_library(workdir)
        phase_correct(workdir, cz, "hard", hard_files, hard_n, kernels, None)
        soiled = phase_clean(workdir, files)
        contigs = prefix + ".contig.seq.fa"
        map_launches = phase_map(workdir, files, contigs, kernels)
        launches["radix_sort"] += map_launches
        phase_map_index(srt, contigs, sort_rec)
        map_reads_launches = phase_map_reads(workdir, contigs, kernels)
        launches["radix_sort"] += map_reads_launches
        workflow_launches = phase_workflow(workdir, soiled, kernels)
        for name, n in workflow_launches.items():
            launches[name] += n
        phase_workflow_small(workdir)
        if "--profile" in sys.argv[1:]:
            pdir = os.path.join(workdir, "prof_map")
            plib, _ = _mirror(files, pdir)
            extra = [(f"{title} (first soiled file)", argv)
                     for title, argv, _ in _clean_argv(
                         soiled[0], os.path.dirname(plib))]
            extra.append(("map_pair -k 31 -s 5 -l 125 -r 100 -i 0.97",
                          MAP_ARGV + ["-o", os.path.join(pdir, "out"),
                                      contigs, plib]))
            extra.append(("workflow.run_full (phase 15 a)",
                          lambda: _run_workflow(
                              os.path.join(workdir, "prof_workflow"),
                              soiled)))
            extra.append(("debruijn_contig --mesh 4 (phase 16 a)",
                          ["debruijn_contig", "-k", "31", "-i", "0.02", "-M",
                           "125", "--mesh", str(MESH_SLOTS), "-o",
                           os.path.join(workdir, "prof_mesh"), lib]))
            phase_profile(workdir, lib, cz, files, extra)
            phase_correct_steps(cz, cfiles)
            phase_clean_map_steps(workdir, soiled, files, contigs)
            phase_workflow_steps(workdir, soiled, files)
        phase_doubling_oracle(workdir, prefix, dprefix)
        table = phase_oracle(files, lib)
        phase_doubling_steps(table, workdir)
        mesh_launches = phase_mesh(workdir, lib, files, n_reads, table,
                                   dprefix, cfiles, contigs, kernels)
        for name, n in mesh_launches.items():
            launches[name] += n
        phase_mesh_kernels(chop, srt, kern, sort_rec, files)
        mp_launches = phase_multiprocess(workdir, lib, files, table)
        for part in mp_launches.values():
            for name, n in part.items():
                launches[name] += n
        twin_launches = phase_hosttwins(workdir, lib, files, hard_files,
                                        prefix, contigs, table, kernels)
        for name, n in twin_launches.items():
            launches[name] += n
        t = time.perf_counter()
        hook_launches = phase_hooks(kernels)
        _log(f"phase 19: {time.perf_counter() - t:.1f} s")
        for name, n in hook_launches.items():
            launches[name] += n

    records = [
        {"name": "chop", "route": "cuda",
         "source": "dbg_assembly_tpu_torch/ops/csrc/chop.cu",
         "replaces": "dbg_assembly_tpu/ops/pallas_chop.py:81",
         "launches": launches["chop"],
         "launches_pipeline": workflow_launches["chop"],
         "launches_mesh": mesh_launches["chop"],
         "launches_multiprocess": mp_launches["multiprocess"]["chop"],
         "launches_spectrum": mp_launches["spectrum"]["chop"],
         "launches_hosttwins": twin_launches["chop"],
         "launches_hooks": hook_launches["chop"], **kern},
        {"name": "radix_sort", "route": "cuda",
         "source": "dbg_assembly_tpu_torch/ops/csrc/radix_sort.cu",
         "replaces": "dbg_assembly_tpu/ops/pallas_sort.py:236",
         "launches": launches["radix_sort"],
         "launches_map_pair": map_launches,
         "launches_map_reads": map_reads_launches,
         "launches_pipeline": workflow_launches["radix_sort"],
         "launches_mesh": mesh_launches["radix_sort"],
         "launches_multiprocess": mp_launches["multiprocess"]["radix_sort"],
         "launches_spectrum": mp_launches["spectrum"]["radix_sort"],
         "launches_hosttwins": twin_launches["radix_sort"],
         "launches_hooks": hook_launches["radix_sort"],
         **sort_rec}]
    records.append({
        "name": "rc_expand", "route": "cuda",
        "source": "dbg_assembly_tpu_torch/ops/csrc/rc_expand.cu",
        "replaces": "none: host numpy, dbg_assembly_tpu/kmer/count.py "
                    "expand_bitmap_rc",
        "launches": rce.launches, **rc_rec})
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
