"""Multi-process distributed ingest over torch.distributed.

Counterpart of tools/launch_distributed.py (one process a host under
jax.distributed).  Every process takes its slice of the .lib file list
(line i goes to process i % P), cuts its reads into batches of
--batch-reads rows and runs each through the sharded ingest step
(parallel/count_sharded.graph_ingest_step_exact) over one mesh of
P x --local-slots slots (parallel/ranks.RankMesh): k-mers route to their
owner slot on whatever process holds it, and the step's statistics are
global.  Each process keeps its own slots' records.

Run one process a rank (process 0 listens at the coordinator):

  python -m dbg_assembly_tpu_torch.tools.launch_distributed \\
      --coordinator host0:29500 --num-processes 2 --process-id <i> \\
      --lib reads.lib -k 21 [--local-slots N] [--device cuda|cpu] \\
      [--backend nccl|gloo]

Outputs, as JAX's launcher's: <out>.p<pid>.npz (kmers uint64, lcnt, rcnt
int32 (unsaturated), first_idx int64 of the process's slots) where the
process holds any k-mer, and process 0's <out>.dist.json
(num_processes, n_devices = the global slot count, total_kmers).  Window j
of global slot g in a step has the stream position stream_pos + g *
(rows a slot x windows a row) + j, where stream_pos starts at pid * 10^12
and advances by rows * P * (L - k + 1) a step.  Where JAX's launcher runs
(every process the same number of steps), the files equal its files.
Where the slices differ in length, every process runs the largest count of
steps, its missing ones empty batches that add no k-mer; JAX's would wait
forever.

No hidden fallback: nccl with more ranks on a host than it has cards, or
--device cuda without a card, raises; gloo with --device cuda stages every
collective through host memory and says so.  Each process prints its
layout and, last, one line "[p<pid>] stats {json}": wall, peak device
memory, the chop's and the sort's launches, steps, capacity doublings and
the bytes moved between its own slots and sent to other processes.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..contig.graph import _merge_parts
from ..io import fastq
from ..ops import chop
from ..ops import sort as radix
from ..parallel import count_sharded, ranks
from ..parallel import mesh as meshmod

# seconds the rendezvous or any collective may wait for the other ranks
TIMEOUT_S = 600.0


def _batches(files: list[str], fmt: str, k: int, L: int, rows: int):
    """[rows, L] code blocks of the reads of ``files`` (reads shorter than
    k skipped, rows zero-padded to L), then the tail padded with empty
    rows, as JAX's launcher cuts them."""
    pend_c = np.zeros((0, L), np.uint8)
    pend_l = np.zeros((0,), np.int32)
    for path in files:
        batch = fastq.read_batch(path, fmt=fmt, strict_n=False,
                                 keep_heads=False)
        codes = np.zeros((batch.n_reads, L), np.uint8)
        w = min(L, batch.codes.shape[1])
        codes[:, :w] = batch.codes[:, :w]
        lens = np.minimum(batch.lengths, L).astype(np.int32)
        keep = lens >= k
        pend_c = np.concatenate([pend_c, codes[keep]])
        pend_l = np.concatenate([pend_l, lens[keep]])
        while len(pend_c) >= rows:
            yield pend_c[:rows], pend_l[:rows]
            pend_c, pend_l = pend_c[rows:], pend_l[rows:]
    tail_c = np.zeros((rows, L), np.uint8)
    tail_l = np.zeros((rows,), np.int32)
    tail_c[:len(pend_c)] = pend_c
    tail_l[:len(pend_l)] = pend_l
    yield tail_c, tail_l


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dbg_assembly_tpu_torch.tools.launch_distributed",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--lib", required=True,
                    help=".lib list of read files; every process takes "
                    "lines where line_index %% num_processes == process_id")
    ap.add_argument("-k", type=int, default=21)
    ap.add_argument("-f", type=int, default=1, help="1=fastq 2=fasta")
    ap.add_argument("--max-read-len", type=int, default=250)
    ap.add_argument("--batch-reads", type=int, default=100_000,
                    help="rows a process feeds a step")
    ap.add_argument("--local-slots", type=int, default=1,
                    help="shard slots this process holds")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--out", default="dist")
    a = ap.parse_args(argv)
    if a.batch_reads % a.local_slots:
        ap.error(f"--batch-reads {a.batch_reads} must divide into "
                 f"--local-slots {a.local_slots} equal blocks")

    t0 = time.perf_counter()
    pid, P = a.process_id, a.num_processes
    mesh = ranks.init(a.coordinator, P, pid, a.local_slots, a.backend,
                      a.device, TIMEOUT_S)
    dev = mesh.devices[0]
    print(f"[p{pid}] {mesh.layout()}", flush=True)
    with open(a.lib) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    my_files = [p for i, p in enumerate(files) if i % P == pid]
    print(f"[p{pid}] feeding {len(my_files)}/{len(files)} files", flush=True)

    k, L, rows = a.k, a.max_read_len, a.batch_reads
    chop.launches = radix.launches = 0
    meshmod.bytes_moved = ranks.bytes_across = 0
    parts, total_kmers = [], 0
    steps = empty_steps = doublings = 0
    stream_pos = pid * 10 ** 12           # disjoint per-process positions
    batches = _batches(my_files, "fq" if a.f == 1 else "fa", k, L, rows)
    while True:
        b = next(batches, None)
        # every rank runs the largest number of steps
        if not mesh.max_int(b is not None):
            break
        if b is None:
            b = (np.zeros((rows, L), np.uint8), np.zeros(rows, np.int32))
            empty_steps += 1
        codes, lens = b
        cs = [c.to(dev) for c in torch.from_numpy(codes).tensor_split(
            a.local_slots)]
        ls = [x.to(dev) for x in torch.from_numpy(lens).tensor_split(
            a.local_slots)]
        *rec, n_unique, stats = count_sharded.graph_ingest_step_exact(
            cs, ls, stream_pos, ksize=k, mesh=mesh)
        # this process keeps its own owner slots' records
        parts += [tuple(r[d] for r in rec) for d in range(a.local_slots)
                  if n_unique[d]]
        if len(parts) >= 8:
            parts = _merge_parts(parts, k)
        total_kmers += stats["total_kmers"]
        doublings += stats["capacity_doublings"]
        steps += 1
        stream_pos += rows * P * (L - k + 1)

    if parts:
        u, lc, rc, fi, _ = _merge_parts(parts, k)[0]
        print(f"[p{pid}] local owner shards: {u.shape[0]} nodes", flush=True)
        np.savez(f"{a.out}.p{pid}.npz", kmers=u.cpu().numpy().view(np.uint64),
                 lcnt=lc.cpu().numpy(), rcnt=rc.cpu().numpy(),
                 first_idx=fi.cpu().numpy())
    if pid == 0:
        with open(a.out + ".dist.json", "w") as f:
            json.dump({"num_processes": P, "n_devices": mesh.n,
                       "total_kmers": total_kmers}, f)
        print(f"[p0] wrote {a.out}.dist.json total_kmers={total_kmers}",
              flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[p{pid}] stats " + json.dumps({
        "wall_s": time.perf_counter() - t0, "steps": steps,
        "empty_steps": empty_steps, "capacity_doublings": doublings,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else 0,
        "launches": {"chop": chop.launches, "radix_sort": radix.launches},
        "bytes_within": meshmod.bytes_moved,
        "bytes_across": ranks.bytes_across}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
