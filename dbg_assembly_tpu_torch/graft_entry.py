"""Driver hooks: the flagship step and one distributed run, reads to
scaffolds.

Counterpart of __graft_entry__.py.  entry() returns the flagship step,
the canonical k-mer chop + sort + run-length count that feeds both k-mer
counting and de Bruijn graph construction, with its inputs.
dryrun_multichip(n) runs the whole distributed path over an n-slot mesh
(parallel/mesh.data_mesh: slot d on cuda:(d mod cards), so four slots
share one card where the machine has one).

    python -m dbg_assembly_tpu_torch.graft_entry [--device cuda|cpu]

runs entry()'s step once, then dryrun_multichip(4), and prints
``dryrun ok``.  ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import gzip
import os
import tempfile

import numpy as np
import torch

from . import resolve_device

ENTRY_K = 31


def entry(device="cuda"):
    """(step, (codes, lengths)): step(codes, lengths) is the production
    per-batch counting step (what KmerCounter and kmerfreq run) at k 31,
    returning (uniq, counts, n_unique, n_valid) as
    kmer.count.count_unique_fast; the inputs are JAX's entry() batch,
    [256, 150] uint8 codes and int32 lengths, on ``device``."""
    from .kmer import count as kc
    dev = resolve_device(device)

    def step(codes, lengths):
        return kc.count_unique_fast(codes, lengths, ENTRY_K)

    rng = np.random.default_rng(0)
    N, L = 256, 150
    codes = torch.from_numpy(
        rng.integers(0, 4, size=(N, L)).astype(np.uint8)).to(dev)
    lengths = torch.from_numpy(np.full(N, L, np.int32)).to(dev)
    return step, (codes, lengths)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _write_fq(path: str, reads: np.ndarray, mate: int) -> None:
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = reads.shape[1]
    with gzip.open(path, "wb") as f:
        for i, row in enumerate(reads):
            f.write(b"@p%d/%d\n" % (i, mate) + acgt[row].tobytes()
                    + b"\n+\n" + b"I" * L + b"\n")


def _dryrun(n_devices: int, workdir: str, device="cuda"):
    """The five stages of dryrun_multichip in ``workdir``, JAX's inputs,
    seeds and checks: (1) the 5-phase corrector with the reads
    data-parallel and the k 11 table sharded over the slots; (2) ingest
    through GraphBuilder(mesh=), the exact capacity-doubling step; (3) the
    mesh contig stage (links, pruning, doubling readout); (4) map_pair
    with the read batches sharded, equal to the single-device mapping byte
    for byte; (5) scaffolding from the mesh-mapped pairs, which joins the
    two contigs across the unsequenced gap.  Returns the paths of the
    contig FASTA, the mesh .map_pair.2ctg.gz and the scaffold FASTA."""
    from .contig.graph import GraphBuilder
    from .contig.mesh_assemble import assemble_doubling_mesh
    from .contig.refassemble import AssembleParams
    from .correct import sharded as csh
    from .correct.engine import CorrectParams
    from .kmer import count as kc
    from .parallel import mesh as meshmod
    from .scaffold import map_pair, scaffold

    m = meshmod.data_mesh(n_devices, device)

    ksize = 21
    rng = np.random.default_rng(1)
    # two genome segments separated by an unsequenced gap: contig reads
    # cover each segment; pairs straddle the gap so scaffolding joins the
    # two contigs with an N run
    segA, gap, segB, L = 1500, 60, 1500, 64
    glen = segA + segB
    N = max(16 * n_devices, 768)
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    startsA = rng.integers(0, segA - L, size=N // 2)
    startsB = rng.integers(segA, glen - L, size=N - N // 2)
    starts = np.concatenate([startsA, startsB])
    codes = np.stack([genome[s:s + L] for s in starts]).astype(np.uint8)
    lengths = np.full(N, L, np.int32)
    P = L - ksize + 1

    # (1) sharded 5-phase correction, the k 11 table over the slots
    kc_k = 11
    counter = kc.KmerCounter(kc_k, device=device)
    counter.add(codes, lengths)
    uniq, counts, _ = counter.finalize()
    bm = kc.expand_bitmap_rc(kc.freq_bitmap(uniq, counts, kc_k, 1), kc_k)
    ascii_seq = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    cp = CorrectParams(ksize=kc_k, max_change=2)
    one, multi, deleted, tl, tr, am, fb = csh.correct_batch_sharded(
        m, ascii_seq, codes, lengths, csh.shard_bitmap(m, bm), cp)
    _check(am.shape == ascii_seq.shape and deleted.shape == (N,),
           f"correction shapes {am.shape}, {deleted.shape}")

    # (2) distributed ingest (GraphBuilder's mesh mode)
    gb = GraphBuilder(ksize, mesh=m)
    gb.add(codes, lengths)
    table = gb.finalize()
    _check(gb.total_kmers == N * P, f"{gb.total_kmers} k-mers != {N * P}")
    _check(table.n_nodes > 0, "empty node table")

    # (3) the mesh contig stage (links + pruning + doubling readout)
    params = AssembleParams(ksize=ksize, init_hash_size=0.0001,
                            contig_len_cutoff=100)
    stats = assemble_doubling_mesh(table, params, workdir + "/dry", m)
    _check(stats.contig_num + stats.small_num > 0, "no contigs read out")
    contig_fa = workdir + "/dry.contig.seq.fa"
    with open(contig_fa) as f:
        _check(f.read().startswith(">ctg_1\t"), "no >ctg_1 record")
    _check(stats.contig_num >= 2, "the gap should split the assembly")

    # (4) mesh-sharded map_pair (the pairs straddle the gap)
    insert = 300
    n_pairs = 48
    s1 = rng.integers(segA + gap // 2 + L - insert, segA - L, size=n_pairs)
    comp = (3 - genome)[::-1]
    r1 = np.stack([genome[s:s + L] for s in s1])
    r2 = np.stack([comp[glen - (s + insert):][:L] for s in s1])
    fq1, fq2 = workdir + "/p_1.fq.gz", workdir + "/p_2.fq.gz"
    _write_fq(fq1, r1, 1)
    _write_fq(fq2, r2, 2)
    lib = workdir + "/pairs.lib"
    with open(lib, "w") as f:
        f.write(fq1 + "\n" + fq2 + "\n")
    kw = dict(ksize=ksize, seed_kmer_num=3, min_ctg_len=100,
              min_read_len=L, min_identity=0.95, fmt=1, device=device)
    map_pair.run(contig_fa, lib, workdir + "/single_map", mesh_devices=0, **kw)
    map_pair.run(contig_fa, lib, workdir + "/mesh_map", mesh_devices=n_devices,
                 **kw)
    base = os.path.basename(fq1) + ".map_pair.2ctg.gz"
    mesh_2ctg = workdir + "/mesh_map/" + base
    with gzip.open(mesh_2ctg) as f:
        mesh_bytes = f.read()
    with gzip.open(workdir + "/single_map/" + base) as f:
        single_bytes = f.read()
    _check(mesh_bytes == single_bytes, "mesh mapping diverged")
    _check(mesh_bytes.count(b"\n") > n_pairs // 2, "pairs did not map")

    # (5) scaffold readout from the mesh-mapped pairs
    twoctg = workdir + "/twoctg.lib"
    with open(twoctg, "w") as f:
        f.write(mesh_2ctg + "\n")
    scaffold.run(contig_fa, twoctg, contig_fa, insert_size=insert,
                 pair_num_cut=3, is_mate=False)
    scaf = contig_fa + f".insert{insert}.scaffold.seq.fa"
    with open(scaf) as f:
        text = f.read()
    _check(text.startswith(">scf_1"), text[:80])
    body = "".join(ln for ln in text.splitlines() if not ln.startswith(">"))
    _check("N" in body, "no gap Ns: the contigs were not joined")
    _check(len(body) > segA, "scaffold shorter than one segment")
    return contig_fa, mesh_2ctg, scaf


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The whole distributed path, reads to scaffolds, over an n-slot mesh
    on ``device``, in a temporary directory (see _dryrun).  Raises where a
    stage's check fails, or where data_mesh raises (no card on
    "cuda")."""
    with tempfile.TemporaryDirectory() as td:
        _dryrun(n_devices, td, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    step, inputs = entry(args.device)
    uniq, counts, n_unique, n_valid = step(*inputs)
    print(f"entry: count_unique_fast on {tuple(inputs[0].shape)} at k "
          f"{ENTRY_K}: {n_unique} unique of {n_valid} k-mers "
          f"({uniq.device})", flush=True)
    dryrun_multichip(4, args.device)
    print("dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
