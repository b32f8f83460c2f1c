"""Strong-scaling curve of the distributed ingest step over 1, 2, 4 and 8
slots.

Counterpart of tools/measure_scaling.py.  JAX's fixed batch (the first
argument, default 65 536 reads x 150 bp from rng(5)'s 1 Mb genome, k 21)
is sharded over n = 1, 2, 4 and 8 slots of parallel.mesh.data_mesh, and
each n gets one first call, then the best of 3, the card synchronised
around each call.  Two steps are timed: count_sharded.graph_ingest_step
at default_capacity, as JAX's tool times it (its ``dropped`` is printed:
at 4 and 8 slots the owner rule's skew drops k-mers, so it does less
work there), and graph_ingest_step_exact, the path GraphBuilder(mesh=)
runs, which drops none, so that its column compares equal work at every
n.  For each n: the wall, M k-mers a second, speedup and efficiency
against n = 1 for both steps, the bytes the collectives moved and the
exact step's capacity doublings.  Every n's merged node table (uniq,
lcnt, rcnt, first_idx, counts of the exact step) must equal n = 1's.

Slots sit on cuda:(d mod cards): on one card every slot shares it, so the
curve measures the mesh's overhead (D x the launches, D^2 exchange
pieces), not a gain.

    python -m dbg_assembly_tpu_torch.tools.measure_scaling [batch] \\
        [--device cuda|cpu]

Prints a table and writes no file (JAX's appends to DISTRIBUTED.md).
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..parallel import count_sharded
from ..parallel import mesh as meshmod

K = 21
READ_LEN = 150
SLOTS = (1, 2, 4, 8)
STEPS = {"raw": "graph_ingest_step", "exact": "graph_ingest_step_exact"}


def scaling_batch(batch: int):
    """JAX's tool's reads: ``batch`` windows of rng(5)'s 1 Mb genome."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=batch)
    codes = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    return codes, np.full(batch, READ_LEN, np.int32)


def _sync(mesh) -> None:
    for dev in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _timed(mesh, fn):
    """(fn's result, wall s, bytes moved), the card synchronised around."""
    _sync(mesh)
    before = meshmod.bytes_moved
    t = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t, meshmod.bytes_moved - before


def _merged(out) -> list[torch.Tensor]:
    """The slots' node records (uniq, lcnt, rcnt, first_idx, counts) as
    one table ordered by k-mer: owners hold disjoint k-mers."""
    cols = [torch.cat([x.cpu() for x in col]) for col in out[:5]]
    order = torch.argsort(cols[0])
    return [c[order] for c in cols]


def run(batch: int = 65536, device="cuda") -> list[dict]:
    """One row a slot count: per step its first call (s), best of 3 (s),
    k-mers a second, bytes moved a call and its stats; the exact step's
    tables compared with one slot's (raises on a difference)."""
    codes, lengths = scaling_batch(batch)
    n_kmers = batch * (READ_LEN - K + 1)
    rows, want = [], None
    for n in SLOTS:
        m = meshmod.data_mesh(n, device)
        cs, ls = meshmod.shard_batch(
            m, meshmod.pad_to_multiple(codes, n),
            meshmod.pad_to_multiple(lengths, n))
        cap = count_sharded.default_capacity(batch, READ_LEN, K, n)
        steps = {
            "raw": lambda: count_sharded.graph_ingest_step(
                cs, ls, 0, ksize=K, mesh=m, capacity=cap),
            "exact": lambda: count_sharded.graph_ingest_step_exact(
                cs, ls, 0, ksize=K, mesh=m, capacity=cap)}
        row = {"n": n, "layout": m.layout(), "capacity": cap}
        for name, fn in steps.items():
            out, first, moved = _timed(m, fn)
            best = min(_timed(m, fn)[1] for _ in range(3))
            stats = out[-1]
            row[name] = {"first_s": first, "best_s": best,
                         "rate": n_kmers / best, "bytes": moved,
                         "dropped": stats["dropped"],
                         "capacity_doublings":
                             stats.get("capacity_doublings", 0)}
            if name == "exact":
                table = _merged(out)
        if want is None:
            want = table
        elif not all(torch.equal(a, b) for a, b in zip(table, want)):
            raise AssertionError(f"{n} slots: the merged node table != "
                                 f"{SLOTS[0]} slot's")
        rows.append(row)
    for row in rows:
        for name in STEPS:
            s = row[name]
            s["speedup"] = s["rate"] / rows[0][name]["rate"]
            s["efficiency"] = s["speedup"] / row["n"]
    return rows


def table(rows: list[dict], batch: int) -> str:
    n_kmers = batch * (READ_LEN - K + 1)
    out = [f"Fixed batch {batch} reads x {READ_LEN} bp (k {K}, {n_kmers} "
           "k-mer slots), strong scaling; best of 3 after a first call",
           "",
           "| slots | layout | step | first call s | best ms | M k-mers/s "
           "| speedup | efficiency | dropped | capacity doublings "
           "| bytes moved |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for row in rows:
        for name, step in STEPS.items():
            s = row[name]
            out.append(
                f"| {row['n']} | {row['layout']} | `{step}` | "
                f"{s['first_s']:.4f} | {s['best_s'] * 1e3:.4f} | "
                f"{s['rate'] / 1e6:.4f} | {s['speedup']:.4f}x | "
                f"{s['efficiency'] * 100:.2f}% | {s['dropped']} | "
                f"{s['capacity_doublings']} | {s['bytes']} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=65536)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.batch, args.device)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "the CPU")
    print(f"ingest-step scaling on {where}", flush=True)
    print(table(rows, args.batch), flush=True)
    print("the exact step's merged node tables are equal at every slot "
          "count", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
