"""DISTRIBUTED.md's communication-volume model held against the port's
ingest step.

Counterpart of tools/verify_comm_volume.py, which sums the collective
operands of JAX's compiled step.  The model: the distributed ingest moves
about 16 B a k-mer slot through all_to_all (8 B key + 8 B packed
payload), flat per slot in D.  The port's step routes each kept k-mer as
four columns (int64 key, uint8 left and right codes, int64 position), and
the mesh counts the bytes that leave a slot (parallel.mesh.bytes_moved; a
slot's own bucket stays).  At JAX's shape (N 1024 x L 150, k 31, D 8,
rng(0), count_sharded.default_capacity) this runs
count_sharded.graph_ingest_step, then graph_ingest_step_exact (what
GraphBuilder(mesh=) runs), and for each prints the bytes in total and a
k-mer slot against the model, the bytes of one routed k-mer, dropped and
capacity_doublings.

Checks, each raising: every step's bytes equal the sum over the (source,
owner) segments with source != owner of the segment's kept k-mers times
the bytes of one routed record, every routing attempt of the exact step
counted at its capacity; and the raw step's bytes a slot lie within JAX's
0.8-2.0 band of the model.  The exact step's ratio is printed, not
checked: the owner rule's skew (ROADMAP Queue 3) doubles its capacity at
D >= 4, and each doubling routes the step again.

    python -m dbg_assembly_tpu_torch.tools.verify_comm_volume \\
        [--device cuda|cpu] [--slots 8]

Writes no file.  ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..contig.graph import _chop_with_edges
from ..ops.chop import SENTINEL
from ..parallel import count_sharded
from ..parallel import mesh as meshmod

MODEL_BYTES_PER_SLOT = 16
BAND = (0.8, 2.0)
TOOL_K = 31


def _segments(cs, ls, ksize: int, D: int):
    """([D, D] k-mers of each (source, owner) segment, bytes of one routed
    record), from each slot's own chop: the owner of a valid window is
    its k-mer mod D, as count_sharded routes it."""
    seg = np.zeros((D, D), np.int64)
    record = 0
    for s, (c, ln) in enumerate(zip(cs, ls)):
        kmers, left, right = _chop_with_edges(c, ln, ksize)
        flat = kmers.reshape(-1)
        seg[s] = torch.bincount(flat[flat != SENTINEL] % D,
                                minlength=D).cpu().numpy()
        # key, left, right and the int64 stream position
        record = (kmers.element_size() + left.element_size()
                  + right.element_size() + torch.int64.itemsize)
    return seg, record


def _expected_bytes(seg: np.ndarray, record: int, capacity: int,
                    doublings: int) -> int:
    """Bytes the segments leaving their slot carry over every routing
    attempt (capacity doubled before each retry)."""
    off = ~np.eye(seg.shape[0], dtype=bool)
    return sum(int(np.minimum(seg, capacity << a)[off].sum()) * record
               for a in range(doublings + 1))


def _moved(fn):
    """(fn's result, bytes the collectives moved while it ran)."""
    before = meshmod.bytes_moved
    out = fn()
    return out, meshmod.bytes_moved - before


def measure(codes: np.ndarray, lengths: np.ndarray, ksize: int, D: int,
            device="cuda") -> dict:
    """Both steps on a D-slot mesh on ``device``: per step its bytes
    moved, bytes a k-mer slot, ratio to the model, dropped, capacity and
    capacity_doublings; raises unless each step's bytes equal the
    segments' (the identity)."""
    m = meshmod.data_mesh(D, device)
    N, L = codes.shape
    slots = N * (L - ksize + 1)
    cs, ls = meshmod.shard_batch(m, codes, lengths)
    cap = count_sharded.default_capacity(N, L, ksize, D)
    seg, record = _segments(cs, ls, ksize, D)
    out = {"reads": N, "read_len": L, "ksize": ksize, "slots": slots,
           "capacity": cap, "record_bytes": record, "layout": m.layout()}
    runs = {
        "graph_ingest_step": lambda: count_sharded.graph_ingest_step(
            cs, ls, 0, ksize=ksize, mesh=m, capacity=cap),
        "graph_ingest_step_exact":
            lambda: count_sharded.graph_ingest_step_exact(
                cs, ls, 0, ksize=ksize, mesh=m, capacity=cap)}
    for name, fn in runs.items():
        res, moved = _moved(fn)
        stats = res[-1]
        doublings = stats.get("capacity_doublings", 0)
        want = _expected_bytes(seg, record, cap, doublings)
        if moved != want:
            raise AssertionError(
                f"{name}: {moved} B moved between slots != {want} B of the "
                "kept records of the segments that leave their slot")
        out[name] = {"bytes": moved, "per_slot": moved / slots,
                     "ratio": moved / (slots * MODEL_BYTES_PER_SLOT),
                     "dropped": stats["dropped"],
                     "capacity": stats.get("capacity", cap),
                     "capacity_doublings": doublings}
    return out


def tool_batch(n_reads: int = 1024, read_len: int = 150):
    """JAX's tool's batch: rng(0) codes, every read full length."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)
    return codes, np.full(n_reads, read_len, np.int32)


def report(r: dict) -> None:
    """Prints measure()'s result; raises unless the raw step lies within
    BAND of the model."""
    slots = r["slots"]
    print(f"k-mer slots per step: {slots} ({r['reads']} reads x "
          f"{r['read_len']} bp, k {r['ksize']}); {r['layout']}; "
          f"default_capacity {r['capacity']}", flush=True)
    print(f"model (DISTRIBUTED.md): {slots * MODEL_BYTES_PER_SLOT} B "
          f"({MODEL_BYTES_PER_SLOT} B a k-mer slot)")
    print(f"a routed k-mer carries {r['record_bytes']} B (int64 key, uint8 "
          "left and right codes, int64 position)")
    for name in ("graph_ingest_step", "graph_ingest_step_exact"):
        s = r[name]
        print(f"{name}: {s['bytes']} B between slots, "
              f"{s['per_slot']:.2f} B a k-mer slot, {s['ratio']:.2f} of "
              f"the model; dropped {s['dropped']}, capacity_doublings "
              f"{s['capacity_doublings']} (capacity {s['capacity']}); "
              "== the kept records of the segments that leave their slot")
    ratio = r["graph_ingest_step"]["ratio"]
    if not BAND[0] <= ratio <= BAND[1]:
        raise AssertionError(f"graph_ingest_step moves {ratio:.2f} of the "
                             f"model, outside {BAND}: the model is off")
    print(f"OK: graph_ingest_step within {BAND[0]}-{BAND[1]} of the "
          f"{MODEL_BYTES_PER_SLOT} B/slot model", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=8)
    args = ap.parse_args(argv)
    codes, lengths = tool_batch()
    report(measure(codes, lengths, TOOL_K, args.slots, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
