"""Host time a call of the chop's and the sort's wrappers, or of the
triage probes' wrappers to the end of their kernels, on one card.

    python3 -m dbg_assembly_tpu_torch.tools.launch_path
    PYTHONPATH=<checkout> python3 <this file>
    PYTHONPATH=<checkout> python3 <this file> --probes NAME [NAME ...] \
        [--shape ROWS COLS]

Times ops.chop.chop and ops.sort.sort at the main path's shapes (those of
chip_smoke.py phases 5, 7 and 16) on seeded random inputs: for each shape
RUNS runs of CALLS calls, the card idle at the start of each run, the host
time a call to return from each run.  Run as a file, it times the package
that PYTHONPATH finds first, so one machine can time two checkouts' launch
paths with the same code, in turns (the time moves between processes:
compare within one machine and read the spread).

With ``--probes``, times the named probes' wrappers (ops/probes.py)
instead, each on its own input and on a seeded one of ``--shape`` (int32
bits over the whole range, or float32 normals; by default 2^26 elements,
where bytes decide), each first held equal to its plain version: the
same runs, each until the card has finished its calls, so at the large
shape the time is the kernel's.  Prints one JSON object a shape, {"what",
"n_runs", "calls", "median_ms", "q1_ms", "q3_ms", "min_ms", "max_ms"}, and
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

CALLS = 20        # calls a run: the sort's launches stay far under the queue
RUNS = 100        # runs a shape: enough for the quartiles
READ_LEN = 150
# (name, reads, k, edges): kmerfreq's batch, ingest's, ingest's counted
CHOP_SHAPES = (("kmerfreq", 200_000, 17, False),
               ("ingest edges", 100_000, 31, True),
               ("ingest counting", 100_000, 31, False))
# (name, keys, key_bits, index): kmerfreq's batch, ingest's, the 8-part
# merge, map_pair's index, the mesh's route and owner reduce
SORT_SHAPES = (("kmerfreq", 26_800_000, 35, False),
               ("ingest", 12_000_000, 63, True),
               ("merge", 35_350_944, 62, True),
               ("map_index", 4_389_922, 62, True),
               ("mesh_route", 3_000_000, 3, True),
               ("mesh_owner", 5_248_452, 62, True))


def host_runs(fn, sync: bool = False) -> list[float]:
    """Host ms a call of fn in each of RUNS runs of CALLS calls, the card
    idle at the start of each run; with ``sync``, up to when the card has
    finished the run's calls."""
    fn()
    out = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            fn()
        if sync:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / CALLS * 1e3)
    torch.cuda.synchronize()
    return out


def summary(what: str, ms: list[float]) -> dict:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"what": what, "n_runs": len(ms), "calls": CALLS,
            "median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3),
            "min_ms": min(ms), "max_ms": max(ms)}


def time_probes(names: list[str], shape: tuple[int, int]) -> None:
    """Each probe's wrapper, on its own input and on one of ``shape``,
    == its plain version, then timed to the end of its kernels."""
    from dbg_assembly_tpu_torch.ops import probes
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        p = probes.PROBES[name]
        own = probes.to_torch(p.make_input()).cuda()
        if own.dtype == torch.int32:
            large = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                  device="cuda", generator=g)
        else:
            large = torch.randn(shape, device="cuda", generator=g)
        for x in (own, large):
            if not all(torch.equal(a, b)
                       for a, b in zip(p.kernel(x), p.plain(x))):
                raise AssertionError(f"probe {name} {tuple(x.shape)}: "
                                     f"kernel != plain")
            ms = host_runs(lambda: p.kernel(x), sync=True)
            print(json.dumps(summary(f"probe {name} {tuple(x.shape)}", ms)),
                  flush=True)
        del own, large
        torch.cuda.empty_cache()


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", nargs="+", metavar="NAME",
                    help="time these probes instead of the chop and sort")
    ap.add_argument("--shape", nargs=2, type=int, default=(524_288, 128),
                    metavar=("ROWS", "COLS"),
                    help="the probes' second input shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("launch_path needs a CUDA card")
    if args.probes:
        time_probes(args.probes, tuple(args.shape))
        return 0
    from dbg_assembly_tpu_torch.ops import chop, sort
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, n, k, edges in CHOP_SHAPES:
        codes = torch.randint(0, 4, (n, READ_LEN), dtype=torch.uint8,
                              device="cuda", generator=g)
        lengths = torch.full((n,), READ_LEN, dtype=torch.int32,
                             device="cuda")
        ms = host_runs(lambda: chop.chop(codes, lengths, k, edges))
        print(json.dumps(summary(f"chop {name} {n}x{READ_LEN} k={k}", ms)),
              flush=True)
        del codes, lengths
    for name, n, bits, index in SORT_SHAPES:
        # below 2^62 at 62 and 63 bits: torch.randint's bound is an int64
        keys = torch.randint(0, 2 ** min(bits, 62), (n,), dtype=torch.int64,
                             device="cuda", generator=g)
        ms = host_runs(lambda: sort.sort(keys, bits, index))
        print(json.dumps(summary(f"sort {name} {n} keys of {bits} bits, "
                                 f"index {index}", ms)), flush=True)
        del keys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
