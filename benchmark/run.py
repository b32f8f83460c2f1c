"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the cell's inputs on the card from the seed, runs the traffic's
set-up stages on them once, warms up on a slice of them, runs passes of
the cell's stage chain back to back for the window, checks set-up and the
last pass against the plain reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines of standard error.  Exits non-zero, with no result, where torch
finds no card (or fewer than the cell asks for), or where JAX or the JAX
package was loaded.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    _, cell, _, _ = harness.load_cell(a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              T_START)
    found = harness.banned_modules()
    if found:
        print("no result: banned modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
