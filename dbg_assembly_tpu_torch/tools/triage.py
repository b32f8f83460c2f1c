"""GPU triage: each probe kernel built, launched and checked in a process of
its own.

The port's counterpart of tools/mosaic_triage.py, the JAX package's Mosaic
(Pallas-on-TPU) compiler triage.  It runs the seven probes of ops/probes.py
(the same functions on the same inputs as that tool's probes) and a
``chop_kernel`` row that holds ops.chop.chop against chop_plain at 256 x
150, k = 31, as that tool re-runs its Pallas chop.

    python -m dbg_assembly_tpu_torch.tools.triage [--device cuda|cpu] [name]

With no name, every probe runs in its own subprocess with a hard timeout
(a CUDA fault poisons its process's context, and one failed build must not
hide the rest); one row per probe is printed (name, OK/FAIL, seconds, the
error's first line), the results go to
dbg_assembly_tpu_torch/_build/triage_results.json, and the exit code is 1
if any row failed.  With a name, that probe runs in this process.  A probe
passes when its output equals both its plain version on the same tensors
and the numpy expectation the JAX tool asserts, exactly.  ``--device cuda``
(the default) raises without a card; ``--device cpu`` runs the plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import build, chop, probes

TIMEOUT_S = 300
NAMES = (*probes.PROBES, "chop_kernel")
RESULTS = os.path.join(build.BUILD_DIR, "triage_results.json")
_MODULE = "dbg_assembly_tpu_torch.tools.triage"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _chop_kernel(dev: torch.device) -> int:
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(
        rng.integers(0, 4, size=(256, 150)).astype(np.uint8)).to(dev)
    lengths = torch.full((256,), 150, dtype=torch.int32, device=dev)
    got = chop.chop(codes, lengths, 31)[0]
    if not torch.equal(got, chop.chop_plain(codes, lengths, 31)[0]):
        raise AssertionError("chop kernel != chop_plain")
    return chop.launches


def run_probe(name: str, device: str = "cuda") -> int:
    """Runs one probe in this process; raises unless its output equals its
    plain version and the expectation.  Returns its kernel launches."""
    dev = resolve_device(device)
    if name == "chop_kernel":
        return _chop_kernel(dev)
    p = probes.PROBES[name]
    x = p.make_input()
    t = probes.to_torch(x).to(dev)
    got = p.kernel(t)
    want = p.plain(t)
    expect = p.expect(x)
    if not len(got) == len(want) == len(expect):
        raise AssertionError(f"{name}: {len(got)} outputs, plain "
                             f"{len(want)}, expected {len(expect)}")
    for i, (g, w, e) in enumerate(zip(got, want, expect)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} != plain version")
        if not np.array_equal(probes.to_numpy(g, e), e):
            raise AssertionError(f"{name}: output {i} != expectation")
    return probes.launches[name]


def run_all(device: str = "cuda") -> dict:
    """Every probe in its own subprocess; prints a row each, writes
    RESULTS and returns {name: {ok, sec, launches, err}}."""
    resolve_device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    results = {}
    for name in NAMES:
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-u", "-m", _MODULE, "--device", device,
                 name], capture_output=True, text=True, timeout=TIMEOUT_S,
                env=env)
            m = re.search(rf"^PROBE {name} OK launches=(\d+)$", r.stdout,
                          re.M)
            ok = r.returncode == 0 and m is not None
            fail = re.search(rf"^PROBE {name} FAIL (.*)$", r.stderr, re.M)
            err = "" if ok else (fail.group(1) if fail else
                                 (r.stderr.strip().splitlines()
                                  or [f"exit code {r.returncode}"])[-1])
            res = {"ok": ok, "sec": round(time.perf_counter() - t0, 2),
                   "launches": int(m.group(1)) if m else 0,
                   "err": err[:300]}
        except subprocess.TimeoutExpired:
            res = {"ok": False, "sec": TIMEOUT_S, "launches": 0,
                   "err": f"TIMEOUT after {TIMEOUT_S} s"}
        results[name] = res
        print(f"{name:16s} {'OK  ' if res['ok'] else 'FAIL'} "
              f"{res['sec']:7.2f}s  launches {res['launches']}  "
              f"{res['err'][:120]}", flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with open(RESULTS, "w") as f:
        json.dump({"device": device, "results": results}, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m " + _MODULE,
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("name", nargs="?", choices=NAMES,
                    help="run one probe in this process")
    args = ap.parse_args(argv)
    if args.name is None:
        results = run_all(args.device)
        return 0 if all(r["ok"] for r in results.values()) else 1
    try:
        n = run_probe(args.name, args.device)
    except Exception as e:   # reported to the parent, which goes on
        first = (str(e).strip().splitlines() or [""])[0]
        print(f"PROBE {args.name} FAIL {type(e).__name__}: {first}",
              file=sys.stderr, flush=True)
        raise
    print(f"PROBE {args.name} OK launches={n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
