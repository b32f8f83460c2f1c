"""One run of one cell: set-up, the timed window of passes, the check, the
result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration file (the entry's ``file``), its traffic mix
(``traffic/<traffic>.json``: the libraries it takes, the stage chain, the
warm-up slice and any arguments the warm-up adds, the check's sample),
each metric's reader (``metrics/<metric>.py``) and each stage's checker
(``checks.CHECKS``, by command).  A pass runs the chain once over the whole input, every command
in process through the port's ``cli.main`` with the upstream's options, in
a directory of its own.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from . import checks, gen, trace as tracemod

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level modules that may not be loaded once the window has closed
BANNED = ("jax", "jaxlib", "flax", "dbg_assembly_tpu")


def load_cell(name: str, root: str = ROOT):
    """(manifest, cell, configuration, traffic) of the named cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; workloads: "
                         + " ".join(sorted(cells)))
    cell = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    bench = os.path.join(root, manifest["paths"][0])
    with open(os.path.join(bench, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return manifest, cell, config, traffic


def metric_reader(name: str, root: str = ROOT, bench: str = BENCH):
    """The ``read(ctx)`` of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with trace its per-layer ones (those that list it, or, with no list,
    every cell that reports the metric they move)."""
    def e2e_here(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in manifest["end_to_end"] if e2e_here(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


@dataclass
class Context:
    """What metric readers and checkers see of a run."""
    device: torch.device
    seed: int
    inputs: dict
    check: dict
    setup_s: float = 0.0
    passes: list = field(default_factory=list)   # wall, spans, counters
    trace: dict | None = None
    work: dict = field(default_factory=dict)
    peak_bytes: int = 0
    pass_files: list = field(default_factory=list)
    scratch: str = ""

    def span_median(self, name: str):
        vals = [p["spans"][name] for p in self.passes if name in p["spans"]]
        return statistics.median(vals) if vals else None


def _program():
    """The port's command line and the modules whose counters a pass
    reads; imported here, so that a checkout without the port fails."""
    from dbg_assembly_tpu_torch import cli
    from dbg_assembly_tpu_torch.clean import adapter, lowqual
    from dbg_assembly_tpu_torch.correct import device as correct_device
    from dbg_assembly_tpu_torch.ops import chop, sort
    return cli, {"chop": chop, "sort": sort, "correct": correct_device,
                 "lowqual": lowqual, "adapter": adapter}


def _reset(mods: dict) -> None:
    mods["chop"].launches = 0
    mods["sort"].launches = 0
    for name in ("correct", "lowqual", "adapter"):
        mods[name].reset_counts()


def _counters(mods: dict) -> dict:
    out = {"chop.launches": mods["chop"].launches,
           "sort.launches": mods["sort"].launches}
    for name in ("correct", "lowqual", "adapter"):
        out.update({f"{name}.{k}": v for k, v in mods[name].counts.items()})
    return out


def _pass_dir(where: str, files: list) -> tuple[list, str]:
    """A directory with links to the inputs and a .lib listing them, so
    that what a command writes beside its inputs lands there."""
    os.makedirs(where)
    links = []
    for path in files:
        link = os.path.join(where, os.path.basename(path))
        os.symlink(os.path.abspath(path), link)
        links.append(link)
    lib = os.path.join(where, "reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in links))
    return links, lib


def stage_argvs(traffic: dict, config: dict, work: str, files: list,
                lib: str, device: str, extra: dict | None = None) -> list:
    """(span, command, argv) of each command of the chain, in order; a
    stage with "per_file" runs once a file, {file} its input.  extra
    appends arguments to a command (the controls: a flag given again
    overrides the traffic's)."""
    wanted = gen.select_libraries(config, traffic)
    read_len = max(int(x["read_len"]) for x in config["libraries"]
                   if x["name"] in wanted)
    out = []
    for stage in traffic["stages"]:
        for path in (files if stage.get("per_file") else [None]):
            env = {"lib": lib, "work": work, "read_len": read_len,
                   "file": path}
            argv = [a.format_map(env) for a in stage["args"]]
            more = list((extra or {}).get(stage["command"], []))
            out.append((stage["span"], stage["command"],
                        [stage["command"], *argv, *more, "--device",
                         device]))
    return out


def run_chain(cli, argvs: list, log, sync) -> list:
    """Run the commands in turn; the host-clock span of each ends once the
    device is idle.  Returns (span name, seconds) of each, in order."""
    spans = []
    for span, _, argv in argvs:
        t = time.perf_counter()
        with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            cli.main(argv)
        sync()
        spans.append((span, time.perf_counter() - t))
    return spans


def _slice_inputs(inputs: dict, rows: int, where: str) -> list:
    """The first ``rows`` reads of every input file, as FASTQ.gz files."""
    os.makedirs(where)
    blobs = []
    for (lib, mate), seq, qual in zip(inputs["names"], inputs["seqs"],
                                      inputs["quals"]):
        blobs.append((os.path.join(where, f"{lib}_{mate}.fq.gz"),
                      gen.fastq_bytes(lib, mate, seq[:rows], qual[:rows])))
    gen.write_gz(blobs)
    return [p for p, _ in blobs]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _window(cli, mods, ctx, traffic, config, tmp, device, seconds, log,
            sync, control):
    """Passes back to back: the first always, a further one while the
    time used plus the last pass's wall stays within ``seconds``.  Returns
    each pass's (directory, input links, argvs as the traffic gives
    them)."""
    t_window = time.perf_counter()
    dirs = []
    while True:
        _reset(mods)
        pdir = os.path.join(tmp, f"pass{len(dirs)}")
        links, lib = _pass_dir(pdir, ctx.inputs["files"])
        t = time.perf_counter()
        spans_at = run_chain(cli, stage_argvs(traffic, config, pdir, links,
                                              lib, device, control),
                             log, sync)
        wall = time.perf_counter() - t
        spans: dict = {}
        for span, sec in spans_at:                # a span over every file
            spans[span] = spans.get(span, 0.0) + sec
        ctx.passes.append({"wall": wall, "start": t, "spans": spans,
                           "spans_at": spans_at, "counters": _counters(mods)})
        dirs.append((pdir, links,
                     stage_argvs(traffic, config, pdir, links, lib, device)))
        if time.perf_counter() - t_window + wall > seconds:
            return dirs, time.perf_counter() - t_window


def _check(ctx, dirs) -> dict:
    """name -> (number, limit): the last pass against the reference, the
    others against the last."""
    last_dir, last_links, last_argvs = dirs[-1]
    ctx.pass_files = last_links
    want = checks.digests(last_dir)
    compared = {"passes_differ": (
        sum(checks.digests(d) != want for d, _, _ in dirs[:-1]), 0)}
    state: dict = {}
    for _, command, argv in last_argvs:
        checker = checks.CHECKS.get(command)
        if checker is None:
            raise SystemExit(f"no check for command {command!r}")
        # the checker sees the command's own flags, not "--device <dev>"
        for key, (val, lim) in checker(argv[1:-2], ctx, state).items():
            compared[key] = (compared.get(key, (0, lim))[0] + val, lim)
    return compared


def _tree_bytes(top: str) -> int:
    """Bytes of the regular files under ``top`` (links not followed)."""
    return sum(os.lstat(os.path.join(d, f)).st_size
               for d, _, files in os.walk(top) for f in files
               if not os.path.islink(os.path.join(d, f)))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", root: str = ROOT,
             bench: str = BENCH, control: dict | None = None) -> dict:
    """One run of the cell; returns the result line as a dict.  control
    (the controls' tests only): arguments appended to commands of the
    timed passes, which the check does not see."""
    manifest, _, config, traffic = load_cell(name, root)
    cli, mods = _program()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    tmp = tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))
    log = open(os.path.join(tmp, "program.log"), "w")
    try:
        os.makedirs(os.path.join(tmp, "inputs"))
        inputs = gen.make_inputs(config, traffic, seed,
                                 os.path.join(tmp, "inputs"), dev)
        ctx = Context(dev, seed, inputs, traffic.get("check", {}),
                      scratch=tmp)
        # warm-up: the whole chain on a slice of the same reads, so that
        # the kernels are built and loaded and the context is up;
        # "warmup_args" appends arguments to a command of the warm-up
        # alone (a flag given again overrides the traffic's)
        wfiles = _slice_inputs(inputs, int(traffic["warmup_reads"]),
                               os.path.join(tmp, "warm_inputs"))
        wdir = os.path.join(tmp, "warm")
        wlinks, wlib = _pass_dir(wdir, wfiles)
        run_chain(cli, stage_argvs(traffic, config, wdir, wlinks, wlib,
                                   device, traffic.get("warmup_args")),
                  log, sync)
        shutil.rmtree(wdir)
        card = power_limit() if cuda else "cpu"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.setup_s = time.perf_counter() - t_start

        prof = tracemod.Tracer() if trace else None
        if prof is not None:
            prof.start()
        dirs, window_s = _window(cli, mods, ctx, traffic, config, tmp,
                                 device, seconds, log, sync, control)
        if prof is not None:
            ctx.trace = prof.stop(window_s, ctx.passes)
        if cuda:
            ctx.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        found = banned_modules()
        if found:
            raise SystemExit("banned modules loaded: " + ", ".join(found))

        # the check runs once the window has closed, the peak is read and
        # the program's state is freed
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        compared = _check(ctx, dirs)
        check_s = time.perf_counter() - t_check
        if trace:
            ctx.work = tracemod.kmer_work(inputs, [a for _, _, a in
                                                   dirs[-1][2]], dev)
        correct = all(v <= lim for v, lim in compared.values())

        metrics = {}
        for m in cell_metrics(manifest, name, trace):
            value = metric_reader(m["name"], root, bench)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": correct,
            "attempted": len(ctx.passes),
            "failed": 0 if correct else len(ctx.passes),
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(dev) if cuda
                                else "cpu"),
                       "count": 1, "memory_peak_bytes": ctx.peak_bytes,
                       "card": card},
        }
        if ctx.trace is not None:
            result["device"]["busy_s"] = ctx.trace["busy_s"]
            result["device"]["window_s"] = ctx.trace["window_s"]
            result["breakdown"] = ctx.trace["breakdown"]
        result["pass_s"] = [p["wall"] for p in ctx.passes]
        result["files_bytes"] = _tree_bytes(tmp)
        result["check_s"] = check_s
        result["compared"] = {k: {"value": v, "limit": lim}
                              for k, (v, lim) in compared.items()}
        # again once the check and the metric readers have run: a result
        # is printed only from a process that never loaded them
        found = banned_modules()
        if found:
            raise SystemExit("banned modules loaded: " + ", ".join(found))
        return result
    except BaseException:
        log.flush()
        with open(log.name) as f:
            sys.stderr.write(f.read()[-6000:])
        raise
    finally:
        log.close()
        shutil.rmtree(tmp, ignore_errors=True)
