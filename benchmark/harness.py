"""One run of one cell: set-up, the timed window of passes, the check, the
result line.

Everything a cell needs is found by name, so that a cell, a traffic mix, a
configuration, a metric or a checker is added as new files and entries
alone:

- the cell: an entry of ``workloads`` in BENCHMARK.json;
- its configuration: the file its ``configs`` entry names, with the
  genome and ``libraries`` (each ``name``, ``read_len``, ``insert``,
  ``depth``);
- its traffic mix, ``traffic/<traffic>.json``:
  ``libraries`` ("all", "first" or a list of names) that the inputs hold;
  ``stages``, the timed chain, each ``{"span", "command", "args"}``, with
  ``"per_file": true`` to run once an input file; ``setup`` (optional),
  stages in the same format run once, on the whole input, before the
  warm-up; ``lists`` (optional), ``{file name: [line, ...]}``, files the
  harness writes beside the inputs; ``warmup_reads``, the reads a file of
  the warm-up's slice; ``warmup_args`` (optional), ``{command: [arg,
  ...]}`` appended to the warm-up's commands alone (a flag given again
  overrides the traffic's); ``soil`` (optional, gen.soil); ``check``
  (what the checkers sample);
- each metric's reader: ``metrics/<metric>.py``, ``read(ctx)``, which
  returns None where it finds nothing to read; the device is traced over
  the window of a traced run, and of an untraced one where an end-to-end
  metric of the cell has the source ``device_trace``;
- each stage command's checker, set-up stages' too:
  ``checkers/<command>.py``, ``check(argv, run, state)`` (checks.py).  A
  command with no checker stops the run before it starts.

A chain runs in a directory of its own (set-up's, the warm-up's, each
pass's), every command in process through the port's ``cli.main`` with
the upstream's options and ``--device``, so that what a command writes
beside its inputs lands there.  The directory holds links to the inputs
and, but in set-up's, to what set-up wrote; ``reads.lib``, every input
file; ``<library>.pair.lib``, each library's two files; and the traffic's
lists.  Set-up runs once, its time counted in ``setup_s``; a pass runs
the timed chain once over the whole input.  Once the window has closed,
every pass's files (by digest, each file's own directory read as
``{work}``) are held to the last pass's, then set-up's stages and the last
pass's, in turn, to their checkers, which share one ``state``.

Templates, ``{key}`` in ``args`` and in the lines of lists:

    {work}            the chain's directory
    {lib}             {work}/reads.lib
    {read_len}        the longest read of the traffic's libraries
    {file}            the input file of a per_file stage
    {lib.NAME}        {work}/NAME.pair.lib, library NAME's two files
    {insert.NAME}     library NAME's insert
    {read_len.NAME}   library NAME's read length

for NAME each library the traffic takes, whatever its name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
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


def _load(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT, bench: str = BENCH):
    """The ``read(ctx)`` of metrics/<name>.py."""
    return _load(os.path.join(bench, "metrics", name + ".py"),
                 "bench_metric_" + name.replace(".", "_")).read


def checker(command: str, bench: str = BENCH):
    """The ``check(argv, run, state)`` of checkers/<command>.py."""
    path = os.path.join(bench, "checkers", command + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"no check for command {command!r}")
    return _load(path, "bench_checker_" + command).check


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
    pass_files: list = field(default_factory=list)  # the checked chain's
    scratch: str = ""                                # input links

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


TEMPLATE = re.compile(r"\{([^{}]*)\}")


def expand(text: str, env: dict) -> str:
    """``text`` with each ``{key}`` replaced by env's value."""
    def one(m):
        if m.group(1) not in env:
            raise SystemExit(f"no template key {m.group(1)!r} in {text!r}; "
                             "keys: " + " ".join(sorted(env)))
        return str(env[m.group(1)])
    return TEMPLATE.sub(one, text)


def template_env(config: dict, traffic: dict, work: str) -> dict:
    """The template keys of a chain's directory ``work``, but {file}."""
    wanted = gen.select_libraries(config, traffic)
    libs = [x for x in config["libraries"] if x["name"] in wanted]
    env = {"work": work, "lib": os.path.join(work, "reads.lib"),
           "read_len": max(int(x["read_len"]) for x in libs)}
    for x in libs:
        env["lib." + x["name"]] = os.path.join(work, x["name"] + ".pair.lib")
        env["insert." + x["name"]] = int(x["insert"])
        env["read_len." + x["name"]] = int(x["read_len"])
    return env


def stage_argvs(stages: list, env: dict, files: list, device: str,
                extra: dict | None = None) -> list:
    """(span, command, argv) of each command of ``stages``, in order; a
    stage with "per_file" runs once a file of ``files``, {file} its input.
    extra appends arguments to a command (the warm-up's and the controls':
    a flag given again overrides the traffic's)."""
    out = []
    for stage in stages:
        for path in (files if stage.get("per_file") else [None]):
            argv = [expand(a, dict(env, file=path)) for a in stage["args"]]
            more = list((extra or {}).get(stage["command"], []))
            out.append((stage["span"], stage["command"],
                        [stage["command"], *argv, *more, "--device",
                         device]))
    return out


@dataclass
class StageDir:
    """The directory a chain runs in."""
    path: str
    links: list        # the input files' links, in library order
    env: dict          # the template keys but {file}
    own: set           # names the harness put there

    def argvs(self, stages: list, device: str, extra=None) -> list:
        return stage_argvs(stages, self.env, self.links, device, extra)


def _link(path: str, where: str) -> str:
    link = os.path.join(where, os.path.basename(path))
    os.symlink(os.path.abspath(path), link)
    return link


def _write_lines(path: str, lines: list) -> None:
    with open(path, "x") as f:       # never through a link, never twice
        f.write("".join(x + "\n" for x in lines))


def stage_dir(where: str, files: list, names: list, config: dict,
              traffic: dict, made: list = ()) -> StageDir:
    """Make ``where``: links to the input ``files`` (each the (library,
    mate) of ``names``) and to set-up's outputs ``made``, reads.lib,
    <library>.pair.lib each library's, and the traffic's lists."""
    os.makedirs(where)
    links = [_link(path, where) for path in files]
    for path in made:
        _link(path, where)
    env = template_env(config, traffic, where)
    _write_lines(env["lib"], links)
    for name in gen.select_libraries(config, traffic):
        _write_lines(env["lib." + name], [
            x for x, (lib, _) in zip(links, names) if lib == name])
    for name, lines in traffic.get("lists", {}).items():
        _write_lines(os.path.join(where, name),
                    [expand(x, env) for x in lines])
    return StageDir(where, links, env, set(os.listdir(where)))


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


def _window(cli, mods, ctx, make_pass, stages, device, seconds, log, sync,
            control):
    """Passes back to back: the first always, a further one while the
    time used plus the last pass's wall stays within ``seconds``.  Returns
    each pass's StageDir."""
    t_window = time.perf_counter()
    dirs = []
    while True:
        _reset(mods)
        d = make_pass(os.path.join(ctx.scratch, f"pass{len(dirs)}"))
        t = time.perf_counter()
        spans_at = run_chain(cli, d.argvs(stages, device, control), log,
                             sync)
        wall = time.perf_counter() - t
        spans: dict = {}
        for span, sec in spans_at:                # a span over every file
            spans[span] = spans.get(span, 0.0) + sec
        ctx.passes.append({"wall": wall, "start": t, "spans": spans,
                           "spans_at": spans_at, "counters": _counters(mods)})
        dirs.append(d)
        if time.perf_counter() - t_window + wall > seconds:
            return dirs, time.perf_counter() - t_window


def _check(ctx, dirs: list, chains: list, checkers: dict,
           device: str) -> dict:
    """name -> (number, limit): the passes against the last by digest;
    then each chain of ``chains``, (StageDir, stages) in turn (set-up's,
    then the last pass's), against the reference."""
    last = dirs[-1]
    want = checks.digests(last.path, last.own)
    compared = {"passes_differ": (
        sum(checks.digests(d.path, d.own) != want for d in dirs[:-1]), 0)}
    state: dict = {}
    for d, stages in chains:
        ctx.pass_files = d.links
        for _, command, argv in d.argvs(stages, device):
            # the checker sees the command's own flags, not "--device <dev>"
            for key, (val, lim) in checkers[command](argv[1:-2], ctx,
                                                     state).items():
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
    setup, stages = traffic.get("setup", []), traffic["stages"]
    checkers = {s["command"]: checker(s["command"], bench)
                for s in setup + stages}
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

        def make_dir(where, files, made=()):
            return stage_dir(where, files, inputs["names"], config, traffic,
                             made)
        # set-up: its stages once, on the whole input; what they write
        # appears in the warm-up's and every pass's directory
        chains, made = [], []
        if setup:
            sdir = make_dir(os.path.join(tmp, "setup"), inputs["files"])
            run_chain(cli, sdir.argvs(setup, device), log, sync)
            made = [os.path.join(sdir.path, n)
                    for n in sorted(set(os.listdir(sdir.path)) - sdir.own)]
            chains.append((sdir, setup))
        # warm-up: the timed chain on a slice of the same reads, so that
        # the kernels are built and loaded and the context is up
        wfiles = _slice_inputs(inputs, int(traffic["warmup_reads"]),
                               os.path.join(tmp, "warm_inputs"))
        wdir = make_dir(os.path.join(tmp, "warm"), wfiles, made)
        run_chain(cli, wdir.argvs(stages, device, traffic.get("warmup_args")),
                  log, sync)
        shutil.rmtree(wdir.path)
        card = power_limit() if cuda else "cpu"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.setup_s = time.perf_counter() - t_start

        # the profiler runs in a traced run, and in an untraced one where
        # an end-to-end metric of the cell is read from the device's trace
        traced = trace or any(m["source"] == "device_trace" for m in
                              cell_metrics(manifest, name, False))
        prof = tracemod.Tracer() if traced else None
        if prof is not None:
            prof.start()
        dirs, window_s = _window(
            cli, mods, ctx, lambda where: make_dir(where, inputs["files"],
                                                   made),
            stages, device, seconds, log, sync, control)
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
        compared = _check(ctx, dirs, chains + [(dirs[-1], stages)],
                          checkers, device)
        check_s = time.perf_counter() - t_check
        if trace:
            ctx.work = tracemod.kmer_work(
                inputs, [a for _, _, a in dirs[-1].argvs(stages, device)],
                dev)
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
        if trace:
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
