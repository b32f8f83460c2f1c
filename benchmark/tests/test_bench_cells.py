"""Whole runs of tiny cells on the CPU, past the harness's look for a
card: each traffic proves correct against the reference; a new mix,
configuration and metric need only new files; every fault the cells can
have, planted under the timed path, turns ``correct`` false; so does each
cell's control.  What each traffic brings (its tiny twins, faults and
control) is its file tests/cells/<traffic>.py, found by listing."""

import json
import os

import pytest

from conftest import BENCH, CELLS as CELLS_DIR, _load, cell_tests, \
    make_root, tiny_cells

CELLS = list(tiny_cells())
# the tiny cell -> the tests/cells module of its traffic
CELL_TESTS = {cell: mod for mod in cell_tests().values()
              for cell in mod.tiny(_load)}
# the three faults every traffic has, by the words before a fault's colon
KINDS = ("state unchanged", "half the batch", "an answer altered")


def _cells_file(traffic):
    return os.path.relpath(os.path.join(CELLS_DIR, traffic + ".py"),
                           os.path.dirname(BENCH))


def _traffics():
    listed = {n[:-5] for n in os.listdir(os.path.join(BENCH, "traffic"))
              if n.endswith(".json")}
    return sorted(listed | set(cell_tests()))


@pytest.mark.parametrize("traffic", _traffics())
def test_every_traffic_has_its_tests(traffic):
    """Each traffic/<traffic>.json has its tests/cells/<traffic>.py, with
    a control, a tiny twin of that traffic and a fault of each kind; each
    such file, a traffic."""
    path = _cells_file(traffic)
    assert os.path.isfile(os.path.join(BENCH, "traffic", traffic + ".json")), \
        f"{path} has no benchmark/traffic/{traffic}.json"
    assert traffic in cell_tests(), \
        f"benchmark/traffic/{traffic}.json has no {path}"
    mod = cell_tests()[traffic]
    assert callable(getattr(mod, "control", None)), f"{path}: no control"
    twins = mod.tiny(_load)
    assert twins, f"{path}: no tiny twin"
    real = [s["command"] for s in _load("traffic", traffic + ".json")
            ["stages"]]
    for name, (_, mix) in twins.items():
        assert [s["command"] for s in mix["stages"]] == real, (path, name)
    faults = getattr(mod, "FAULTS", [])
    missing = set(KINDS) - {f[1].split(":")[0] for f in faults}
    assert not missing, f"{path}: no fault of kind {sorted(missing)}"
    named = ([f[0] for f in faults]
             + [f[0] for f in getattr(mod, "GUARANTEE_FAULTS", [])]
             + list(getattr(mod, "SPAN_METRICS", {})))
    assert set(named) <= set(twins), (path, sorted(set(named) - set(twins)))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(run_tiny, cell):
    r = run_tiny(cell, trace=False)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared" and r["attempted"] >= 1
    assert set(r["metrics"]) == {"mbases_per_s", "setup_s"}
    assert r["metrics"]["mbases_per_s"]["value"] > 0


def test_new_mix_config_and_metric_are_files_only(tmp_path, run_tiny):
    """A throwaway traffic (kmerfreq alone at k 11), a configuration and a
    per-layer metric, each added as a file and an entry."""
    config, traffic = tiny_cells()["tiny.correct"]
    config = dict(config, name="throwaway_cfg", genome_length=20000)
    mix = dict(traffic, stages=[
        {"span": "kmerfreq", "command": "kmerfreq",
         "args": ["-k", "11", "-m", "1", "{lib}"]}])
    root, bench = make_root(str(tmp_path / "x"), {"x.count": (config, mix)})
    with open(os.path.join(bench, "metrics", "pass_count.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.passes)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["per_layer"].append(
        {"name": "pass_count", "unit": "passes", "better": "higher",
         "source": "program_counter", "layer": "workflow",
         "moves": "mbases_per_s", "workloads": ["x.count"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    r = run_tiny("x.count", trace=False, root_bench=(root, bench))
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"passes_differ", "table_bytes_differ",
                                  "spectrum_lines_differ"}
    # the traced run needs the profiler's device activity: on the CPU
    # only the readers that need no trace are asked for
    from benchmark import harness
    ctx = harness.Context(None, 1, {"bases": 1, "reads": 1}, {},
                          passes=[{"wall": 1.0, "spans": {}}])
    assert harness.metric_reader("pass_count", root, bench)(ctx) == 1


def test_device_trace_metric_traces_an_untraced_run(tmp_path, run_tiny,
                                                    monkeypatch):
    """An end-to-end metric read from the device's trace has the profiler
    run over the window of an untraced run, whose line still carries no
    busy_s, window_s or breakdown; a cell without one is not traced."""
    from benchmark import harness, trace
    started = []

    class FakeTracer:
        def start(self):
            started.append(1)
            self.t0 = __import__("time").perf_counter()

        def stop(self, window_s, passes):
            return trace.summarise([("k", self.t0, self.t0 + 0.25)],
                                   (self.t0, self.t0 + window_s), passes)
    monkeypatch.setattr(trace, "Tracer", FakeTracer)
    config, traffic = tiny_cells()["tiny.clean"]
    cells = {"x.a": (config, traffic), "x.b": (config, traffic)}
    root, bench = make_root(str(tmp_path / "x"), cells)
    with open(os.path.join(bench, "metrics", "card_busy.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.trace['busy_s']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["end_to_end"].append(
        {"name": "card_busy", "unit": "s", "better": "lower", "bound": 0.01,
         "source": "device_trace", "workloads": ["x.a"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    r = run_tiny("x.a", trace=False, root_bench=(root, bench))
    assert r["correct"] and started == [1]
    assert r["metrics"]["card_busy"]["value"] == 0.25
    assert not {"busy_s", "window_s"} & set(r["device"])
    assert "breakdown" not in r
    r = run_tiny("x.b", trace=False, root_bench=(root, bench))
    assert started == [1] and "card_busy" not in r["metrics"]


def _spy_checkers(mp):
    """Record (command, argv) of each checker call of a run."""
    from benchmark import harness
    calls = []
    real = harness.checker

    def counting(command, bench=harness.BENCH):
        check = real(command, bench)

        def spy(argv, run, state):
            calls.append((command, list(argv)))
            return check(argv, run, state)
        return spy
    mp.setattr(harness, "checker", counting)
    return calls


def _spy_passes(mp):
    """The run's Context, as the window fills it."""
    from benchmark import harness
    seen = []
    real = harness._window

    def window(cli, mods, ctx, *a):
        seen.append(ctx)
        return real(cli, mods, ctx, *a)
    mp.setattr(harness, "_window", window)
    return seen


def _setup_table_mix():
    """tiny.correct with kmerfreq's table made in set-up."""
    config, traffic = tiny_cells()["tiny.correct"]
    count, correct = traffic["stages"]
    return config, dict(traffic, setup=[count], stages=[correct])


def test_setup_stage_feeds_the_timed_chain(tmp_path, run_tiny, monkeypatch):
    """kmerfreq -k 13 once in set-up, correct_error_reads -k 13 timed on
    its table: correct; set-up's checker runs once, before the timed
    stage's, on set-up's own files; no pass times kmerfreq."""
    root, bench = make_root(str(tmp_path / "x"),
                            {"x.setup": _setup_table_mix()})
    calls = _spy_checkers(monkeypatch)
    seen = _spy_passes(monkeypatch)
    r = run_tiny("x.setup", seconds=3.0, root_bench=(root, bench))
    assert r["correct"], r["compared"]
    assert [c for c, _ in calls] == ["kmerfreq", "correct_error_reads"]
    assert calls[0][1][-1].endswith(os.path.join("setup", "reads.lib"))
    assert os.path.basename(os.path.dirname(calls[1][1][-1])) == \
        f"pass{r['attempted'] - 1}"
    assert {"passes_differ", "table_bytes_differ", "spectrum_lines_differ",
            "reads_differ"} <= set(r["compared"])
    passes = seen[0].passes
    assert len(passes) == r["attempted"]
    assert all([s for s, _ in p["spans_at"]] == ["correct"] for p in passes)


def test_setup_stage_is_checked(tmp_path, run_tiny, monkeypatch):
    """A fault in the set-up stage (one bit of its table) turns correct
    false through set-up's checker."""
    root, bench = make_root(str(tmp_path / "x"),
                            {"x.setup": _setup_table_mix()})
    cell_tests()["correct"]._patch_table_bit(monkeypatch)
    r = run_tiny("x.setup", root_bench=(root, bench))
    assert not r["correct"]
    assert r["compared"]["table_bytes_differ"]["value"] > 0


# stand-ins for the checkers of the two scaffolding commands, written into
# a throwaway root: each output is there
CHECK_MAP_PAIR = """import os


def check(argv, run, state):
    with open(argv[-1]) as f:
        read1 = os.path.basename(f.readline().strip())
    out = os.path.join(argv[argv.index("-o") + 1], read1)
    state.setdefault("maps", []).append(argv)
    return {"map_pair_files_missing": (sum(
        not os.path.isfile(out + ext)
        for ext in (".map_pair.2ctg.gz", ".map_pair.stat")), 0)}
"""

CHECK_LINK_SCAFFOLD = """import os


def check(argv, run, state):
    pre = argv[argv.index("-o") + 1] + ".insert" + argv[argv.index("-i") + 1]
    return {"scaffold_files_missing": (sum(
        not os.path.isfile(pre + ext)
        for ext in (".scaffold.seq.fa", ".scaffold.links.all")), 0)}
"""


def _scaffold_mix():
    """The upstream's two scaffolding rounds (test/03.build_scaffold) on
    contigs made in set-up: map_pair and link_scaffold at insert 400,
    then again at 800 on the round-1 scaffolds."""
    config, contig = tiny_cells()["tiny.ecoli_contig"]
    stages, lists = [], {}
    contigs = "{work}/asm.contig.seq.fa"
    for rnd, lib in enumerate(("insert400", "insert800"), 1):
        twoctg = f"twoctg_{lib}.lib"
        lists[twoctg] = [f"{{work}}/map_{lib}/{lib}_1.fq.gz.map_pair.2ctg.gz"]
        stages += [
            {"span": f"map_pair.{lib}", "command": "map_pair",
             "args": ["-k", "31", "-s", "5", "-l", "125", "-r",
                      f"{{read_len.{lib}}}", "-i", "0.97", "-o",
                      f"{{work}}/map_{lib}", contigs, f"{{lib.{lib}}}"]},
            {"span": f"link_scaffold.{lib}", "command": "link_scaffold",
             "args": ["-i", f"{{insert.{lib}}}", "-o", f"{{work}}/round{rnd}",
                      contigs, "{work}/" + twoctg]}]
        contigs = f"{{work}}/round{rnd}.insert{{insert.{lib}}}.scaffold.seq.fa"
    return config, dict(contig, setup=contig["stages"], stages=stages,
                        lists=lists)


def test_command_checked_by_a_new_file(tmp_path, run_tiny, monkeypatch):
    """A chain of commands with no checker stops before any input is made;
    a checker file for each, added to the root alone, makes it run and
    prove correct.  The throwaway root's copy of checkers/ loses any file
    of the chain's timed commands first, so that the test proves the same
    whether or not the repository has them."""
    from benchmark import harness
    mix = _scaffold_mix()
    root, bench = make_root(str(tmp_path / "x"), {"x.scaffold": mix})
    for stage in mix[1]["stages"]:
        path = os.path.join(bench, "checkers", stage["command"] + ".py")
        if os.path.exists(path):
            os.remove(path)
    with monkeypatch.context() as mp:
        def never(*a, **kw):
            raise AssertionError("inputs made for a cell that cannot run")
        mp.setattr(harness.gen, "make_inputs", never)
        with pytest.raises(SystemExit,
                           match="no check for command 'map_pair'"):
            run_tiny("x.scaffold", root_bench=(root, bench))
    for command, text in (("map_pair", CHECK_MAP_PAIR),
                          ("link_scaffold", CHECK_LINK_SCAFFOLD)):
        with open(os.path.join(bench, "checkers", command + ".py"),
                  "w") as f:
            f.write(text)
    r = run_tiny("x.scaffold", root_bench=(root, bench))
    assert r["correct"], r["compared"]
    assert {"passes_differ", "contigs_lines_differ",
            "map_pair_files_missing",
            "scaffold_files_missing"} <= set(r["compared"])


FAULTS = [f for mod in cell_tests().values()
          for f in getattr(mod, "FAULTS", [])]


@pytest.mark.parametrize("cell,what,patch,number", FAULTS,
                         ids=[f[1].split(":")[0].replace(" ", "_") + "-"
                              + f[0] for f in FAULTS])
def test_fault_is_caught(run_tiny, monkeypatch, cell, what, patch, number):
    patch(monkeypatch)
    r = run_tiny(cell, trace=False)
    assert not r["correct"], what
    assert r["compared"][number]["value"] > r["compared"][number]["limit"]


# the faults that the checks replaying no tool (reference/guarantees.py)
# catch as well
GUARANTEE_FAULTS = [f for mod in cell_tests().values()
                    for f in getattr(mod, "GUARANTEE_FAULTS", [])]


@pytest.mark.parametrize("cell,patch,number", GUARANTEE_FAULTS,
                         ids=[f[1].__name__[7:] for f in GUARANTEE_FAULTS])
def test_fault_breaks_a_guarantee(run_tiny, monkeypatch, cell, patch,
                                  number):
    patch(monkeypatch)
    r = run_tiny(cell, trace=False)
    assert r["compared"][number]["value"] > r["compared"][number]["limit"]


# each cell's control, its traffic's control(): the step that would tempt
# a later PR, with the number of the checks replaying no tool that it
# breaks (GUARANTEE), where the traffic has one
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(run_tiny, monkeypatch, cell):
    mod = CELL_TESTS[cell]
    r = run_tiny(cell, trace=False, control=mod.control(monkeypatch))
    assert not r["correct"], r["compared"]
    guarantee = getattr(mod, "GUARANTEE", None)
    if guarantee:
        got = r["compared"][guarantee]
        assert got["value"] > got["limit"], r["compared"]


CONTROL_SEEDS = (4000000001, 4000000002, 4000000003)


def _real_cells():
    from benchmark import harness
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _real_cells())
def test_control_fails_at_cell_size(monkeypatch, cell):
    """The control on the card at the cell's own size, on three seeds; the
    numbers compared are appended, a JSON line a run, to the file that
    $CONTROLS_JSONL names, where it is set."""
    import time
    from benchmark import harness
    traffic = harness.load_cell(cell)[1]["traffic"]
    if traffic not in cell_tests():
        pytest.fail(f"no {_cells_file(traffic)}: no control for traffic "
                    f"{traffic!r}")
    control = cell_tests()[traffic].control(monkeypatch)
    out = os.environ.get("CONTROLS_JSONL")
    for seed in CONTROL_SEEDS:
        r = harness.run_cell(cell, seed, 1.0, False, time.perf_counter(),
                             control=control)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps({"cell": cell, "seed": seed,
                                    "compared": r["compared"]}) + "\n")
        assert not r["correct"], (seed, r["compared"])
