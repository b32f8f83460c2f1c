"""BENCHMARK.json against the contract: names, units, files, readers."""

import json
import os
import re

from benchmark import harness

BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    assert all(0.01 <= x["bound"] <= 0.25 for x in m["end_to_end"])
    assert 1 <= m["run_seconds"] <= 51


def test_every_file_exists():
    m = manifest()
    root = harness.ROOT
    for c in m["configs"]:
        assert c["file"].startswith(m["paths"][0] + "/")
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.metric_reader(x["name"]))


def test_every_per_layer_metric_moves_a_reported_metric():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert cell in cells
            moved = e2e[x["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in cells:
        assert harness.cell_metrics(m, cell, trace=True)
        assert {"setup_s"} < {x["name"] for x in
                              harness.cell_metrics(m, cell, trace=False)}


def test_every_stage_command_has_a_check():
    """Each command of every traffic's set-up and timed stages has its
    checker, found as a run finds it."""
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as f:
            traffic = json.load(f)
        for stage in traffic.get("setup", []) + traffic["stages"]:
            assert callable(harness.checker(stage["command"]))


def test_contig_readers_are_their_originals():
    """Each <metric>.contig reader, loaded as the harness loads it, reads
    what <metric>'s reader reads."""
    from benchmark import trace
    m = manifest()
    names = {x["name"] for x in m["end_to_end"] + m["per_layer"]}
    split = [x["name"] for x in m["per_layer"]
             if x["name"].endswith(".contig")
             and x["name"][:-len(".contig")] in names]
    assert len(split) == 6
    ctx = harness.Context(
        None, 1, {"bases": 129_000_000}, {},
        passes=[{"wall": 11.0, "start": 0.0, "spans": {}}] * 3,
        trace={"busy_s": 1.5, "window_s": 50.0, "kernel_s": {
            "chop_kernel(int)": 0.04, "onesweep_kernel(int)": 0.06}},
        work={"chop_bytes": 3e9, "sort_bytes": 4e9}, peak_bytes=3 << 30)
    for name in split:
        base = name[:-len(".contig")]
        assert harness.metric_reader(name)(ctx) == \
            harness.metric_reader(base)(ctx), name
    assert trace.CHOP.search("chop_kernel(int)")
