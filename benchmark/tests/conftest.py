"""Fixtures of the benchmark's own tests: a throwaway benchmark root with
tiny cells made from the real configuration and traffic files, and the
``gpu`` marker for tests that need the card."""

import functools
import importlib.util
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where torch finds none")


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("gpu"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


CELLS = os.path.join(BENCH, "tests", "cells")


@functools.cache
def cell_tests() -> dict:
    """traffic -> the module of tests/cells/<traffic>.py, for every such
    file: the traffic's tiny twins (``tiny(load)``), its ``FAULTS``, its
    ``control(monkeypatch)``, and optionally ``GUARANTEE_FAULTS``,
    ``GUARANTEE`` and ``SPAN_METRICS``."""
    mods = {}
    for name in sorted(os.listdir(CELLS)):
        if name.endswith(".py"):
            traffic = name[:-3]
            spec = importlib.util.spec_from_file_location(
                "bench_cell_tests_" + traffic, os.path.join(CELLS, name))
            mods[traffic] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[traffic])
    return mods


def tiny_cells() -> dict:
    """name -> (config, traffic): the real files at a size the CPU holds,
    each traffic's twins as its tests/cells file cuts them."""
    cells = {}
    for mod in cell_tests().values():
        twins = mod.tiny(_load)
        assert not set(twins) & set(cells), sorted(set(twins) & set(cells))
        cells.update(twins)
    return cells


def make_root(where: str, cells: dict) -> tuple[str, str]:
    """A benchmark root under ``where`` holding ``cells`` (name ->
    (config, traffic)) and the real metric readers and checkers; returns
    (root, benchmark folder)."""
    bench = os.path.join(where, "benchmark")
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "traffic"))
    for sub in ("metrics", "checkers"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    manifest = _load("..", "BENCHMARK.json")
    manifest["configs"], manifest["workloads"] = [], []
    seen = {}
    for name, (config, traffic) in cells.items():
        tname = name.replace(".", "_")
        if config["name"] in seen:
            assert seen[config["name"]] == config, config["name"]
        else:
            seen[config["name"]] = config
            path = f"benchmark/configs/{config['name']}.json"
            with open(os.path.join(where, path), "w") as f:
                json.dump(config, f)
            manifest["configs"].append(
                {"name": config["name"], "source": config["source"],
                 "file": path, "reduced": config["reduced"], "why": "test"})
        with open(os.path.join(bench, "traffic", tname + ".json"), "w") as f:
            json.dump(traffic, f)
        manifest["workloads"].append(
            {"name": name, "config": config["name"], "traffic": tname,
             "chips": 1, "why": "test"})
    for m in manifest["per_layer"]:
        m["workloads"] = list(cells)
    # every tiny cell reports the end-to-end metrics the CPU can read: not
    # those of the device's trace
    manifest["end_to_end"] = [m for m in manifest["end_to_end"]
                              if m["source"] != "device_trace"]
    for m in manifest["end_to_end"]:
        m.pop("workloads", None)
    with open(os.path.join(where, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return where, bench


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path), tiny_cells())


@pytest.fixture
def run_tiny(tiny_root):
    """Run a tiny cell on the CPU: harness.run_cell past its look for a
    card."""
    import time
    from benchmark import harness

    def run(cell, seed=20260101, seconds=0.5, trace=False, control=None,
            root_bench=tiny_root):
        root, bench = root_bench
        return harness.run_cell(cell, seed, seconds, trace,
                                time.perf_counter(), device="cpu", root=root,
                                bench=bench, control=control)
    return run
