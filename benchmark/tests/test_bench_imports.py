"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness

BANNED = {"jax", "jaxlib", "flax", "dbg_assembly_tpu"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(harness.BENCH, sub)):
        if os.path.basename(d) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_levels(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_in_the_harness():
    for path in _sources():
        assert not set(_top_levels(path)) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert not set(_top_levels(path)) & (BANNED | {
            "dbg_assembly_tpu_torch", "benchmark"}), path


def test_loaded_modules():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.run, benchmark.harness as h; h._program(); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert not set(eval(out)) & BANNED


def test_no_result_once_a_banned_module_loads(tmp_path, monkeypatch):
    """A metric reader that loads a banned module after the window has
    closed leaves the run with no result."""
    from conftest import make_root, tiny_cells
    root, bench = make_root(str(tmp_path / "root"),
                            {"tiny.clean": tiny_cells()["tiny.clean"]})
    fake = tmp_path / "fake" / "flax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "fake"))
    with open(os.path.join(bench, "metrics", "setup_s.py"), "a") as f:
        f.write("\nimport flax  # noqa: E402,F401\n")
    try:
        with pytest.raises(SystemExit, match="banned modules loaded: flax"):
            harness.run_cell("tiny.clean", 1, 0.1, False,
                             time.perf_counter(), device="cpu", root=root,
                             bench=bench)
    finally:
        sys.modules.pop("flax", None)
