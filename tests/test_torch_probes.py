"""The triage probes (ops/probes.py) and the GPU triage entry point
(tools/triage.py) against the JAX package's Mosaic triage
(tools/mosaic_triage.py, loaded from its file, not edited).

Six JAX probes run in Pallas interpret mode on the CPU, where each asserts
its own numpy expectation; a spy on ``pl.pallas_call`` keeps the arrays
that went in and came out, and the port's input and plain version must
equal them exactly.  The seventh, probe_fori_sort_net, cannot run in
interpret mode: ``pltpu.roll(v, -dist, 1)`` (mosaic_triage.py:193) raises
"shift must be non-negative" there.  That is a quirk of the JAX tool, not of
the port, so its plain version is held against np.sort(x, axis=1) on the
probe's own input, which the spy still records."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dbg_assembly_tpu_torch.ops import probes
from dbg_assembly_tpu_torch.tools import triage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERPRETABLE = ["copy_f32", "copy_u32", "shift_u32", "two_out_u32",
                 "grid_block", "bitonic_stage"]


def _jax_triage():
    spec = importlib.util.spec_from_file_location(
        "mosaic_triage", os.path.join(ROOT, "tools", "mosaic_triage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_probe(name, monkeypatch):
    """Runs the JAX probe in interpret mode; returns (inputs, outputs) of
    its pallas_call as numpy, outputs None if the call raised."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    real = pl.pallas_call
    seen = {}

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def call(*xs):
            seen["inputs"] = [np.asarray(x) for x in xs]
            out = fn(*xs)
            seen["outputs"] = [np.asarray(o) for o in
                               (out if isinstance(out, tuple) else (out,))]
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", spy)
    with pltpu.force_tpu_interpret_mode():
        try:
            _jax_triage().PROBES[name]()
        except ValueError:
            if name != "fori_sort_net":
                raise
    return seen["inputs"], seen.get("outputs")


@pytest.mark.parametrize("name", INTERPRETABLE)
def test_plain_matches_jax_probe(name, monkeypatch):
    inputs, outputs = _run_jax_probe(name, monkeypatch)
    p = probes.PROBES[name]
    x = p.make_input()
    assert len(inputs) == 1
    assert x.dtype == inputs[0].dtype and np.array_equal(x, inputs[0])
    got = p.plain(probes.to_torch(x))
    expect = p.expect(x)
    assert len(got) == len(outputs) == len(expect)
    for g, o, e in zip(got, outputs, expect):
        g = probes.to_numpy(g, e)
        assert g.dtype == o.dtype == e.dtype
        assert np.array_equal(g, o) and np.array_equal(g, e)


def test_fori_sort_net_plain_matches_np_sort(monkeypatch):
    inputs, _ = _run_jax_probe("fori_sort_net", monkeypatch)
    p = probes.PROBES["fori_sort_net"]
    x = p.make_input()
    assert x.dtype == np.uint32 and np.array_equal(x, inputs[0])
    (got,) = p.plain(probes.to_torch(x))
    got = probes.to_numpy(got, x)
    assert np.array_equal(got, np.sort(x, axis=1))
    assert np.array_equal(got, p.expect(x)[0])


def test_uint32_bits_round_trip():
    x = np.array([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]], np.uint32)
    t = probes.to_torch(x)
    assert t.dtype == torch.int32
    assert np.array_equal(probes.to_numpy(probes._bits(probes._u(t)), x), x)
    # wrapping at 2^32, as the kernels' unsigned arithmetic does
    a, b = probes.two_out_u32_plain(t)
    assert np.array_equal(probes.to_numpy(a, x), x + np.uint32(1))
    assert np.array_equal(probes.to_numpy(b, x), x * np.uint32(3))


@pytest.mark.parametrize("name", triage.NAMES)
def test_run_probe_on_cpu(name):
    """The triage's child mode in this process: plain version == numpy
    expectation (and == the chop's plain version), no kernel launched."""
    before = dict(probes.launches)
    assert triage.run_probe(name, "cpu") == 0
    assert probes.launches == before


def test_triage_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "dbg_assembly_tpu_torch.tools.triage",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = proc.stdout.strip().splitlines()
    assert [r.split()[0] for r in rows] == list(triage.NAMES)
    assert all(r.split()[1] == "OK" for r in rows), rows
    with open(triage.RESULTS) as f:
        res = json.load(f)
    assert res["device"] == "cpu"
    assert set(res["results"]) == set(triage.NAMES)
    assert all(r["ok"] and r["launches"] == 0 and r["err"] == ""
               for r in res["results"].values())


def test_triage_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        triage.run_all("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        triage.run_probe("copy_f32", "cuda")


@pytest.mark.parametrize("bad", ["dtype", "rank", "strided", "device"])
@pytest.mark.parametrize("name", list(probes.PROBES))
def test_wrapper_rejects(name, bad):
    x = probes.to_torch(probes.PROBES[name].make_input())
    if bad == "dtype":
        x = x.to(torch.float64)
    elif bad == "rank":
        x = x.reshape(-1)
    elif bad == "strided":
        x = x[:, ::2]
    elif bad == "device":
        # neither a CPU nor a CUDA tensor: no plain fallback is taken
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError)):
        probes.PROBES[name].kernel(x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(probes.PROBES))
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernels have no CPU mode")
    p = probes.PROBES[name]
    x = probes.to_torch(p.make_input()).cuda()
    before = probes.launches[name]
    got = p.kernel(x)
    torch.cuda.synchronize()
    assert probes.launches[name] == before + 1
    want = p.plain(x)
    assert len(got) == len(want)
    for g, w, e in zip(got, want, p.expect(p.make_input())):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert np.array_equal(probes.to_numpy(g, e), e)
