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


REDESIGNED_F32 = ["copy_f32", "grid_block"]
REDESIGNED_U32 = ["copy_u32", "two_out_u32", "shift_u32", "bitonic_stage"]
REDESIGNED = REDESIGNED_F32 + REDESIGNED_U32


@pytest.mark.parametrize("name", REDESIGNED_F32)
def test_plain_at_large_shape_matches_numpy(name):
    """The plain versions of the float32 redesigned probes at the shape
    where chip_smoke.py times them against their bytes bound (2^26
    float32) equal the probe's ``expect``, the port's copy of the numpy
    formula of tools/mosaic_triage.py."""
    from chip_smoke import PROBE_LARGE_SHAPES
    p = probes.PROBES[name]
    x = np.random.default_rng(6).standard_normal(PROBE_LARGE_SHAPES[name],
                                                 dtype=np.float32)
    (got,) = p.plain(probes.to_torch(x))
    (want,) = p.expect(x)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy(), want)


def _u32_with_wraps(seed, shape):
    """Seeded uint32 over the whole range, with chip_smoke.py's
    PROBE_WRAP_VALUES (where + 7, + 1 and * 3 wrap at 2^32, and the top
    bits set), as many as fit, at the start of the first row and the end
    of the last."""
    from chip_smoke import PROBE_WRAP_VALUES
    x = np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                             dtype=np.uint32)
    wrap = np.array(PROBE_WRAP_VALUES[:shape[1]], np.uint32)
    x[0, :len(wrap)] = wrap
    x[-1, -len(wrap):] = wrap
    return x


def _with_straddle(flat, half):
    """chip_smoke.py's PROBE_STRADDLE pairs put into the flat uint32 array
    at 1..k and half + 1..half + k, as its _probe_draw puts them: the same
    offset in both halves of flat[:2 * half] and of flat[1:]."""
    from chip_smoke import PROBE_STRADDLE
    k = min(len(PROBE_STRADDLE), half - 1)
    if k > 0:
        top, bottom = zip(*PROBE_STRADDLE[:k])
        flat[1:1 + k] = top
        flat[half + 1:half + 1 + k] = bottom
    return flat


# each probe's result at 0xFFFFFFF9, the first wrap value, as Python ints
_AT_FIRST_WRAP = {
    "copy_u32": lambda v, x: (v + 7) % 2 ** 32,
    "two_out_u32": lambda v, x: (v + 1) % 2 ** 32,
    "shift_u32": lambda v, x: (((v << 2) | (v >> 30)) ^ v) % 2 ** 32,
    "bitonic_stage": lambda v, x: min(v, int(x[x.shape[0] // 2, 0])),
}


@pytest.mark.parametrize("name", REDESIGNED_U32)
def test_u32_plain_with_wrap_values_matches_numpy(name):
    """The plain versions of the uint32 redesigned probes equal the probe's
    ``expect``, the port's copy of the numpy formula of
    tools/mosaic_triage.py (numpy's uint32 arithmetic wraps), on a
    mid-sized seeded input that holds the values that wrap; that formula
    is held against JAX's output at the probe's own input by
    test_plain_matches_jax_probe.  2^26 would take gigabytes of int64
    intermediates a test worker."""
    p = probes.PROBES[name]
    x = _u32_with_wraps(7, (4096, 256))
    got = p.plain(probes.to_torch(x))
    want = p.expect(x)
    assert len(got) == len(want) == (2 if name == "two_out_u32" else 1)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == x.shape
        assert g.is_contiguous()
        assert w.dtype == np.uint32
        assert np.array_equal(probes.to_numpy(g, w), w)
    # the input holds a value at which each result wraps
    assert x[0, 0] == 0xFFFFFFF9
    assert int(want[0][0, 0]) == _AT_FIRST_WRAP[name](0xFFFFFFF9, x)
    if name == "two_out_u32":
        assert int(want[1][0, 0]) == 0xFFFFFFF9 * 3 % 2 ** 32


# ((v << 2) | (v >> 30)) ^ v with a logical >>, written out; an arithmetic
# >> would give 0x3FFFFFFF at 0xC0000000, 0xFFFFFFFF at 0x80000000
SHIFT_AT_TOP_BITS = [(0x80000000, 0x80000002), (0xC0000000, 0xC0000003),
                     (0xFFFFFFFF, 0x00000000), (0x40000000, 0x40000001),
                     (0xBFFFFFFF, 0x40000001)]


@pytest.mark.parametrize("v,want", SHIFT_AT_TOP_BITS)
def test_shift_u32_plain_at_top_bits_matches_numpy(v, want):
    """shift_u32_plain reads the int32 bits as unsigned: at each value with
    a top bit set it equals the result written out and numpy's uint32
    formula, beside every other PROBE_WRAP_VALUES value in one row."""
    from chip_smoke import PROBE_WRAP_VALUES
    x = np.array([[v, *PROBE_WRAP_VALUES]], np.uint32)
    (got,) = probes.shift_u32_plain(probes.to_torch(x))
    got = probes.to_numpy(got, x)
    assert got[0, 0] == want
    assert np.array_equal(got, ((x << 2) | (x >> 30)) ^ x)
    assert np.array_equal(got, probes.PROBES["shift_u32"].expect(x)[0])


def _bitonic_edge_cases():
    from chip_smoke import PROBE_EDGE_SHAPES
    return [(shape, off) for shape in PROBE_EDGE_SHAPES["bitonic_stage"]
            for off in (0, 1)]


@pytest.mark.parametrize("shape,off", _bitonic_edge_cases())
def test_bitonic_stage_plain_across_sign_bit_matches_numpy(shape, off):
    """bitonic_stage_plain == numpy's unsigned minimum / maximum of the
    halves at chip_smoke.py's edge shapes, on its buffer of n + 1 elements
    read from offset 0 and 1, with PROBE_STRADDLE's pairs across the sign
    bit at one offset in both halves, where a signed min would differ."""
    n = shape[0] * shape[1]
    half = n // 2
    flat = _with_straddle(_u32_with_wraps(n, (1, n + 1)).reshape(-1), half)
    x = flat[off:off + n].reshape(shape)
    (got,) = probes.bitonic_stage_plain(probes.to_torch(x))
    got = probes.to_numpy(got, x)
    top, bottom = x.reshape(-1)[:half], x.reshape(-1)[half:]
    want = np.concatenate([np.minimum(top, bottom), np.maximum(top, bottom)])
    assert np.array_equal(got.reshape(-1), want)
    assert np.array_equal(got, probes.PROBES["bitonic_stage"].expect(x)[0])
    if half > 1:
        # the straddling pairs are in both halves, and a signed min of
        # them is another answer
        i = 1 - off
        assert (top[i], bottom[i]) == (0x7FFFFFFF, 0x80000000)
        signed = np.minimum(top.view(np.int32), bottom.view(np.int32))
        assert signed.view(np.uint32)[i] != want[i]


@pytest.mark.parametrize("name", ["two_out_u32", "shift_u32",
                                  "bitonic_stage", "fori_sort_net"])
def test_yardstick_matches_plain_on_cpu(name):
    """chip_smoke.py's yardstick (the fewest PyTorch calls that compute a
    probe's outputs on the int32 bits) equals the plain version, every
    output, at the probe's shape and, for the redesigned probes, at the
    edge shapes with the wrap and straddle values."""
    from chip_smoke import _PROBE_PAIR, PROBE_EDGE_SHAPES
    p = probes.PROBES[name]
    inputs = [p.make_input()]
    for shape in PROBE_EDGE_SHAPES.get(name, ()):
        n = shape[0] * shape[1]
        flat = _u32_with_wraps(n, (1, n)).reshape(-1)
        if name == "bitonic_stage":
            flat = _with_straddle(flat, n // 2)
        inputs.append(flat.reshape(shape))
    _, fn = _PROBE_PAIR[name]
    for x in inputs:
        t = probes.to_torch(x)
        got, want = fn(t), p.plain(t)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), x.shape


@pytest.mark.parametrize("on_current", [True, False])
def test_launch_enters_device_context_only_off_current(on_current,
                                                        monkeypatch):
    """build.launch, which every wrapper's CUDA path calls: the raw handle
    of the card's current stream goes last, and a device context is
    entered only for a card that is not the current device."""
    from dbg_assembly_tpu_torch.ops import build
    entered = []

    class _Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 1000 + dev, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.cuda, "device", _Ctx)
    calls = []
    dev = 2 if on_current else 3
    assert build.launch(lambda *a: calls.append(a) or 0, dev, 11, 22) == 0
    assert calls == [(11, 22, 1000 + dev)]
    assert entered == ([] if on_current else [3])


def test_launch_path_tool_summary_and_no_card(monkeypatch):
    """tools/launch_path: the summary's quartiles of the runs' host ms,
    and without a card it raises before timing anything."""
    from dbg_assembly_tpu_torch.tools import launch_path
    s = launch_path.summary("x", [4.0, 1.0, 3.0, 2.0, 5.0])
    assert s == {"what": "x", "n_runs": 5, "calls": launch_path.CALLS,
                 "median_ms": 3.0, "q1_ms": 2.0, "q3_ms": 4.0,
                 "min_ms": 1.0, "max_ms": 5.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_path.main()


@pytest.mark.parametrize("sync", [False, True])
def test_launch_path_host_runs_waits_for_the_card_with_sync(sync,
                                                            monkeypatch):
    """tools/launch_path: host_runs gives RUNS times of CALLS calls each,
    the card idle at the start of every run and, with ``sync``, waited for
    at the end of every run too; ``--probes`` without a card raises."""
    from dbg_assembly_tpu_torch.tools import launch_path
    calls, syncs = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    ms = launch_path.host_runs(lambda: calls.append(1), sync=sync)
    assert len(ms) == launch_path.RUNS and min(ms) >= 0
    assert len(calls) == 1 + launch_path.RUNS * launch_path.CALLS
    assert len(syncs) == launch_path.RUNS * (1 + sync) + 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_path.main(["--probes", "shift_u32", "--shape", "8", "128"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", REDESIGNED)
def test_redesigned_kernel_matches_plain_on_card(name):
    """The six redesigned probes on the card == their plain versions,
    every output, at the probe's shape, chip_smoke.py's edge shapes (their
    scalar paths) and large shape, each contiguous and 4 bytes past 16-byte
    alignment; the integer probes on int32 bits over the whole range with
    the values that wrap and the top bits, bitonic_stage with pairs across
    the sign bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernels have no CPU mode")
    from chip_smoke import PROBE_EDGE_SHAPES, PROBE_LARGE_SHAPES
    p = probes.PROBES[name]
    u32 = name in REDESIGNED_U32
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape in (p.make_input().shape, *PROBE_EDGE_SHAPES[name],
                  PROBE_LARGE_SHAPES[name]):
        n = shape[0] * shape[1]
        if u32:
            flat = _u32_with_wraps(n, (1, n + 1)).reshape(-1)
            if name == "bitonic_stage":
                flat = _with_straddle(flat, n // 2)
            buf = probes.to_torch(flat).cuda()
        else:
            buf = torch.randn(n + 1, device="cuda", generator=g)
        for x in (buf[:n].view(shape), buf[1:].view(shape)):
            before = probes.launches[name]
            got = p.kernel(x)
            torch.cuda.synchronize()
            assert probes.launches[name] == before + 1
            want = p.plain(x)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == x.shape
                assert a.is_contiguous()
                assert torch.equal(a, b), (shape, x.storage_offset())
