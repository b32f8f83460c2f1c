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
import re
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
REDESIGNED = REDESIGNED_F32 + REDESIGNED_U32 + ["fori_sort_net"]


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


def _hard_rows(x, rng):
    """chip_smoke.py's _hard_rows in numpy, in place on uint32 rows x:
    between the first and the last row, row 1 and every fourth after it
    drawn from PROBE_SIGN_VALUES, row 2 all 0x80000000, row 3 sorted and
    row 4 reversed, as many as fit; returns x."""
    from chip_smoke import PROBE_SIGN_VALUES
    rows, w = x.shape
    r = np.arange(1, max(rows - 1, 1), 4)
    x[r] = np.array(PROBE_SIGN_VALUES, np.uint32)[rng.integers(
        0, 4, (len(r), w))]
    if rows > 3:
        x[2] = 0x80000000
    if rows > 4:
        x[3] = np.sort(x[3])
    if rows > 5:
        x[4] = np.sort(x[4])[::-1]
    return x


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
        x = flat.reshape(shape)
        if name == "fori_sort_net":
            _hard_rows(x, np.random.default_rng(n))
        inputs.append(x)
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
    """The seven redesigned probes on the card == their plain versions,
    every output, at the probe's shape, chip_smoke.py's edge shapes (their
    scalar paths) and large shape, each contiguous and 4 bytes past 16-byte
    alignment; the integer probes on int32 bits over the whole range with
    the values that wrap and the top bits, bitonic_stage with pairs across
    the sign bit, fori_sort_net with rows hard for a sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernels have no CPU mode")
    from chip_smoke import PROBE_EDGE_SHAPES, PROBE_LARGE_SHAPES
    p = probes.PROBES[name]
    u32 = name not in REDESIGNED_F32
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
            if name == "fori_sort_net":
                rows = _hard_rows(probes.to_numpy(x, flat).copy(),
                                  np.random.default_rng(n))
                x.copy_(probes.to_torch(rows))
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


# ------------------------------------------- fori_sort_net's kernel model
SORT_NET_SRC = os.path.join(ROOT, "dbg_assembly_tpu_torch", "ops", "csrc",
                            "probe_fori_sort_net.cu")
SORT_WIDTHS = [2 ** p for p in range(1, 11)]


def _source_values():
    """kValues, the elements a lane of csrc/probe_fori_sort_net.cu."""
    with open(SORT_NET_SRC) as f:
        return int(re.search(r"constexpr int kValues = (\d+);", f.read())[1])


def _top_bit(m):
    return 1 << (m.bit_length() - 1)


def _sort_net_stages(w):
    """The kernel's stage masks in order: for k = 2, 4, .., w the mirrored
    stage k - 1, then k / 4, .., 1."""
    masks, k = [], 2
    while k <= w:
        masks.append(k - 1)
        j = k // 4
        while j >= 1:
            masks.append(j)
            j //= 2
        k *= 2
    return masks


def _sort_net_model(x, V, seed=0):
    """csrc/probe_fori_sort_net.cu in numpy on uint32 rows x: blocks of
    256 threads, 8 warps of 32 lanes, lane t of warp u holding V
    consecutive elements, e = 32 V u + V t + q; elements past the last row
    random (the kernel's masked lanes hold values no row reads).  Each
    stage of mask M as the kernel takes it: in the lane (M < V), min to
    register q and max to q ^ M for q < q ^ M; across lanes (M < 32 V),
    register q ^ (M % V) of lane t ^ (M // V), the lane with bit
    top(M // V) clear keeping the min; across warps, the block's elements
    through shared memory, the element with bit top(M) clear keeping the
    min.  Returns the rows and the number of stages of each kind."""
    rows, w = x.shape
    n, per = rows * w, 256 * V
    nb = -(-n // per)
    flat = np.random.default_rng(seed).integers(0, 2 ** 32, nb * per,
                                                dtype=np.uint32)
    flat[:n] = x.reshape(-1)
    a = flat.reshape(nb, 8, 32, V)
    lane, q, e = np.arange(32), np.arange(V), np.arange(per)
    kinds = {"lane": 0, "shuffle": 0, "shared": 0}
    for M in _sort_net_stages(w):
        if M < V:
            b = a[..., q ^ M]
            a = np.where(q < (q ^ M), np.minimum(a, b), np.maximum(a, b))
            kinds["lane"] += 1
        elif M < 32 * V:
            b = a[:, :, lane ^ (M // V), :][..., q ^ (M % V)]
            lower = ((lane & _top_bit(M // V)) == 0)[:, None]
            a = np.where(lower, np.minimum(a, b), np.maximum(a, b))
            kinds["shuffle"] += 1
        else:
            s = a.reshape(nb, per)
            b = s[:, e ^ M]
            lower = (e & _top_bit(M)) == 0
            a = np.where(lower, np.minimum(s, b),
                         np.maximum(s, b)).reshape(a.shape)
            kinds["shared"] += 1
    return a.reshape(-1)[:n].reshape(rows, w), kinds


@pytest.mark.parametrize("V", [4, 8, 16])
@pytest.mark.parametrize("w", SORT_WIDTHS)
def test_sort_net_model_matches_np_sort(w, V):
    """The kernel's network in its register and lane layout sorts every
    row as uint32 at every width, with V = 4, 8 and 16 values a lane, on
    more rows than a block holds (the last block ragged), with the wrap
    values and rows hard for a sort."""
    rows = 256 * V // w + 7
    x = _hard_rows(_u32_with_wraps(w, (rows, w)), np.random.default_rng(w))
    got, kinds = _sort_net_model(x, V)
    assert np.array_equal(got, np.sort(x, axis=1))
    stages = w.bit_length() - 1
    assert sum(kinds.values()) == stages * (stages + 1) // 2
    assert (kinds["shared"] > 0) == (w > 32 * V)


# (values a lane, stages in the lane, stages across lanes) at w = 128:
# a stage shuffles when its mask reaches past the lane's V elements
SORT_NET_KINDS_128 = [(4, 13, 15), (8, 18, 10), (16, 22, 6)]


@pytest.mark.parametrize("V,in_lane,shuffled", SORT_NET_KINDS_128)
def test_sort_net_model_shuffles_at_128(V, in_lane, shuffled):
    """At the probe's width the layout decides how many of the 28 stages
    shuffle (V shuffles a lane each, 32 lanes holding 32 V / 128 rows):
    15 at 4 values a lane, 6 at 16; the source's V is one of these."""
    x = _u32_with_wraps(1, (8, 128))
    got, kinds = _sort_net_model(x, V)
    assert np.array_equal(got, np.sort(x, axis=1))
    assert kinds == {"lane": in_lane, "shuffle": shuffled, "shared": 0}
    assert _source_values() in [k[0] for k in SORT_NET_KINDS_128]


def _sort_edge_cases():
    from chip_smoke import PROBE_EDGE_SHAPES
    return [(shape, off) for shape in PROBE_EDGE_SHAPES["fori_sort_net"]
            for off in (0, 1)]


@pytest.mark.parametrize("shape,off", _sort_edge_cases())
def test_fori_sort_net_plain_and_model_at_edge_shapes(shape, off):
    """At chip_smoke.py's edge shapes, on its buffer of n + 1 elements
    read from offset 0 and 1, with the wrap values and rows hard for a
    sort: the plain version and the model of the kernel with the source's
    values a lane each equal np.sort as uint32; a signed sort differs."""
    n = shape[0] * shape[1]
    flat = _u32_with_wraps(n, (1, n + 1)).reshape(-1)
    x = _hard_rows(flat[off:off + n].reshape(shape).copy(),
                   np.random.default_rng(n))
    want = np.sort(x, axis=1)
    (got,) = probes.fori_sort_net_plain(probes.to_torch(x))
    assert np.array_equal(probes.to_numpy(got, x), want)
    assert np.array_equal(_sort_net_model(x, _source_values())[0], want)
    # rows with values on both sides of the sign bit (every width from 8,
    # by the wrap values), where a signed sort gives another order
    straddles = (x >> 31).min(axis=1) != (x >> 31).max(axis=1)
    assert straddles.any() or shape[1] < 8
    signed = np.sort(x.view(np.int32), axis=1).view(np.uint32)
    assert np.array_equal(signed, want) == (not straddles.any())
