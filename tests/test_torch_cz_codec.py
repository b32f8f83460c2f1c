"""The .cz table codec on the host pool (dbg_assembly_tpu_torch/io/cz.py
on io/pool.py): the .cz and .cz.len bytes are a serial zlib loop's at
every worker count, the reader gives each table back exactly, a damaged
table raises as the serial reader does, and the pool keeps its order and
its bound."""

import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from dbg_assembly_tpu_torch import spans
from dbg_assembly_tpu_torch.io import cz, pool

BITS = cz.SRC_BLOCK_KMERS // 8          # source block of the 1-bit table
BYTES = cz.SRC_BLOCK_KMERS              # of the 8-bit table
FORMATS = {"bits": (cz.write_cz_bits, BITS),
           "bytes": (cz.write_cz_bytes, BYTES)}
WORKERS = [1, 2, 8]


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


def _cores(monkeypatch, n):
    """The process may run on n cores."""
    monkeypatch.setattr(pool.os, "sched_getaffinity",
                        lambda pid: set(range(n)))


def _table(n, seed, fmt):
    """n bytes of a sparse table: a 1-bit table's few set bits, or an
    8-bit table's counts, mostly 0."""
    rng = np.random.default_rng(seed)
    t = np.zeros(n, np.uint8)
    hits = rng.integers(0, n, size=max(1, n // 300))
    if fmt == "bits":
        t[hits] = 1 << rng.integers(0, 8, size=len(hits))
    else:
        t[hits] = rng.integers(1, 256, size=len(hits))
    return t


def _serial(table, block, level):
    """The serial writer's bytes: each block its own zlib stream."""
    comps = [zlib.compress(table[o:o + block].tobytes(), level)
             for o in range(0, len(table), block)]
    return b"".join(comps), "".join(f"{len(c)}\n" for c in comps)


def _serial_read(path, n, block):
    """The serial reader: one block after another from the file."""
    out = np.zeros(n, np.uint8)
    sizes = [int(x) for x in Path(path + ".len").read_text().split()]
    with open(path, "rb") as f:
        for i, s in enumerate(sizes):
            raw = zlib.decompress(f.read(s))
            out[i * block:i * block + len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def _files(path):
    """The .cz bytes and the .cz.len text at path."""
    return Path(path).read_bytes(), Path(path + ".len").read_text()


def _read(path, n, block):
    return cz._read_blocks(path, np.zeros(n, np.uint8), block)


# blocks: a ragged last block past IN_FLIGHT blocks a worker at 2
# workers, a table smaller than one block, and whole blocks
SHAPES = {"bits": {"ragged": 10 * BITS + 12345, "small": 4097,
                   "whole": 3 * BITS},
          "bytes": {"ragged": 2 * BYTES + 777, "small": 65536,
                    "whole": BYTES}}


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("shape", ["ragged", "small", "whole"])
@pytest.mark.parametrize("fmt", ["bits", "bytes"])
def test_bytes_match_serial_and_round_trip(tmp_path, monkeypatch, fmt,
                                           shape, workers):
    _cores(monkeypatch, workers)
    write, block = FORMATS[fmt]
    n = SHAPES[fmt][shape]
    table = _table(n, n, fmt)
    path = str(tmp_path / "t.cz")
    with spans.span("caller") as caller:
        write(path, table)
        back = _read(path, n, block)
    assert _files(path) == _serial(table, block, 1)
    np.testing.assert_array_equal(back, table)
    blocks = -(-n // block)
    recs = [r for r in spans.records() if r.name.startswith("io.cz_")]
    assert [r.name for r in recs] == ["io.cz_write", "io.cz_read"]
    for r in recs:
        assert r.counts == {"bytes": n, "blocks": blocks,
                            "workers": min(workers, blocks)}
    # no pool thread opened a span
    assert {r.thread for r in spans.records()} == {caller.thread}


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("level", [0, 6, 9])
def test_level(tmp_path, monkeypatch, level, workers):
    """A level other than the default 1, each worker count the serial
    loop's bytes."""
    _cores(monkeypatch, workers)
    table = _table(4 * BITS + 99, level, "bits")
    path = str(tmp_path / "t.cz")
    cz.write_cz_bits(path, table, level=level)
    assert _files(path) == _serial(table, BITS, level)
    np.testing.assert_array_equal(_read(path, len(table), BITS), table)


@pytest.mark.parametrize("workers", WORKERS)
def test_read_serial_files(tmp_path, monkeypatch, workers):
    """Files a serial writer made, at the public readers' sizes (k = 12:
    2 MiB and 16 MiB), read back as the serial reader reads them."""
    _cores(monkeypatch, workers)
    for fmt, read, n in (("bits", cz.read_cz_bits, 4 ** 12 // 8),
                         ("bytes", cz.read_cz_bytes, 4 ** 12)):
        block = FORMATS[fmt][1]
        table = _table(n, 7, fmt)
        path = str(tmp_path / f"{fmt}.cz")
        data, lens = _serial(table, block, 1)
        Path(path).write_bytes(data)
        Path(path + ".len").write_text(lens)
        np.testing.assert_array_equal(read(path, 12), table)
        np.testing.assert_array_equal(_serial_read(path, n, block), table)


def _damage(path, how):
    data, lens = _files(path)
    sizes = [int(x) for x in lens.split()]
    mid = sum(sizes[:2]) + sizes[2] // 2   # inside the third block
    if how == "truncated":
        Path(path).write_bytes(data[:mid])
    elif how == "extra_len":               # .len lists one block too many
        Path(path + ".len").write_text(lens + f"{sizes[-1]}\n")
    else:                                  # a middle block's bytes broken
        Path(path).write_bytes(data[:mid] + bytes(16) + data[mid + 16:])


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("how", ["truncated", "extra_len", "corrupt"])
def test_damaged_table_raises_as_serial(tmp_path, monkeypatch, how,
                                        workers):
    _cores(monkeypatch, workers)
    n = 6 * BITS
    path = str(tmp_path / "t.cz")
    cz.write_cz_bits(path, _table(n, 3, "bits"))
    _damage(path, how)
    with pytest.raises(zlib.error) as serial:
        _serial_read(path, n, BITS)
    with pytest.raises(zlib.error) as pooled:
        _read(path, n, BITS)
    assert str(pooled.value) == str(serial.value)


def test_stress_more_workers_than_cores(tmp_path, monkeypatch):
    """64 workers, more than the cores, switching threads every
    microsecond: every block lands in its place, in both directions."""
    _cores(monkeypatch, 64)
    n = 70 * BITS + 5
    table = _table(n, 11, "bits")
    path = str(tmp_path / "t.cz")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cz.write_cz_bits(path, table)
        back = _read(path, n, BITS)
    finally:
        sys.setswitchinterval(interval)
    assert _files(path) == _serial(table, BITS, 1)
    np.testing.assert_array_equal(back, table)


def test_workers_follow_cores_and_blocks(monkeypatch):
    _cores(monkeypatch, 3)
    assert [pool.workers(b) for b in (0, 1, 2, 3, 10)] == [1, 1, 2, 3, 3]


def test_one_block_runs_without_a_pool(tmp_path, monkeypatch):
    """A table of one block is deflated and inflated in the caller's
    thread, whatever the cores."""
    _cores(monkeypatch, 8)

    def no_pool(*a, **kw):
        raise AssertionError("a pool for one block")
    monkeypatch.setattr(pool, "ThreadPoolExecutor", no_pool)
    table = _table(BITS, 5, "bits")
    path = str(tmp_path / "t.cz")
    cz.write_cz_bits(path, table)
    np.testing.assert_array_equal(_read(path, BITS, BITS), table)


def test_in_flight_bound(monkeypatch):
    """The pool runs at most IN_FLIGHT blocks a worker ahead of the
    caller, and hands the results back in order."""
    started = []
    got = []

    def fn(i):
        started.append(i)
        return i * i
    for r in pool.in_order(fn, range(100), 2):
        assert len(started) <= len(got) + pool.IN_FLIGHT * 2
        got.append(r)
    assert got == [i * i for i in range(100)]


def test_raise_in_a_worker_reaches_the_caller_in_order():
    """The first item to raise, in item order, is the one the caller
    sees, as in a serial loop; the results before it arrive first."""
    got = []

    def fn(i):
        if i in (5, 9):
            raise ValueError(i)
        return i
    with pytest.raises(ValueError) as err:
        for r in pool.in_order(fn, range(40), 4):
            got.append(r)
    assert got == [0, 1, 2, 3, 4] and err.value.args == (5,)
