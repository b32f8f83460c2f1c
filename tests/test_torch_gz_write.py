"""gz_write_bytes on the host pool (dbg_assembly_tpu_torch/io/fastq.py on
io/pool.py): one gzip member whose bytes follow the input and the level
alone, whatever the worker count; an input of one chunk or less is the
serial zlib stream's bytes exactly."""

import functools
import gzip
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest

from dbg_assembly_tpu_torch import spans
from dbg_assembly_tpu_torch.io import fastq, pool

CHUNK = fastq.GZ_CHUNK
WORKERS = [1, 2, 8]
SIZES = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 11 * CHUNK // 2]


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


def _cores(monkeypatch, n):
    """The process may run on n cores."""
    monkeypatch.setattr(fastq.os, "sched_getaffinity",
                        lambda pid: set(range(n)))


@functools.lru_cache(maxsize=None)
def _text(n, seed=0):
    """n bytes of lines drawn from a small vocabulary of 100-byte lines
    and random bases, so repeats reach across every chunk boundary."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 99)) + b"\n"
             for _ in range(64)]
    out = bytearray()
    while len(out) < n:
        if rng.random() < 0.7:
            out += vocab[int(rng.integers(0, len(vocab)))]
        else:
            out += bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), 77))
            out += b"\n"
    return bytes(out[:n])


@functools.lru_cache(maxsize=None)
def _fastq(n, seed=0):
    """About n bytes of one-line FASTQ: 250 bp reads, qualities drifting
    along the read."""
    rng = np.random.default_rng(seed)
    reads = -(-n // 530)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (reads, 250))]
    quals = (rng.integers(0, 10, (reads, 250)).cumsum(1) % 40 + 35)
    quals = quals.astype(np.uint8)
    out = bytearray()
    for i in range(reads):
        out += b"@r%d/1\n" % i + seqs[i].tobytes() + b"\n+\n"
        out += quals[i].tobytes() + b"\n"
    return bytes(out)


def _serial(data, level=1):
    """The serial writer's bytes: one zlib stream."""
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def _write(tmp_path, data, level=1):
    path = tmp_path / "t.gz"
    fastq.gz_write_bytes(str(path), data, level)
    return path.read_bytes()


def _one_member(gz, data):
    """gz decompresses to data, and zlib's gzip reader ends at its end."""
    assert gzip.decompress(gz) == data
    d = zlib.decompressobj(31)
    assert d.decompress(gz) + d.flush() == data
    assert d.eof and d.unused_data == b""


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("n", SIZES)
def test_round_trip_one_member(tmp_path, monkeypatch, n, workers):
    _cores(monkeypatch, workers)
    data = _text(n, seed=n)
    gz = _write(tmp_path, data)
    _one_member(gz, data)
    serial = _serial(data)
    if n <= CHUNK:
        assert gz == serial
    else:
        assert gz[:10] == serial[:10]


@pytest.mark.parametrize("n", [CHUNK + 1, 11 * CHUNK // 2])
def test_bytes_follow_the_input_alone(tmp_path, monkeypatch, n):
    """The same bytes at 1, 2 and 8 workers, and from 64 workers
    switching threads often."""
    data = _text(n, seed=3)
    got = []
    interval = sys.getswitchinterval()
    try:
        for workers in WORKERS + [64]:
            _cores(monkeypatch, workers)
            sys.setswitchinterval(1e-6 if workers == 64 else interval)
            got.append(_write(tmp_path, data))
    finally:
        sys.setswitchinterval(interval)
    assert all(g == got[0] for g in got)


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("n", [CHUNK // 2, 3 * CHUNK + 5])
def test_level(tmp_path, monkeypatch, level, n):
    """The caller's level is the one each chunk deflates at: a small
    input is zlib's stream at that level, and a large one is as small as
    that level's serial stream, within 0.5 %."""
    _cores(monkeypatch, 4)
    data = _fastq(n, seed=level)
    gz = _write(tmp_path, data, level)
    _one_member(gz, data)
    serial = _serial(data, level)
    assert gz[:10] == serial[:10]
    if n <= CHUNK:
        assert gz == serial
    assert abs(len(gz) / len(serial) - 1) < 0.005
    other = _serial(data, 7 - level)
    assert abs(len(gz) / len(other) - 1) > 0.005


def test_size_near_the_serial_writer(tmp_path, monkeypatch):
    """On 8 MiB of one-line FASTQ the member is within 0.5 % of the
    serial stream's size."""
    _cores(monkeypatch, 8)
    data = _fastq(8 * CHUNK, seed=5)
    gz = _write(tmp_path, data)
    assert abs(len(gz) / len(_serial(data)) - 1) < 0.005


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("n", [0, CHUNK, 5 * CHUNK + 9])
def test_span_counts(tmp_path, monkeypatch, n, workers):
    """io.gzip records its chunks and workers beside its bytes; the pool
    threads open no span."""
    _cores(monkeypatch, workers)
    with spans.span("caller") as caller:
        gz = _write(tmp_path, _text(n))
    chunks = max(1, -(-n // CHUNK))
    [rec] = [r for r in spans.records() if r.name == "io.gzip"]
    assert rec.counts == {"bytes_in": n, "bytes_out": len(gz),
                          "chunks": chunks,
                          "workers": min(workers, chunks)}
    assert {r.thread for r in spans.records()} == {caller.thread}


def test_one_chunk_runs_without_a_pool(tmp_path, monkeypatch):
    """An input of one chunk is deflated in the caller's thread, whatever
    the cores."""
    _cores(monkeypatch, 8)

    def no_pool(*a, **kw):
        raise AssertionError("a pool for one chunk")
    monkeypatch.setattr(pool, "ThreadPoolExecutor", no_pool)
    data = _text(CHUNK)
    assert _write(tmp_path, data) == _serial(data)


def test_gzip_tool_accepts_the_member(tmp_path, monkeypatch):
    """The gzip tool reads a member of several chunks as one file."""
    if shutil.which("gzip") is None:
        pytest.skip("no gzip on the path")
    _cores(monkeypatch, 4)
    data = _text(3 * CHUNK + 17, seed=9)
    path = tmp_path / "t.gz"
    fastq.gz_write_bytes(str(path), data)
    subprocess.run(["gzip", "-t", str(path)], check=True)
    out = subprocess.run(["gzip", "-dc", str(path)], check=True,
                         capture_output=True).stdout
    assert out == data


def test_bytearray_and_readers(tmp_path, monkeypatch):
    """A bytearray writes what its bytes write, and the port's reader
    parses the member."""
    _cores(monkeypatch, 4)
    data = _fastq(2 * CHUNK + 100, seed=2)
    assert _write(tmp_path, bytearray(data)) == _write(tmp_path, data)
    batch = fastq.read_batch(str(tmp_path / "t.gz"))
    assert batch.n_reads == data.count(b"\n+\n")


@pytest.mark.parametrize("chunk", [1024, 4096, 16384])
def test_small_chunks_primed_with_the_input_before(tmp_path, monkeypatch,
                                                   chunk):
    """A chunk smaller than deflate's window is still primed with the
    input before it, up to 32 KiB: 8 KiB of random bytes repeated eight
    times compress to little more than one copy, and read back whole."""
    _cores(monkeypatch, 3)
    monkeypatch.setattr(fastq, "GZ_CHUNK", chunk)
    block = np.random.default_rng(chunk).bytes(8192)
    data = block * 8
    gz = _write(tmp_path, data)
    assert gzip.decompress(gz) == data
    assert len(gz) < 8192 + 2048
