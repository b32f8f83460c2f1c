"""Cleaning in the port (dbg_assembly_tpu_torch.clean) against the JAX
package, exactly: float64 sums, integers and bytes, tolerance 0.

Inputs: the tests/torch_port_data.py library soiled by
dbg_assembly_tpu_torch/tools/soil.py as chip_smoke.py soils its own (the
mate's adapter over a suffix, a Phred 2 tail, an N), random batches made
from a seed with numpy, and hand-built reads (N bases, all
low quality, shorter than -r, empty, lower case, adapters at the start and
the end, tied DP scores), with the default adapters, -b 1 and an adapter
file.  The port runs on the CPU here; chip_smoke.py holds the card against
the CPU.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu.clean import adapter as jad
from dbg_assembly_tpu.clean import lowqual as jlq
from dbg_assembly_tpu.io import fastq as jfq
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch import dna as tdna
from dbg_assembly_tpu_torch import spans
from dbg_assembly_tpu_torch.clean import adapter as tad
from dbg_assembly_tpu_torch.clean import lowqual as tlq
from dbg_assembly_tpu_torch.io import fastq as tfq
from dbg_assembly_tpu_torch.tools.soil import soil
from torch_port_data import write_fastq, write_lib

R1 = jad.DEFAULT_ADAPTERS["R1-adapter"][0][1]
R2 = jad.DEFAULT_ADAPTERS["R2-adapter"][0][1]
TIE_ADAPTER = "ACACACACACACACAC"


def _rand_bases(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _hand_reads() -> list[tuple[str, str, str]]:
    """(name, sequence, qualities) of the hand-built cases."""
    rng = np.random.default_rng(5)
    hi = "".join(chr(c) for c in rng.integers(53, 74, 200))
    b = lambda n: _rand_bases(rng, n)          # noqa: E731
    return [
        ("n_bases", b(40) + "NN" + b(30) + "N" + b(27), hi[:100]),
        ("all_low", b(100), "#" * 100),
        ("short", b(50), hi[:50]),
        ("short_and_low", b(60), hi[:20] + "#" * 40),
        ("empty", "", ""),
        ("lower_case", b(100).lower(), hi[100:200]),
        ("adapter_at_start", R1 + b(67), hi[:100]),
        ("adapter_at_end", b(80) + R1[:20], hi[:100]),
        ("adapter_twice_tie", b(30) + R1[:14] + b(20) + R1[:14] + b(22),
         hi[:100]),
        ("tie_adapter_runs", "AC" * 50, hi[:100]),
        ("tie_adapter_late", b(70) + "ACAC" * 6 + b(6), hi[:100]),
        ("low_tail", b(100), hi[:60] + "#" * 40),
        ("low_middle", b(100), hi[:30] + "#" * 10 + hi[:60]),
        ("n_run_low", b(20) + "N" * 30 + b(50), hi[:100]),
        ("exact_cutoff", b(100), "+" * 100),       # Phred 10 at 0.1
    ]


def _write_hand_fastq(path: str) -> str:
    with open(path, "w") as f:
        for name, s, q in _hand_reads():
            f.write(f"@{name} extra\n{s}\n+\n{q}\n")
    return path


@pytest.fixture(scope="module")
def soiled(tmp_path_factory):
    """The port-data library, soiled; returns its two FASTQ paths."""
    d = tmp_path_factory.mktemp("clean")
    lib = write_lib(str(d))
    with open(lib) as f:
        files = f.read().split()
    out = []
    for mate, path in enumerate(files, start=1):
        b = jfq.read_batch(path, keep_ascii=True)
        reads, quals = b.seqs_ascii.copy(), b.quals.copy()
        soil(reads, quals, mate, seed=10 + mate)
        out.append(str(d / f"soiled_{mate}.fq"))
        write_fastq(out[-1], "s", reads, quals, mate)
    return out


def _batch(seed: int, n: int = 400, L: int = 120):
    """Random qualities (a share at Phred 2), bases with N, ragged lengths
    (some 0) and 2-bit codes with N = 4, from a seed."""
    rng = np.random.default_rng(seed)
    quals = rng.integers(35, 75, (n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.08] = 35
    quals[: n // 10] = 43                        # Phred 10: 0.1 exactly
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[:3] = [0, 1, L]
    seq = np.frombuffer(b"ACGTN", np.uint8)[
        rng.choice(5, (n, L), p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    codes = tdna.ascii_to_codes(seq, strict_n=True)
    # adapters and their prefixes planted at random places
    a = np.array(["ACGT".index(c) for c in R1], np.uint8)
    for i in range(0, n, 4):
        p = int(rng.integers(0, L))
        w = int(rng.integers(8, len(a) + 1))
        codes[i, p:p + w] = a[:min(w, L - p)]
    for i in range(1, n, 9):                     # TIE_ADAPTER's runs
        p = int(rng.integers(0, L - 16))
        codes[i, p:p + 16] = np.tile([0, 1], 8)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return quals, seq, lengths, codes


def test_qual2err_table():
    for shift in (33, 64):
        np.testing.assert_array_equal(tlq.qual2err_table(shift),
                                      jlq.qual2err_table(shift))


@pytest.mark.parametrize("seed,cutoff", [(0, 0.001), (1, 0.01), (2, 0.05),
                                         (3, 0.1)])
def test_lowqual_scan(seed, cutoff):
    quals, _, lengths, _ = _batch(seed)
    want = jlq._lowqual_scan(jnp.asarray(quals), jnp.asarray(lengths),
                             cutoff, 33)
    got = tlq._lowqual_scan(torch.from_numpy(quals),
                            torch.from_numpy(lengths), cutoff, 33)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("chunk", [tlq.DEFAULT_CHUNK, 37])
def test_clean_lowqual_arrays(chunk):
    quals, seq, lengths, _ = _batch(4)
    jres, jq = jlq.clean_lowqual_arrays(quals, seq, lengths, 0.01, 40)
    tres, tq = tlq.clean_lowqual_arrays(quals, seq, lengths, 0.01, 40,
                                        device="cpu", chunk=chunk)
    np.testing.assert_array_equal(tq, jq)
    for name, w in vars(jres).items():
        g = getattr(tres, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert jres.trimmed.any() and jres.short.any()


@pytest.mark.parametrize("adapter", [R1, R2, TIE_ADAPTER, "A"])
def test_align_one_adapter(adapter):
    _, _, lengths, codes = _batch(5)
    codes[5, :40] = np.tile([0, 1], 20)              # runs of tied scores
    acodes = tdna.ascii_to_codes(np.frombuffer(adapter.encode(), np.uint8),
                                 strict_n=True)
    want = jad._align_one_adapter(jnp.asarray(codes), jnp.asarray(lengths),
                                  jnp.asarray(acodes), len(adapter))
    got = tad._align_one_adapter(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), acodes,
                                 len(adapter))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("chunk", [tad.DEFAULT_CHUNK, 53])
def test_clean_adapter_arrays(chunk):
    _, _, lengths, codes = _batch(6)
    adapters = [R1, TIE_ADAPTER, R2]
    want = jad.clean_adapter_arrays(codes, lengths, adapters, 12, 50)
    got = tad.clean_adapter_arrays(codes, lengths, adapters, 12, 50,
                                   device="cpu", chunk=chunk)
    for name, w in vars(want).items():
        g = getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (want.hit == 0).any() and (want.hit == 1).any() and want.short.any()


def _adapter_file(path) -> str:
    with open(path, "w") as f:
        f.write(">tie first\nACACACAC\nACACACAC\n>R1\n" + R1 + "\n")
    return str(path)


@pytest.mark.parametrize("use_rc", [False, True])
def test_load_adapter_file(tmp_path, use_rc):
    path = _adapter_file(tmp_path / "ad.fa")
    assert tad.load_adapter_file(path, use_rc) == \
        jad.load_adapter_file(path, use_rc)


def _gz(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def _same_outputs(jout: str, tout: str) -> None:
    assert _gz(tout) == _gz(jout)
    with open(jout + ".stat", "rb") as a, open(tout + ".stat", "rb") as b:
        assert b.read() == a.read()


def _inputs(soiled, tmp_path, source) -> list:
    return soiled if source == "soiled" else [
        _write_hand_fastq(str(tmp_path / "hand.fq"))]


def _lowqual_outputs(inputs, tmp_path, cutoff) -> None:
    for i, path in enumerate(inputs):
        jout, tout = str(tmp_path / f"j{i}.gz"), str(tmp_path / f"t{i}.gz")
        for mod, out in ((jlq, jout), (tlq, tout)):
            kw = {} if mod is jlq else {"device": "cpu"}
            mod.run_file(path, out, out + ".stat", err_cutoff=cutoff,
                         min_read_len=75, **kw)
        _same_outputs(jout, tout)
        assert b"TrimLowQual" in _gz(tout)


def _adapter_outputs(inputs, tmp_path, adapters, use_rc) -> None:
    if adapters == "file":
        adapters = _adapter_file(tmp_path / "ad.fa")
    for i, path in enumerate(inputs):
        jout, tout = str(tmp_path / f"j{i}.gz"), str(tmp_path / f"t{i}.gz")
        for mod, out in ((jad, jout), (tad, tout)):
            kw = {} if mod is jad else {"device": "cpu"}
            mod.run_file(path, out, out + ".stat", adapter_file=adapters,
                         score_cutoff=12, min_read_len=75, use_rc=use_rc,
                         **kw)
        _same_outputs(jout, tout)
        assert b"Aligned to adapter" in _gz(tout)


def _many_gz_chunks(monkeypatch) -> None:
    """.gz outputs deflated in chunks of 4 KiB, so the fixtures' outputs
    take gz_write_bytes's pool; every io.gzip span of the test is then
    checked to have run more than one chunk."""
    monkeypatch.setattr(tfq, "GZ_CHUNK", 4096)
    monkeypatch.setattr(tfq.os, "sched_getaffinity",
                        lambda pid: set(range(3)))
    spans.reset()


def _took_many_gz_chunks() -> None:
    gz = [r.counts for r in spans.records() if r.name == "io.gzip"]
    assert gz and all(c["chunks"] > 1 and c["workers"] == 3 for c in gz)


@pytest.mark.parametrize("source,cutoff", [("soiled", 0.001),
                                           ("soiled", 0.02), ("hand", 0.001),
                                           ("hand", 0.1)])
def test_lowqual_file(soiled, tmp_path, source, cutoff):
    _lowqual_outputs(_inputs(soiled, tmp_path, source), tmp_path, cutoff)


@pytest.mark.parametrize("source,adapters,use_rc", [
    ("soiled", "Both-adapter", False), ("hand", "Both-adapter", False),
    ("hand", "file", False), ("hand", "file", True),
    ("soiled", "R2-adapter", False)])
def test_adapter_file(soiled, tmp_path, source, adapters, use_rc):
    _adapter_outputs(_inputs(soiled, tmp_path, source), tmp_path, adapters,
                     use_rc)


@pytest.mark.parametrize("cutoff", [0.001, 0.02])
def test_lowqual_file_gz_chunks(soiled, tmp_path, monkeypatch, cutoff):
    """test_lowqual_file with the outputs deflated in many chunks."""
    _many_gz_chunks(monkeypatch)
    _lowqual_outputs(soiled, tmp_path, cutoff)
    _took_many_gz_chunks()


@pytest.mark.parametrize("adapters,use_rc", [("Both-adapter", False),
                                            ("file", True)])
def test_adapter_file_gz_chunks(soiled, tmp_path, monkeypatch, adapters,
                                use_rc):
    """test_adapter_file with the outputs deflated in many chunks."""
    _many_gz_chunks(monkeypatch)
    _adapter_outputs(soiled, tmp_path, adapters, use_rc)
    _took_many_gz_chunks()


def test_cli_clean_two_stages(soiled, tmp_path):
    """clean_lowqual then clean_adapter through both CLIs, as the
    workflow chains them (workflow.clean_reads)."""
    src = soiled[0]
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        lq = str(tmp_path / f"{name}.nonLowQual.gz")
        ad = lq + ".nonAdapter.gz"
        assert main(["clean_lowqual", "-e", "0.02", "-r", "75", "-t", "2",
                     *extra, src, lq, lq[:-3] + ".stat"]) == 0
        assert main(["clean_adapter", "-r", "75", *extra, lq, ad,
                     ad[:-3] + ".stat"]) == 0
        outs[name] = [_gz(lq), _gz(ad)]
        for p in (lq[:-3] + ".stat", ad[:-3] + ".stat"):
            with open(p, "rb") as f:
                outs[name].append(f.read())
    assert outs["torch"] == outs["jax"]


def test_counts():
    quals, seq, lengths, codes = _batch(7, n=50, L=30)
    tlq.reset_counts()
    tlq.clean_lowqual_arrays(quals, seq, lengths, 0.01, 10, device="cpu",
                             chunk=20)
    assert tlq.counts == {"chunks": 3, "steps": 90}
    tad.reset_counts()
    tad.clean_adapter_arrays(codes, lengths, [R1, TIE_ADAPTER], 12, 10,
                             device="cpu", chunk=20)
    assert tad.counts == {"chunks": 6, "steps": 180}


@pytest.mark.gpu
def test_cleaning_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    quals, seq, lengths, codes = _batch(8, n=3000)
    cpu = tlq.clean_lowqual_arrays(quals, seq, lengths, 0.01, 40,
                                   device="cpu")
    gpu = tlq.clean_lowqual_arrays(quals, seq, lengths, 0.01, 40,
                                   device="cuda")
    for name, w in vars(cpu[0]).items():
        np.testing.assert_array_equal(getattr(gpu[0], name), w)
    a = [R1, TIE_ADAPTER]
    cpu = tad.clean_adapter_arrays(codes, lengths, a, 12, 40, device="cpu")
    gpu = tad.clean_adapter_arrays(codes, lengths, a, 12, 40, device="cuda")
    for name, w in vars(cpu).items():
        np.testing.assert_array_equal(getattr(gpu, name), w)


def test_empty_file(tmp_path):
    """An empty input: clean_lowqual writes no read and a .stat of nan
    shares, as JAX does; clean_adapter's .stat divides by zero bases and
    raises, as JAX's does."""
    path = str(tmp_path / "empty.fq")
    open(path, "w").close()
    jout, tout = str(tmp_path / "j.gz"), str(tmp_path / "t.gz")
    jlq.run_file(path, jout, jout + ".stat")
    tlq.run_file(path, tout, tout + ".stat", device="cpu")
    _same_outputs(jout, tout)
    for run, kw in ((jad.run_file, {}), (tad.run_file, {"device": "cpu"})):
        with pytest.raises(ZeroDivisionError):
            run(path, tout, tout + ".stat", **kw)


if __name__ == "__main__":
    raise SystemExit(pytest.main([os.path.abspath(__file__), "-q"]))
