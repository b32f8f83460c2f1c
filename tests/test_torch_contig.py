"""debruijn_contig end to end: the port's pipeline.run (device="cpu") and
its CLI against the JAX package's pipeline.run on a simulated ~12 kb
library.  All eight artifacts byte for byte, plus the run log with its
"Run time" values masked."""

import io
import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dbg_assembly_tpu.contig import pipeline as jpipe  # noqa: E402
from dbg_assembly_tpu.contig.refassemble import (  # noqa: E402
    AssembleParams as JParams)
from dbg_assembly_tpu_torch.contig import pipeline as tpipe  # noqa: E402
from dbg_assembly_tpu_torch.contig.refassemble import (  # noqa: E402
    AssembleParams as TParams)

import torch_port_data  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = (".contig.kmer.freq", ".contig.tip.fa", ".contig.lowedge.fa",
            ".contig.bubble.fa", ".contig.seq.fa", ".contig.seq.depth",
            ".contig.small.fa", ".contig.small.depth")


def _normalize(log: str, prefix: str) -> str:
    return re.sub(r"(Run time: )[0-9.e+-]+", r"\1X",
                  log.replace(prefix, "PREFIX"))


def _assert_same_files(jprefix: str, tprefix: str) -> None:
    for suf in SUFFIXES:
        with open(jprefix + suf, "rb") as a, open(tprefix + suf, "rb") as b:
            assert a.read() == b.read(), suf


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return torch_port_data.write_lib(str(tmp_path_factory.mktemp("contig")))


# (init_hash_size -i, max doublings -e): no enlargement; enlargements
# between buffers; enlargements until -e runs out, then the degrade re-pass
@pytest.mark.parametrize("init,doublings", [(0.01, 10), (2e-5, 10),
                                            (2e-5, 1)])
def test_pipeline_matches_jax(lib, tmp_path, init, doublings):
    k = 31
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    jlog, tlog = io.StringIO(), io.StringIO()
    js = jpipe.run(lib, jprefix, ksize=k,
                   params=JParams(ksize=k, init_hash_size=init),
                   log_stream=jlog, log_buffer=100, log_doublings=doublings)
    ts = tpipe.run(lib, tprefix, ksize=k,
                   params=TParams(ksize=k, init_hash_size=init),
                   log_stream=tlog, log_buffer=100, log_doublings=doublings,
                   device="cpu")
    assert vars(ts) == vars(js)
    assert ts.contig_num > 0
    _assert_same_files(jprefix, tprefix)
    tl = _normalize(tlog.getvalue(), tprefix)
    assert tl == _normalize(jlog.getvalue(), jprefix)
    if init < 0.01:
        assert "Enlarge" in tl or "enlarge" in tl
    if doublings == 1:
        assert "Alert" in tl


def test_unported_options_raise(lib, tmp_path, monkeypatch):
    # every option is ported now: the distributed stage (mesh_devices) runs
    # and writes the doubling readout's files
    # (tests/test_torch_mesh_stages.py holds it against JAX's --mesh); on
    # cuda without a card it raises before it writes anything
    params = dict(ksize=31, init_hash_size=0.01)
    tpipe.run(lib, str(tmp_path / "m"), mesh_devices=2, device="cpu",
              params=TParams(**params))
    tpipe.run(lib, str(tmp_path / "d"), readout="doubling", device="cpu",
              params=TParams(**params))
    _assert_same_files(str(tmp_path / "d"), str(tmp_path / "m"))
    from dbg_assembly_tpu_torch import cli
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["debruijn_contig", "--mesh", "4", "-o",
                  str(tmp_path / "c"), lib])
    assert not os.path.exists(str(tmp_path / "c") + ".contig.kmer.freq")


def test_cli_debruijn_contig(lib, tmp_path):
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    jlog = io.StringIO()
    jpipe.run(lib, jprefix, ksize=27, max_read_len=90,
              params=JParams(ksize=27, init_hash_size=0.01,
                             contig_len_cutoff=100),
              log_stream=jlog, log_threads=2)
    proc = subprocess.run(
        [sys.executable, "-m", "dbg_assembly_tpu_torch", "debruijn_contig",
         "-k", "27", "-r", "90", "-i", "0.01", "-M", "100", "-t", "2",
         "-o", tprefix, "--device", "cpu", lib],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    _assert_same_files(jprefix, tprefix)
    assert (_normalize(proc.stderr, tprefix)
            == _normalize(jlog.getvalue(), jprefix))


def test_cli_kmerfreq(lib, tmp_path):
    from dbg_assembly_tpu.kmer import kmerfreq as jkf
    from dbg_assembly_tpu_torch import cli
    jr = jkf.run(lib, ksize=13, low_freq_cutoff=2,
                 out_prefix=str(tmp_path / "jax"))
    assert cli.main(["kmerfreq", "-k", "13", "-m", "2", "--device", "cpu",
                     lib]) == 0
    for suf in (".cz", ".cz.len", ".stat"):
        with open(jr["cz"][:-3] + suf, "rb") as a, \
                open(lib + ".kmer.freq" + suf, "rb") as b:
            assert a.read() == b.read(), suf
