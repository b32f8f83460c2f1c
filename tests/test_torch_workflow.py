"""The port's whole workflow (dbg_assembly_tpu_torch.workflow and the
``pipeline`` command) against the JAX package's, exactly: every file under
both work dirs, .gz decompressed, after the work dir's own path is replaced
in the .lib/.para lists that name it.

The data have golden.sim_dataset's shape (a 200 kb genome, 150 bp pairs
at 20x, inserts 400 and 800, so two scaffold rounds run; 100 kb for the
command) and are made in the test's own directory; they are cleaned,
counted, corrected, assembled with both readouts, mapped and scaffolded.
The port runs on the CPU here (chip_smoke.py phase 15 runs it on the
card).
"""

import gzip
import os

import pytest
import torch

from dbg_assembly_tpu import cli as jcli
from dbg_assembly_tpu import workflow as jwf
from dbg_assembly_tpu_torch import cli as tcli
from dbg_assembly_tpu_torch import workflow as twf
from tools.simulate_reads import generate_dataset

CFG = dict(correct_k=13, init_hash_size=0.01, map_min_read=100)


def _tree(root: str) -> dict:
    """Every file under root by relative path, .gz decompressed, root's
    path replaced."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with (gzip.open(p, "rb") if p.endswith(".gz") else
                  open(p, "rb")) as f:
                out[os.path.relpath(p, root)] = \
                    f.read().replace(root.encode(), b"<work>")
    return out


def _same_tree(got: str, want: str) -> int:
    g, w = _tree(got), _tree(want)
    assert sorted(g) == sorted(w)
    bad = [k for k in w if g[k] != w[k]]
    assert not bad, bad
    return len(w)


def _dataset(d, genome_len: int) -> list:
    """golden.sim_dataset's libraries, made in d: [(read1, read2, insert)]."""
    return generate_dataset(str(d), genome_len, 150, 20.0, (400, 800),
                            seed=7)["libs"]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("sim"), 200_000)


@pytest.mark.parametrize("readout", ["exact", "doubling"])
def test_run_full(libs, tmp_path, readout):
    jw, tw = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jwf.run_full(libs, jwf.PipelineConfig(readout=readout, **CFG), jw)
    got = twf.run_full(libs, twf.PipelineConfig(readout=readout,
                                                device="cpu", **CFG), tw)
    assert got == {k: v.replace(jw, tw) for k, v in want.items()}
    n = _same_tree(tw, jw)
    # the cleaning, counting, correction, contig and two scaffold rounds'
    # files, each round's scaffolds the next round's contigs
    assert n > 50
    assert got["scaffolds"].endswith(".insert400.scaffold.seq.fa"
                                     ".insert800.scaffold.seq.fa")
    with open(got["scaffolds"]) as f:
        assert f.read().count(">") > 0


def test_pipeline_cli(tmp_path, capsys):
    """``pipeline -k 13 -p recipe.para`` through both CLIs: a recipe of the
    raw pairs, longest insert ranked first; the recipe's read lists sit
    beside it, outside the work dir, where map_pair writes its
    .map_pair.2ctg.lib lists.  A 100 kb genome."""
    libs = _dataset(tmp_path / "sim", 100_000)
    printed = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        para = d / "recipe.para"
        rows = ["#scaf_rank kmer_size seedKmerNum align_ident insert_size "
                "pairNumCut is_mate read_file"]
        for rank, (r1, r2, ins) in zip((2, 1), libs):
            lib = d / f"raw_{ins}.lib"
            lib.write_text(f"{r1}\n{r2}\n")
            rows.append(f"{rank} 27 5 0.95 {ins} 2 0 {lib}")
        para.write_text("\n".join(rows) + "\n")
        specs = [f"{r1},{r2},{ins}" for r1, r2, ins in libs]
        assert main(["pipeline", "-k", "13", "-w", str(d / "work"), "-p",
                     str(para), *extra, *specs]) == 0
        printed[name] = capsys.readouterr().out.replace(str(d), "<d>")
    assert printed["torch"] == printed["jax"]
    assert ".insert800.scaffold.seq.fa.insert400.scaffold" in printed["jax"]
    assert _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax")) > 50


def test_mesh_raises(libs, tmp_path, monkeypatch):
    """mesh_devices is ported (tests/test_torch_mesh_stages.py runs it
    against JAX's); its slots on cuda without a card raise before the
    workflow writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        twf.run_full(libs, twf.PipelineConfig(mesh_devices=2, **CFG),
                     str(tmp_path))
    assert not os.listdir(tmp_path)


def test_every_command_ported():
    assert sorted(tcli.COMMANDS) == sorted(jcli.COMMANDS)
    assert len(tcli.COMMANDS) == 22
