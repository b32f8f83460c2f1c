"""The port's driver hooks (dbg_assembly_tpu_torch/graft_entry.py) against
__graft_entry__.py on the CPU: entry()'s inputs and its step's outputs,
and the distributed dry run's contig FASTA, mesh .map_pair.2ctg and
scaffold FASTA against what the JAX package's single-device stages write
on the same seeded inputs.  Exact equality: integers and bytes."""

import gzip
import os

import numpy as np
import pytest

import __graft_entry__ as jentry
from dbg_assembly_tpu.contig.graph import GraphBuilder as JGraphBuilder
from dbg_assembly_tpu.contig.pointer_doubling import assemble_doubling
from dbg_assembly_tpu.contig.refassemble import AssembleParams as JParams
from dbg_assembly_tpu.kmer import count as jcount
from dbg_assembly_tpu.scaffold import map_pair as jmap_pair
from dbg_assembly_tpu.scaffold import scaffold as jscaffold
from dbg_assembly_tpu_torch import graft_entry
from dbg_assembly_tpu_torch.ops.chop import SENTINEL
from test_torch_mesh import two_torch_threads  # noqa: F401 (autouse)


def _read(path: str) -> bytes:
    with (gzip.open(path, "rb") if path.endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def test_entry_inputs_are_jax():
    _, (jc, jl) = jentry.entry()
    _, (tc, tl) = graft_entry.entry("cpu")
    for t, j in ((tc, jc), (tl, jl)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and t.shape == j.shape
        assert t.numpy().tobytes() == j.tobytes()


def test_entry_step_matches_jax():
    jstep, jargs = jentry.entry()
    tstep, targs = graft_entry.entry("cpu")
    ju, jc, jn, jv = (np.asarray(x) for x in jstep(*jargs))
    tu, tc, tn, tv = tstep(*targs)
    tu = tu.numpy()
    # the port's INT64_MAX sentinel stands where JAX's all-ones uint64 does
    assert np.array_equal(tu == SENTINEL, ju == jcount.SENTINEL)
    keep = ju != jcount.SENTINEL
    assert np.array_equal(tu[keep].view(np.uint64), ju[keep])
    assert np.array_equal(tc.numpy(), jc)
    assert (tn, tv) == (int(jn), int(jv))
    assert tn > 0 and tv == 256 * (150 - 31 + 1)


def _jax_artifacts(workdir: str):
    """__graft_entry__.dryrun_multichip's inputs through the JAX package's
    single-device stages (the mesh stages equal them, as its own tests
    hold): ingest, the doubling readout, map_pair, scaffolding.  Returns
    the paths of the contig FASTA, the .map_pair.2ctg.gz and the scaffold
    FASTA."""
    ksize = 21
    rng = np.random.default_rng(1)
    segA, gap, segB, L = 1500, 60, 1500, 64
    glen = segA + segB
    N = 768
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    startsA = rng.integers(0, segA - L, size=N // 2)
    startsB = rng.integers(segA, glen - L, size=N - N // 2)
    starts = np.concatenate([startsA, startsB])
    codes = np.stack([genome[s:s + L] for s in starts]).astype(np.uint8)
    lengths = np.full(N, L, np.int32)
    gb = JGraphBuilder(ksize)
    gb.add(codes, lengths)
    prefix = os.path.join(workdir, "dry")
    assemble_doubling(gb.finalize(), JParams(
        ksize=ksize, init_hash_size=0.0001, contig_len_cutoff=100), prefix)
    contig_fa = prefix + ".contig.seq.fa"
    insert, n_pairs = 300, 48
    s1 = rng.integers(segA + gap // 2 + L - insert, segA - L, size=n_pairs)
    comp = (3 - genome)[::-1]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fqs = []
    for mate, reads in ((1, np.stack([genome[s:s + L] for s in s1])),
                        (2, np.stack([comp[glen - (s + insert):][:L]
                                      for s in s1]))):
        fqs.append(os.path.join(workdir, f"p_{mate}.fq.gz"))
        with gzip.open(fqs[-1], "wb") as f:
            for i, row in enumerate(reads):
                f.write(b"@p%d/%d\n" % (i, mate) + acgt[row].tobytes()
                        + b"\n+\n" + b"I" * L + b"\n")
    lib = os.path.join(workdir, "pairs.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in fqs))
    out = os.path.join(workdir, "map")
    jmap_pair.run(contig_fa, lib, out, ksize=ksize, seed_kmer_num=3,
                  min_ctg_len=100, min_read_len=L, min_identity=0.95, fmt=1)
    twoctg = os.path.join(out, "p_1.fq.gz.map_pair.2ctg.gz")
    with open(os.path.join(workdir, "twoctg.lib"), "w") as f:
        f.write(twoctg + "\n")
    jscaffold.run(contig_fa, os.path.join(workdir, "twoctg.lib"), contig_fa,
                  insert_size=insert, pair_num_cut=3, is_mate=False)
    return contig_fa, twoctg, contig_fa + f".insert{insert}.scaffold.seq.fa"


def test_dryrun_artifacts_match_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = graft_entry._dryrun(2, str(tmp_path / "port"), "cpu")
    want = _jax_artifacts(str(tmp_path / "jax"))
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        assert _read(g) == _read(w), os.path.basename(g)
    assert _read(got[2]).startswith(b">scf_1")


def test_dryrun_multichip_returns_none():
    assert graft_entry.dryrun_multichip(4, device="cpu") is None


def test_main_prints_dryrun_ok(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert graft_entry.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "dryrun ok"
    assert "30720 unique of 30720 k-mers" in lines[0]
    assert os.listdir(tmp_path) == []


def test_dryrun_needs_a_card_for_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: graft_entry.entry(),
               lambda: graft_entry.dryrun_multichip(4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
