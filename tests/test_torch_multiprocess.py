"""Multi-process ingest (dbg_assembly_tpu_torch/tools/launch_distributed.py
over parallel/ranks.py) against the JAX package: two real processes over
gloo on the CPU, two local slots each, on tests/test_multihost.py's data
(20 kb genome, seeds 31/32, k 17, reads of 100).  Their owner shards are
disjoint and together equal the single-process node tables of both
packages; every .npz array (first_idx included) and the .dist.json equal
those of JAX's tools/launch_distributed.py run the same way.  Three files
over two processes (uneven slices: JAX's launcher would wait forever)
complete with the single-process table.  Ports come from the OS; every
process runs two torch threads and every subprocess has a timeout."""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 17
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argv_of, n: int, cwd: str) -> list[str]:
    """Start n processes (argv_of(pid, port)) at once and wait for all;
    returns their outputs.  Each has TIMEOUT_S seconds."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(argv_of(pid, port), cwd=cwd, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(n)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out)
    for p, out in zip(procs, logs):
        assert p.returncode == 0, out[-3000:]
    return logs


def _torch_argv(lib, out, extra=()):
    def argv(pid, port):
        return [sys.executable, "-m",
                "dbg_assembly_tpu_torch.tools.launch_distributed",
                "--coordinator", f"localhost:{port}", "--num-processes", "2",
                "--process-id", str(pid), "--lib", lib, "-k", str(K),
                "--max-read-len", "100", "--local-slots", "2", "--device",
                "cpu", "--backend", "gloo", "--out", out, *extra]
    return argv


def _stats(log: str) -> dict:
    line = [ln for ln in log.splitlines() if "] stats {" in ln][-1]
    return json.loads(line.split(" stats ", 1)[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The library, both launchers' runs and both single-process tables."""
    from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
    from dbg_assembly_tpu import dna
    from dbg_assembly_tpu.contig.graph import GraphBuilder
    from dbg_assembly_tpu_torch.contig.graph import build_from_files

    d = tmp_path_factory.mktemp("multiprocess")
    genome = make_genome(20_000, seed=31, repeat_frac=0.0)
    r1, q1, r2, q2 = simulate_pe(genome, 100, 300, 6.0, seed=32,
                                 err_start=0.0, err_end=0.0)
    files = [str(d / "reads_1.fq.gz"), str(d / "reads_2.fq.gz")]
    write_fq_gz(files[0], "mh", r1, q1, 1)
    write_fq_gz(files[1], "mh", r2, q2, 2)
    lib = str(d / "reads.lib")
    with open(lib, "w") as f:
        f.write("\n".join(files) + "\n")

    gb = GraphBuilder(K, max_read_len=100)
    for r in (r1, r2):
        codes = dna.ascii_to_codes(r)
        gb.add(codes, np.full(len(codes), 100, np.int32))
    jtable = gb.finalize()
    ttable = build_from_files(files, K, "fq", 100, device="cpu")

    tlogs = _launch(_torch_argv(lib, str(d / "torch")), 2, str(d))
    jlogs = _launch(lambda pid, port: [
        sys.executable, os.path.join(ROOT, "tools", "launch_distributed.py"),
        "--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", str(pid), "--lib", lib, "-k", str(K),
        "--max-read-len", "100", "--cpu-devices", "2", "--out",
        str(d / "jax")], 2, str(d))
    return dict(dir=d, files=files, lib=lib, jtable=jtable, ttable=ttable,
                tlogs=tlogs, jlogs=jlogs)


def _union(prefix: str, n: int = 2):
    """(kmers, lcnt, rcnt) over the processes' shards, by k-mer; the
    shards must be disjoint."""
    z = [np.load(f"{prefix}.p{pid}.npz") for pid in range(n)]
    kmers = np.concatenate([x["kmers"] for x in z])
    assert len(np.unique(kmers)) == len(kmers), "owner shards must be disjoint"
    order = np.argsort(kmers)
    return [np.concatenate([x[f] for x in z])[order]
            for f in ("kmers", "lcnt", "rcnt")]


def _assert_table(got, table):
    for g, name in zip(got, ("kmers", "lcnt", "rcnt")):
        np.testing.assert_array_equal(g, getattr(table, name), err_msg=name)


def test_union_equals_single_process(runs):
    got = _union(str(runs["dir"] / "torch"))
    _assert_table(got, runs["ttable"])
    _assert_table(got, runs["jtable"])
    with open(runs["dir"] / "torch.dist.json") as f:
        meta = json.load(f)
    assert meta == {"num_processes": 2, "n_devices": 4,
                    "total_kmers": runs["jtable"].total_kmers}
    stats = [_stats(log) for log in runs["tlogs"]]
    assert [s["steps"] for s in stats] == [1, 1]
    assert all(s["bytes_across"] > 0 and s["empty_steps"] == 0
               for s in stats)
    assert "2 of 4 slots (rank 1 of 2) on cpu, gloo" in runs["tlogs"][1]


@pytest.mark.parametrize("pid", [0, 1])
def test_files_equal_jax_launcher(runs, pid):
    want = np.load(str(runs["dir"] / f"jax.p{pid}.npz"))
    got = np.load(str(runs["dir"] / f"torch.p{pid}.npz"))
    assert sorted(got.files) == sorted(want.files) == \
        ["first_idx", "kmers", "lcnt", "rcnt"]
    for name in want.files:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # process 1's positions start at 10^12: first_idx is each source
    # process's own stream position
    assert (got["first_idx"] >= 10 ** 12).any()
    a, b = ((runs["dir"] / f"{n}.dist.json").read_bytes()
            for n in ("jax", "torch"))
    assert a == b


def test_uneven_slices_complete(runs):
    """Three files over two processes, 400 rows a step: process 0 feeds
    1200 reads in four steps, process 1 600 in two and two empty ones."""
    from tools.simulate_reads import make_genome, simulate_pe, write_fq_gz
    from dbg_assembly_tpu_torch.contig.graph import build_from_files
    d = runs["dir"] / "uneven"
    d.mkdir()
    genome = make_genome(20_000, seed=31, repeat_frac=0.0)
    r3, q3, _, _ = simulate_pe(genome, 100, 300, 6.0, seed=33,
                               err_start=0.0, err_end=0.0)
    third = str(d / "reads_3.fq.gz")
    write_fq_gz(third, "mh3", r3, q3, 1)
    files = runs["files"] + [third]
    lib = str(d / "three.lib")
    with open(lib, "w") as f:
        f.write("\n".join(files) + "\n")
    logs = _launch(_torch_argv(lib, str(d / "out"), ("--batch-reads",
                                                     "400")), 2, str(d))
    stats = [_stats(log) for log in logs]
    assert [(s["steps"], s["empty_steps"]) for s in stats] == [(4, 0),
                                                               (4, 2)]
    table = build_from_files(files, K, "fq", 100, device="cpu")
    _assert_table(_union(str(d / "out")), table)
    with open(d / "out.dist.json") as f:
        assert json.load(f)["total_kmers"] == table.total_kmers


A2A_SCRIPT = """
import sys, numpy as np, torch
from dbg_assembly_tpu_torch.parallel import count_sharded as cs, mesh, ranks
pid, port = int(sys.argv[1]), sys.argv[2]
m = ranks.init(f"localhost:{port}", 2, pid, 3, "gloo", "cpu", 60)
one = mesh.data_mesh(m.n, "cpu")
mine = slice(m.first_slot, m.first_slot + 3)
# ragged buffers, some empty: arrivals in global source order
bufs = [[torch.arange((s * 7 + t * 3) % 5) + 100 * s + 10 * t
         for t in range(m.n)] for s in range(m.n)]
want = mesh.all_to_all(one, bufs)[mine]
assert all(torch.equal(g, w) for g, w in zip(m.all_to_all(bufs[mine]), want))
assert m.sum_ints(pid + 1, 5) == [3, 10] and m.max_int(pid) == 1
# a 2-periodic read overflows the default capacity: both sides must
# double alike (global rows, global dropped)
codes = np.tile(np.array([0, 1], np.uint8), (60, 32))
codes[::2] = np.random.default_rng(4).integers(0, 4, (30, 64))
lens = np.full(60, 64, np.int32)
c, l = mesh.shard_batch(one, codes, lens)
for step, nrec in ((cs.count_step_exact, 3), (cs.graph_ingest_step_exact, 6)):
    kw = dict(ksize=15) if nrec == 3 else dict(ksize=15, base_index=7)
    *rec_one, st_one = step(c, l, mesh=one, **kw)
    *rec, st = step(c[mine], l[mine], mesh=m, **kw)
    assert st == st_one and st["capacity_doublings"] >= 1, (st, st_one)
    for r, w in zip(rec, rec_one):
        for g, x in zip(r, w[mine]):
            assert (torch.equal(g, x) if torch.is_tensor(g) else g == x)
print("ok", ranks.bytes_across)
"""


def test_collectives_and_steps_over_two_ranks(tmp_path):
    """RankMesh in two processes of three slots each against one process
    of the same six slots: all_to_all (ragged and empty buffers),
    sum_ints, max_int, and count_step_exact / graph_ingest_step_exact on
    an input that overflows the default capacity, so both sides must
    double alike: records, stats, capacity and doublings equal."""
    script = tmp_path / "ranks_check.py"
    script.write_text(A2A_SCRIPT)
    logs = _launch(lambda pid, port: [sys.executable, str(script), str(pid),
                                      str(port)], 2, str(tmp_path))
    assert all("ok " in log for log in logs)


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """Two nccl ranks on a host with one card raise, naming the cause, and
    no process group starts (no switch to gloo).  Both ranks run as
    threads of this process, with torch told of one card."""
    import torch.distributed as dist
    from dbg_assembly_tpu_torch.parallel import ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    port, errors = _free_port(), [None, None]

    def rank(r):
        try:
            ranks.init(f"localhost:{port}", 2, r, 1, "nccl", "cuda", 30)
        except RuntimeError as e:
            errors[r] = str(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(e and "NCCL refuses two ranks on one card" in e
               for e in errors), errors
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="gloo"):
        ranks.init(f"localhost:{port}", 1, 0, 1, "nccl", "cpu", 30)
