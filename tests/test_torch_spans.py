"""The port's span recorder (dbg_assembly_tpu_torch/spans.py): the record
itself, the spans each command of the benchmark's chains takes on a tiny
input through cli.main on the CPU, the clock against torch.profiler's
exported timeline, and the Chrome trace DBG_TRACE_OUT writes."""

import ast
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from dbg_assembly_tpu_torch import cli, spans
from dbg_assembly_tpu_torch.io import fastq
from dbg_assembly_tpu_torch.tools.soil import soil
from torch_port_data import write_fastq, write_lib

# the spans of each layer (the benchmark's per-layer metrics read them)
IO = {"io.parse", "io.gzip", "io.cz_write", "io.cz_read"}
COUNTING = {"kmerfreq.qsplit", "kmerfreq.count", "kmerfreq.finalize",
            "kmerfreq.table_write"}
CORRECTION = {"correct.table_load", "correct.table_upload",
              "correct.table_expand", "correct.host_table",
              "correct.engine", "correct.fallback", "correct.format"}
DOUBLING = {"contig.doubling." + s for s in (
    "graph_init", "calc_links", "kmer.freq", "tips", "lowedges", "bubbles",
    "readout", "succ_resolve", "heads", "body_scatters", "seed_argmin",
    "chain_loop", "write_files")}
CONTIG = {"contig.ingest", "contig.parse_wait", "contig.finalize",
          "contig.schedule", "contig.readout", "contig.readout.layout",
          "contig.readout.replay"} | DOUBLING
CLEANING = {"lowqual.scan", "adapter.align", "lowqual.format",
            "adapter.format"}
MAPPING = {"scaffold.index", "scaffold.map", "map_pair.parse",
           "map_pair.format", "map_pair.write"}
SCAFFOLDING = {"link_scaffold.read", "link_scaffold.graph",
               "link_scaffold.readout"}
TABLE = IO | COUNTING | CORRECTION | CONTIG | CLEANING | MAPPING \
    | SCAFFOLDING


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


# ------------------------------------------------------------ the record
def test_nesting_parents_and_counts():
    with spans.command("x") as cmd:
        with spans.span("a", n=1) as a:
            with spans.span("b") as b:
                spans.add(n=2)
                spans.add(n=3, m=1)
            spans.add(n=4)
        with spans.span("c") as c:
            pass
    recs = spans.records()
    assert [r.name for r in recs] == ["cmd.x", "a", "b", "c"]
    assert [r.index for r in recs] == [0, 1, 2, 3]
    assert cmd.parent == -1 and a.parent == 0 and b.parent == 1 \
        and c.parent == 0
    assert a.counts == {"n": 5} and b.counts == {"n": 5, "m": 1}
    assert c.counts == {}
    assert cmd.start <= a.start <= b.start <= b.end <= a.end <= c.start \
        <= c.end <= cmd.end
    assert a.seconds == (a.end - a.start) / 1e9
    assert {r.thread for r in recs} == {threading.get_native_id()}
    spans.add(n=1)                      # no span open: nothing to count
    assert spans.dropped() == 0


def test_threads_and_command_ids():
    """A span on a helper thread takes the command's id, and the
    command's span as its parent where its thread has none open."""
    got = {}

    def helper():
        with spans.span("h") as h:
            with spans.span("h2") as h2:
                got.update(h=h, h2=h2, tid=threading.get_native_id())

    with spans.command("one") as one:
        t = threading.Thread(target=helper)
        t.start()
        t.join()
        with spans.span("main") as main:
            pass
    with spans.command("two") as two:
        with spans.span("later") as later:
            pass
    with spans.span("outside") as outside:
        pass
    h, h2 = got["h"], got["h2"]
    assert one.command >= 1 and two.command == one.command + 1
    assert h.command == h2.command == main.command == one.command
    assert later.command == two.command and outside.command == 0
    assert h.parent == one.index and h2.parent == h.index
    assert main.parent == one.index and outside.parent == -1
    assert h.thread == got["tid"] != main.thread
    assert later.parent == two.index


def test_nested_commands_restore_the_outer_one():
    with spans.command("outer") as outer:
        with spans.command("inner") as inner:
            with spans.span("x") as x:
                pass
        with spans.span("y") as y:
            pass
    assert inner.parent == outer.index and inner.command != outer.command
    assert x.command == inner.command and y.command == outer.command


def test_bound_and_dropped(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.command("x"):
        for _ in range(4):
            with spans.span("s") as s:
                pass
    recs = spans.records()
    assert len(recs) == 3 and spans.dropped() == 2
    assert s.index == -1 and s.end is not None     # still timed
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0
    with spans.span("again") as s:
        pass
    assert s.index == 0


def test_span_closes_what_an_exception_left_open():
    with pytest.raises(ValueError):
        with spans.span("outer") as outer:
            spans._begin("left open", {})
            raise ValueError
    with spans.span("next") as nxt:
        pass
    assert outer.end is not None and nxt.parent == -1


def test_threads_record_concurrently():
    """Many threads, each nesting spans under one command, with the
    interpreter switching threads often: every span is kept once, at its
    own index, with its own thread's parent."""
    import sys
    per, threads = 200, 16
    done = []

    def work():
        for _ in range(per):
            with spans.span("outer") as o:
                with spans.span("inner") as i:
                    spans.add(n=1)
            done.append((o, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.command("x") as cmd:
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    recs = spans.records()
    assert len(recs) == 1 + 2 * per * threads == len(set(map(id, recs)))
    assert [r.index for r in recs] == list(range(len(recs)))
    for o, i in done:
        assert o.parent == cmd.index and i.parent == o.index
        assert i.thread == o.thread and i.counts == {"n": 1}
        assert o.command == i.command == cmd.command


def test_recorder_reads_no_tensor():
    """The recorder imports nothing that could read or wait on the
    device: the standard library only."""
    tree = ast.parse(open(spans.__file__).read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "contextlib", "itertools", "json", "os",
                    "threading", "time"}, mods


# ------------------------------------------------- the commands' spans
@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The port-data library and a soiled copy of each of its files."""
    d = tmp_path_factory.mktemp("spans")
    lib = write_lib(str(d))
    with open(lib) as f:
        files = f.read().split()
    soiled = []
    for mate, path in enumerate(files, start=1):
        b = fastq.read_batch(path, keep_ascii=True)
        reads, quals = b.seqs_ascii.copy(), b.quals.copy()
        soil(reads, quals, mate, seed=20 + mate)
        soiled.append(str(d / f"soiled_{mate}.fq"))
        write_fastq(soiled[-1], "s", reads, quals, mate)
    return str(d), lib, soiled


def _run(argv):
    """Run one command through cli.main on the CPU; its records."""
    before = len(spans.records())
    cli.main(argv + ["--device", "cpu"])
    recs = spans.records()
    mine = recs[before:]
    cmd = mine[0]
    assert cmd.name == "cmd." + argv[0] and cmd.parent == -1
    for r in mine[1:]:
        assert r.command == cmd.command and r.end is not None
        assert cmd.start <= r.start <= r.end <= cmd.end
        i = r.parent
        while i != cmd.index:              # nested in the command's span
            assert i > cmd.index
            i = recs[i].parent
    names = {r.name for r in mine[1:]}
    assert names <= TABLE, names - TABLE
    return mine


def _names(recs):
    return {r.name for r in recs[1:]}


def test_chain_spans(library, tmp_path):
    """The five commands of the benchmark's three chains, each with its
    table's spans nested in its command's span, and no other name."""
    d, lib, soiled = library
    kf = _run(["kmerfreq", "-k", "13", "-m", "1", "-q", "10", lib])
    assert _names(kf) == {"io.parse", "kmerfreq.qsplit", "kmerfreq.count",
                          "kmerfreq.finalize", "kmerfreq.table_write",
                          "io.cz_write"}
    by = {r.name: r for r in kf}
    assert by["io.cz_write"].parent == by["kmerfreq.table_write"].index
    # the 4^13 / 8 = 8 MiB table in blocks of 1 MiB, on a pool of threads
    # that opens no span
    assert by["io.cz_write"].counts["blocks"] == 8
    assert by["io.cz_write"].counts["workers"] >= 1
    assert {r.thread for r in kf} == {kf[0].thread}
    parses = [r for r in kf if r.name == "io.parse"]
    assert len(parses) == 2 and all(r.counts["reads"] > 0
                                    and r.counts["bytes"] > 0
                                    for r in parses)
    assert by["kmerfreq.qsplit"].counts["segments"] > 0
    assert by["kmerfreq.count"].counts["windows"] > 0

    co = _run(["correct_error_reads", "-k", "13", "-c", "2",
               lib + ".kmer.freq.cz", lib])
    names = _names(co)
    assert {"correct.table_load", "io.cz_read", "correct.table_upload",
            "correct.table_expand", "io.parse", "correct.engine",
            "correct.format", "io.gzip"} <= names <= {
                "correct.table_load", "io.cz_read", "correct.table_upload",
                "correct.table_expand", "io.parse", "correct.engine",
                "correct.fallback", "correct.host_table", "correct.format",
                "io.gzip"}
    by = {r.name: r for r in co}
    assert by["io.cz_read"].parent == by["correct.table_load"].index
    assert by["correct.table_load"].counts["bytes"] == 4 ** 13 // 8
    # the rc expand on the device, inside the upload, so that
    # span_s.table_load still covers the whole table build
    assert (by["correct.table_expand"].parent
            == by["correct.table_upload"].index)
    assert by["correct.table_expand"].counts == {"words": 4 ** 13 // 32,
                                                 "launches": 0}
    assert by["io.cz_read"].counts["blocks"] == 8
    assert by["io.cz_read"].counts["workers"] >= 1
    assert {r.thread for r in co} == {co[0].thread}
    gz = [r for r in co if r.name == "io.gzip"]
    assert len(gz) == 2 and all(0 < r.counts["bytes_out"]
                                < r.counts["bytes_in"] for r in gz)

    # an initial table small enough that the enlargement schedule runs
    ex = _run(["debruijn_contig", "-k", "31", "-r", "100", "-i", "2e-5",
               "-b", "100", "-M", "100", "-o", str(tmp_path / "ex"), lib])
    assert _names(ex) == {"contig.ingest", "contig.parse_wait", "io.parse",
                          "contig.finalize", "contig.schedule",
                          "contig.readout", "contig.readout.layout",
                          "contig.readout.replay"}
    cmd = ex[0]
    helper = [r for r in ex if r.name == "io.parse"
              and r.thread != cmd.thread]
    assert len(helper) == 2 and all(r.parent == cmd.index for r in helper)
    waits = [r for r in ex if r.name == "contig.parse_wait"]
    assert {ex[0].thread} == {r.thread for r in waits}

    pd = _run(["debruijn_contig", "-k", "31", "-r", "100", "-i", "0.01",
               "--readout", "doubling", "-M", "100", "-o",
               str(tmp_path / "pd"), lib])
    assert _names(pd) == {"contig.ingest", "contig.parse_wait", "io.parse",
                          "contig.finalize", "contig.readout"} | DOUBLING

    for mate, path in enumerate(soiled, start=1):
        lq = _run(["clean_lowqual", "-e", "0.01", "-r", "75", path,
                   f"{path}.lq.gz", f"{path}.lq.stat"])
        assert _names(lq) == {"io.parse", "lowqual.scan", "lowqual.format",
                              "io.gzip"}
        ad = _run(["clean_adapter", "-s", "12", "-r", "75", f"{path}.lq.gz",
                   f"{path}.ad.gz", f"{path}.ad.stat"])
        assert _names(ad) == {"io.parse", "adapter.align", "adapter.format",
                              "io.gzip"}
        aligns = [r for r in ad if r.name == "adapter.align"]
        assert len(aligns) == 2                 # one a chunk an adapter
        assert all(r.counts == {"chunks": 1, "reads": 1800}
                   for r in aligns)
    # every span of a command, across the seven commands
    assert len(spans.records()) < 200 and spans.dropped() == 0


def test_scaffold_spans(library, tmp_path):
    """map_pair and link_scaffold on contigs of the library: each span
    once a pair of files (the map once a mate), nested in its command's
    span, with its counts; the decode of read1 inside map_pair.parse on
    the command thread, read2's on a helper thread; the three io.gzip
    inside map_pair.write."""
    d, lib, _ = library
    prefix = str(tmp_path / "asm")
    _run(["debruijn_contig", "-k", "31", "-r", "100", "-i", "0.01", "-M",
          "100", "-o", prefix, lib])
    contigs = prefix + ".contig.seq.fa"
    mp = _run(["map_pair", "-k", "31", "-s", "5", "-l", "100", "-r", "100",
               "-o", str(tmp_path / "map"), contigs, lib])
    assert _names(mp) == MAPPING | {"io.parse", "io.gzip"}
    cmd = mp[0]
    by = {r.name: r for r in mp}
    for name in ("scaffold.index", "map_pair.parse", "map_pair.format",
                 "map_pair.write"):
        assert [r.name for r in mp].count(name) == 1, name
        assert by[name].parent == cmd.index and by[name].thread == cmd.thread
    with open(lib) as f:
        files = f.read().split()
    n = 1800
    assert by["map_pair.parse"].counts == {
        "bytes": sum(os.path.getsize(p) for p in files), "reads": 2 * n}
    parses = [r for r in mp if r.name == "io.parse"]
    assert len(parses) == 2
    mine = [r for r in parses if r.thread == cmd.thread]
    assert [r.parent for r in mine] == [by["map_pair.parse"].index]
    [helper] = [r for r in parses if r.thread != cmd.thread]
    assert helper.parent == cmd.index
    assert by["map_pair.parse"].start <= helper.start <= helper.end \
        <= by["map_pair.parse"].end
    ix = by["scaffold.index"].counts
    assert ix["contigs"] > 0 and ix["windows"] >= ix["kmers"] \
        >= ix["unique"] > 0
    maps = [r for r in mp if r.name == "scaffold.map"]
    assert len(maps) == 2 and all(
        r.counts["reads"] == n and r.counts["chunks"] == 1
        and 0 < r.counts["mapped"] <= n and r.thread == cmd.thread
        for r in maps)
    fmt = by["map_pair.format"].counts
    assert fmt["pairs"] == n == sum(fmt[x] for x in ("diff", "same", "gap",
                                                     "none"))
    assert fmt["diff"] > 0 and fmt["same"] > 0
    gz = [r for r in mp if r.name == "io.gzip"]
    assert len(gz) == 3 and all(r.parent == by["map_pair.write"].index
                                for r in gz)

    twoctg = tmp_path / "twoctg.lib"
    twoctg.write_text(str(tmp_path / "map" / os.path.basename(files[0]))
                      + ".map_pair.2ctg.gz\n")
    ls = _run(["link_scaffold", "-i", "300", "-o", str(tmp_path / "scf"),
               contigs, str(twoctg)])
    assert [r.name for r in ls[1:]] == ["link_scaffold.read",
                                        "link_scaffold.graph",
                                        "link_scaffold.readout"]
    read, graph, readout = ls[1:]
    assert all(r.parent == ls[0].index for r in ls[1:])
    with open(contigs) as f:
        assert read.counts == {"contigs": f.read().count(">"),
                               "pairs": fmt["diff"]}
    assert set(graph.counts) == {"FR", "RF", "FF", "RR", "wrong", "lowfreq",
                                 "deleted", "interleave"}
    assert sum(graph.counts[x] for x in ("FR", "RF", "FF", "RR",
                                         "wrong")) == fmt["diff"]
    with open(str(tmp_path / "scf") + ".insert300.scaffold.seq.fa") as f:
        fa = f.read().split("\n")
    assert readout.counts == {
        "scaffolds": sum(x.startswith(">") for x in fa),
        "bases": sum(len(x) for x in fa if x and not x.startswith(">"))}


def test_fallback_span(library, monkeypatch):
    """Rows the device engine flags are re-run on the host inside
    correct.fallback, one span a chunk, with their count."""
    from dbg_assembly_tpu_torch.correct import device as dev_engine
    from dbg_assembly_tpu_torch.correct import pipeline
    from dbg_assembly_tpu_torch.correct.engine import CorrectParams
    d, lib, _ = library
    if not os.path.exists(lib + ".kmer.freq.cz"):
        cli.main(["kmerfreq", "-k", "13", lib, "--device", "cpu"])
    real = dev_engine.correct_batch_device

    def flag_every_third(*a, **kw):
        out = list(real(*a, **kw))
        fb = np.zeros(len(out[-1]), bool)
        fb[::3] = True
        return tuple(out[:-1]) + (fb,)
    monkeypatch.setattr(dev_engine, "correct_batch_device",
                        flag_every_third)
    bitmap = pipeline.load_bitmap(lib + ".kmer.freq.cz", 13)
    batch = fastq.read_batch(open(lib).read().split()[0], keep_ascii=True)
    spans.reset()
    pipeline.correct_batch_torch(batch, bitmap,
                                 CorrectParams(ksize=13).resolved(),
                                 chunk=700, device="cpu")
    fb = [r for r in spans.records() if r.name == "correct.fallback"]
    assert [r.counts["rows"] for r in fb] == [234, 234, 134]


# --------------------------------------------------- clock and exporter
def test_clock_on_the_profiler_timeline(library, tmp_path, monkeypatch):
    """A command's span, exported through DBG_TRACE_OUT, starts within
    1 ms of torch.profiler's exported event of the record_function
    region around the command."""
    from torch.profiler import ProfilerActivity, profile, record_function
    d, lib, _ = library
    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGT\n>b\nACGTACGT\n")
    out = tmp_path / "spans"
    monkeypatch.setenv("DBG_TRACE_OUT", str(out))
    with record_function("warm"):
        torch.ones(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("region"):
            cli.main(["fasta_len", str(fa)])
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    with open(tmp_path / "prof.json") as f:
        pj = json.load(f)
    [ev] = [e for e in pj["traceEvents"] if e.get("name") == "region"]
    [path] = glob.glob(str(out / "fasta_len.*.trace.json"))
    with open(path) as f:
        sj = json.load(f)
    [cmd] = [e for e in sj["traceEvents"] if e["name"] == "cmd.fasta_len"]
    assert sj["baseTimeNanoseconds"] == pj["baseTimeNanoseconds"]
    prof_ns = ev["ts"] * 1e3 + pj["baseTimeNanoseconds"]
    span_ns = cmd["ts"] * 1e3 + sj["baseTimeNanoseconds"]
    assert abs(span_ns - prof_ns) < 1e6, (span_ns - prof_ns) / 1e3
    assert cmd["dur"] <= ev["dur"] + 1e3


def test_trace_out_writes_a_chrome_trace(library, tmp_path, monkeypatch):
    d, lib, soiled = library
    out = tmp_path / "traces"
    monkeypatch.setenv("DBG_TRACE_OUT", str(out))
    cli.main(["clean_lowqual", "-e", "0.01", "-r", "75", soiled[0],
              str(tmp_path / "o.gz"), str(tmp_path / "o.stat"), "--device",
              "cpu"])
    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGT\n")
    cli.main(["fasta_len", str(fa)])
    files = sorted(os.listdir(out))
    assert len(files) == 2
    (lq,) = [f for f in files if f.startswith("clean_lowqual.")]
    name, pid, cid, *_ = lq.split(".")
    assert pid == str(os.getpid()) and int(cid) >= 1
    with open(out / lq) as f:
        trace = json.load(f)
    assert trace["displayTimeUnit"] == "ms"
    events = trace["traceEvents"]
    assert {e["name"] for e in events} == {
        "cmd.clean_lowqual", "io.parse", "lowqual.scan", "lowqual.format",
        "io.gzip"}
    cmd = [e for e in events if e["name"] == "cmd.clean_lowqual"][0]
    for e in events:
        assert e["ph"] == "X" and e["pid"] == os.getpid()
        assert isinstance(e["tid"], int) and e["dur"] >= 0
        assert cmd["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
            <= cmd["ts"] + cmd["dur"] + 1e-3
    parse = [e for e in events if e["name"] == "io.parse"][0]
    assert parse["args"]["reads"] == 1800


def test_no_trace_without_the_flag(library, tmp_path, monkeypatch):
    monkeypatch.delenv("DBG_TRACE_OUT", raising=False)
    monkeypatch.chdir(tmp_path)
    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGT\n")
    cli.main(["fasta_len", str(fa)])
    assert sorted(os.listdir(tmp_path)) == ["x.fa", "x.fa.len"]
    assert [r.name for r in spans.records()] == ["cmd.fasta_len"]
