"""The span_s.* readers (benchmark/program_spans.py) against synthetic
passes and records: the pass window, the command-thread filter, the
outermost of nested named spans, the median, no value on drops or where
no span occurred; then each reader as the manifest wires it, and the
readers on whole runs of the tiny cells on the CPU."""

import json
import os

import pytest

from benchmark import harness, program_spans
from conftest import cell_tests
from dbg_assembly_tpu_torch import spans

S = 10 ** 9
MAIN, HELPER = 100, 200


def rec(name, start_s, end_s, parent=-1, thread=MAIN):
    r = spans.Span(name, int(start_s * S), parent, thread, 1, {})
    r.end = None if end_s is None else int(end_s * S)
    return r


def index(records):
    for i, r in enumerate(records):
        r.index = i
    return records


def two_passes():
    """Pass 0 on [10, 20] s, pass 1 on [30, 45] s."""
    return [{"start": 10.0, "wall": 10.0}, {"start": 30.0, "wall": 15.0}]


def synthetic():
    return index([
        rec("io.parse", 5, 6),                       # before the window
        rec("cmd.kmerfreq", 10.1, 19),               # 1
        rec("io.parse", 10.2, 11.2, parent=1),       # 1 s
        rec("io.parse", 10.2, 13.2, parent=1, thread=HELPER),
        rec("kmerfreq.table_write", 12, 14, parent=1),
        rec("cmd.correct_error_reads", 30.5, 44),    # 5
        rec("io.parse", 31, 33, parent=5),           # 2 s
        rec("correct.engine", 33, 40, parent=5),     # 7
        rec("io.parse", 34, 35, parent=7),           # held: not counted
        rec("io.parse", 36, 37.5, parent=5),         # 1.5 s
        rec("io.parse", 44.5, None, parent=5),       # still open
        rec("io.parse", 46, 50),                     # after the window
    ])


def test_window_thread_and_nesting():
    recs = synthetic()
    # pass 0: 1 s (the helper thread's 3 s left out); pass 1: 2 + 1 + 1.5
    # s (the open span and those outside both windows left out)
    got = program_spans.pass_seconds(two_passes(), recs, 0, ["io.parse"])
    assert got == pytest.approx((1.0 + 4.5) / 2)
    # a named span inside another named span counts once, as the outer
    assert program_spans.pass_seconds(
        two_passes(), recs, 0, ["io.parse", "correct.engine"]) == \
        pytest.approx((1.0 + (2 + 7 + 1.5)) / 2)


def test_helper_thread_only_where_it_ran_a_command():
    recs = index([rec("cmd.x", 10.1, 19, thread=HELPER),
                  rec("io.parse", 11, 12, parent=0, thread=HELPER),
                  rec("io.parse", 11, 15, parent=0, thread=MAIN)])
    assert program_spans.pass_seconds(two_passes()[:1], recs, 0,
                                      ["io.parse"]) == pytest.approx(1.0)


def test_median_over_passes():
    passes = [{"start": float(10 * i), "wall": 9.0} for i in range(1, 6)]
    recs = []
    for i, sec in zip(range(1, 6), (4.0, 1.0, 9.0, 2.0, 3.0)):
        recs.append(rec("cmd.x", 10 * i, 10 * i + 8.5))
        recs.append(rec("io.gzip", 10 * i + 0.1, 10 * i + 0.1 + sec / 2,
                        parent=len(recs) - 1))
    index(recs)
    # each pass's span is half its number of seconds: median 3 / 2
    assert program_spans.pass_seconds(passes, recs, 0, ["io.gzip"]) == \
        pytest.approx(1.5)
    # a pass without the span counts as 0 s
    passes.append({"start": 60.0, "wall": 9.0})
    recs.append(rec("cmd.x", 60.1, 61))
    index(recs)
    assert program_spans.pass_seconds(passes, recs, 0, ["io.gzip"]) == \
        pytest.approx((1.0 + 1.5) / 2)


def test_none_where_no_span_occurred():
    recs = synthetic()
    assert program_spans.pass_seconds(two_passes(), recs, 0,
                                      ["contig.readout"]) is None
    assert program_spans.pass_seconds(two_passes(), [], 0,
                                      ["io.parse"]) is None


def test_none_on_drops_in_the_window():
    recs = synthetic()
    # the records filled after the window: the window lost nothing
    late = index(synthetic() + [rec("x", 60, 61)])
    assert program_spans.pass_seconds(two_passes(), late, 5,
                                      ["io.parse"]) == pytest.approx(2.75)
    # the last record kept opened inside the second pass: spans after it
    # in that pass may be lost
    assert program_spans.pass_seconds(two_passes(), recs[:-1], 1,
                                      ["io.parse"]) is None
    assert program_spans.pass_seconds(two_passes(), [], 1,
                                      ["io.parse"]) is None


class Ctx:
    def __init__(self, passes):
        self.passes = passes


SPAN_METRICS = {
    "span_s.parse": ("io.parse", "contig.parse_wait"),
    "span_s.gzip": ("io.gzip",),
    "span_s.format": ("correct.format", "lowqual.format",
                      "adapter.format"),
    "span_s.qsplit": ("kmerfreq.qsplit",),
    "span_s.table_write": ("kmerfreq.table_write",),
    "span_s.table_load": ("correct.table_load", "correct.table_upload"),
    "span_s.readout": ("contig.readout",),
    "span_s.clean_loop": ("lowqual.scan", "adapter.align"),
}


def _manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_entries():
    """Each span metric is wired as a span metric, moving the end-to-end
    metric besides setup_s that each of its cells reports."""
    manifest = _manifest()
    per = {m["name"]: m for m in manifest["per_layer"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert set(SPAN_METRICS) <= set(per)
    for name in SPAN_METRICS:
        m = per[name]
        assert (m["unit"], m["better"], m["source"]) == \
            ("s", "lower", "program_span")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_reads_its_spans(name, monkeypatch):
    """Each reader, loaded as the harness loads it, sums its own spans
    from the recorder and no other."""
    names = SPAN_METRICS[name]
    recs = [rec("cmd.x", 10.1, 19.9)]
    for i, n in enumerate(names):
        recs.append(rec(n, 11 + i, 11.25 + i, parent=0))
    recs.append(rec("contig.ingest", 16, 19, parent=0))    # no metric's
    index(recs)
    monkeypatch.setattr(spans, "_records", recs)
    monkeypatch.setattr(spans, "_dropped", 0)
    read = harness.metric_reader(name)
    assert read(Ctx(two_passes()[:1])) == pytest.approx(0.25 * len(names))
    monkeypatch.setattr(spans, "_dropped", 1)
    assert read(Ctx(two_passes()[:1])) is None


def test_reader_without_the_recorder(monkeypatch):
    """A program with no recorder (an older checkout): no value, no
    error."""
    import builtins
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "dbg_assembly_tpu_torch" and fromlist \
                and "spans" in fromlist:
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_spans)
    for name in SPAN_METRICS:
        assert harness.metric_reader(name)(Ctx(two_passes())) is None


# tiny cell -> the span metrics its run reads, from its traffic's file
# tests/cells/<traffic>.py
TINY_SPAN_METRICS = {cell: metrics for mod in cell_tests().values()
                     for cell, metrics in
                     getattr(mod, "SPAN_METRICS", {}).items()}


@pytest.mark.parametrize("cell", sorted(TINY_SPAN_METRICS))
def test_readers_on_a_tiny_cell(run_tiny, monkeypatch, cell):
    """A whole run of a tiny cell on the CPU gives each reader of the
    cell's real counterpart a value: the harness is asked for the span
    metrics beside the end-to-end ones (a traced run needs the card)."""
    metrics = TINY_SPAN_METRICS[cell]
    real = harness.cell_metrics

    def with_spans(manifest, name, trace):
        per = {m["name"]: m for m in manifest["per_layer"]}
        return real(manifest, name, trace) + [per[m] for m in metrics]
    monkeypatch.setattr(harness, "cell_metrics", with_spans)
    r = run_tiny(cell, trace=False)
    assert r["correct"], r["compared"]
    for m in metrics:
        assert r["metrics"][m]["value"] > 0, m
    wall = min(r["pass_s"])
    assert r["metrics"]["span_s.parse"]["value"] < wall
