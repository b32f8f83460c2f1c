"""sort_roofline.scaffold's reader: the windows of the contig index's
sorts that open in the passes, against the radix sort's kernel time."""

import types

import pytest

from benchmark import harness, trace

read = harness.metric_reader("sort_roofline.scaffold")
windows = read.__globals__["windows"]


def _rec(name, start_s, **counts):
    return types.SimpleNamespace(name=name, start=start_s * 1e9,
                                 counts=counts)


PASSES = [{"start": 10.0, "wall": 5.0}, {"start": 15.0, "wall": 5.0}]
RECORDS = [_rec("scaffold.index", 2.0, windows=999),      # set-up's
           _rec("scaffold.index", 11.0, windows=100),
           _rec("scaffold.map", 11.5, reads=7),
           _rec("scaffold.index", 13.0, windows=50),
           _rec("scaffold.index", 16.0, windows=100),
           _rec("scaffold.index", 18.0)]                   # no count


def test_windows_of_the_passes_only():
    assert windows(PASSES, RECORDS, 0) == 250
    assert windows([], RECORDS, 0) is None


@pytest.mark.parametrize("last_start,want", [(19.0, None), (25.0, 250)])
def test_windows_none_where_a_pass_lost_records(last_start, want):
    records = RECORDS + [_rec("io.gzip", last_start)]
    assert windows(PASSES, records, 3) == want


def test_read(monkeypatch):
    from dbg_assembly_tpu_torch import spans
    monkeypatch.setattr(spans, "records", lambda: RECORDS)
    monkeypatch.setattr(spans, "dropped", lambda: 0)
    ctx = types.SimpleNamespace(passes=PASSES, trace=None)
    assert read(ctx) is None                 # an untraced run
    ctx.trace = {"kernel_s": {"onesweep_kernel(unsigned long const*)": 2e-9,
                              "hist_kernel(x)": 1e-9, "chop_kernel": 1.0}}
    want = 100.0 * 250 * 24 / trace.PEAK_BYTES_S / 3e-9
    assert read(ctx) == pytest.approx(want)
    ctx.trace = {"kernel_s": {"chop_kernel": 1.0}}
    assert read(ctx) is None                 # no sort in the window
    monkeypatch.setattr(spans, "records", lambda: RECORDS[:1])
    ctx.trace = {"kernel_s": {"hist_kernel(x)": 1e-9}}
    assert read(ctx) is None                 # a program with no count
