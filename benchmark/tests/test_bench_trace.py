"""The trace arithmetic: the union of device intervals, the idle gaps and
their labels, and the bytes bound of the chop and the sort."""

import torch

from benchmark import trace


def test_union_and_idle_share_with_overlaps():
    events = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 2.5, 4.0),
              ("d", 6.0, 7.0), ("e", 6.5, 6.8), ("f", 9.0, 9.5)]
    passes = [{"start": 0.0, "spans_at": [("kmerfreq", 5.5),
                                          ("correct", 4.5)]}]
    s = trace.summarise(events, (0.0, 10.0), passes)
    # busy: [0, 4] + [6, 7] + [9, 9.5] = 5.5 s, not the 7.3 s summed
    assert abs(s["busy_s"] - 5.5) < 1e-12
    assert abs(s["window_s"] - 10.0) < 1e-12
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["kmerfreq..correct", "correct",
                                    "correct"]
    assert [round(g[1], 9) for g in gaps] == [2.0, 2.0, 0.5]
    assert abs(s["kernel_s"]["e"] - 0.3) < 1e-12


def test_window_counts_by_hand():
    # two reads of 10 bases, k 4: read 0 all good (7 windows); read 1 has
    # a bad base at 4, leaving runs of 4 (1 window) and 5 (2 windows)
    seq = torch.full((2, 10), ord("A"), dtype=torch.uint8)
    qual = torch.full((2, 10), 33 + 30, dtype=torch.uint8)
    qual[1, 4] = 33 + 5
    assert trace.window_counts(seq, qual, 4, 10, None, "cpu") == (19, 10)
    assert trace.window_counts(seq, qual, 4, 0, None, "cpu") == (20, 14)
    assert trace.window_counts(seq, qual, 4, 0, 8, "cpu") == (16, 10)


def test_kmer_work_bytes():
    seq = torch.full((3, 20), ord("C"), dtype=torch.uint8)
    qual = torch.full((3, 20), 33 + 30, dtype=torch.uint8)
    inputs = {"seqs": [seq], "quals": [qual]}
    argvs = [["kmerfreq", "-k", "5", "-q", "10", "lib"],
             ["correct_error_reads", "-k", "5", "cz", "lib"],
             ["debruijn_contig", "-k", "11", "-r", "20", "lib"]]
    w = trace.kmer_work(inputs, argvs, "cpu")
    # kmerfreq: 60 bases + 48 windows x 8 B; contig: 60 bases + 30 x 10 B
    assert w["chop_bytes"] == (60 + 48 * 8) + (60 + 30 * 10)
    assert w["sort_bytes"] == (48 + 30) * 16


def test_kernel_patterns():
    names = {"void chop_kernel<true>(unsigned char const*, int)": 1.0,
             "onesweep_kernel(unsigned long*, int)": 2.0,
             "hist_kernel(unsigned long const*)": 0.5,
             "scan_kernel(unsigned int*)": 0.25,
             "void at::native::segmented_scan_kernel()": 9.0}
    assert trace.kernel_seconds(names, trace.CHOP) == 1.0
    assert trace.kernel_seconds(names, trace.SORT) == 2.75


def test_card_seconds_leave_out_host_copies():
    """card_s_per_gbase: the device's own work (kernels, sets, copies
    within the card) over input gigabases times passes; copies to and
    from host memory do not count; no value without a trace."""
    from benchmark import harness
    read = harness.metric_reader("card_s_per_gbase")
    kernel_s = {"void chop_kernel<true>(unsigned char const*, int)": 0.5,
                "Memcpy HtoD (Pageable -> Device)": 3.0,
                "Memcpy DtoH (Device -> Pageable)": 4.0,
                "Memcpy HtoD (Pinned -> Device)": 1.0,
                "Memcpy DtoD (Device -> Device)": 0.25,
                "Memset (Device)": 0.125}
    ctx = harness.Context(None, 1, {"bases": 250_000_000}, {},
                          passes=[{"wall": 1.0}, {"wall": 1.0}],
                          trace={"kernel_s": kernel_s})
    assert read(ctx) == (0.5 + 0.25 + 0.125) / 0.5
    ctx.trace = None
    assert read(ctx) is None
