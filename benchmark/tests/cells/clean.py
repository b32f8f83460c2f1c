"""Tests of the ``clean`` traffic (clean_lowqual, then clean_adapter, on
each file): its tiny twin, its faults, its control and the span metrics a
run of it reads.  No check replaying no tool covers the cleaners, so the
traffic has no guarantee faults."""

import numpy as np


def tiny(load):
    """The E. coli configuration cut to a 30 000 bp genome at depth 6."""
    ecoli = load("configs", "ecoli_mg1655_pe250.json")
    ecoli.update(name="tiny_ecoli", genome_length=30000)
    for lib in ecoli["libraries"]:
        lib["depth"] = 6
    clean = load("traffic", "clean.json")
    clean["warmup_reads"] = 100
    return {"tiny.clean": (ecoli, clean)}


def _patch_lowqual_unchanged(mp):
    from dbg_assembly_tpu_torch.clean import lowqual
    real = lowqual.clean_lowqual_arrays

    def untrimmed(*a, **kw):
        res, quals = real(*a, **kw)
        lengths = a[2].astype(np.int64)
        res.keep_start[:] = 0
        res.keep_len_pre[:] = lengths
        res.final_len[:] = lengths
        res.trimmed[:] = False
        res.short[:] = False
        return res, quals
    mp.setattr(lowqual, "clean_lowqual_arrays", untrimmed)


def _patch_adapter_half(mp):
    from dbg_assembly_tpu_torch.clean import adapter
    real = adapter._align_one_adapter

    def half(codes, lengths, *a):
        out = real(codes, lengths, *a)
        n = codes.shape[0] // 2
        for x in out:
            x[n:] = 0
        return out
    mp.setattr(adapter, "_align_one_adapter", half)


def _patch_lowqual_answer(mp):
    from dbg_assembly_tpu_torch.clean import lowqual
    real = lowqual._lowqual_scan

    def altered(*a, **kw):
        total, start, length = real(*a, **kw)
        total[0] += 1e-6
        return total, start, length
    mp.setattr(lowqual, "_lowqual_scan", altered)


FAULTS = [
    ("tiny.clean", "state unchanged: clean_lowqual trims nothing",
     _patch_lowqual_unchanged, "lowqual_reads_differ"),
    ("tiny.clean", "half the batch: the adapter DP scores half the reads",
     _patch_adapter_half, "adapter_reads_differ"),
    ("tiny.clean", "an answer altered: one read's error sum",
     _patch_lowqual_answer, "lowqual_reads_differ"),
]


def control(monkeypatch):
    """clean_lowqual's error sums from float32 error terms, the nearest
    precision below the float64 the upstream sums in: patched in, no
    arguments appended."""
    from dbg_assembly_tpu_torch.clean import lowqual
    real = lowqual.qual2err_table
    monkeypatch.setattr(lowqual, "qual2err_table",
                        lambda shift=33: real(shift).astype(np.float32)
                        .astype(np.float64))
    return None


SPAN_METRICS = {
    "tiny.clean": ["span_s.parse", "span_s.gzip", "span_s.format",
                   "span_s.clean_loop"],
}
