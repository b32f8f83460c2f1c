"""Tests of the ``correct`` traffic (kmerfreq, then correct_error_reads):
its tiny twin, its faults, its control and the span metrics a run of it
reads."""

import numpy as np


def tiny(load):
    """The E. coli configuration cut to a 30 000 bp genome at depth 6,
    counting and correction at k 13 (the table a CPU holds), 60 random
    and 20 hardest reads checked."""
    ecoli = load("configs", "ecoli_mg1655_pe250.json")
    ecoli.update(name="tiny_ecoli", genome_length=30000)
    for lib in ecoli["libraries"]:
        lib["depth"] = 6
    correct = load("traffic", "correct.json")
    for stage in correct["stages"]:
        stage["args"][stage["args"].index("-k") + 1] = "13"
    correct["check"] = {"random_reads": 60, "hardest_reads": 20}
    correct["warmup_reads"] = 100
    return {"tiny.correct": (ecoli, correct)}


def _patch_correct_unchanged(mp):
    from dbg_assembly_tpu_torch.correct import pipeline
    real = pipeline.correct_batch_torch

    def unchanged(batch, *a, **kw):
        ones, multis, deleteds, tls, trs, _ = real(batch, *a, **kw)
        z = np.zeros_like(ones)
        return z, z, z, z, z, batch.seqs_ascii
    mp.setattr(pipeline, "correct_batch_torch", unchanged)


def _patch_count_half(mp):
    from dbg_assembly_tpu_torch.kmer import count
    real = count.KmerCounter.add
    mp.setattr(count.KmerCounter, "add",
               lambda self, c, l: real(self, c[:len(c) // 2],
                                       l[:len(l) // 2]))


def _patch_table_bit(mp):
    from dbg_assembly_tpu_torch.kmer import count
    real = count.freq_bitmap

    def flipped(*a, **kw):
        out = real(*a, **kw)
        out[np.flatnonzero(out)[0]] ^= 1
        return out
    mp.setattr(count, "freq_bitmap", flipped)


FAULTS = [
    ("tiny.correct", "state unchanged: correction returns its input",
     _patch_correct_unchanged, "reads_differ"),
    ("tiny.correct", "half the batch: counting sees half of each batch",
     _patch_count_half, "table_bytes_differ"),
    ("tiny.correct", "an answer altered: one bit of the table",
     _patch_table_bit, "table_bytes_differ"),
]

GUARANTEE_FAULTS = [
    ("tiny.correct", _patch_correct_unchanged, "untouched_reads_differ"),
    ("tiny.correct", _patch_count_half, "untouched_reads_differ"),
]

GUARANTEE = "untouched_reads_differ"


def control(monkeypatch):
    """The table's cutoff taken as >= instead of the upstream's strict >."""
    return {"kmerfreq": ["-m", "0"]}


SPAN_METRICS = {
    "tiny.correct": ["span_s.parse", "span_s.gzip", "span_s.format",
                     "span_s.qsplit", "span_s.table_write",
                     "span_s.table_load"],
}
