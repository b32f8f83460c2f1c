"""Tests of the ``contig`` traffic (debruijn_contig): its tiny twins on
both configurations, its faults, its control and the span metrics a run
of it reads."""

import copy


def tiny(load):
    """The S. aureus configuration cut to a 40 000 bp genome, and the E.
    coli one to 30 000 bp at depth 6; contigs at ``-i 0.001``, the small
    initial hash."""
    sa = load("configs", "saureus_usa300_pe101.json")
    sa.update(name="tiny_sa", genome_length=40000)
    ecoli = load("configs", "ecoli_mg1655_pe250.json")
    ecoli.update(name="tiny_ecoli", genome_length=30000)
    for lib in ecoli["libraries"]:
        lib["depth"] = 6
    contig = load("traffic", "contig.json")
    args = contig["stages"][0]["args"]
    args[args.index("-i") + 1] = "0.001"
    contig["warmup_reads"] = 100
    return {"tiny.contig": (sa, contig),
            "tiny.ecoli_contig": (ecoli, copy.deepcopy(contig))}


def _patch_merge_unchanged(mp):
    from dbg_assembly_tpu_torch.contig import graph
    real = graph._merge_parts
    mp.setattr(graph, "_merge_parts",
               lambda parts, k: real(parts[:1], k))


def _patch_ingest_half(mp):
    from dbg_assembly_tpu_torch.contig import graph
    real = graph._aggregate_batch
    mp.setattr(graph, "_aggregate_batch",
               lambda c, l, k, b: real(c[:len(c) // 2], l[:len(l) // 2], k,
                                       b))


def _patch_node_counter(mp):
    from dbg_assembly_tpu_torch.contig import graph
    real = graph.GraphBuilder.finalize

    def altered(self):
        t = real(self)
        t.lcnt[len(t.lcnt) // 2, 0] += 7
        return t
    mp.setattr(graph.GraphBuilder, "finalize", altered)


FAULTS = [
    ("tiny.contig", "state unchanged: the merge keeps the first batch",
     _patch_merge_unchanged, "kmer_freq_lines_differ"),
    ("tiny.contig", "half the batch: ingest sees half of each batch",
     _patch_ingest_half, "kmer_freq_lines_differ"),
    ("tiny.contig", "an answer altered: one edge counter",
     _patch_node_counter, "kmer_freq_lines_differ"),
]

GUARANTEE_FAULTS = [
    ("tiny.contig", _patch_merge_unchanged, "contig_depths_differ"),
    ("tiny.contig", _patch_ingest_half, "contig_depths_differ"),
]

GUARANTEE = "contig_steps_unsupported"


def control(monkeypatch):
    """A link taken at >= the depth cutoff instead of the strict >
    (contig.cpp:132)."""
    return {"debruijn_contig": ["-D", "1"]}


SPAN_METRICS = {"tiny.contig": ["span_s.parse", "span_s.readout"]}
