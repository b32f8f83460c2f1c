"""The whole workflow as one typed entry point: clean -> correct -> contigs ->
iterative scaffolding.

Counterpart of dbg_assembly_tpu/workflow.py, with one field more: the
``device`` every stage that takes one runs on (``cuda`` by default, which
raises without a card).  Reference orchestration (work.sh + .para files):
  * test/01.clean_correct/work.sh: clean_lowqual -> clean_adapter ->
    kmerfreq -> correct_error_reads
  * test/02.build_contig/work.sh:  debruijn_contig on corrected reads
  * test/03.build_scaffold/*/work.sh + link_scaffold/yeast.para: iterative
    map_pair + link_scaffold per library, shortest insert first, each
    round's scaffolds becoming the next round's contigs (ReadMe.txt:40-41)

The .para recipe columns (yeast.para:1-8) are parsed by io/lib.py:
  scaf_rank kmer_size seedKmerNum align_ident insert_size pairNumCut is_mate read_file
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import resolve_device


@dataclass
class PipelineConfig:
    # cleaning
    err_rate_cutoff: float = 0.01
    min_read_len: int = 75
    adapter_file: str = "Both-adapter"
    adapter_score: int = 12
    # correction
    correct_k: int = 17
    low_freq_cutoff: int = 1
    qual_cutoff: int = 10      # kmerfreq -q (work.sh:31 uses -q 10)
    max_change: int = 2
    # contigs
    contig_k: int = 31
    max_read_len: int = 250
    init_hash_size: float = 0.1
    contig_len_cutoff: int = 125
    readout: str = "exact"      # "doubling" = the bulk assembler
    mesh_devices: int = 0       # > 0: sharded correction + contig stage
    # scaffolding defaults (overridden per .para row)
    map_min_ctg: int = 125
    map_min_read: int = 250
    min_identity: float = 0.97
    work_dir: str = "."
    device: str = "cuda"


def clean_reads(libs: list[tuple[str, str]], cfg: PipelineConfig,
                out_dir: str) -> list[str]:
    """Run lowqual + adapter cleaning over PE libraries; returns cleaned
    file paths in read1,read2 order."""
    from .clean import adapter, lowqual
    os.makedirs(out_dir, exist_ok=True)
    cleaned = []
    for r1, r2 in libs:
        for p in (r1, r2):
            b = os.path.basename(p)
            lq = os.path.join(out_dir, b + ".nonLowQual.gz")
            lowqual.run_file(p, lq, lq[:-3] + ".stat",
                             err_cutoff=cfg.err_rate_cutoff,
                             min_read_len=cfg.min_read_len,
                             device=cfg.device)
            ad = os.path.join(out_dir, b + ".nonLowQual.gz.nonAdapter.gz")
            adapter.run_file(lq, ad, ad[:-3] + ".stat",
                             adapter_file=cfg.adapter_file,
                             score_cutoff=cfg.adapter_score,
                             min_read_len=cfg.min_read_len,
                             device=cfg.device)
            cleaned.append(ad)
    return cleaned


def correct_reads(cleaned: list[str], cfg: PipelineConfig,
                  out_dir: str) -> list[str]:
    from .correct import pipeline as corr
    from .correct.engine import CorrectParams
    from .kmer import kmerfreq
    lib = os.path.join(out_dir, "clean_reads.lib")
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in cleaned))
    kf = kmerfreq.run(lib, ksize=cfg.correct_k,
                      low_freq_cutoff=cfg.low_freq_cutoff,
                      qual_cutoff=cfg.qual_cutoff, device=cfg.device)
    corr.run(kf["cz"], lib,
             CorrectParams(ksize=cfg.correct_k, max_change=cfg.max_change),
             fmt=1, device=cfg.device, mesh_devices=cfg.mesh_devices)
    return [p + ".correct.fa.gz" for p in cleaned]


def build_contigs(corrected: list[str], cfg: PipelineConfig,
                  prefix: str) -> str:
    from .contig import pipeline as ctg
    from .contig.refassemble import AssembleParams
    lib = prefix + ".corrected.lib"
    with open(lib, "w") as f:
        f.write("".join(p + "\n" for p in corrected))
    params = AssembleParams(ksize=cfg.contig_k,
                            init_hash_size=cfg.init_hash_size,
                            contig_len_cutoff=cfg.contig_len_cutoff)
    ctg.run(lib, prefix, ksize=cfg.contig_k, fmt=2,
            max_read_len=cfg.max_read_len, params=params,
            readout=cfg.readout, mesh_devices=cfg.mesh_devices,
            device=cfg.device)
    return prefix + ".contig.seq.fa"


def scaffold_iterative(contig_fa: str, para_path: str,
                       cfg: PipelineConfig, out_dir: str) -> str:
    """Iterative scaffolding per .para recipe, shortest insert first.
    Returns the final scaffold FASTA path."""
    from .io.lib import read_file_list, read_para
    from .scaffold import map_pair, scaffold as scf

    rows = sorted(read_para(para_path), key=lambda r: r.scaf_rank)
    os.makedirs(out_dir, exist_ok=True)
    current = contig_fa
    for row in rows:
        map_dir = os.path.join(
            out_dir, f"maping_insert{row.insert_size}")
        # read_file column: a .lib listing read1/read2 pairs
        map_pair.run(current, row.read_file, map_dir,
                     ksize=row.kmer_size, seed_kmer_num=row.seed_kmer_num,
                     min_ctg_len=cfg.map_min_ctg,
                     min_read_len=cfg.map_min_read,
                     min_identity=row.align_identity, fmt=1,
                     device=cfg.device)
        files = read_file_list(row.read_file)
        twoctg = os.path.join(out_dir, f"twoctg_insert{row.insert_size}.lib")
        with open(twoctg, "w") as f:
            for i in range(0, len(files), 2):
                base = os.path.basename(files[i])
                f.write(f"{map_dir}/{base}.map_pair.2ctg.gz\n")
        scf.run(current, twoctg, current, insert_size=row.insert_size,
                pair_num_cut=row.pair_num_cut, is_mate=bool(row.is_mate))
        current = current + f".insert{row.insert_size}.scaffold.seq.fa"
    return current


def run_full(raw_libs: list[tuple[str, str, int]], cfg: PipelineConfig,
             work_dir: str, para_path: str | None = None) -> dict:
    """End-to-end: clean -> correct -> contigs -> iterative scaffolding.

    raw_libs: [(read1, read2, insert_size)] — when para_path is None a
    recipe is generated from insert sizes (shortest first, pairNumCut 3).
    cfg.mesh_devices > 0 runs correction and the contig stage over that
    many slots on cfg.device, as the JAX workflow does.
    """
    resolve_device(cfg.device)
    os.makedirs(work_dir, exist_ok=True)
    pairs = [(r1, r2) for r1, r2, _ in raw_libs]
    cleaned = clean_reads(pairs, cfg, os.path.join(work_dir, "01.clean"))
    corrected = correct_reads(cleaned, cfg, os.path.join(work_dir,
                                                         "01.clean"))
    prefix = os.path.join(work_dir, "02.contig", "asm")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    contig_fa = build_contigs(corrected, cfg, prefix)

    scaf_dir = os.path.join(work_dir, "03.scaffold")
    os.makedirs(scaf_dir, exist_ok=True)
    if para_path is None:
        para_path = os.path.join(scaf_dir, "auto.para")
        with open(para_path, "w") as f:
            f.write("#scaf_rank kmer_size seedKmerNum align_ident "
                    "insert_size pairNumCut is_mate read_file\n")
            for rank, (r1, r2, ins) in enumerate(
                    sorted(raw_libs, key=lambda x: x[2]), 1):
                lib = os.path.join(scaf_dir, f"lib_insert{ins}.lib")
                i = raw_libs.index((r1, r2, ins))
                with open(lib, "w") as lf:
                    lf.write(cleaned[2 * i] + "\n" + cleaned[2 * i + 1]
                             + "\n")
                f.write(f"{rank} 31 5 0.97 {ins} 3 0 {lib}\n")
    final = scaffold_iterative(contig_fa, para_path, cfg, scaf_dir)
    return {"contigs": contig_fa, "scaffolds": final}
