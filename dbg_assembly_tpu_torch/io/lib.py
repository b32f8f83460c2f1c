""".lib list files and .para scaffold recipes.

Counterpart of dbg_assembly_tpu/io/lib.py and of the JAX package's
contig/pipeline.py read_file_list.  Parity: DBG_contig/seqKmer.cpp:101-114
(every nonempty line, read_file_list), correct_error/seqKmer.cpp:110-129
(whitespace stripped per line), link_scaffold/map_func.cpp:57-77 ('#'
comments, first token), and the
scaffolding recipe of link_scaffold/yeast.para:1-8 with the columns
  scaf_rank kmer_size seedKmerNum align_ident insert_size pairNumCut is_mate read_file
"""

from __future__ import annotations

from dataclasses import dataclass


def read_file_list(path: str) -> list[str]:
    """Parity: DBG_contig/seqKmer.cpp:101-114 (every nonempty line)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def read_lib(path: str) -> list[str]:
    files = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            tok = line.split()
            if tok:
                files.append(tok[0])
    return files


@dataclass
class ParaRow:
    scaf_rank: int
    kmer_size: int
    seed_kmer_num: int
    align_identity: float
    insert_size: int
    pair_num_cut: int
    is_mate: int
    read_file: str


def read_para(path: str) -> list[ParaRow]:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) < 8:
                continue
            rows.append(ParaRow(int(tok[0]), int(tok[1]), int(tok[2]),
                                float(tok[3]), int(tok[4]), int(tok[5]),
                                int(tok[6]), tok[7]))
    return rows
