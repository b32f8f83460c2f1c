"""Helper commands (counterpart of the parts of
dbg_assembly_tpu/utils/helpers.py that the port's stages use)."""

from __future__ import annotations

import gzip
import io

from ..io.fastq import gz_write_bytes


def merge_corrected_pair(read1_file: str, read2_file: str) -> dict:
    """Parity: merge_two_corr_files (correct_error/correct.cpp:851-922) —
    merge corrected read1/read2 one-line FASTA into .pair.fa.gz +
    .single.fa.gz + .pair.single.stat."""
    pair_path = read1_file + ".pair.fa.gz"
    single_path = read1_file + ".single.fa.gz"
    pr = pb = sr = sb = 0
    pf = bytearray()
    sf = bytearray()
    with gzip.open(read1_file, "rb") as g1, gzip.open(read2_file, "rb") as g2:
        f1 = io.BytesIO(g1.read())
        f2 = io.BytesIO(g2.read())
    while True:
        h1 = f1.readline()
        if not h1:
            break
        s1 = f1.readline().rstrip(b"\n")
        h2 = f2.readline()
        s2 = f2.readline().rstrip(b"\n")
        h1 = h1.rstrip(b"\n")
        h2 = h2.rstrip(b"\n")
        if s1 and s2:
            pf += h1 + b"\n" + s1 + b"\n" + h2 + b"\n" + s2 + b"\n"
            pr += 2
            pb += len(s1) + len(s2)
        else:
            if s1:
                sf += h1 + b"\n" + s1 + b"\n"
                sr += 1
                sb += len(s1)
            if s2:
                sf += h2 + b"\n" + s2 + b"\n"
                sr += 1
                sb += len(s2)
    gz_write_bytes(pair_path, bytes(pf))
    gz_write_bytes(single_path, bytes(sf))
    with open(read1_file + ".pair.single.stat", "w") as f:
        f.write(f"pair reads:   {pr}\n")
        f.write(f"pair bases:   {pb}\n")
        f.write(f"single reads: {sr}\n")
        f.write(f"single bases: {sb}\n")
    return dict(pair=pair_path, single=single_path)
