"""Small post-processing helpers replacing the reference's Perl scripts.

Counterpart of dbg_assembly_tpu/utils/helpers.py."""

from __future__ import annotations

import gzip
import io

from ..io.fastq import gz_write_bytes


def _read_fasta_dict(path: str) -> dict:
    """Parity: Read_fasta in redecide_contig_and_small.pl:43-73 — id ->
    (full header after '>', seq with whitespace stripped)."""
    out = {}
    name = None
    head = None
    seq = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out[name] = (head, "".join(seq))
                head = line[1:]
                name = head.split()[0] if head.split() else ""
                seq = []
            else:
                seq.append("".join(line.split()))
    if name is not None:
        out[name] = (head, "".join(seq))
    return out


def redecide_contig_and_small(contig_file: str, small_file: str,
                              len_cutoff: int = 100, prefix: str = "ctg",
                              small_prefix: str = "small") -> tuple[str, str]:
    """Parity: redecide_contig_and_small.pl (scafftig variant:
    prefix='sct', small_prefix='smalltig'): re-split two FASTA files at a
    new length cutoff, renumbering with odd ids for the large set;
    iteration is ASCIIbetical over ids (Perl `sort keys`); the first header
    token is replaced in place, the remainder kept verbatim."""
    import re
    records = _read_fasta_dict(contig_file)
    records.update(_read_fasta_dict(small_file))
    big_path = f"{contig_file}.len{len_cutoff}.fa"
    small_path = f"{small_file}.len{len_cutoff}.fa"
    ctg_id = -1
    sma_id = 0
    with open(big_path, "w") as bf, open(small_path, "w") as sf:
        for name in sorted(records):
            head, seq = records[name]
            if len(seq) > len_cutoff:
                ctg_id += 2
                nh = re.sub(r"^\S+", str(ctg_id), head, count=1)
                bf.write(f">{prefix}_{nh}\n{seq}\n")
            else:
                sma_id += 1
                nh = re.sub(r"^\S+", str(sma_id), head, count=1)
                sf.write(f">{small_prefix}_{nh}\n{seq}\n")
    return big_path, small_path


def filter_unpaired_reads(reads1: str, reads2: str,
                          out1: str | None = None,
                          out2: str | None = None) -> dict:
    """Parity: clean_illumina/filter_unpaired_reads.pl — re-pair two cleaned
    FASTQ streams, keeping only pairs where both mates are non-empty;
    headers are reduced to their first token."""
    import os
    if out1 is None:
        out1 = os.path.basename(reads1) + ".pe1.gz"
    if out2 is None:
        out2 = os.path.basename(reads2) + ".pe2.gz"
    both = single = empty = 0
    b1 = b2 = 0
    with gzip.open(reads1, "rb") as f1, gzip.open(reads2, "rb") as f2, \
            gzip.open(out1, "wb") as o1, gzip.open(out2, "wb") as o2:
        while True:
            h1 = f1.readline()
            h2 = f2.readline()
            if not h1 or not h2:
                break
            if not (h1.startswith(b"@") and h2.startswith(b"@")):
                continue
            s1 = f1.readline().rstrip(b"\n")
            plus1 = f1.readline()
            q1 = f1.readline()
            s2 = f2.readline().rstrip(b"\n")
            plus2 = f2.readline()
            q2 = f2.readline()
            n1 = h1.split()[0]
            n2 = h2.split()[0]
            if n1 != n2:
                raise ValueError(f"read name mismatch: {n1} vs {n2}")
            if s1 and s2:
                o1.write(n1 + b"\n" + s1 + b"\n" + plus1 + q1)
                o2.write(n2 + b"\n" + s2 + b"\n" + plus2 + q2)
                both += 1
                b1 += len(s1)
                b2 += len(s2)
            elif s1 or s2:
                single += 1
            else:
                empty += 1
    return dict(both=both, single=single, empty=empty,
                bases1=b1, bases2=b2, out1=out1, out2=out2)


def rev_com_seq_file(in_path: str, out_path: str) -> None:
    """Parity: link_scaffold/rev_com_seq.pl — reverse complement every
    record, keyed/sorted by the first header token (Perl `sort keys`,
    duplicates overwrite), header rewritten to `>{id}_rc`, sequence
    wrapped at 50 chars (Display_seq), only AGCTagct complemented (N and
    other letters preserved; rev_com_seq.pl tr/AGCTagct/TCGAtcga/)."""
    comp = bytes.maketrans(b"AGCTagct", b"TCGAtcga")
    records: dict[bytes, bytes] = {}
    with open(in_path, "rb") as f:
        name = None
        seq: list[bytes] = []
        for line in f:
            line = line.rstrip(b"\n")
            if line[:1] == b">":
                if name is not None:
                    records[name] = b"".join(seq)
                head = line[1:]
                toks = head.split()
                name = toks[0] if toks else b""
                seq = []
            else:
                seq.append(b"".join(line.split()))
        if name is not None:
            records[name] = b"".join(seq)
    with open(out_path, "wb") as o:
        for name in sorted(records):
            rc = records[name].translate(comp)[::-1]
            body = b"".join(rc[i:i + 50] + b"\n"
                            for i in range(0, len(rc), 50)) or b"\n"
            o.write(b">" + name + b"_rc\n" + body)


def split_libfile(lib_path: str) -> list[str]:
    """Parity: correct_error/split_libfile.pl — one output file per input
    LINE (including blank lines), named `<lib>.1`, `<lib>.2`, ... each
    holding that line verbatim."""
    out = []
    with open(lib_path) as f:
        for number, line in enumerate(f, 1):
            p = f"{lib_path}.{number}"
            with open(p, "w") as o:
                o.write(line)
            out.append(p)
    return out


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
