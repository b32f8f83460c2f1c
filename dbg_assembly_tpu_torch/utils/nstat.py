"""Assembly length statistics (fastaDeal.pl / seqlen_stat.pl equivalents).

Counterpart of dbg_assembly_tpu/utils/nstat.py.

Output format matches the shipped fixtures
(test/02.build_contig/*.seq.fa.len and *.len.stat):

    ctg_1\t78935              (fasta_len: id<TAB>length per record)

    Total\t516\t4536342       (seqlen_stat: counts and N10..N90 table)
    Maximum\t1\t78935
    N50\t69\t19872
    ...
    Minimum\t1\t126
"""

from __future__ import annotations


def fasta_lengths(path: str):
    """Yield (id, length) per record (fastaDeal.pl -attr id:len)."""
    name = None
    ln = 0
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line[:1] == b">":
                if name is not None:
                    yield name.decode(), ln
                name = line[1:].split()[0] if len(line) > 1 else b""
                ln = 0
            else:
                ln += len(line.replace(b" ", b""))
    if name is not None:
        yield name.decode(), ln


def write_len_file(fa_path: str, out_path: str) -> None:
    with open(out_path, "w") as f:
        for name, ln in fasta_lengths(fa_path):
            f.write(f"{name}\t{ln}\n")


def seqlen_stat(lengths) -> dict:
    """N10..N90 table from a length list."""
    ls = sorted(lengths, reverse=True)
    total = sum(ls)
    out = {"total_num": len(ls), "total_len": total,
           "max": ls[0] if ls else 0, "min": ls[-1] if ls else 0}
    acc = 0
    idx = 0
    for nx in range(10, 100, 10):
        target = total * nx / 100.0
        while idx < len(ls) and acc < target:
            acc += ls[idx]
            idx += 1
        # seqlen_stat.pl reports the 0-based rank of the crossing sequence
        out[f"N{nx}"] = (max(idx - 1, 0), ls[idx - 1] if idx else 0)
    return out


def write_len_stat(len_path: str, out_path: str, col: int = 2) -> None:
    lengths = []
    with open(len_path) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= col:
                lengths.append(int(tok[col - 1]))
    st = seqlen_stat(lengths)
    with open(out_path, "w") as f:
        f.write(f"Total\t{st['total_num']}\t{st['total_len']}\n")
        f.write(f"Maximum\t1\t{st['max']}\n")
        for nx in range(10, 100, 10):
            cnt, ln = st[f"N{nx}"]
            f.write(f"N{nx}\t{cnt}\t{ln}\n")
        f.write(f"Minimum\t{st['total_num'] and 1}\t{st['min']}\n")
