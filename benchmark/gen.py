"""Seeded inputs of a cell, made on the device: a genome, paired-end
libraries with a rising error profile, optional soiling, and the one-line
FASTQ.gz files the stage commands read.

The model is that of the repository's numpy simulator
(``tools/simulate_reads.py``: a random genome with planted repeats,
substitution errors whose rate rises with the square of the position,
Phred qualities that follow the profile, low qualities on most errors) and
of its soiler (``dbg_assembly_tpu_torch/tools/soil.py``), redone in
PyTorch so that a run makes a library in seconds.  Unlike the numpy
simulator, inserts are clipped only to the read length, so mates of a short
insert overlap.  Every draw comes from one ``torch.Generator`` on the
device, in a fixed order: the same seed on the same card and PyTorch gives
the same bytes.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
# a read's name: "@<library>_<ordinal, zero-padded>/<mate>"
NAME_DIGITS = 8


@dataclass
class Library:
    """One paired-end library: [N, L] 2-bit codes and Phred+33 qualities
    of each mate, on the device, and the true number of errors a read."""
    name: str
    codes: tuple          # (r1, r2) uint8 [N, L], 0..3
    quals: tuple          # (q1, q2) uint8 [N, L], ASCII
    errors: tuple         # (e1, e2) int32 [N]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_genome(length: int, repeat_fraction: float, repeat_unit: int,
                g: torch.Generator, device) -> torch.Tensor:
    """[length] uint8 codes 0..3: uniform bases, then length *
    repeat_fraction / repeat_unit segments of repeat_unit bases copied in
    turn from one random place to another (later copies may overwrite
    earlier ones, as in the numpy simulator)."""
    genome = torch.randint(0, 4, (length,), generator=g, device=device,
                           dtype=torch.uint8)
    n_rep = int(length * repeat_fraction / repeat_unit)
    pos = torch.randint(0, length - repeat_unit, (2, n_rep), generator=g,
                        device=device).tolist()
    for src, dst in zip(*pos):
        genome[dst:dst + repeat_unit] = genome[src:src + repeat_unit].clone()
    return genome


def error_profile(read_len: int, start: float, end: float, device):
    """Per-position substitution rate: start + (end - start) * x^2 over
    x = position / (read_len - 1)."""
    x = torch.arange(read_len, device=device, dtype=torch.float64) \
        / max(read_len - 1, 1)
    return start + (end - start) * x * x


def _mate(genome, starts, read_len, rc, prof, g):
    """Reads of read_len bases at ``starts`` (reverse complements if rc),
    with substitution errors drawn from ``prof``, and their qualities."""
    dev = genome.device
    idx = starts[:, None] + torch.arange(read_len, device=dev)[None, :]
    seq = genome[idx]
    if rc:
        seq = 3 - seq.flip(1)
    shape = seq.shape
    err = torch.rand(shape, generator=g, device=dev) < prof[None, :]
    shift = torch.randint(1, 4, shape, generator=g, device=dev,
                          dtype=torch.uint8)
    seq = torch.where(err, (seq + shift) % 4, seq)
    base_q = (-10.0 * torch.log10(prof.clamp_min(1e-5))).to(torch.int64)
    q = (base_q[None, :] + torch.randint(-3, 4, shape, generator=g,
                                         device=dev)).clamp(2, 41)
    low = err & (torch.rand(shape, generator=g, device=dev) < 0.7)
    q = torch.where(low, torch.randint(2, 15, shape, generator=g,
                                       device=dev), q)
    return seq, (q + 33).to(torch.uint8), err.sum(1, dtype=torch.int32)


def simulate_library(genome: torch.Tensor, lib: dict, errors: dict,
                     insert_sd_fraction: float,
                     g: torch.Generator) -> Library:
    """One library of the configuration: genome_length * depth / (2 *
    read_len) pairs, inserts normal around ``insert`` with the configured
    SD, clipped to [read_len, genome length]; R2 is the reverse
    complement of the fragment's far end."""
    dev = genome.device
    glen = genome.shape[0]
    L = int(lib["read_len"])
    n_pairs = int(glen * float(lib["depth"]) / (2 * L))
    ins = torch.normal(float(lib["insert"]),
                       float(lib["insert"]) * insert_sd_fraction,
                       (n_pairs,), generator=g, device=dev)
    ins = ins.round().to(torch.int64).clamp(L, glen)
    starts = (torch.rand(n_pairs, generator=g, device=dev, dtype=torch.float64)
              * (glen - ins + 1)).to(torch.int64)
    prof = error_profile(L, float(errors["start"]), float(errors["end"]), dev)
    r1, q1, e1 = _mate(genome, starts, L, False, prof, g)
    r2, q2, e2 = _mate(genome, starts + ins - L, L, True, prof, g)
    return Library(lib["name"], (r1, r2), (q1, q2), (e1, e2))


def soil(codes_ascii: torch.Tensor, quals: torch.Tensor, adapter: bytes,
         spec: dict, g: torch.Generator) -> None:
    """In place, on [N, L] ASCII reads and qualities of one mate (the
    soiler of dbg_assembly_tpu_torch/tools/soil.py): in a share
    ``adapter_share`` of reads ``adapter`` over a suffix that starts
    uniformly in [20, min(150, L)); in ``lowqual_share`` Phred 2 over a
    tail from a uniform position; an N in ``n_share`` of reads."""
    dev = codes_ascii.device
    N, L = codes_ascii.shape
    ad = torch.tensor(list(adapter), dtype=torch.uint8, device=dev)
    col = torch.arange(L, device=dev)[None, :]
    rel = col - torch.randint(20, min(150, L), (N, 1), generator=g,
                              device=dev)
    over = ((torch.rand(N, 1, generator=g, device=dev)
             < float(spec["adapter_share"]))
            & (rel >= 0) & (rel < len(ad)))
    codes_ascii[over] = ad[rel[over]]
    low = ((torch.rand(N, 1, generator=g, device=dev)
            < float(spec["lowqual_share"]))
           & (col >= torch.randint(0, L, (N, 1), generator=g, device=dev)))
    quals[low] = ord("#")
    rows = torch.rand(N, generator=g, device=dev) < float(spec["n_share"])
    cols = torch.randint(0, L, (N,), generator=g, device=dev)
    rid = torch.nonzero(rows).flatten()
    codes_ascii[rid, cols[rid]] = ord("N")


def read_name(lib: str, mate: int, i: int) -> bytes:
    """The header line fastq_bytes gives read i (0-based)."""
    return b"@%s_%0*d/%d" % (lib.encode(), NAME_DIGITS, i + 1, mate)


def fastq_bytes(name: str, mate: int, seq_ascii: torch.Tensor,
                quals: torch.Tensor) -> bytes:
    """One-line FASTQ of [N, L] ASCII reads, every record the same
    length (names zero-padded), laid out on the device."""
    dev = seq_ascii.device
    N, L = seq_ascii.shape
    head = f"@{name}_".encode()
    tail = f"/{mate}\n".encode()
    ordinal = torch.arange(1, N + 1, device=dev, dtype=torch.int64)
    powers = 10 ** torch.arange(NAME_DIGITS - 1, -1, -1, device=dev,
                                dtype=torch.int64)
    digits = (ordinal[:, None] // powers[None, :] % 10 + ord("0")) \
        .to(torch.uint8)

    def const(b: bytes):
        return torch.tensor(list(b), dtype=torch.uint8,
                            device=dev).expand(N, len(b))
    rec = torch.cat([const(head), digits, const(tail), seq_ascii,
                     const(b"\n+\n"), quals, const(b"\n")], dim=1)
    return rec.contiguous().cpu().numpy().tobytes()


def write_gz(paths_and_data: list[tuple[str, bytes]]) -> None:
    """gzip level 1, one thread a file (zlib releases the interpreter
    lock while it deflates)."""
    def one(item):
        path, data = item
        with open(path, "wb") as f:
            f.write(zlib.compress(data, 1, wbits=31))
    with ThreadPoolExecutor(max(1, len(paths_and_data))) as ex:
        list(ex.map(one, paths_and_data))


def select_libraries(config: dict, traffic: dict) -> list:
    """Names of the libraries a traffic takes: "all", "first", or a list
    of names."""
    names = [lib["name"] for lib in config["libraries"]]
    sel = traffic["libraries"]
    if sel == "all":
        return names
    if sel == "first":
        return names[:1]
    unknown = sorted(set(sel) - set(names))
    if unknown:
        raise ValueError(f"traffic names libraries the configuration "
                         f"lacks: {unknown}")
    return list(sel)


def make_inputs(config: dict, traffic: dict, seed: int, workdir: str,
                device) -> dict:
    """The cell's inputs under ``workdir``: the genome of the
    configuration, every library the traffic names, soiled where the
    traffic says so, as <library>_<mate>.fq.gz.  Returns the file list in
    library order, and for each file its (library, mate), its reads and
    qualities (ASCII, on the host) and each read's true error count; reads
    and bases in all."""
    wanted = select_libraries(config, traffic)
    g = generator(seed, device)
    genome = make_genome(int(config["genome_length"]),
                         float(config["repeat_fraction"]),
                         int(config["repeat_unit"]), g, device)
    # every library of the configuration is drawn, in order, and the
    # soiling from a generator of its own, so that a library's reads do
    # not depend on which others a traffic takes or soils
    made = [simulate_library(genome, lib, config["errors"],
                             float(config["insert_sd_fraction"]), g)
            for lib in config["libraries"]]
    g_soil = generator(seed ^ 0x5011ED, device)
    soil_spec = traffic.get("soil")
    out = {"files": [], "names": [], "seqs": [], "quals": [], "errors": [],
           "reads": 0, "bases": 0}
    blobs = []
    for lib in made:
        if lib.name not in wanted:
            continue
        for mate in (1, 2):
            seq = ACGT.to(device)[lib.codes[mate - 1].long()]
            qual = lib.quals[mate - 1].clone()
            if soil_spec is not None:
                soil(seq, qual, soil_spec["adapters"][mate - 1].encode(),
                     soil_spec, g_soil)
            path = os.path.join(workdir, f"{lib.name}_{mate}.fq.gz")
            blobs.append((path, fastq_bytes(lib.name, mate, seq, qual)))
            out["files"].append(path)
            out["names"].append((lib.name, mate))
            out["seqs"].append(seq.cpu())
            out["quals"].append(qual.cpu())
            out["errors"].append(lib.errors[mate - 1].cpu())
            out["reads"] += seq.shape[0]
            out["bases"] += seq.numel()
    write_gz(blobs)
    return out
