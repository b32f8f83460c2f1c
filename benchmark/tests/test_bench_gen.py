"""The seeded generator and the soiler: the same seed gives the same
bytes; counts, lengths and inserts follow the configuration."""

import gzip
import hashlib

import pytest
import torch

from benchmark import gen

CONFIG = {"genome_length": 50000, "repeat_fraction": 0.05,
          "repeat_unit": 700, "insert_sd_fraction": 0.05,
          "errors": {"start": 0.001, "end": 0.0061},
          "libraries": [{"name": "frag", "read_len": 101, "insert": 180,
                         "depth": 20},
                        {"name": "long", "read_len": 250, "insert": 800,
                         "depth": 4}]}
SOIL = {"adapter_share": 0.1, "lowqual_share": 0.1, "n_share": 0.005,
        "adapters": ["GATCGGAAGAGCACACGTCTGAACTCCAGTCAC",
                     "GATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]}


def _digest(out):
    h = hashlib.blake2b()
    for path in out["files"]:
        with gzip.open(path) as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("soil", [None, SOIL])
def test_same_seed_same_bytes(tmp_path, soil):
    traffic = {"libraries": "all"}
    if soil:
        traffic["soil"] = soil
    seed = 2 ** 33 + 5          # wider than 32 bits
    digests = []
    for i, s in enumerate((seed, seed, seed + 1)):
        d = tmp_path / str(i)
        d.mkdir()
        digests.append(_digest(gen.make_inputs(CONFIG, traffic, s, str(d),
                                               "cpu")))
    assert digests[0] == digests[1] != digests[2]


def test_counts_lengths_and_inserts(tmp_path):
    out = gen.make_inputs(CONFIG, {"libraries": "all"}, 7, str(tmp_path),
                          "cpu")
    assert [n for n, _ in out["names"]] == ["frag", "frag", "long", "long"]
    for (name, _), seq in zip(out["names"], out["seqs"]):
        lib = {x["name"]: x for x in CONFIG["libraries"]}[name]
        n_pairs = int(50000 * lib["depth"] / (2 * lib["read_len"]))
        assert tuple(seq.shape) == (n_pairs, lib["read_len"])
    with gzip.open(out["files"][0]) as f:
        lines = f.read().split(b"\n")
    assert lines[0] == b"@frag_00000001/1" and lines[2] == b"+"
    assert len(lines) == 4 * out["seqs"][0].shape[0] + 1
    errors = sum(int(e.sum()) for e in out["errors"])
    assert 0.0015 < errors / out["bases"] < 0.004


def test_mates_overlap_at_short_inserts():
    g = gen.generator(3, "cpu")
    genome = gen.make_genome(20000, 0.0, 700, g, "cpu")
    lib = gen.simulate_library(
        genome, {"name": "x", "read_len": 101, "insert": 180, "depth": 30},
        {"start": 0.0, "end": 0.0}, 0.05, g)
    r1, r2 = lib.codes
    # with no errors the overlap of R1's tail and R2's reverse complement
    # is exact: the fragment is shorter than two reads
    rc2 = 3 - r2.flip(1)
    hits = 0
    for i in range(50):
        a, b = r1[i].tolist(), rc2[i].tolist()
        shift = next(s for s in range(102) if a[s:] == b[:101 - s])
        hits += 0 < shift < 101
    assert hits == 50


def test_soil_shares():
    g = gen.generator(11, "cpu")
    seq = gen.ACGT[torch.randint(0, 4, (20000, 150), generator=g)]
    qual = torch.full((20000, 150), ord("I"), dtype=torch.uint8)
    gen.soil(seq, qual, SOIL["adapters"][0].encode(), SOIL, g)
    low = (qual == ord("#")).any(1).float().mean().item()
    with_n = (seq == ord("N")).any(1).float().mean().item()
    assert 0.08 < low < 0.12 and 0.002 < with_n < 0.009
