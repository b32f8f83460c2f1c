"""The generator's calibration: the k-mer spectrum of a configuration's
simulated libraries (all of them), to set beside the upstream's golden
one (test/01.clean_correct/clean_reads.lib.kmer.freq.stat: 173 726 599
individuals, 12 704 717 species, 63.2 % of them at frequency 2 or less).

    python3 benchmark/calibrate.py [--config ecoli_mg1655_pe250] \
        [--seed 1] [-k 17] [-q 10] [--device cuda]

Prints one JSON line per quality cutoff (0 and -q): individuals, species
and the share of species seen at most once and at most twice.  A record
only: no check rests on it.
"""

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--config", default="ecoli_mg1655_pe250")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("-k", type=int, default=17)
    ap.add_argument("-q", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import gen
    from benchmark.reference import kmers
    bench = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(bench, "configs", a.config + ".json")) as f:
        config = json.load(f)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        inputs = gen.make_inputs(config, {"libraries": "all"}, a.seed, tmp,
                                 a.device)
    files = list(zip(inputs["seqs"], inputs["quals"]))
    for q in (0, a.q):
        _, counts, total = kmers.count(files, a.k, q, a.device)
        species = counts.numel()
        print(json.dumps({
            "config": a.config, "seed": a.seed, "k": a.k, "q": q,
            "reads": inputs["reads"], "bases": inputs["bases"],
            "individuals": total, "species": species,
            "share_le1": int((counts <= 1).sum()) / species,
            "share_le2": int((counts <= 2).sum()) / species}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
