"""What the two scaffolding checkers (checkers/map_pair.py,
checkers/link_scaffold.py) share: the reference's own file in place of
each file of the program that a stage reads, the cell's reads by read id,
and the files read back.

A stage of the scaffold chain reads what an earlier one wrote: map_pair
the contigs (set-up's debruijn_contig) or the round-1 scaffolds;
link_scaffold the contigs and map_pair's 2ctg files.  The checkers feed
the reference the reference's own version of each, never the program's:
each checker leaves its reference outputs in ``state["reference"]``, by
the normalised path of the program's file they stand for; set-up's
contigs are the reference assembler's, which the debruijn_contig checker
leaves in the run's scratch directory as ``reference_contig.contig.seq.fa``.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from .checks import differ
from .gen import NAME_DIGITS

CONTIG_SUFFIX = ".contig.seq.fa"


def key(path: str) -> str:
    return os.path.normpath(os.path.abspath(path))


def reference_file(path: str, run, state: dict) -> bytes:
    """The reference's bytes for the program's file at ``path``."""
    got = state.get("reference", {}).get(key(path))
    if got is not None:
        return got
    if path.endswith(CONTIG_SUFFIX):
        ref = os.path.join(run.scratch, "reference_contig" + CONTIG_SUFFIX)
        if os.path.isfile(ref):
            with open(ref, "rb") as f:
                return f.read()
    raise SystemExit(f"no reference for {path}: no checked stage before "
                     "this one wrote it")


def keep(path: str, data: bytes, state: dict) -> None:
    state.setdefault("reference", {})[key(path)] = data


def read_back(path: str) -> bytes:
    """A file the program wrote, gunzipped where it ends in .gz; empty
    where it is missing."""
    try:
        with (gzip.open(path) if path.endswith(".gz") else
              open(path, "rb")) as f:
            return f.read()
    except FileNotFoundError:
        return b""


def lines_differ(path: str, want: bytes) -> int:
    return differ(read_back(path).split(b"\n"), want.split(b"\n"))


def file_list(path: str) -> list:
    """A .lib list's nonempty lines."""
    with open(path) as f:
        return [x.rstrip("\n") for x in f if x.rstrip("\n")]


class Reads:
    """The cell's reads of the pass's input files, by the read id map_pair
    writes: ``<library>_<ordinal>/<mate>`` (gen.read_name without the
    '@')."""

    def __init__(self, run):
        self.by = {}
        for fi, (lib, mate) in enumerate(run.inputs["names"]):
            self.by[(lib.encode(), mate)] = run.inputs["seqs"][fi].numpy()

    def rows(self, ids: list):
        """([M, L] ASCII, [M] lengths) of each id; length -1 where the id
        names no read."""
        L = max(a.shape[1] for a in self.by.values())
        seqs = np.zeros((len(ids), L), np.uint8)
        lens = np.full(len(ids), -1, np.int64)
        wanted: dict = {}                # (library, mate) -> (ids, reads)
        for j, rid in enumerate(ids):
            head, _, mate = rid.rpartition(b"/")
            lib, _, num = head.rpartition(b"_")
            key = (lib, int(mate) if mate.isdigit() else 0)
            if key in self.by and len(num) == NAME_DIGITS and num.isdigit():
                js, nums = wanted.setdefault(key, ([], []))
                js.append(j)
                nums.append(int(num) - 1)
        for key, (js, nums) in wanted.items():
            a = self.by[key]
            js, nums = np.array(js), np.array(nums)
            keep = (nums >= 0) & (nums < a.shape[0])
            seqs[js[keep], :a.shape[1]] = a[nums[keep]]
            lens[js[keep]] = a.shape[1]
        return seqs, lens
