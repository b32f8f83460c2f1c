"""What decides ``correct``: each stage command's files, held against the
plain reference under ``reference/``.

A stage command's checker is ``check(argv, run, state)`` in
``checkers/<command>.py``, found by the command's name as a metric's reader
is (``harness.checker``).  It parses the stage's own argument list (the
command's flags, without ``--device``) with the flags and defaults of the
upstream tool, works the expected answer out from the cell's inputs alone,
and returns named numbers, each with its limit.  Every comparison of the
checkers here is exact (limit 0): the port promises files byte-identical
to the upstream tools'.  The correction and contig stages are also held,
on every read and contig, to what the upstream guarantees of each record
(reference/guarantees.py), which replays neither tool.  Checkers share
what one derives for the next (the k-mer table, cleaned records) through
``state``, set-up stages' checkers first.

This module holds what more than one checker, or the harness, uses.
"""

from __future__ import annotations

import gzip
import hashlib
import os

from .gen import read_name


def differ(got: list, want: list) -> int:
    """Items that differ, position by position, and those one side lacks."""
    return sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))


def lines_differ(path: str, want: bytes) -> int:
    """Lines of the file at ``path`` (none if it is missing) that differ
    from ``want``'s."""
    try:
        with open(path, "rb") as f:
            got = f.read()
    except FileNotFoundError:
        got = b""
    return differ(got.split(b"\n"), want.split(b"\n"))


def input_records(path: str, run, state: dict) -> list:
    """(head, seq, qual) records of a stage's input: a cell input file,
    or what the reference made for an earlier stage's output."""
    if path in state.get("records", {}):
        return state["records"][path]
    fi = run.pass_files.index(path)
    lib, mate = run.inputs["names"][fi]
    seqs = run.inputs["seqs"][fi].numpy()
    quals = run.inputs["quals"][fi].numpy()
    return [(read_name(lib, mate, i), seqs[i].tobytes(), quals[i].tobytes())
            for i in range(seqs.shape[0])]


def records_differ(got_path: str, want: list) -> int:
    """Records (four lines each) of a FASTQ.gz that differ from want."""
    with gzip.open(got_path) as f:
        lines = f.read().split(b"\n")
    got = [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]
    return differ(got, [(h, s, b"+", q) for h, s, q in want])


def clean_result(name, out_path, stat_path, records, stat, state):
    """A cleaner's numbers; its records kept for the next stage's check."""
    state.setdefault("records", {})[out_path] = records
    stat_differ = lines_differ(stat_path, stat.encode())
    return {f"{name}_reads_differ": (records_differ(out_path, records), 0),
            f"{name}_stat_lines_differ": (stat_differ, 0)}


def digests(directory: str, skip) -> dict:
    """blake2b of every regular file a pass wrote, by its path under
    ``directory`` (the inputs and set-up's outputs are links; the files in
    ``skip`` are the harness's), each with the directory's own path in it
    read as ``{work}``, so that a file naming its pass's paths compares
    equal across passes."""
    own = os.path.abspath(directory).encode()
    out = {}
    for d, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, directory)
            if rel in skip or os.path.islink(path):
                continue
            with open(path, "rb") as f:
                data = f.read()
            out[rel] = hashlib.blake2b(
                data.replace(own, b"{work}")).hexdigest()
    return dict(sorted(out.items()))
