"""Seeded soiling of a simulated read library, so that both cleaning stages
have work: ``chip_smoke.py`` soils its E. coli-scale library with it and
``tests/test_torch_clean.py`` its small one."""

from __future__ import annotations

import numpy as np

from ..clean.adapter import DEFAULT_ADAPTERS


def soil(reads: np.ndarray, quals: np.ndarray, mate: int, seed: int) -> None:
    """In place, on [N, L] ASCII reads and qualities of one mate: in 10 %
    of reads the mate's default adapter (R1 or R2, clean/adapter.py) over a
    suffix that starts uniformly in [20, min(150, L)); in 10 % Phred 2 over
    a random tail; an N in 0.5 %."""
    rng = np.random.default_rng(seed)
    N, L = reads.shape
    name = "R1-adapter" if mate == 1 else "R2-adapter"
    adapter = np.frombuffer(DEFAULT_ADAPTERS[name][0][1].encode(), np.uint8)
    col = np.arange(L)[None, :]
    rel = col - rng.integers(20, min(150, L), N)[:, None]
    over = ((rng.random(N) < 0.10)[:, None] & (rel >= 0)
            & (rel < len(adapter)))
    reads[over] = adapter[rel[over]]
    low = (rng.random(N) < 0.10)[:, None] & (col >= rng.integers(0, L, N)
                                             [:, None])
    quals[low] = ord("#")
    rows = np.flatnonzero(rng.random(N) < 0.005)
    reads[rows, rng.integers(0, L, len(rows))] = ord("N")
