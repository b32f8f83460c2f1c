"""The host thread pool of the codecs (io/cz.py's table blocks, io/fastq.py's
gzip chunks): one worker a core the process may run on, at most one an
item, the results in the items' order.  zlib drops the GIL while it
deflates or inflates, so the workers run at once.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor

IN_FLIGHT = 4                          # results held pending a worker


def workers(n_items: int) -> int:
    """Threads for n_items items: the process's cores, at most one an
    item."""
    return max(1, min(len(os.sched_getaffinity(0)), n_items))


def in_order(fn, items, workers: int):
    """fn over items, its results in order: in this thread for one worker,
    else on a pool of ``workers`` threads with at most IN_FLIGHT a worker
    pending.  A raise in fn reaches the caller at its item, as in a serial
    loop; the items after it are cancelled."""
    if workers == 1:
        yield from map(fn, items)
        return
    with ThreadPoolExecutor(workers) as pool:
        pending = collections.deque()
        try:
            for item in items:
                if len(pending) == IN_FLIGHT * workers:
                    yield pending.popleft().result()
                pending.append(pool.submit(fn, item))
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()
