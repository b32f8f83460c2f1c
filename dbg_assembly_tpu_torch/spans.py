"""The port's span recorder: where a command's host time goes.

A span is a named stretch of one thread's host time, stamped with
``time.perf_counter_ns()``: the clock the benchmark puts the device trace
on, so spans and device activity line up with no conversion.  Each record
holds its name, start and end, the index of its parent span (the innermost
span open on its thread, or, on a thread with none open, the span of the
command running), the thread's native id, the command's id (one a command
entered through ``cli.main``) and a small dict of counts.

The recorder is always on and cheap: a span is a few microseconds of
Python, it never synchronises the device or reads a tensor (its time is
the host's; the device trace shows the device), and it is taken around a
file, a batch or a phase, never inside a loop over reads or positions.
Records stay in memory, at most ``LIMIT``; past that new spans are
dropped and counted (``dropped()``) until ``reset()``.

    with spans.span("io.parse"):
        ...
        spans.add(bytes=len(data), reads=n)

``write_chrome_trace`` writes one command's records as a Chrome trace
whose timestamps sit on ``torch.profiler``'s exported timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

LIMIT = 1 << 17

# seconds of libkineto's ChromeTraceBaseTime interval: the base of the
# profiler's exported timestamps is the wall clock floored to it
_BASE_INTERVAL_S = 7889238


class Span:
    """One record.  start and end are perf_counter_ns(); end is None while
    the span is open; index is -1 for a dropped span."""

    __slots__ = ("name", "start", "end", "parent", "thread", "command",
                 "counts", "index")

    def __init__(self, name, start, parent, thread, command, counts):
        self.name = name
        self.start = start
        self.end = None
        self.parent = parent
        self.thread = thread
        self.command = command
        self.counts = counts
        self.index = -1

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


_records: list = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_command_ids = itertools.count(1)
_command = None          # the span of the command running, or None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _begin(name: str, counts: dict) -> Span:
    global _dropped
    stack = _stack()
    cmd = _command
    parent = stack[-1] if stack else cmd
    s = Span(name, 0, parent.index if parent is not None else -1,
             threading.get_native_id(), cmd.command if cmd else 0, counts)
    with _lock:
        if len(_records) < LIMIT:
            s.index = len(_records)
            _records.append(s)
        else:
            _dropped += 1
    stack.append(s)
    s.start = time.perf_counter_ns()
    return s


def _end(s: Span) -> None:
    """Close ``s`` and whatever this thread opened inside it and left
    open."""
    s.end = time.perf_counter_ns()
    stack = _stack()
    if s in stack:
        while stack.pop() is not s:
            pass


@contextlib.contextmanager
def span(name: str, **counts):
    """The span of the code inside the block; yields its record."""
    s = _begin(name, counts)
    try:
        yield s
    finally:
        _end(s)


def add(**counts) -> None:
    """Add counts to the innermost span open on this thread."""
    stack = _stack()
    if stack:
        c = stack[-1].counts
        for key, val in counts.items():
            c[key] = c.get(key, 0) + val


@contextlib.contextmanager
def command(name: str):
    """The span ``cmd.<name>`` of one command, under a new command id that
    every span opened meanwhile, on any thread, carries."""
    global _command
    outer = _command
    s = _begin("cmd." + name, {})
    s.command = next(_command_ids)
    _command = s
    try:
        yield s
    finally:
        _command = outer
        _end(s)


def records() -> list:
    """The records kept, in the order they opened."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans dropped since the last reset because the records were full."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def write_chrome_trace(path: str, command_id: int) -> None:
    """The closed records of one command as a Chrome trace (JSON): an "X"
    event a span, its counts as args, pid this process, tid the thread's
    native id.  ``ts`` is the span's wall-clock time less
    ``baseTimeNanoseconds``, in microseconds, the base floored as
    libkineto floors it, so the file's events sit on the timeline of
    ``torch.profiler``'s ``export_chrome_trace`` of the same run: the
    ``traceEvents`` of the two files concatenate into one trace.  The
    wall clock is reached through one anchor pair, time_ns() and
    perf_counter_ns() read back to back."""
    wall, perf = time.time_ns(), time.perf_counter_ns()
    base = (wall // 10 ** 9 // _BASE_INTERVAL_S) * _BASE_INTERVAL_S \
        * 10 ** 9
    shift = wall - perf - base
    pid = os.getpid()
    events = [{"ph": "X", "cat": "span", "name": s.name, "pid": pid,
               "tid": s.thread, "ts": (s.start + shift) / 1e3,
               "dur": (s.end - s.start) / 1e3,
               "args": dict(s.counts, parent=s.parent, index=s.index)}
              for s in records()
              if s.command == command_id and s.end is not None]
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                   "traceEvents": events}, f)
