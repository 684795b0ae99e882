"""Host spans of the port, alive only while ``torch.profiler`` records.

``span(name)`` is a context manager. With no profiler recording it is a
shared no-op, returned after one read of the profiler's enabled flag, so
an untraced run pays next to nothing for it. While a profiler records,
the span enters ``torch.profiler.record_function(name)``, so it lies on
the profiler's host timeline beside the device's kernels, and on exit
adds to an in-process table, per name: its calls, its wall time and its
self time (the wall time less that of the spans opened inside it).

``totals()`` returns a copy of the table, ``reset()`` clears it. Nothing
is written anywhere else. Spans nest within one thread at a time: the
table and the stack of open spans belong to the process.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class SpanTotal(NamedTuple):
    calls: int
    wall_ns: int      # perf_counter_ns from enter to exit, summed
    self_ns: int      # wall_ns less the wall time of the spans inside


_NOOP = contextlib.nullcontext()
_table: dict[str, list[int]] = {}     # name -> [calls, wall_ns, self_ns]
_open: list[list[int]] = []           # per open span: [start_ns, child_ns]


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = record_function(name)

    def __enter__(self):
        _open.append([time.perf_counter_ns(), 0])
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        start, child = _open.pop()
        wall = time.perf_counter_ns() - start
        if _open:
            _open[-1][1] += wall
        t = _table.setdefault(self.name, [0, 0, 0])
        t[0] += 1
        t[1] += wall
        t[2] += wall - child


def span(name: str):
    """A span named ``name`` while a profiler records, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def totals() -> dict[str, SpanTotal]:
    """What the spans have added up since the last ``reset()``."""
    return {k: SpanTotal(*v) for k, v in _table.items()}


def reset() -> None:
    _table.clear()
