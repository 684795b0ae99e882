"""What a run hands the metric readers (``cgbench/metrics/<name>.py``,
each a ``read(record)`` that returns a number, a dict with ``value``
and more, or None when it finds nothing to read)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import roofline
from .loops import Window
from .spec import Cell
from .trace import Trace


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class Record:
    cell: Cell
    setup_s: float
    window: Window                   # untraced: e2e metrics, spans, counters
    launches: dict = field(default_factory=dict)   # counter deltas, window
    moves: list = field(default_factory=list)      # executed per window slot
    traced: Window | None = None     # the traced part of a --trace 1 run
    trace: Trace | None = None
    device_kind: str = ""
    power_limit_w: float | None = None

    def slot_wall_s(self) -> float:
        return self.window.seconds / max(self.window.slots, 1)

    def mean_cpu_ms(self) -> float | None:
        cpu = self.window.cpu_s
        return 1e3 * sum(cpu) / len(cpu) if cpu else None

    def idle_pct(self) -> float | None:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def kernel_roofline(self, pattern: str, work) -> dict | None:
        """A kernel's share of its bound: the bound of the traced slots'
        work over the kernel's device time there, in %."""
        if self.trace is None or self.traced is None:
            return None
        if not self.device_kind:
            raise RuntimeError("a roofline needs the card: no CUDA device")
        launches, secs = self.trace.kernel_time(pattern)
        if launches == 0 or secs <= 0:
            return None
        nbytes, ops = work(self.cell.cg)
        bound, by = roofline.bound_s(nbytes, ops)
        return dict(value=100.0 * bound * self.traced.slots / secs,
                    bound_by=by, launches=launches, device_s=secs,
                    power_limit_w=self.power_limit_w)
