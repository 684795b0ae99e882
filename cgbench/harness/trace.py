"""What the profiler's trace of a window says: the device's busy time
(the union of every operation on the card: kernels, copies, sets), each
kernel's device time, the longest idle gaps by what the host was doing,
and the device operations that took the most time.

The traced window is the span ``cgbench.window`` that the loops open;
an idle gap is charged to the innermost host operation or span open
when it began (``cgbench.slot``: the program's Python between its
operations; ``cgbench.deliver``: waiting to reuse a host buffer;
``cgbench.wait_due``: the open loop waiting for the schedule).
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> (launches, s)
    device_ops: list = field(default_factory=list)   # [[name, s], ...]
    idle_gaps: list = field(default_factory=list)    # [[name, s], ...]

    def kernel_time(self, pattern: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.kernels.items() if rx.search(k)]
        return (sum(c for c, _ in hits), sum(s for _, s in hits))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _open_at(host, starts, spans, t) -> str:
    """The innermost host operation open at ``t``: the latest-starting
    one of the few hundred that began last, else the innermost of the
    harness's own spans (the program's Python between operations)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    for s, e, name in reversed(spans):
        if s <= t < e:
            return name
    return "(no host op)"


def read(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a ``Trace``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # a record_function span is mirrored on the device timeline as
            # a user annotation: it is no operation
            if not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith("cgbench."):
                dev.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
            if e.name == "cgbench.window":
                window = (s, t)
    if window is None:
        raise RuntimeError("the trace holds no cgbench.window span")
    w0, w1 = window
    kernels = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (t - s) / 1e6
    busy = _merge([(max(s, w0), min(t, w1)) for s, t, _ in dev
                   if t > w0 and s < w1])
    busy_s = sum(t - s for s, t in busy) / 1e6
    # idle gaps inside the window, charged to the innermost open host op
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("cgbench.")]
    by_name = defaultdict(float)
    for g0, g1 in gaps:
        by_name[_open_at(host, starts, spans, g0)] += (g1 - g0) / 1e6
    top_dev = sorted(((k, v[1]) for k, v in kernels.items()),
                     key=lambda kv: -kv[1])[:TOP]
    top_gap = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_s,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 device_ops=[[k, v] for k, v in top_dev],
                 idle_gaps=[[k, v] for k, v in top_gap])
