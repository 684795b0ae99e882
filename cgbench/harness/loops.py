"""The measured loops.

Both drive one slot at a time through the program with its state
carried, and deliver each slot's worker assignment into pinned host
memory (``Delivery``: a few buffers reused in turn, so at most that many
slots are in flight).

* ``closed_loop``: slots back to back for the window's seconds; the
  window closes after the device has finished every slot issued in it.
* ``open_loop``: slot k is due when its last message has arrived on the
  fixed schedule, ``(k+1)·slot_len/rate`` seconds after the window opens,
  and is issued then or, if the host is behind, as soon as it can be.
  Its latency runs from the due time to the moment its assignment is in
  host memory (the CUDA event after the copy, mapped onto the host clock
  by an anchor event taken as the window opens).

``Run`` keeps what the correctness check after the window needs.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

# slots whose answers may still be on their way to the host
DELIVERY_DEPTH = 4
# how long past the window's close the open loop still serves slots due
# inside it
GRACE_S = 60.0


class StreamExhausted(RuntimeError):
    pass


@dataclass
class Run:
    """The slots routed so far. It keeps, for the correctness check, the
    state before and after and the outputs of every slot below
    ``start_slots`` and of a uniform sample of ``sample_size`` later slots
    drawn from ``seed`` as they pass (reservoir sampling), and the
    outputs of the last few slots delivered. So the device's memory does
    not grow over the window."""
    program: object
    keys: torch.Tensor                  # [slots, slot_len]
    state: object
    start_slots: int = 0
    sample_size: int = 0
    seed: int = 0
    stream_note: str = ""               # why the stream is no longer,
                                        # where a limit cut it
    first_state: object = None
    next_slot: int = 0
    kept: dict = field(default_factory=dict)   # slot -> (pre, out, post)
    recent: dict = field(default_factory=dict)  # slot -> out, the last few
    executed: list = field(default_factory=list)   # every slot's moves

    def __post_init__(self):
        self.first_state = self.state
        self._rng = random.Random(self.seed)
        self._seen = 0                  # slots offered to the sample
        self._sample = []               # the sampled slots, in any order

    def _keep(self, i: int, entry):
        if i < self.start_slots:
            self.kept[i] = entry
            return
        k = self._seen
        self._seen += 1
        if k < self.sample_size:
            self._sample.append(i)
        else:
            r = self._rng.randrange(k + 1)
            if r >= self.sample_size:
                return
            del self.kept[self._sample[r]]
            self._sample[r] = i
        self.kept[i] = entry

    def step(self, cpu_s: list):
        i = self.next_slot
        if i >= self.keys.shape[0]:
            raise StreamExhausted(
                f"the window outran the stream made in set-up ({i} slots): "
                "raise the traffic mix's max_rate_msgs_per_s"
                + self.stream_note)
        pre = self.state
        c0 = time.thread_time()
        with record_function("cgbench.slot"):
            out, self.state = self.program.step(self.keys[i], pre)
        cpu_s.append(time.thread_time() - c0)
        self.next_slot = i + 1
        self._keep(i, (pre, out, self.state))
        self.recent[i] = out
        self.recent.pop(i - DELIVERY_DEPTH, None)
        self.executed.append(out.executed)
        return i, out


class Delivery:
    """Each slot's worker assignment copied into pinned host memory."""

    def __init__(self, slot_len: int, device: torch.device,
                 depth: int = DELIVERY_DEPTH):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(slot_len, dtype=torch.int32,
                                 pin_memory=self.cuda) for _ in range(depth)]
        self.events = [None] * depth
        self.slot_of = [-1] * depth

    def send(self, i: int, assignment: torch.Tensor):
        j = i % len(self.bufs)
        with record_function("cgbench.deliver"):
            if self.events[j] is not None:
                self.events[j].synchronize()
            self.bufs[j].copy_(assignment, non_blocking=self.cuda)
            ev = None
            if self.cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
        self.events[j] = ev
        self.slot_of[j] = i
        return ev

    def delivered(self):
        """(slot, host buffer) of the answers still held."""
        return [(i, b) for i, b in zip(self.slot_of, self.bufs) if i >= 0]


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    kind: str
    first_slot: int
    slots: int = 0
    seconds: float = 0.0
    cpu_s: list = field(default_factory=list)   # host CPU s in each step
    latency_s: list = field(default_factory=list)   # open loop, per slot
    lateness_s: list = field(default_factory=list)  # issue − due, per slot
    failed: int = 0                               # slots never answered
    issued_s: list = field(default_factory=list)  # each slot's issue time,
                                                  # from the window's start


def warm_up(run: Run, delivery: Delivery, n_slots: int, device):
    for _ in range(n_slots):
        i, out = run.step([])
        delivery.send(i, out.assignment)
    sync(device)


def closed_loop(run: Run, delivery: Delivery, seconds: float,
                device) -> Window:
    w = Window("closed", run.next_slot)
    sync(device)
    t0 = time.perf_counter()
    with record_function("cgbench.window"):
        while (now := time.perf_counter()) - t0 < seconds:
            w.issued_s.append(now - t0)
            i, out = run.step(w.cpu_s)
            delivery.send(i, out.assignment)
        sync(device)
    w.seconds = time.perf_counter() - t0
    w.slots = run.next_slot - w.first_slot
    return w


def _wait_until(t: float):
    with record_function("cgbench.wait_due"):
        while True:
            left = t - time.perf_counter()
            if left <= 0:
                return
            if left > 2e-3:
                time.sleep(left - 1e-3)


def open_loop(run: Run, delivery: Delivery, seconds: float, rate: float,
              slot_len: int, device) -> Window:
    w = Window("open", run.next_slot)
    interval = slot_len / rate
    n_due = int(seconds / interval)
    sync(device)
    anchor = None
    if device.type == "cuda":
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        anchor.synchronize()
    t0 = time.perf_counter()
    done = []                    # (due, event or host completion time)
    with record_function("cgbench.window"):
        for k in range(n_due):
            due = t0 + (k + 1) * interval
            _wait_until(due)
            now = time.perf_counter()
            if now > t0 + seconds + GRACE_S:
                w.failed = n_due - k
                break
            w.lateness_s.append(now - due)
            w.issued_s.append(now - t0)
            i, out = run.step(w.cpu_s)
            ev = delivery.send(i, out.assignment)
            done.append((due, ev if ev is not None else time.perf_counter()))
        sync(device)
    w.seconds = time.perf_counter() - t0
    w.slots = run.next_slot - w.first_slot
    for due, ev in done:
        t = ev if isinstance(ev, float) else t0 + anchor.elapsed_time(ev) / 1e3
        w.latency_s.append(t - due)
    return w
