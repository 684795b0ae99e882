"""Fault injection — seeded, scripted failure schedules (port of
``repro.runtime.chaos``, the same module: it is plain numpy).

* ``ChaosEvent`` — one scripted fault: a replica **crash** (process
  stops serving and heartbeating; the monitor detects it by heartbeat
  expiry), a **slow**-down (service capacity divided by ``factor``), or
  a **recover** (process returns, subject to the engine's re-admission
  ramp).
* ``ChaosSchedule`` — an ordered event list consumed step by step via
  ``pop_due``. Anything exposing ``pop_due(step) -> list[ChaosEvent]``
  can be handed to ``ServingEngine(chaos=...)``.

``ChaosSchedule.random`` derives a script from a seed once with numpy's
generator, making the same calls in the same order as the reference, so
one seed replays the same fault sequence in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KINDS = ("crash", "slow", "recover")


@dataclass(frozen=True)
class ChaosEvent:
    step: int          # engine step the event fires at (1-based ticks)
    kind: str          # "crash" | "slow" | "recover"
    replica: int
    factor: float = 1.0   # slowdown divisor for "slow" (2.0 = half speed)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"use one of {KINDS}")


class ChaosSchedule:
    """Ordered fault script. ``pop_due`` hands out events whose step has
    arrived (each at most once); ``reset`` rewinds for a fresh run over
    the same scenario."""

    def __init__(self, events=()):
        self.events: list[ChaosEvent] = sorted(events, key=lambda e: e.step)
        self._i = 0

    def __len__(self) -> int:
        return len(self.events)

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.events)

    def reset(self) -> None:
        self._i = 0

    def pop_due(self, step: int) -> list[ChaosEvent]:
        due = []
        while (self._i < len(self.events)
               and self.events[self._i].step <= step):
            due.append(self.events[self._i])
            self._i += 1
        return due

    # -- scenario constructors -------------------------------------------
    @classmethod
    def kill_one(cls, replica: int, at: int,
                 recover_at: int | None = None) -> "ChaosSchedule":
        """The canonical kill-1-of-N scenario: crash ``replica`` at step
        ``at``, optionally bring it back at ``recover_at``."""
        events = [ChaosEvent(at, "crash", replica)]
        if recover_at is not None:
            if recover_at <= at:
                raise ValueError("recover_at must come after the crash")
            events.append(ChaosEvent(recover_at, "recover", replica))
        return cls(events)

    @classmethod
    def slowdown(cls, replica: int, at: int, factor: float,
                 recover_at: int | None = None) -> "ChaosSchedule":
        """Divide ``replica``'s service capacity by ``factor`` from step
        ``at`` (a mid-run cpulimit), optionally restoring it later."""
        events = [ChaosEvent(at, "slow", replica, factor=factor)]
        if recover_at is not None:
            events.append(ChaosEvent(recover_at, "recover", replica))
        return cls(events)

    @classmethod
    def random(cls, seed: int, n_replicas: int, n_steps: int, *,
               p_crash: float = 0.002, mean_downtime: int = 20,
               p_slow: float = 0.0, slow_factor: float = 4.0,
               mean_slowtime: int = 20) -> "ChaosSchedule":
        """A seeded random script: at most one replica is down at a time
        (crash→delayed recovery loops), independent slowdown episodes on
        the others. Crash and slow episodes never overlap on one replica
        — ``apply_chaos`` treats "recover" kind-agnostically, so a slow
        episode's recover landing mid-downtime would revive the corpse
        early and break the one-down-at-a-time invariant. Derived once
        from ``seed`` — re-running the schedule replays the identical
        fault sequence."""
        rng = np.random.default_rng(seed)
        events: list[ChaosEvent] = []
        down_until, down_replica = 0, -1
        slow_until = np.zeros(n_replicas, np.int64)
        for step in range(1, n_steps + 1):
            if step >= down_until and rng.random() < p_crash:
                # never crash a replica mid-slow-episode: its pending
                # slow recover would cut the crash downtime short
                up = [r for r in range(n_replicas)
                      if slow_until[r] <= step]
                if up:
                    r = up[int(rng.integers(len(up)))]
                    dt = max(1, int(rng.exponential(mean_downtime)))
                    events.append(ChaosEvent(step, "crash", r))
                    events.append(ChaosEvent(min(step + dt, n_steps),
                                             "recover", r))
                    down_until, down_replica = step + dt, r
            if p_slow > 0:
                for r in range(n_replicas):
                    if r == down_replica and step < down_until:
                        continue   # no slow episodes on the down replica
                    if step >= slow_until[r] and rng.random() < p_slow:
                        dt = max(1, int(rng.exponential(mean_slowtime)))
                        events.append(ChaosEvent(step, "slow", r,
                                                 factor=slow_factor))
                        events.append(ChaosEvent(min(step + dt, n_steps),
                                                 "recover", r))
                        slow_until[r] = step + dt
        return cls(events)
