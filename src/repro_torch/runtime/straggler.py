"""Straggler mitigation = the paper's *worker delegation* at step scale
(port of ``repro.runtime.straggler``).

Each data-parallel host monitors its own step time (the "worker
monitors its workload" of §V-C) and emits a **binary** signal — busy
(step time above θ_b × median) or idle (below θ_i × median). Signals
piggyback on the per-step metrics the trainer already collects (no
extra communication round — the paper's piggybacking).

Pairing is a thin adapter over the shared ``repro_torch.core.delegation``
engine (the same FCFS-with-severity-order queues the CG simulator and
the serving router use): busy hosts pair with idle hosts in severity
order, signals the move budget could not serve carry over FCFS to the
next slot, and one pipeline shard (virtual worker) moves per pair;
routing changes affect only future batches.

``StragglerConfig.hysteresis``/``adaptive_moves`` opt into the shared
adaptive controller (``repro_torch.core.controller``): signals latch
between separate enter/exit step-time ratios with a dwell (a host
hovering at θ_b × median stops flapping), and the per-slot move budget
follows the summed step-time excess instead of the static
``max_moves_per_slot``.

The step-time windows and the signals are host NumPy, as in the
reference (f32 pressure, ``np.nanmedian``); the delegation queues and
the controller's state live on ``device``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import controller, delegation
from repro_torch.kernels.backend import resolve_device


@dataclass
class StragglerConfig:
    theta_busy: float = 1.15     # step_time > θ_b × median → busy
    theta_idle: float = 0.90     # step_time < θ_i × median → idle
    window: int = 8              # time slot t0, in steps
    max_moves_per_slot: int = 2
    adaptive_moves: bool = False  # per-slot budget from the summed
                                  # step-time excess over the fleet mean
                                  # (repro_torch.core.controller), clamped
                                  # [min_moves, max_moves_per_slot]
    min_moves: int = 1
    depth_decay: float = 0.5     # EWMA decay of the step-time ratios
    hysteresis: bool = False     # latch busy/idle between enter/exit
                                  # ratio levels + dwell
    exit_margin: float = 0.10    # busy exits below θ_b−margin × median,
                                  # idle exits above θ_i+margin × median
    dwell: int = 3               # slots a raw signal must persist


@dataclass
class DelegationBalancer:
    """Source-side CG balancer for pipeline shards across hosts."""
    n_hosts: int
    cfg: StragglerConfig = field(default_factory=StragglerConfig)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._hist: list[deque] = [deque(maxlen=self.cfg.window)
                                   for _ in range(self.n_hosts)]
        self._dcfg = delegation.DelegationConfig(
            n_workers=self.n_hosts, n_virtual=0,
            max_moves_per_slot=self.cfg.max_moves_per_slot, fcfs=True)
        self._dev = resolve_device(self.device)
        self._queues = delegation.init_queues(self.n_hosts, self._dev)
        self.moves: list[tuple[int, int]] = []
        # adaptive controller over the step-time/median ratio: busy
        # enters above θ_b and exits below θ_b − margin (idle
        # symmetric); the budget follows the summed ratio excess
        if self.cfg.adaptive_moves or self.cfg.hysteresis:
            c = self.cfg
            self._controller = controller.DelegationController.from_thresholds(
                controller.ControllerConfig(
                    n_workers=self.n_hosts,
                    adaptive_moves=c.adaptive_moves,
                    min_moves=c.min_moves,
                    max_moves=c.max_moves_per_slot,
                    depth_decay=c.depth_decay,
                    hysteresis=c.hysteresis, dwell=c.dwell),
                theta_busy=c.theta_busy, theta_idle=c.theta_idle,
                margin=c.exit_margin, device=self._dev)
        else:
            self._controller = None

    @property
    def flap_count(self) -> int:
        """Cumulative busy/idle signal flips (controller telemetry)."""
        return self._controller.flaps if self._controller else 0

    def observe(self, host: int, step_time_s: float) -> None:
        self._hist[host].append(step_time_s)

    def _means(self) -> list[float]:
        return [np.mean(h) if h else np.nan for h in self._hist]

    def signals(self) -> tuple[list[int], list[int]]:
        """Binary delegation signals after the current slot."""
        means = self._means()
        med = np.nanmedian(means)
        busy, idle = [], []
        if not np.isfinite(med) or med <= 0:
            return busy, idle
        for h, m in enumerate(means):
            if not np.isfinite(m):
                continue
            if m > self.cfg.theta_busy * med:
                busy.append(h)
            elif m < self.cfg.theta_idle * med:
                idle.append(h)
        return busy, idle

    def rebalance(self, pipeline) -> list[tuple[int, int]]:
        """Pair busy→idle hosts (severity order, FCFS carry-over across
        slots, bounded per slot) and move one shard per pair.
        ``pipeline`` must expose move_shard()."""
        means = np.asarray(self._means(), np.float32)
        pressure = np.where(np.isfinite(means), means, 0.0)
        budget = None
        if self._controller is not None:
            med = float(np.nanmedian(means))
            if not np.isfinite(med) or med <= 0:
                return []
            # a host with no samples sits at ratio 1.0: neither busy
            # nor idle, and it contributes no depth excess
            ratio = np.where(np.isfinite(means), means / med, 1.0)
            ratio = torch.from_numpy(ratio.astype(np.float32)).to(self._dev)
            busy_t, idle_t, budget_t = self._controller.step(ratio, ratio,
                                                             1.0)
            budget = budget_t if self.cfg.adaptive_moves else None
        else:
            busy, idle = self.signals()
            busy_t = torch.zeros(self.n_hosts, dtype=torch.bool)
            busy_t[busy] = True
            idle_t = torch.zeros(self.n_hosts, dtype=torch.bool)
            idle_t[idle] = True
            busy_t, idle_t = busy_t.to(self._dev), idle_t.to(self._dev)
        src, dst, n_pairs, self._queues = delegation.plan_pairs(
            self._dcfg, self._queues, torch.from_numpy(pressure), busy_t,
            idle_t, budget)
        src, dst = src.cpu().numpy(), dst.cpu().numpy()
        moved = []
        for j in range(int(n_pairs)):
            sid = pipeline.move_shard(int(src[j]), int(dst[j]))
            if sid is not None:
                moved.append((int(src[j]), int(dst[j])))
        self.moves.extend(moved)
        return moved
