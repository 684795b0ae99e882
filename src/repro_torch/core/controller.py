"""Adaptive delegation controller — closed-loop budgets + hysteresis
(port of ``repro.core.controller``).

* **Adaptive move budgets** (``adaptive_moves=True``): the per-slot
  budget is derived from EWMA'd queue depths — the backlog above the
  fleet mean over ``unit`` (the traffic one move re-routes per slot),
  clamped to ``[min_moves, max_moves]``; ``per_worker_budget=True``
  emits an [n] vector of per-worker shed caps instead.
* **Busy/idle hysteresis** (``hysteresis=True``): a signal latches only
  after ``dwell`` consecutive slots over the enter level and releases
  only past a separate exit level.

With both off the masks are the raw threshold comparisons and the
budget is ``max_moves``. All state lives in device tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.backend import resolve_device


class ControllerConfig(NamedTuple):
    n_workers: int
    # --- adaptive move budget ---
    adaptive_moves: bool = False   # derive the budget from queue depth
    min_moves: int = 1             # budget floor at equilibrium
    max_moves: int = 8             # = the engine's max_moves_per_slot
    depth_decay: float = 0.5       # EWMA decay of per-worker depths
    per_worker_budget: bool = False  # emit an [n] budget vector
    # --- busy/idle hysteresis ---
    hysteresis: bool = False       # latch signals between enter/exit
    dwell: int = 3                 # consecutive over-enter slots before
                                   # a new signal latches
    # --- migration-cost cap ---
    byte_budget: float = 0.0       # max VW state bytes one slot may
                                   # migrate (0 = unmetered)


class ControllerState(NamedTuple):
    depth_ewma: torch.Tensor   # [n] f32 EWMA'd queue depth / backlog
    busy_latch: torch.Tensor   # [n] bool signals emitted last slot
    idle_latch: torch.Tensor   # [n] bool
    busy_dwell: torch.Tensor   # [n] i32 consecutive slots above enter
    idle_dwell: torch.Tensor   # [n] i32 consecutive slots below enter
    flaps: torch.Tensor        # []  i32 cumulative emitted-signal flips
    budget: torch.Tensor       # []  i32 budget emitted last slot


def _device_scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``device``. A Python number is
    filled in on the device (no host-to-device copy, so a CUDA slot
    loop does not wait), and a tensor divisor keeps the division a true
    division (torch turns a division by a Python scalar on CUDA into a
    product with its reciprocal)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def init_controller(cfg: ControllerConfig, device="cuda") -> ControllerState:
    n = cfg.n_workers
    device = resolve_device(device)
    return ControllerState(
        depth_ewma=torch.zeros(n, dtype=torch.float32, device=device),
        busy_latch=torch.zeros(n, dtype=torch.bool, device=device),
        idle_latch=torch.zeros(n, dtype=torch.bool, device=device),
        busy_dwell=torch.zeros(n, dtype=torch.int32, device=device),
        idle_dwell=torch.zeros(n, dtype=torch.int32, device=device),
        flaps=torch.zeros((), dtype=torch.int32, device=device),
        budget=torch.full((), cfg.max_moves, dtype=torch.int32,
                          device=device))


def controller_step(cfg: ControllerConfig, state: ControllerState,
                    pressure, depths, unit,
                    enter_busy, exit_busy, enter_idle, exit_idle,
                    unit_bytes=None):
    """One monitoring-slot tick of the controller.

    ``pressure`` [n] is what the thresholds compare against, ``depths``
    [n] the queue depth per worker, ``unit`` the backlog one executed
    move drains per slot. Thresholds are compared in f32, as in the
    reference. Returns ``(new_state, busy [n] bool, idle [n] bool,
    budget)``; ``budget`` is a 0-dim i32 tensor, or an [n] vector under
    ``cfg.per_worker_budget``.
    """
    dev = state.depth_ewma.device
    f32 = torch.float32
    pressure = torch.as_tensor(pressure, dtype=f32, device=dev)
    depths = torch.as_tensor(depths, dtype=f32, device=dev)

    raw_busy = pressure > enter_busy
    raw_idle = pressure < enter_idle

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    busy_dwell = torch.where(raw_busy, state.busy_dwell + 1, zero)
    idle_dwell = torch.where(raw_idle, state.idle_dwell + 1, zero)
    if cfg.hysteresis:
        busy = torch.where(state.busy_latch, pressure > exit_busy,
                           busy_dwell >= cfg.dwell)
        idle = torch.where(state.idle_latch, pressure < exit_idle,
                           idle_dwell >= cfg.dwell)
        idle = idle & ~busy       # shedding wins if both ever latch
    else:
        busy, idle = raw_busy, raw_idle

    flips = ((busy != state.busy_latch).sum()
             + (idle != state.idle_latch).sum()).to(torch.int32)

    depth_ewma = (cfg.depth_decay * state.depth_ewma
                  + (1.0 - cfg.depth_decay) * depths)
    unit_f = torch.clamp(_device_scalar(unit, dev), min=1e-9)
    if cfg.adaptive_moves and cfg.per_worker_budget:
        excess_w = torch.clamp(depth_ewma - depth_ewma.mean(), min=0.0)
        demand_w = torch.ceil(excess_w / unit_f).to(torch.int32)
        budget = torch.clamp(demand_w, 0, cfg.max_moves)
        budget = torch.where(busy, torch.clamp(budget, min=cfg.min_moves),
                             budget)
    elif cfg.adaptive_moves:
        excess = torch.clamp(depth_ewma - depth_ewma.mean(), min=0.0).sum()
        demand = torch.ceil(excess / unit_f)
        budget = torch.clamp(demand.to(torch.int32), cfg.min_moves,
                             cfg.max_moves)
    else:
        budget = torch.full((), cfg.max_moves, dtype=torch.int32, device=dev)
    if cfg.byte_budget > 0 and unit_bytes is not None:
        ub = torch.clamp(_device_scalar(unit_bytes, dev), min=1e-9)
        fit = torch.floor(cfg.byte_budget / ub).to(torch.int32)
        budget = torch.minimum(budget, torch.clamp(fit, min=1))

    new_state = ControllerState(
        depth_ewma=depth_ewma,
        busy_latch=busy,
        idle_latch=idle,
        busy_dwell=busy_dwell,
        idle_dwell=idle_dwell,
        flaps=state.flaps + flips,
        # telemetry stays a scalar either way: the vector's effective
        # total is what the engine can execute
        budget=(torch.clamp(budget.sum(), max=cfg.max_moves).to(torch.int32)
                if budget.ndim else budget))
    return new_state, busy, idle, budget


class DelegationController:
    """Stateful host-side wrapper over ``controller_step`` for callers
    that tick from Python; ``step`` replaces the state and returns the
    masks + budget for this slot."""

    def __init__(self, cfg: ControllerConfig, *,
                 enter_busy: float, exit_busy: float,
                 enter_idle: float, exit_idle: float, device="cuda"):
        self.cfg = cfg
        self.enter_busy, self.exit_busy = enter_busy, exit_busy
        self.enter_idle, self.exit_idle = enter_idle, exit_idle
        self.state = init_controller(cfg, device=device)

    @classmethod
    def from_thresholds(cls, cfg: ControllerConfig, *, theta_busy: float,
                        theta_idle: float, margin: float, device="cuda"):
        """Busy exits ``margin`` below its enter level, idle ``margin``
        above."""
        return cls(cfg, enter_busy=theta_busy,
                   exit_busy=theta_busy - margin,
                   enter_idle=theta_idle,
                   exit_idle=theta_idle + margin, device=device)

    def step(self, pressure, depths, unit=1.0, unit_bytes=None):
        self.state, busy, idle, budget = controller_step(
            self.cfg, self.state, pressure, depths, unit,
            self.enter_busy, self.exit_busy,
            self.enter_idle, self.exit_idle, unit_bytes)
        return busy, idle, budget

    @property
    def flaps(self) -> int:
        return int(self.state.flaps)

    @property
    def last_budget(self) -> int:
        return int(self.state.budget)
