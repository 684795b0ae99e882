"""Worker delegation and its controller, plain torch: what one
monitoring slot does with the busy/idle signals.

The controller turns utilisation into busy and idle signals (with
hysteresis if asked) and a move budget (adaptive if asked). Delegation
keeps windowed per-VW rates, admits the signals into FCFS queues, turns
per-worker shed/absorb budgets into (busy, idle) pairs and moves the
busy worker's highest-rate VW onto the idle one, one move at a time.
"""
from __future__ import annotations

import numpy as np
import torch

NOT_QUEUED = 2**31 - 1


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def controller_step(cfg: dict, st: dict, pressure, depths, unit: float):
    """Returns (busy, idle, budget, new controller fields)."""
    dev = pressure.device
    enter_busy = cfg["theta_busy"]
    exit_busy = cfg["theta_busy"] - cfg["theta_margin"]
    enter_idle = cfg["theta_idle"]
    exit_idle = cfg["theta_idle"] + cfg["theta_margin"]
    raw_busy = pressure > enter_busy
    raw_idle = pressure < enter_idle
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    busy_dwell = torch.where(raw_busy, st["busy_dwell"] + 1, zero)
    idle_dwell = torch.where(raw_idle, st["idle_dwell"] + 1, zero)
    if cfg["hysteresis"]:
        busy = torch.where(st["busy_latch"], pressure > exit_busy,
                           busy_dwell >= cfg["dwell"])
        idle = torch.where(st["idle_latch"], pressure < exit_idle,
                           idle_dwell >= cfg["dwell"])
        idle = idle & ~busy
    else:
        busy, idle = raw_busy, raw_idle
    flips = ((busy != st["busy_latch"]).sum()
             + (idle != st["idle_latch"]).sum()).to(torch.int32)
    decay = cfg["depth_decay"]
    depth_ewma = decay * st["depth_ewma"] + (1.0 - decay) * depths
    max_moves = cfg["max_moves_per_slot"]
    if cfg["adaptive_moves"]:
        unit_f = torch.clamp(torch.full((), float(unit), dtype=torch.float32,
                                        device=dev), min=1e-9)
        excess = torch.clamp(depth_ewma - depth_ewma.mean(), min=0.0).sum()
        budget = torch.clamp(torch.ceil(excess / unit_f).to(torch.int32),
                             cfg["min_moves"], max_moves)
    else:
        budget = torch.full((), max_moves, dtype=torch.int32, device=dev)
    new = dict(depth_ewma=depth_ewma, busy_latch=busy, idle_latch=idle,
               busy_dwell=busy_dwell, idle_dwell=idle_dwell,
               flaps=st["flaps"] + flips, budget=budget)
    return busy, idle, budget, new


def _enqueue(fcfs: bool, busy, idle, busy_since, idle_since, slot):
    nq = torch.full_like(busy_since, NOT_QUEUED)
    slot = slot.expand_as(busy_since)
    if fcfs:
        b = torch.where(busy & (busy_since == NOT_QUEUED), slot, busy_since)
        b = torch.where(idle, nq, b)
        i = torch.where(idle & (idle_since == NOT_QUEUED), slot, idle_since)
        i = torch.where(busy, nq, i)
        return b, i
    return torch.where(busy, slot, nq), torch.where(idle, slot, nq)


def _fcfs_rank(enq, severity):
    """Queued workers first by (enqueue slot, severity), ties by index."""
    sev = torch.where(enq == NOT_QUEUED,
                      torch.full_like(severity, float("inf")), severity)
    order = torch.argsort(sev, stable=True)
    return order[torch.argsort(enq[order], stable=True)]


def rebalance_step(cfg: dict, st: dict, pressure, busy, idle, vw_arrivals,
                   capacities, budget):
    """One slot of delegation. ``budget`` is None or a 0-dim count that
    clamps the executed moves. Returns (new delegation fields, moves
    executed this slot)."""
    dev = st["vw_owner"].device
    n = cfg["n_workers"]
    V = n * cfg["alpha"]
    M = cfg["max_moves_per_slot"]
    rate = (_f32(cfg["rate_decay"]) * st["vw_rate"].double()
            + vw_arrivals.double()).float()
    busy_since, idle_since = _enqueue(cfg["fcfs_pairing"], busy, idle,
                                      st["busy_since"], st["idle_since"],
                                      st["pair_slot"])
    in_busy = busy_since != NOT_QUEUED
    in_idle = idle_since != NOT_QUEUED
    busy_rank = _fcfs_rank(busy_since, -pressure)
    idle_rank = _fcfs_rank(idle_since, pressure)
    owner = st["vw_owner"]
    owner_l = owner.long()
    owned = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, owner_l, torch.ones_like(owner))
    rate_w = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, owner_l, rate)
    one = torch.clamp(owned, max=1)
    zero = torch.zeros_like(owned)
    if cfg["capacity_weighted"]:
        total = rate_w.sum()
        share = capacities / torch.clamp(capacities.sum(), min=1e-9)
        target = share * total
        per_vw = torch.clamp(total * _recip(max(V, 1)), min=1e-9)
        surplus = torch.round((rate_w - target) / per_vw).to(torch.int32)
        deficit = torch.round((target - rate_w) / per_vw).to(torch.int32)
        shed = torch.where(in_busy, torch.minimum(torch.maximum(surplus, one),
                                                  owned), zero)
        absorb = torch.where(in_idle, torch.clamp(deficit, min=1), zero)
    else:
        shed = torch.where(in_busy, one, zero)
        absorb = torch.where(in_idle, torch.ones_like(zero), zero)
    shed, absorb = shed.to(torch.int32), absorb.to(torch.int32)
    # the schedule: run-length decoding of the budgets in FCFS order
    last = max(n - 1, 0)
    cs = torch.cumsum(shed[busy_rank], 0)
    ca = torch.cumsum(absorb[idle_rank], 0)
    j = torch.arange(M, dtype=cs.dtype, device=dev)
    src = busy_rank[torch.clamp(torch.searchsorted(cs, j, right=True), 0,
                                last)]
    dst = idle_rank[torch.clamp(torch.searchsorted(ca, j, right=True), 0,
                                last)]
    n_exec = torch.clamp(torch.minimum(cs[-1], ca[-1]), max=M).to(torch.int32)
    if budget is not None:
        n_exec = torch.minimum(n_exec, budget.to(torch.int32))
    # execution: the source's highest-rate VW, one move at a time
    new_owner = owner.clone()
    done = torch.zeros((), dtype=torch.int32, device=dev)
    served_src = torch.zeros(n, dtype=torch.int32, device=dev)
    served_dst = torch.zeros(n, dtype=torch.int32, device=dev)
    neg_inf = torch.full_like(rate, float("-inf"))
    for k in range(M):
        s, d = src[k: k + 1], dst[k: k + 1]
        cand = new_owner == s
        v = torch.argmax(torch.where(cand, rate, neg_inf)).reshape(1)
        can = (n_exec > k) & cand.any()
        new_owner.index_put_((v,), torch.where(can, d.to(new_owner.dtype),
                                               new_owner.index_select(0, v)))
        step = can.to(torch.int32).reshape(1)
        done = done + step[0]
        served_src.index_add_(0, s, step)
        served_dst.index_add_(0, d, step)
    nq = torch.full_like(busy_since, NOT_QUEUED)
    busy_since = torch.where(served_src >= shed, nq, busy_since)
    idle_since = torch.where(served_dst >= absorb, nq, idle_since)
    return dict(vw_owner=new_owner, vw_rate=rate, busy_since=busy_since,
                idle_since=idle_since, pair_slot=st["pair_slot"] + 1,
                moves=st["moves"] + done), done
