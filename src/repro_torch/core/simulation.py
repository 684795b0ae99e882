"""Queueing simulation of workers (paper §IV cost model, Figs 9/10/13/14/15),
port of ``repro.core.simulation``.

Arrival process: one message per unit time, routed by some partitioner.
Each worker w drains its unbounded FIFO at service rate c_w messages per
unit time; metrics are per slot. ``simulate_deployment`` is the Fig
14/15 analogue: throughput and M/D/1 latency of a Storm-like deployment
with a fixed per-message cost, some executors cpulimit-ed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QueueSimResult(NamedTuple):
    queue_spread: torch.Tensor    # [slots] max-min queue length
    latency_spread: torch.Tensor  # [slots] max-min latency proxy
    mean_latency: torch.Tensor    # [slots]
    max_latency: torch.Tensor     # [slots] latency at the slowest worker
    imbalance: torch.Tensor       # [slots] normalized-load imbalance
    utilization: torch.Tensor     # [slots, n]
    throughput: torch.Tensor      # [slots] messages drained per unit time
    final_queues: torch.Tensor    # [n]


def slot_latency(q0, arrivals, c):
    """Latency proxy: wait behind the queue + own service, and its
    arrival-weighted mean."""
    cc = torch.clamp(c, min=1e-9)
    lat = (q0 + 0.5 * arrivals) / cc + 1.0 / cc
    mean_lat = (lat * arrivals).sum() / torch.clamp(arrivals.sum(), min=1.0)
    return lat, mean_lat


def slot_imbalance(arrivals, c):
    """(max − mean)/mean of the capacity-normalized slot load."""
    norm_load = arrivals / torch.clamp(c, min=1e-9)
    mean = norm_load.mean()
    return (norm_load.max() - mean) / torch.clamp(mean, min=1e-9)


def simulate_queues(assignment: torch.Tensor, capacities: torch.Tensor,
                    n_workers: int, slot_len: int) -> QueueSimResult:
    """Slot-stepped fluid queueing sim for a fixed routing of the stream.

    ``assignment`` [m] worker ids; ``capacities`` [n] or [slots, n]
    service rates (msgs/unit-time).
    """
    dev = assignment.device
    m = assignment.shape[0]
    slots = m // slot_len
    a = assignment[: slots * slot_len].reshape(slots, slot_len).long()
    caps = torch.as_tensor(capacities, dtype=torch.float32, device=dev)
    if caps.ndim == 1:
        caps = caps.expand(slots, n_workers)
    q0 = torch.zeros(n_workers, dtype=torch.float32, device=dev)
    ones = torch.ones(slot_len, dtype=torch.float32, device=dev)
    outs = []
    for t in range(slots):
        c = caps[t]
        arrivals = torch.zeros(n_workers, dtype=torch.float32,
                               device=dev).index_add_(0, a[t], ones)
        service = c * slot_len
        drained = torch.minimum(q0 + arrivals, service)
        q1 = q0 + arrivals - drained
        lat, mean_lat = slot_latency(q0, arrivals, c)
        util = arrivals / torch.clamp(service, min=1e-9)
        outs.append((q1.max() - q1.min(), lat.max() - lat.min(), mean_lat,
                     lat.max(), slot_imbalance(arrivals, c), util,
                     drained.sum() / slot_len))
        q0 = q1
    if not outs:
        e = torch.zeros(0, device=dev)
        return QueueSimResult(e, e, e, e, e, torch.zeros(0, n_workers,
                                                         device=dev), e, q0)
    qs, ls, ml, pl, imb, util, thr = (torch.stack(x) for x in zip(*outs))
    return QueueSimResult(qs, ls, ml, pl, imb, util, thr, q0)


class DeploymentResult(NamedTuple):
    throughput: torch.Tensor      # messages/second sustained
    mean_latency_ms: torch.Tensor
    max_latency_ms: torch.Tensor  # latency at the worst (slowest) worker


def simulate_deployment(assignment: torch.Tensor, n_workers: int,
                        service_ms: float, cpu_fraction: torch.Tensor,
                        offered_rate_per_s: float) -> DeploymentResult:
    """Fig 14/15 analogue: Storm-like deployment with fixed per-message
    cost. Backpressure binds the topology at the worst (service rate /
    routed share) worker, thr = min(offered, min_w svc_w / share_w);
    latency is the per-worker M/D/1 wait at its realized utilization.
    """
    dev = assignment.device
    m = assignment.shape[0]
    cpu_fraction = torch.as_tensor(cpu_fraction, dtype=torch.float32,
                                   device=dev)
    share = torch.zeros(n_workers, dtype=torch.float32, device=dev
                        ).index_add_(0, assignment.long(),
                                     torch.ones(m, dtype=torch.float32,
                                                device=dev)) / m
    svc_rate = cpu_fraction / (service_ms * 1e-3)          # msgs/s per worker
    per_worker_cap = torch.where(share > 0,
                                 svc_rate / torch.clamp(share, min=1e-9),
                                 torch.full_like(share, float("inf")))
    throughput = torch.clamp(per_worker_cap.min(), max=offered_rate_per_s)
    arr_rate = share * throughput
    rho = torch.clamp(arr_rate / torch.clamp(svc_rate, min=1e-9), 0.0, 0.995)
    s_ms = service_ms / cpu_fraction
    wait = rho / (2.0 * (1.0 - rho)) * s_ms                # M/D/1
    lat_ms = s_ms + wait
    mean_lat = (lat_ms * share).sum()
    max_lat = torch.where(share > 0, lat_ms, torch.zeros_like(lat_ms)).max()
    return DeploymentResult(throughput, mean_lat, max_lat)
