"""Evaluation metrics from the paper (Table III), port of
``repro.core.metrics``. Every metric takes the assignment a partitioner
produced (a tensor on any device) plus capacities."""
from __future__ import annotations

import torch


def loads(assignment: torch.Tensor, n_bins: int,
          weights: torch.Tensor | None = None) -> torch.Tensor:
    """L_w = number (or weight) of messages assigned to each bin."""
    if weights is None:
        weights = torch.ones(assignment.shape, dtype=torch.float32,
                             device=assignment.device)
    return torch.zeros(n_bins, dtype=torch.float32,
                       device=assignment.device).index_add_(
        0, assignment.reshape(-1).long(), weights.reshape(-1).float())


def normalized_loads(assignment: torch.Tensor,
                     capacities: torch.Tensor) -> torch.Tensor:
    """U_w = L_w / c_w (paper §IV)."""
    return loads(assignment, capacities.shape[0]) / capacities


def imbalance(assignment: torch.Tensor,
              capacities: torch.Tensor) -> torch.Tensor:
    """I(t) = max_w U_w − avg_w U_w."""
    U = normalized_loads(assignment, capacities)
    return U.max() - U.mean()


def normalized_imbalance(assignment: torch.Tensor,
                         capacities: torch.Tensor) -> torch.Tensor:
    """Imbalance divided by the average normalized load."""
    U = normalized_loads(assignment, capacities)
    return (U.max() - U.mean()) / torch.clamp(U.mean(), min=1e-12)


def memory_footprint(assignment: torch.Tensor, keys: torch.Tensor,
                     n_bins: int, n_keys: int) -> torch.Tensor:
    """M = Σ_w |{k : k appears at w}| = total key replication, via a
    (n_keys, n_bins) presence vector."""
    if n_keys * n_bins >= 2**31:
        raise ValueError("presence matrix would overflow int32")
    flat = keys.long() * n_bins + assignment.long()
    present = torch.zeros(n_keys * n_bins, dtype=torch.int32,
                          device=keys.device)
    present[flat] = 1
    return present.sum()


def replication_lower_bound(p: torch.Tensor, n_bins: int,
                            eps: float) -> torch.Tensor:
    """Paper Eq. 2: E[X] = Σ_i ceil(p_i · n / (1+eps)) (PoRC bound)."""
    return torch.ceil(p * n_bins / (1.0 + eps)).sum()


def replication_upper_bound_sg(p: torch.Tensor, m: int,
                               n_bins: int) -> torch.Tensor:
    """Paper Eq. 1: E[X] = Σ_i min(ceil(p_i·m), n) (shuffle grouping)."""
    return torch.clamp(torch.ceil(p * m), max=n_bins).sum()
